"""The port's serving engine on the hybrid family against the JAX engine, on
the CPU: the paged pool (prompts longer than the chunk, so that the mamba
state resumes across chunks; two prompts sharing a page-aligned prefix,
which must NOT be shared: recurrent state cannot be inherited; more
requests than slots, so that slots are reused).

One engine of each package serves the same requests on the same bridged
float32 weights of reduced zamba2-7b and of the reference's ``hybrid``
family config (``tests/torch_hybrid_cases.py``).  Tokens, completion
order, the counters and TTFT ticks must be equal, and every per-token
logit within ``atol=1e-5``; the JAX engine runs eagerly and the port is
also fed the reference's bf16-rounded scan weights, the flips counted
(``tests/torch_hybrid_serve.py``, where the checks live).
"""
import pytest

from torch_hybrid_serve import (  # noqa: F401
    serve_both, test_completion_order_equals_reference,
    test_counters_equal_reference, test_every_request_completes,
    test_logits_match_reference, test_own_rounding_flips_are_counted,
    test_recurrent_state_turns_prefix_sharing_off,
    test_tokens_equal_reference, test_ttft_ticks_equal_reference)

CASES = ["zamba2-paged", "hybrid-paged"]


@pytest.fixture(scope="module", params=CASES)
def engines(request):
    return serve_both(request.param)
