"""The checks of the port's serving engine on the hybrid family against the
JAX engine (a helper, not collected): ``tests/test_torch_hybrid_serving.py``
(the paged pool) and ``tests/test_torch_hybrid_contig_serving.py`` (the
contiguous cache) each define the ``engines`` fixture over their cases
and import the tests below.

One engine of each package serves the same requests on the same bridged
float32 weights of reduced zamba2-7b and of the reference's ``hybrid``
family config (``tests/torch_hybrid_cases.py``), on the paged pool
(prompts longer than the chunk, so that the mamba state resumes across
chunks; two prompts sharing a page-aligned prefix, which must NOT be
shared: recurrent state cannot be inherited; more requests than slots, so
that slots are reused) and on the contiguous cache (``paged=False``).
Tokens, completion order, the counters and TTFT ticks must be equal, and
every per-token logit within ``atol=1e-5``.

The JAX engine runs eagerly (``jax.disable_jit``) so that its SSD scans'
inputs can be read; the port's engine runs twice, on its own bf16
rounding of the scans' weights and fed the reference's rounded tensors
(``torch_hybrid_cases``).  The fed run is held to all of the above; the
flips between the two roundings are counted and printed with the own
run's logit distance, and where there is none the own run is held to it
as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy
from torch_hybrid_cases import (configs, count_flips, numpy_tree,
                                port_roundings, reference_roundings,
                                reference_scans)

SERVE = {
    "paged": dict(max_batch=3, max_prompt=8, max_new_tokens=5, page_size=4,
                  max_seq=36, record_logits=True),
    "contiguous": dict(paged=False, max_batch=3, max_prompt=12,
                       max_new_tokens=5, page_size=4, record_logits=True),
}
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]


def _prompts(layout, vocab):
    rng = np.random.RandomState(3)
    if layout == "contiguous":
        return [[int(t) for t in rng.randint(0, vocab, n)]
                for n in (12, 3, 9, 1, 7)]
    base = [int(t) for t in rng.randint(0, vocab, 16)]
    other = [[int(t) for t in rng.randint(0, vocab, n)]
             for n in (5, 3, 11, 19)]
    return [base + [7, 8], other[3], other[1], base + [9], other[0],
            other[2]]


def _serve_port(tc, tp, layout, prompts, **roundings):
    eng = ServingEngine(tc, tp, ServeConfig(**SERVE[layout]), device="cpu")
    with port_roundings(**roundings):
        done = eng.run([Request(i, p) for i, p in enumerate(prompts)])
    return eng, {r.rid: r for r in done}


def serve_both(param):
    """Both engines on case ``param`` ("<config>-<layout>")."""
    case, layout = param.split("-")
    jc, tc = configs(case)
    tree = numpy_tree(jc)
    tp = from_jax_numpy(tc, tree, device="cpu")
    prompts = _prompts(layout, tc.vocab_size)
    je = JaxEngine(jc, jax.tree.map(jnp.asarray, tree),
                   JaxServeConfig(**SERVE[layout]))
    calls = []
    with reference_scans(calls):
        jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    ref, mine = reference_roundings(calls), []
    own, oout = _serve_port(tc, tp, layout, prompts, record=[])
    te, tout = _serve_port(tc, tp, layout, prompts, record=mine, feed=ref)
    return {"jax": je, "port": te, "own": own, "prompts": prompts,
            "jout": {r.rid: r for r in jout}, "tout": tout, "oout": oout,
            "flips": count_flips(mine, ref), "scans": len(calls),
            "case": case, "layout": layout}


def test_every_request_completes(engines):
    assert sorted(engines["tout"]) == list(range(len(engines["prompts"])))
    for r in engines["tout"].values():
        assert r.done and not r.failed
        assert len(r.out_tokens) == SERVE["paged"]["max_new_tokens"]


def test_tokens_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].out_tokens == ref.out_tokens, rid


def test_completion_order_equals_reference(engines):
    assert [r.rid for r in engines["jax"].completed] == \
        [r.rid for r in engines["port"].completed]


def test_logits_match_reference(engines):
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid].logits
        assert len(got) == len(ref.logits)
        for a, b in zip(got, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_own_rounding_flips_are_counted(engines):
    """The port on its own bf16 rounding: the flips against the
    reference's are printed with the logits' distance; with no flip, its
    run is the fed run's, bit for bit."""
    assert engines["scans"] > 0
    dist = max(float(np.abs(a - np.asarray(b)).max())
               for rid, ref in engines["jout"].items()
               for a, b in zip(engines["oout"][rid].logits, ref.logits))
    same = all(engines["oout"][rid].out_tokens == ref.out_tokens
               for rid, ref in engines["jout"].items())
    print(f"{engines['case']} {engines['layout']}: {engines['flips']} bf16 "
          f"flips in {engines['scans']} scans; own-rounding logits "
          f"{dist:.3g} from the reference's, tokens equal: {same}")
    if not engines["flips"]:
        for rid, r in engines["tout"].items():
            assert engines["oout"][rid].out_tokens == r.out_tokens
            for a, b in zip(engines["oout"][rid].logits, r.logits):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def test_recurrent_state_turns_prefix_sharing_off(engines):
    """Two prompts share a page-aligned prefix, but no admission shares:
    every cache leaf must be paged for that, and mamba state is per
    slot (the reference's rule)."""
    assert engines["port"].n_shared_admissions == 0
    assert not engines["port"]._can_share
    if engines["layout"] == "paged":
        assert engines["port"]._slot_state_nbytes > 0
        assert not all(engines["port"]._pooled)
