"""The port's serving engine on MLA models against the JAX engine, on the
CPU.

One engine of each package serves the same requests on the same bridged
float32 weights with ``record_logits=True``, for two configs: the ``mla``
family config of the reference's serving tests, and deepseek-v2-lite
reduced by ``reduce_config`` with its dense MLA block in every layer.
The traffic has prompts longer than the prefill chunk (the resumed path,
which expands the latent window through W_UK / W_UV), two prompts sharing
a whole-page prefix that is not page-aligned (prefix sharing plus a
copy-on-write page of the latent pool), and more requests than slots.
Tokens, completion order, counters and TTFT ticks must be equal and the
per-token logits within ``atol=1e-5``: port output against reference
output directly.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import paged_flash_decode
from repro_torch.launch import serve as launcher
from repro_torch.models.config import ArchConfig
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy

MLA = dict(name="srv_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))
SERVE = dict(max_batch=3, max_prompt=8, max_new_tokens=6, page_size=4,
             max_seq=40, record_logits=True)
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]


def _configs(name):
    if name == "mla":
        return (JaxCfg(**MLA, dtype=jnp.float32),
                ArchConfig(**MLA, dtype=torch.float32))
    jc = jax_reduce(jax_get_config("deepseek-v2-lite-16b").with_(
        family="dense", pattern=(("scan", "mla_mlp", 27),)))
    tc = reduce_config(get_config("deepseek-v2-lite-dense"))
    return jc.with_(dtype=jnp.float32), tc.with_(dtype=torch.float32)


def _prompts():
    rng = np.random.RandomState(7)
    base = [int(t) for t in rng.randint(0, 100, 18)]
    other = [[int(t) for t in rng.randint(0, 100, n)]
             for n in (5, 3, 11, 19, 2, 14)]
    # the sharer (base + [9]) arrives once a short request has freed a
    # slot, while base + [7, 8] is resident and prefilled
    return [base + [7, 8], other[4], other[1], base + [9], other[0],
            other[2], other[3], other[5]]


@pytest.fixture(scope="module", params=["mla", "deepseek-v2-lite-dense"])
def engines(request):
    jc, tc = _configs(request.param)
    jp = jax_init_params(jc, jax.random.PRNGKey(0))
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    launches = paged_flash_decode.mla_launches
    te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    handles = [te.submit(Request(i, p)) for i, p in enumerate(prompts)]
    tdone = te.drain()
    return {"jax": je, "port": te, "prompts": prompts, "handles": handles,
            "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tdone},
            "mla_launches": paged_flash_decode.mla_launches - launches}


def test_every_request_completes(engines):
    assert sorted(engines["tout"]) == list(range(len(engines["prompts"])))
    for h in engines["handles"]:
        assert h.status == "done"
        assert len(h.tokens_so_far) == SERVE["max_new_tokens"]


def test_tokens_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].out_tokens == ref.out_tokens, rid


def test_completion_order_equals_reference(engines):
    assert [r.rid for r in engines["jax"].completed] == \
        [r.rid for r in engines["port"].completed]


def test_logits_match_reference(engines):
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid].logits
        assert len(got) == len(ref.logits) == SERVE["max_new_tokens"]
        for a, b in zip(got, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def test_resumed_sharing_and_cow_paths_exercised(engines):
    eng = engines["port"]
    assert max(len(p) for p in engines["prompts"]) > SERVE["max_prompt"]
    assert eng.n_shared_admissions >= 1 and eng.n_cow_copies >= 1
    assert eng.pages_in_use() == 0              # every page came back
    assert list(eng.cache[0]) == ["ckv"]        # the latent pool only
    # CPU: the plain versions ran, no kernel was launched
    assert eng.stats()["kernel_launches"] == 0
    assert engines["mla_launches"] == 0


def test_launcher_twin_serves_the_dense_mla_variant_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "deepseek-v2-lite-dense", "--reduce",
                       "--device", "cpu", "--requests", "3",
                       "--max-batch", "2", "--max-new-tokens", "4"])
    lines = out.getvalue().splitlines()
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3
