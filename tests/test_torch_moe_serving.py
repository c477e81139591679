"""The port's serving engine on ``attn_moe`` blocks against the JAX engine,
on the CPU.

One engine of each package serves the same requests on the same bridged
float32 weights of the ``moe`` family config (capacity factor 8.0) and of
a copy at capacity factor 0.5, on the paged pool (prompts longer than the
chunk, a shared prefix, more requests than slots) and on the contiguous
cache (``paged=False``).  A dispatch's capacity comes from its shape,
(max_batch, max_prompt) for a chunk and (max_batch, 1) for decode, padding
and inactive slots included, so the port must dispatch the reference's
shapes: tokens, completion order, the counters and TTFT ticks must be
equal, and every per-token logit within ``atol=1e-5``.  At factor 0.5 the
chunk dispatches drop assignments (counted in the port's routing), which
the logits then carry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.models import moe
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy
from torch_moe_cases import configs, numpy_tree

SERVE = {
    "paged": dict(max_batch=4, max_prompt=8, max_new_tokens=6, page_size=4,
                  max_seq=40, record_logits=True),
    "contiguous": dict(paged=False, max_batch=4, max_prompt=12,
                       max_new_tokens=6, page_size=4, record_logits=True),
}
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]
CASES = [f"{f}-{layout}" for f in ("8.0", "0.5") for layout in SERVE]


def _prompts(layout):
    rng = np.random.RandomState(3)
    if layout == "contiguous":
        return [[int(t) for t in rng.randint(0, 100, n)]
                for n in (12, 3, 9, 1, 7, 12)]
    base = [int(t) for t in rng.randint(0, 100, 18)]
    other = [[int(t) for t in rng.randint(0, 100, n)]
             for n in (5, 3, 11, 19, 2)]
    return [base + [7, 8], other[4], other[1], base + [9], other[0],
            other[2], other[3]]


@pytest.fixture(scope="module", params=CASES)
def engines(request):
    factor, layout = request.param.split("-")
    jc, tc = configs("moe", float(factor))
    tree = numpy_tree(jc)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_numpy(tc, tree, device="cpu")
    prompts = _prompts(layout)
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE[layout]))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    drops = {"chunk": 0, "decode": 0}
    good = moe.route

    def counted(p, xf, cfg, token_mask=None):
        r = good(p, xf, cfg, token_mask)
        kind = "decode" if token_mask is None else "chunk"
        drops[kind] += int((~r.keep & (r.experts.reshape(-1)
                                       < cfg.n_experts)).sum())
        return r
    te = ServingEngine(tc, tp, ServeConfig(**SERVE[layout]), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", counted)
        tdone = te.run([Request(i, p) for i, p in enumerate(prompts)])
    return {"jax": je, "port": te, "prompts": prompts, "factor": factor,
            "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tdone}, "drops": drops}


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


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def test_drops_follow_the_capacity_factor(engines):
    """At factor 8.0 no assignment is dropped; at 0.5 the chunks drop
    (4 slots x 8 or 12 rows x top 2 over 4 experts of 8 slots each),
    and decode (4 tokens x 2 into 4 x 8 slots) cannot."""
    d = engines["drops"]
    if engines["factor"] == "8.0":
        assert d == {"chunk": 0, "decode": 0}
    else:
        assert d["chunk"] > 0 and d["decode"] == 0
