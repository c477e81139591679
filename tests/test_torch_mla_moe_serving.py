"""The port's serving engine on reduced deepseek-v2-lite-16b against the JAX
engine, on the CPU.

One engine of each package serves the same requests on the same bridged
float32 weights of reduced deepseek-v2-lite-16b (``mla_mlp`` x 1 +
``mla_moe`` x 2, 8 experts top-2, 2 shared experts; capacity factor 4.0,
and 0.5 on the fp pool, where chunks drop assignments): on the paged
latent pool in fp and int8 (prompts longer than the chunk, a shared
prefix, more requests than slots) and on the contiguous cache
(``paged=False``).  Tokens, completion order, the counters and TTFT ticks
must be equal, and every per-token logit within ``atol=1e-5``.  The
engine's pool is two stages, one a scan: its flattened leaves (stages in
order, keys sorted) are stage 0's then stage 1's, with each stage's
layers, the order a swap snapshot keeps.  Under overcommit both engines
are stepped tick by tick through a swap cycle and a victim preempted
mid-prompt on the fp latent pool
(``tests/torch_swap_lockstep.py``'s ``Lockstep``: tokens, logits,
counters, page tables and every parked snapshot after each tick, and
each restore bit for bit), and a restore rolled by one page must break
the comparison on a victim preempted mid-prompt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.models import moe
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy
from torch_mla_moe_cases import config_fields, configs, numpy_tree

import torch_swap_lockstep as swap

SERVE = {
    "paged": dict(max_batch=4, max_prompt=8, max_new_tokens=5, page_size=4,
                  max_seq=40, record_logits=True),
    "contiguous": dict(paged=False, max_batch=4, max_prompt=12,
                       max_new_tokens=5, page_size=4, record_logits=True),
}
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]
# (capacity case, layout, kv_format)
CASES = [("deepseek", "paged", "fp"), ("deepseek", "paged", "int8"),
         ("deepseek", "contiguous", "fp"), ("deepseek-0.5", "paged", "fp")]


def _ids(c):
    return "-".join(c)


def _prompts(layout):
    rng = np.random.RandomState(3)
    if layout == "contiguous":
        return [[int(t) for t in rng.randint(0, 500, n)]
                for n in (12, 3, 9, 1, 7)]
    base = [int(t) for t in rng.randint(0, 500, 18)]
    other = [[int(t) for t in rng.randint(0, 500, n)]
             for n in (5, 3, 11, 2)]
    return [base + [7, 8], other[3], other[1], base + [9], other[0],
            other[2]]


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def engines(request):
    case, layout, fmt = request.param
    jc, tc = configs(case)
    tree = numpy_tree(jc)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_numpy(tc, tree, device="cpu")
    prompts = _prompts(layout)
    kw = dict(SERVE[layout], kv_format=fmt)
    je = JaxEngine(jc, jp, JaxServeConfig(**kw))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    drops = {"chunk": 0, "decode": 0}
    good = moe.route

    def counted(p, xf, cfg, token_mask=None):
        r = good(p, xf, cfg, token_mask)
        kind = "decode" if token_mask is None else "chunk"
        drops[kind] += int((~r.keep & (r.experts.reshape(-1)
                                       < cfg.n_experts)).sum())
        return r
    te = ServingEngine(tc, tp, ServeConfig(**kw), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", counted)
        tdone = te.run([Request(i, p) for i, p in enumerate(prompts)])
    return {"jax": je, "port": te, "prompts": prompts, "case": case,
            "layout": layout, "jout": {r.rid: r for r in jout},
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


def test_pool_leaves_are_the_two_stages_in_order(engines):
    """The engine's flattened pool: stage 0's leaves (one layer), then
    stage 1's (two), keys sorted, each of the reference's shape."""
    te, je = engines["port"], engines["jax"]
    got = [tuple(t.shape) for t in te._pool_leaves()]
    want = [tuple(a.shape) for a in jax.tree.leaves(je.cache)]
    assert got == want
    assert [s[0] for s in got[:len(got) // 2]] == [1] * (len(got) // 2)
    assert [s[0] for s in got[len(got) // 2:]] == [2] * (len(got) // 2)


def test_drops_follow_the_capacity_factor(engines):
    """At factor 4.0 no assignment is dropped; at 0.5 the chunks drop
    (4 slots x 8 rows x top 2 over 8 experts of 8 slots each), and
    decode (4 tokens x 2 into 8 x 8 slots) cannot."""
    d = engines["drops"]
    if engines["case"] == "deepseek":
        assert d == {"chunk": 0, "decode": 0}
    else:
        assert d["chunk"] > 0 and d["decode"] == 0


# tests/test_quant_pool.py::test_int8_logits_invariant_through_swap_cycle's
# plan: three 6-token prompts, two slots, a pool of 8 pages of 4 rows
SWAP_PROMPTS = [[5, 7, 11, 2, 9, 4], [3, 1, 4, 1, 5, 9], [9, 8, 7, 6, 5, 3]]
SWAP_SERVE = dict(max_batch=2, max_prompt=8, max_new_tokens=12, page_size=4,
                  max_seq=20, num_pages=8, reserve_decode_pages=False)


SWAP_PLANS = {"cycle": (SWAP_SERVE, swap.plan_of(SWAP_PROMPTS)),
              "mid_prompt": (swap.MID_PROMPT, swap.MID_PROMPT_PLAN)}


@pytest.mark.parametrize("plan", sorted(SWAP_PLANS))
def test_swap_matches_reference(plan):
    serve_kw, requests = SWAP_PLANS[plan]
    ls = swap.Lockstep(config_fields("deepseek"), serve_kw, requests).run()
    assert ls.te.n_preemptions > 0
    assert ls.restores == ls.te.n_swap_ins == ls.te.n_preemptions
    # a snapshot holds both stages' latent rows, stage 0's first
    assert [tuple(t.shape[:1]) for t in ls.te._pool_leaves()] == [(1,), (2,)]
    assert all(not r.failed and len(r.out_tokens) == serve_kw[
        "max_new_tokens"] for r in ls.treq.values())
    ls.drained()


def test_planted_roll_fault_is_seen():
    ls = swap.Lockstep(config_fields("deepseek"), swap.MID_PROMPT,
                       swap.MID_PROMPT_PLAN, fault=True)
    with pytest.raises(AssertionError):
        ls.run()
