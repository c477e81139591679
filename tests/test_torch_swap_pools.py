"""Swap preemption on the other pools: the port's engine against the JAX
engine on int8 and int4 GQA pools and on the MLA latent pool (the
reference's ``mla`` family config), fp and int8, on the CPU.

Each case runs ``tests/torch_swap_lockstep.py``'s :class:`Lockstep` (every
tick: tokens, logits within ``atol=1e-5``, counters, ``preempts``, TTFT
ticks, page tables, fault records, snapshot metadata and ``nbytes``),
on two plans: the reference's swap cycle of
``tests/test_quant_pool.py::test_int8_logits_invariant_through_swap_cycle``
and a victim preempted mid-prompt.  A quantized snapshot holds packed
bytes and float32 row scales: within the port a swap-in restores both
bit for bit, and across the frameworks the snapshots are compared
through their dequantized rows.  Within the port, as the reference
requires of its own engine, the overcommitted run's logits equal an
ample pool's bit for bit; and the planted fault (pages restored rolled
by one logical page) must break the comparison on every pool.
"""
import numpy as np
import pytest

from repro_torch.serve import Request, ServeConfig, ServingEngine

import torch_swap_lockstep as swap

POOLS = [("dense", "int8"), ("dense", "int4"), ("mla", "fp"),
         ("mla", "int8")]
CFGS = {"dense": swap.DENSE, "mla": swap.MLA}
PROMPTS = [[5, 7, 11, 2, 9, 4], [3, 1, 4, 1, 5, 9], [9, 8, 7, 6, 5, 3]]
# tests/test_quant_pool.py::test_int8_logits_invariant_through_swap_cycle
CYCLE = dict(max_batch=2, max_prompt=8, max_new_tokens=12, page_size=4,
             max_seq=20)
PLANS = {
    "cycle": (dict(CYCLE, num_pages=8, reserve_decode_pages=False),
              swap.plan_of(PROMPTS)),
    "mid_prompt": (swap.MID_PROMPT, swap.MID_PROMPT_PLAN)}


def _ids(p):
    return "-".join(p)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("pool", POOLS, ids=_ids)
def test_swap_matches_reference(pool, plan):
    name, fmt = pool
    serve_kw, requests = PLANS[plan]
    ls = swap.Lockstep(CFGS[name], dict(serve_kw, kv_format=fmt),
                       requests).run()
    assert ls.te.n_preemptions > 0
    assert ls.restores == ls.te.n_swap_ins == ls.te.n_preemptions
    if plan == "mid_prompt":
        assert any(done < len(swap.MID_PROMPT_PLAN[rid][2])
                   for _, rid, done, _ in ls.swap_outs), ls.swap_outs
    assert all(not r.failed and len(r.out_tokens) == serve_kw[
        "max_new_tokens"] for r in ls.treq.values())
    ls.drained()


@pytest.mark.parametrize("pool", POOLS, ids=_ids)
def test_swap_cycle_logits_equal_an_ample_pool(pool):
    """The overcommitted engine's logits equal an ample pool's bit for
    bit: the swap cycle restores packed bytes and scales exactly."""
    name, fmt = pool
    _, _, tc, tp = swap.params(CFGS[name])
    out = {}
    for pages, extra in ((8, dict(reserve_decode_pages=False)), (32, {})):
        eng = ServingEngine(tc, tp, ServeConfig(
            num_pages=pages, kv_format=fmt, record_logits=True, **CYCLE,
            **extra), device="cpu")
        reqs = [Request(i, p) for i, p in enumerate(PROMPTS)]
        eng.run(reqs)
        out[pages] = (reqs, eng.n_preemptions)
    assert out[8][1] > 0 and out[32][1] == 0
    for a, b in zip(out[8][0], out[32][0]):
        assert a.out_tokens == b.out_tokens
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pool", POOLS, ids=_ids)
def test_planted_roll_fault_is_seen(pool):
    name, fmt = pool
    ls = swap.Lockstep(CFGS[name], dict(swap.MID_PROMPT, kv_format=fmt),
                       swap.MID_PROMPT_PLAN, fault=True)
    with pytest.raises(AssertionError, match="out_tokens|rid"):
        ls.run()
    assert ls.te.n_swap_ins > 0
