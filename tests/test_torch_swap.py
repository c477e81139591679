"""Swap preemption under overcommit: the port's engine against the JAX
engine, on the CPU, on a float32 GQA pool.

Both engines serve the same submission plan on the same bridged weights
with ``reserve_decode_pages=False`` and are stepped tick by tick
(:class:`Lockstep`), which compares them after every tick; within the
port, the pages a swap-in restores equal the snapshot bit for bit, and
every page is free at the end.  The cases are the reference's overcommit
tests (``tests/test_continuous_batching.py``: swap round trip, terminate
mode, swap queue first; ``tests/test_paged_cache.py``: the page-boundary
capacity fault), plus a victim that holds a prefix-shared page, a victim
preempted mid-prompt, and a planted fault (pages restored rolled by one
logical page) that the comparison must see.

:class:`Lockstep` lives in ``tests/torch_swap_lockstep.py``.
"""
import pytest

from repro.core.iotlb import IotlbFault as JaxIotlbFault
from repro_torch.core.iotlb import IotlbFault

from torch_swap_lockstep import (DENSE, MID_PROMPT, MID_PROMPT_PLAN, Lockstep,
                                 plan_of)

BASE = dict(max_batch=2, max_prompt=8, max_new_tokens=8, page_size=4)
TWO = [[5, 7, 11, 2, 9, 4], [3, 1, 4, 1, 5, 9]]
SHARED = [5, 7, 11, 2, 9, 4, 8, 1]
# the sharer arrives once the first request has materialized its prompt
SHARED_PLAN = [(0, 0, SHARED + [6], 0), (1, 1, SHARED + [3, 2], 0),
               (2, 2, [9, 8, 7], 0)]


def test_swap_round_trip():
    """Overcommit exhaustion mid-decode swaps the youngest request out
    and back in: the reference's decisions and logits, no fault."""
    ls = Lockstep(DENSE, dict(BASE, num_pages=5, reserve_decode_pages=False),
                  plan_of(TWO)).run()
    assert ls.te.n_preemptions > 0 and ls.te.n_swap_ins > 0
    assert any(r.preempts > 0 for r in ls.treq.values())
    assert not ls.te.iotlb.faults
    assert ls.restores == ls.te.n_swap_ins
    assert all(not r.failed and len(r.out_tokens) == 8
               for r in ls.treq.values())
    ls.drained()


def test_terminate_mode_kills_the_grower():
    """preemption='terminate': the grower ends with a capacity fault and
    its partial output, as the reference's."""
    ls = Lockstep(DENSE, dict(BASE, num_pages=5, reserve_decode_pages=False,
                              strict_iotlb=False, preemption="terminate"),
                  plan_of(TWO)).run()
    assert ls.te.n_preemptions == 0
    assert any(r.failed for r in ls.treq.values())
    assert any(f[0] == "capacity" for f in ls.faults(ls.te))
    ls.drained()


def test_swap_queue_drains_before_fresh_admissions():
    ls = Lockstep(DENSE, dict(BASE, num_pages=5, reserve_decode_pages=False),
                  plan_of([[5 + i, 7, 11, 2, 9, 4] for i in range(4)]))
    deferred = 0
    while ls.busy():
        ls.tick()
        if ls.te.sched.swapped and ls.te.sched.has_pending():
            deferred += 1
    assert ls.te.n_preemptions > 0 and deferred > 0
    assert all(not r.failed and len(r.out_tokens) == 8
               for r in ls.treq.values())
    ls.drained()


def test_page_boundary_capacity_fault():
    """One page, no victim: growth at row 4 is a capacity fault at that
    row (non-strict: partial output; strict: both raise); with the
    reservation the request is rejected up front."""
    sc = dict(max_batch=1, max_prompt=8, max_new_tokens=8, page_size=4,
              num_pages=1, reserve_decode_pages=False)
    plan = [(0, 0, [5, 7, 3], 0)]
    ls = Lockstep(DENSE, dict(sc, strict_iotlb=False), plan).run()
    assert ls.treq[0].failed and 0 < len(ls.treq[0].out_tokens) < 8
    assert ls.faults(ls.te)[-1][0] == "capacity"
    ls.drained()

    ls = Lockstep(DENSE, dict(sc, strict_iotlb=True), plan)
    ls._submit()
    with pytest.raises(JaxIotlbFault, match="exhausted"):
        while ls.je.sched.has_work():
            ls.je.tick()
    with pytest.raises(IotlbFault, match="exhausted"):
        while ls.te.sched.has_work():
            ls.te.tick()
    assert ls.faults(ls.te) == ls.faults(ls.je)
    assert ls.te.tick_no == ls.je.tick_no
    assert ls.treq[0].out_tokens == ls.jreq[0].out_tokens

    ls = Lockstep(DENSE, dict(sc, strict_iotlb=False,
                              reserve_decode_pages=True), plan).run()
    assert ls.treq[0].failed and ls.treq[0].out_tokens == []
    assert ls.faults(ls.te)[-1][0] == "capacity"


def test_swapped_request_holding_a_shared_prefix_page():
    """A victim whose pages a resident still references: swap-out copies
    their bytes and drops its references, swap-in takes private pages,
    and the sharer's logits stay the reference's."""
    ls = Lockstep(DENSE, dict(BASE, max_seq=24, num_pages=5,
                              reserve_decode_pages=False),
                  SHARED_PLAN).run()
    assert ls.te.n_shared_admissions == 1
    assert any(shared for *_, shared in ls.swap_outs), ls.swap_outs
    assert ls.restores == ls.te.n_swap_ins > 0
    ls.drained()


def test_victim_preempted_mid_prompt_resumes_its_prompt():
    """The youngest resident is still filling its prompt when the pool
    runs dry: it parks with ``prefill_done`` short of its prompt and its
    next chunk goes out as a resumed wave after swap-in."""
    ls = Lockstep(DENSE, MID_PROMPT, MID_PROMPT_PLAN)
    resumed = []
    orig = ls.te._prefill

    def spy(params_, cache, toks, lens, pages, offs):
        resumed.append(offs is not None)
        return orig(params_, cache, toks, lens, pages, offs)
    ls.te._prefill = spy
    ls.run()
    mid = [(t, rid, done) for t, rid, done, _ in ls.swap_outs
           if done < len(MID_PROMPT_PLAN[rid][2])]
    assert mid, ls.swap_outs
    assert ls.restores == ls.te.n_swap_ins > 0 and any(resumed)
    assert all(not r.failed and len(r.out_tokens) == 8
               for r in ls.treq.values())
    ls.drained()


def test_planted_roll_fault_is_seen():
    """A port engine whose swap-in restores the pages rolled by one
    logical page: the lockstep comparison must fail on it."""
    ls = Lockstep(DENSE, MID_PROMPT, MID_PROMPT_PLAN, fault=True)
    with pytest.raises(AssertionError, match="out_tokens|rid"):
        ls.run()
    assert ls.te.n_swap_ins > 0
