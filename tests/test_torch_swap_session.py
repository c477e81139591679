"""Swap preemption at the session surface: priorities, the swap budget
and the handle's 'swapped' status, the port's engine against the JAX
engine on the CPU.

The cases are the reference's ``tests/test_session_api.py`` ones: no
priority inversion under swap preemption, a swap budget too small for
any snapshot and a generous one, the grower that every other resident
outranks and that cannot park itself, the swap queue's bytes while a
request is parked, and the budget's validation.  Each runs both engines
in ``tests/torch_swap_lockstep.py``'s :class:`Lockstep` (every tick:
tokens, logits within ``atol=1e-5``, counters, ``preempts``, TTFT
ticks, handle status, swap bytes, fault records, snapshot metadata).
"""
import pytest

from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.serve import ServeConfig

import torch_swap_lockstep as swap

THREE = [[5, 7, 11, 2, 9, 4], [3, 1, 4, 1, 5, 9], [8, 6, 4, 2, 9, 7]]
OVER = dict(max_batch=2, max_prompt=8, max_new_tokens=8, page_size=4,
            num_pages=5, reserve_decode_pages=False)


def test_no_priority_inversion_under_swap_preemption():
    """The high-priority request is never the victim: best-effort
    neighbours are parked, the grower itself included when everyone else
    outranks it."""
    ls = swap.Lockstep(swap.DENSE, dict(OVER, max_batch=3, num_pages=7),
                       swap.plan_of(THREE, priorities=[0, 5, 0])).run()
    assert ls.te.n_preemptions > 0 and ls.te.n_swap_ins > 0
    assert ls.treq[1].preempts == 0, "high-priority request was preempted"
    assert any(ls.treq[i].preempts > 0 for i in (0, 2))
    assert all(not r.failed for r in ls.treq.values())
    ls.drained()


def test_swap_budget_zero_headroom_terminates_with_fault():
    ls = swap.Lockstep(swap.DENSE, dict(OVER, strict_iotlb=False,
                                        swap_budget_bytes=1),
                       swap.plan_of(THREE[:2])).run()
    assert ls.te.n_swap_budget_denials > 0 and ls.te.n_preemptions == 0
    assert any(r.failed for r in ls.treq.values())
    assert any(f[0] == "swap_budget" for f in ls.faults(ls.te))
    ls.drained()


def test_swap_budget_generous_allows_swap_and_drains_to_zero():
    ls = swap.Lockstep(swap.DENSE, dict(OVER, swap_budget_bytes=1 << 30),
                       swap.plan_of(THREE[:2])).run()
    assert ls.te.n_preemptions > 0 and ls.te.n_swap_budget_denials == 0
    assert all(not r.failed for r in ls.treq.values())
    ls.drained()


def test_inversion_guard_holds_when_grower_cannot_park():
    """Every other resident outranks the grower and the grower's own
    snapshot is over budget: the grower dies on the capacity path and
    higher-priority work is still never evicted."""
    ls = swap.Lockstep(swap.DENSE, dict(OVER, strict_iotlb=False,
                                        swap_budget_bytes=1),
                       swap.plan_of(THREE[:2], priorities=[5, 0])).run()
    assert not ls.treq[0].failed and ls.treq[0].preempts == 0
    assert ls.treq[1].failed
    assert ls.te.n_preemptions == 0 and ls.te.n_swap_budget_denials > 0
    assert any(f[0] == "swap_budget" for f in ls.faults(ls.te))
    ls.drained()


def test_swapped_request_reports_swap_bytes():
    """While a request is parked its handle reads 'swapped' and the swap
    queue holds its bytes, as in the JAX engine tick for tick."""
    ls = swap.Lockstep(swap.DENSE, OVER, swap.plan_of(
        [[5 + i, 7, 11, 2, 9, 4] for i in range(2)]))
    seen = []
    while ls.busy():
        ls.tick()
        parked = [rid for rid, h in ls.handles.items()
                  if h.status == "swapped"]
        if parked:
            seen.append(ls.te.sched.swap_bytes())
            assert [sw.req.rid for sw in ls.te.sched.swapped] == parked
    assert seen and min(seen) > 0
    ls.drained()


@pytest.mark.parametrize("kwargs, field", [
    (dict(swap_budget_bytes=0), "swap_budget_bytes"),
    (dict(swap_budget_bytes=-4096), "swap_budget_bytes"),
    (dict(preemption="evict"), "preemption"),
])
def test_serve_config_rejects_bad_swap_fields(kwargs, field):
    for cls in (JaxServeConfig, ServeConfig):
        with pytest.raises(ValueError, match=rf"ServeConfig\.{field} "):
            cls(**kwargs)


def test_overcommit_fields_construct():
    sc = ServeConfig(reserve_decode_pages=False, preemption="terminate",
                     swap_budget_bytes=1 << 20)
    assert (sc.reserve_decode_pages, sc.preemption,
            sc.swap_budget_bytes) == (False, "terminate", 1 << 20)
