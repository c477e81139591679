"""Swap preemption under overcommit on the hybrid family: the port's engine
against the JAX engine, on the CPU.

Both engines serve the same submission plans on the same bridged float32
weights of the reference's ``hybrid`` family config (a group of 2 x
(``mamba`` + ``shared_attn``); reduced zamba2-7b in
``tests/test_torch_hybrid_swap_zamba2.py``), with
``reserve_decode_pages=False``, stepped tick by tick by :class:`Lockstep`
(``tests/torch_swap_lockstep.py``), which compares them after every tick:
tokens, logits within 1e-5, counters, page tables, faults, and every
parked snapshot, its pages (the shared block's KV pools, one a repeat)
and its recurrent state rows (``slot_rows``: each mamba block's conv and
SSM state) alike.  A swap-in restores both bit for bit into the new
slot.  The JAX engine ticks eagerly and the port is fed its scans' bf16
rounding (``tests/torch_hybrid_cases.py``); the flips are printed.
Prefix sharing stays off (``n_shared_admissions`` 0, as in the
reference): two prompts share a page-aligned prefix.  A planted fault
(pages restored rolled by one page) and a second one (state rows
restored rolled over the layers) must each be seen.
"""
import pytest

from torch_hybrid_cases import SWAP_PLANS, config_fields, swap_case
from torch_swap_lockstep import MID_PROMPT, MID_PROMPT_PLAN, Lockstep


@pytest.mark.parametrize("plan", sorted(SWAP_PLANS))
def test_swap_matches_reference(plan):
    swap_case("hybrid", plan)


def test_planted_roll_fault_is_seen():
    ls = Lockstep(config_fields("hybrid"), MID_PROMPT, MID_PROMPT_PLAN,
                  fault=True, scans=True)
    with pytest.raises(AssertionError):
        ls.run()


def test_planted_state_fault_is_seen():
    """A swap-in that restores each state leaf's rows rolled over the
    layers (the right bytes in the wrong layer) must be seen."""
    ls = Lockstep(config_fields("hybrid"), MID_PROMPT, MID_PROMPT_PLAN,
                  scans=True)
    te, good = ls.te, ls.te._swap_in

    def faulty(slot, sw):
        sw.slot_rows = [t.roll(1, dims=0) for t in sw.slot_rows]
        good(slot, sw)
    te._swap_in = faulty
    with pytest.raises(AssertionError):
        ls.run()
