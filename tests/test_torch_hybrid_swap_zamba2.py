"""Swap preemption under overcommit on reduced zamba2-7b (a group stage of 2
x (2 ``mamba`` + ``shared_attn``), then 2 ``mamba``): the port's engine
against the JAX engine in lockstep, on the CPU, as
``tests/test_torch_hybrid_swap.py`` holds the ``hybrid`` family config
(``torch_hybrid_cases.swap_case``): tokens, logits within 1e-5, counters,
page tables and every parked snapshot, pages and recurrent state rows,
restored bit for bit; no prefix shared.
"""
import pytest

from torch_hybrid_cases import SWAP_PLANS, swap_case


@pytest.mark.parametrize("plan", sorted(SWAP_PLANS))
def test_swap_matches_reference(plan):
    swap_case("zamba2", plan)
