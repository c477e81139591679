"""Phase 16's replay check of ``chip_smoke.py``, run on the CPU.

A MoE dispatch's expert capacity comes from its shape, so ``chip_smoke.py``
holds the MoE engine's logits against a replay of the engine's own
dispatches (``record_dispatches(..., keep_args=True)`` and ``replay``)
through a second engine whose attention runs the kernels' plain versions
on the engine's own routing (``route_forcer``), rather than against a
teacher-forced forward.  Here the script is loaded
by path (no card needed) and its pieces run against the port's CPU engine
on reduced granite-moe-1b-a400m in bf16, at capacity factor 0.5 so that
chunks drop: on the CPU the engine itself runs the plain versions, so the
plain replay, forced or on its own routing, must give its logits and
routing bit for bit (a replay that loses a page copy, or keeps a page
table the engine later changes, does not); a forced replay that routes
otherwise than the engine fails; the planted fault (gates not
renormalised) must land outside the bounds of ``moe_logit_check``.  Also: the script's float32 unit case is
the CPU tests' (``tests/torch_moe_cases.py``) input for input.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_moe_cases as unit
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.model import init_params
from repro_torch.serve import Request, ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SERVE = dict(max_batch=4, max_prompt=16, page_size=16, max_seq=96,
             max_new_tokens=5, record_logits=True)


def _prompts():
    rng = np.random.RandomState(4)
    base = [int(t) for t in rng.randint(0, 512, 32)]
    other = [[int(t) for t in rng.randint(0, 512, n)]
             for n in (40, 7, 23, 16, 3)]
    # the sharer arrives once a short request has freed a slot, while
    # base + [5, 6] is resident and prefilled
    return [base + [5, 6]] + other[:4] + [base + [9], other[4]]


@pytest.fixture(scope="module")
def served():
    cfg = reduce_config(get_config(smoke.MOE_ARCH)).with_(
        capacity_factor=0.5)
    params = init_params(cfg, torch.Generator().manual_seed(16),
                         device="cpu")
    sc = ServeConfig(**SERVE)
    eng = ServingEngine(cfg, params, sc, device="cpu")
    log = smoke.record_dispatches(eng, {}, keep_args=True)
    routes = []
    reqs = [Request(i, p) for i, p in enumerate(_prompts())]
    smoke.patched(smoke.route_recorder(routes), lambda: eng.run(reqs))
    log = list(log)
    runs = {how: smoke.replay(torch, cfg, params, sc, log, how,
                              forced=routes)
            for how in ("plain", "widened")}
    runs["free"] = smoke.replay(torch, cfg, params, sc, log, "plain")
    runs["fault"] = smoke.replay(torch, cfg, params, sc, log[:12], "fault",
                                 forced=routes)
    kern = [x[2][2][smoke.live_rows(x[0], x[2][1])] for x in log
            if x[0] != "copies"]
    return {"cfg": cfg, "params": params, "sc": sc, "eng": eng, "log": log,
            "routes": routes, "runs": runs, "kern": kern}


def test_every_dispatch_kind_and_a_shared_prefix_ran(served):
    kinds = [x[0] for x in served["log"]]
    assert {"fresh", "resumed", "decode"} <= set(kinds)
    assert served["eng"].n_shared_admissions >= 1


@pytest.mark.parametrize("run", ["plain", "free"])
def test_plain_replay_gives_the_engines_logits_bit_for_bit(served, run):
    plain, _ = served["runs"][run]
    assert len(plain) == len(served["kern"])
    for got, want in zip(plain, served["kern"]):
        assert torch.equal(got, want)


def test_plain_replay_routes_alike_and_chunks_drop(served):
    _, routes = served["runs"]["free"]
    by_kind, agreement, set_agreement = smoke.moe_routing_stats(
        served["cfg"], served["log"], served["routes"], routes)
    assert agreement == set_agreement == 1.0
    for rec in by_kind.values():
        assert set(rec) == {"dispatches", "assignments", "dropped",
                            "live_assignments", "live_dropped", "agreement",
                            "set_agreement"}
    assert by_kind["fresh"]["dropped"] + by_kind["resumed"]["dropped"] > 0


def test_logit_check_holds_the_engine_and_sees_the_fault(served):
    """The fault replays a prefix of the log (as the card's does), held
    against the same dispatches of the plain replay."""
    runs = served["runs"]
    assert 0 < len(runs["fault"][0]) < len(runs["plain"][0])
    rec = smoke.moe_logit_check(torch, "cpu", served["kern"],
                                runs["plain"][0], runs["widened"][0],
                                {"fault": runs["fault"][0]})
    assert rec["max_rel_err"] == 0.0
    assert max(rec["fault_over_bound"].values()) >= smoke.MOE_FAULT_MARGIN


def test_a_forced_replay_that_routes_otherwise_fails(served):
    """A forced replay whose ``keep`` is not the recorded one (as where
    its dispatch's capacity differed from the engine's: here the record's
    bits are flipped) must fail rather than hold the logits on other
    routing."""
    forced = list(served["routes"])
    e, k = forced[0]
    forced[0] = (e, ~k)
    with pytest.raises(SystemExit):
        smoke.replay(torch, served["cfg"], served["params"], served["sc"],
                     served["log"][:3], "plain", forced=forced)


@pytest.mark.parametrize("ties", unit.TIES)
def test_unit_case_is_the_cpu_tests_input(ties):
    p, x, cfg = smoke.moe_unit_case(torch, smoke.MOE_UNIT, ties, 0.5, "cpu")
    want_p, want_x = unit.unit_inputs(ties)
    assert sorted(p) == sorted(want_p)
    for k, v in want_p.items():
        assert np.array_equal(p[k].numpy(), v)
    assert np.array_equal(x.numpy(), want_x)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff_expert, cfg.d_model) == \
        (unit.E, unit.K, unit.F, unit.D)
    assert cfg.capacity_factor == 0.5 and 0.5 in unit.FACTORS
    assert smoke.MOE_UNIT["factors"] == (0.5,)
    assert smoke.MOE_UNIT["masks"] == unit.MASKS
