"""Phase 17's replay check of ``chip_smoke.py``, run on the CPU.

As in phase 16 (``tests/test_torch_moe_replay.py``), ``chip_smoke.py``
holds the MoE engine's logits against a replay of the engine's own
dispatches through an engine whose attention runs the kernels' plain
versions on the engine's own routing.  For deepseek-v2-lite-16b the replay must also patch the names
``models/mla.py`` imports (the flash forward of a fresh chunk and the MLA
decode partials); here the script is loaded by path (no card needed) and
its pieces run against the port's CPU engine on reduced
deepseek-v2-lite-16b in bf16, at capacity factor 0.5 so that chunks
drop.  On the CPU the engine itself runs the plain versions, so the
plain replay, forced or on its own routing, must give its logits and
routing bit for bit; both planted faults (the gates not renormalised,
the shared experts' output left out) must land outside the bounds of
``moe_logit_check``; and a replay whose patched names reach
a kernel wrapper fails.  Also: the script's float32 unit case has
deepseek's expert count, top k and shared experts.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import attention, mla, moe
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
    return [base + [5, 6]] + other[:4] + [base + [9], other[4]]


@pytest.fixture(scope="module")
def served():
    cfg = reduce_config(get_config(smoke.MLA_MOE_ARCH)).with_(
        capacity_factor=0.5)
    params = init_params(cfg, torch.Generator().manual_seed(17),
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
    for how in smoke.MOE_FAULTS:
        runs[how] = smoke.replay(torch, cfg, params, sc, log[:12], how,
                                 forced=routes)
    kern = [x[2][2][smoke.live_rows(x[0], x[2][1])] for x in log
            if x[0] != "copies"]
    return {"cfg": cfg, "params": params, "sc": sc, "eng": eng, "log": log,
            "routes": routes, "runs": runs, "kern": kern, "reqs": reqs}


def test_every_dispatch_kind_and_a_shared_prefix_ran(served):
    kinds = [x[0] for x in served["log"]]
    assert {"fresh", "resumed", "decode"} <= set(kinds)
    assert served["eng"].n_shared_admissions >= 1
    assert smoke.moe_layers(served["cfg"]) == 2


def test_live_rows_hold_every_token_the_engine_emitted(served):
    """A dispatch keeps its live slots' logits: every request's recorded
    logits (its last prompt token's, then each decode step's) are among
    them."""
    got = torch.cat(served["kern"])
    for r in served["reqs"]:
        for lg in r.logits:
            row = torch.from_numpy(np.asarray(lg)).float()
            assert bool((got == row).all(-1).any())


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
    assert by_kind["fresh"]["dropped"] + by_kind["resumed"]["dropped"] > 0
    assert by_kind["decode"]["dropped"] == 0


def test_logit_check_holds_the_engine_and_sees_both_faults(served):
    runs = served["runs"]
    assert 0 < len(runs["fault"][0]) < len(runs["plain"][0])
    rec = smoke.moe_logit_check(torch, "cpu", served["kern"],
                                runs["plain"][0], runs["widened"][0],
                                {n: runs[n][0] for n in smoke.MOE_FAULTS})
    assert rec["max_rel_err"] == 0.0
    for name in smoke.MOE_FAULTS:
        assert max(rec[f"{name}_over_bound"].values()) >= \
            smoke.MOE_FAULT_MARGIN, name


@pytest.mark.parametrize("how", ["plain", "widened"] + list(smoke.MOE_FAULTS))
def test_replay_patches_both_attention_modules(how):
    names = {(m.__name__, n) for m, n, _ in smoke.replay_attention(torch,
                                                                   how)}
    assert {(attention.__name__, "flash_attention"),
            (attention.__name__, "paged_flash_decode_partials"),
            (mla.__name__, "flash_attention"),
            (mla.__name__, "mla_paged_decode_partials")} <= names
    if how == "no_shared":
        assert (moe.__name__, "_shared_experts") in names


def test_a_replay_that_reaches_a_kernel_fails(served, monkeypatch):
    """If a patched name still reached a kernel wrapper (its launch count
    moves), the replay must fail rather than compare kernels with
    themselves."""
    good = pfd.mla_paged_decode_partials_plain
    monkeypatch.setattr(pfd, "mla_launches", pfd.mla_launches)

    def counted(*a, **k):
        pfd.mla_launches += 1
        return good(*a, **k)
    monkeypatch.setattr(pfd, "mla_paged_decode_partials_plain", counted)
    with pytest.raises(SystemExit):
        smoke.replay(torch, served["cfg"], served["params"], served["sc"],
                     served["log"][:12], "plain")


@pytest.mark.parametrize("ties", ["columns", "row"])
def test_unit_case_has_deepseeks_experts(ties):
    p, x, cfg = smoke.moe_unit_case(torch, smoke.MLA_MOE_UNIT, ties, 1.25,
                                    "cpu")
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (64, 6, 2)
    assert tuple(p["shared"]["w_up"].shape) == (cfg.d_model,
                                                2 * cfg.d_ff_expert)
    y, aux = moe.moe_ffn(p, x, cfg)
    assert torch.isfinite(y).all() and float(aux) > 0
    r = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    if ties == "row":
        assert r.experts[2].tolist() == list(range(6))
