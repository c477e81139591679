"""The integer formats' logit check of ``chip_smoke.py``, run on the CPU.

``chip_smoke.py`` holds the w8a8 engine's teacher-forced logits to two
statistics of their row errors against a plain forward (``int_stats``:
the largest over rows and the mean square over positions), each within
``SERVE_INT_NOISE_FACTOR`` times the same statistic of a kernel-free
noise floor, and requires every planted fault of ``INT_FAULTS`` to land
``INT_FAULT_MARGIN`` outside one of the two bounds on the errors' scale
(by the max, or by the RMS against the mean-square bound's root).  Here the same
``int_logit_check`` runs on the CPU, loaded from the script by path
(which needs no card), against the port's ``ServingEngine`` serving a
2-layer bf16 w8a8 model of narrow widths.  On the CPU that engine runs
the kernels' plain versions in other GEMM shapes than the plain forward,
so its logits differ from it by rounding, as the card's engine does.

Every norm gain carries one outlier channel, as the gains of trained
language models do: rows' activation maxima then spread as they do in
such a model, which is what a per-tensor activation scale turns into
error.  With the gains of a random init the rows' maxima are alike, and
the fault would barely differ from per-row scaling.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch.serve import parse_quant
from repro_torch.models.model import init_params, quantize_for_serving
from repro_torch.serve import Request, ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# prompts of one to four chunks.  A request of one chunk (at most 16 + 32
# positions here) decodes within one 64-key split of the paged partials,
# where their plain version rounds as the plain forward's attention, so
# its logits may equal the plain forward's exactly (ONE_SPLIT: held to
# the bounds and the faults alone); 33 positions of prompt take the
# decode past the first split
PROMPT_LENS = (40, 23, 60, 9, 33)
ONE_SPLIT = {3}
OUTLIER_GAIN = 10.0


@pytest.fixture(scope="module")
def served():
    """The engine's requests, the packed model and its config."""
    cfg = get_config("qwen2.5-3b").with_(
        n_layers=2, pattern=(("scan", "attn_mlp", 2),), d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with torch.no_grad():
        for blk in params.blocks:
            blk.ln1["w"][0] = OUTLIER_GAIN
            blk.ln2["w"][0] = OUTLIER_GAIN
    cfg = cfg.with_(quant=parse_quant("w8a8"))
    params, _ = quantize_for_serving(cfg, params)
    # 32 new tokens, as the card's phase 6: 32 teacher-forced rows a
    # request; prompts of one to four chunks (PROMPT_LENS)
    sc = ServeConfig(max_batch=4, max_prompt=16, page_size=4, max_seq=128,
                     max_new_tokens=32, record_logits=True)
    rng = np.random.RandomState(5)
    reqs = [Request(i, [int(t) for t in rng.randint(0, 256, n)])
            for i, n in enumerate(PROMPT_LENS)]
    ServingEngine(cfg, params, sc, device="cpu").run(reqs)
    return reqs, params, cfg


def _check(served, r, base_tol, got=None):
    _, params, cfg = served
    seq = r.prompt + r.out_tokens[:-1]
    if got is None:
        got = torch.from_numpy(np.stack(r.logits))
    with torch.inference_mode():
        return smoke.int_logit_check(torch, params, cfg, seq,
                                     len(r.prompt) - 1, got, base_tol,
                                     "cpu w8a8", r.rid)


@pytest.fixture(scope="module")
def records(served):
    """Each request's check, with float32's ``base_tol`` so that both
    bounds are the factor times their floors (bf16's 5% lies above every
    reading of a model this small)."""
    return [_check(served, r, smoke.SERVE_REL_TOL_F32)[0]
            for r in served[0]]


@pytest.mark.parametrize("rid", range(len(PROMPT_LENS)))
def test_the_engine_sits_within_both_bounds(records, rid):
    rec = records[rid]
    assert rec["noise_floor"] > 0 and rec["mean_sq_noise_floor"] > 0
    if rid not in ONE_SPLIT:
        assert rec["max_rel_err"] > 0, "the engine must differ by rounding"
    assert rec["max_rel_err"] <= rec["rel_tol"]
    assert rec["mean_sq_rel_err"] <= rec["mean_sq_rel_tol"]
    assert rec["rel_tol"] == smoke.SERVE_INT_NOISE_FACTOR * rec["noise_floor"]
    assert rec["mean_sq_rel_tol"] == \
        smoke.SERVE_INT_NOISE_FACTOR * rec["mean_sq_noise_floor"]


@pytest.mark.parametrize("fault", smoke.INT_FAULTS)
def test_each_fault_lands_outside_a_bound_by_the_margin(records, fault):
    for rec in records:
        ratios = rec["fault_over_bound"][fault]
        assert set(ratios) == {"max", "rms"}
        assert max(ratios.values()) >= smoke.INT_FAULT_MARGIN, (rec["rid"],
                                                                ratios)


def test_no_bound_falls_below_base_tol_when_a_floor_is_0(served,
                                                        monkeypatch):
    """With the floor's forward equal to the plain one both floors are 0;
    each bound is then ``base_tol`` in its statistic's units (squared for
    the mean square), and a sound engine (here the plain logits
    themselves) passes."""
    monkeypatch.setattr(smoke, "widened_attention", flash_attention_plain)
    r = served[0][0]
    base = smoke.SERVE_REL_TOL_F32
    with torch.inference_mode():
        ref = smoke.plain_forward(torch, served[1], served[2],
                                  r.prompt + r.out_tokens[:-1])
    got = ref[len(r.prompt) - 1:].float()
    rec, _, _, tol = _check(served, r, base, got=got)
    assert rec["noise_floor"] == 0 and rec["mean_sq_noise_floor"] == 0
    assert tol == {"max": base, "mean_sq": base ** 2}
    assert rec["max_rel_err"] == 0 and rec["mean_sq_rel_err"] == 0
