"""Per-row errors behind the w8a8 logit check of ``chip_smoke.py``.

``chip_smoke.py`` holds the w8a8 engine's teacher-forced logits to two
statistics of their row errors (``int_stats``).  This script keeps every
row's error instead, so that other statistics can be weighed against
them.  On the card it serves phase 6 (full-depth qwen2.5-3b at w8a8,
requests 8 and 0) and phase 7 (2 float32 layers at w8a8, six requests)
as ``chip_smoke.py`` does, with ``int_logit_check`` replaced by a
recorder: for the engine, the kernel-free floor and each planted fault
of ``INT_FAULTS`` it writes each row's max |diff| / row max and its
relative L2 error over the vocabulary to a JSON file.  ``--summary``
reads such a file on any host and prints, per request and statistic,
the floor, the engine over the floor and each fault over its bound
(``SERVE_INT_NOISE_FACTOR`` times the floor), on the errors' scale: a
mean square's ratio is given as the ratio of the RMS values.

    python3 int_row_errors.py --out int_rows.json
    python3 int_row_errors.py --summary int_rows.json

``--f32-seeds 3-10`` runs phase 7's check alone (``serve_f32`` at w8a8)
at each weight seed of the range, with ``chip_smoke.py``'s own
``int_logit_check``, and records each failure instead of stopping: one
JSON line a seed, after ``serve_f32``'s own line with every request's
record.  Where the kernel-free floor moves no activation integer the
bound is 1e-5, so the verdict can turn on one rounding; this reads how
often it does.

    python3 int_row_errors.py --f32-seeds 3-10
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def collect(out: Path) -> None:
    import torch
    cs = _smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    sys.path.insert(0, str(cs.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = []

    def record(torch_, params, cfg, seq, start, got, base_tol, tag, rid):
        def fwd(**kw):
            return cs.plain_forward(torch_, params, cfg, seq, **kw)[start:] \
                .float().cpu()
        ref = fwd()
        outs = {"engine": got, "floor": fwd(attention=cs.widened_attention)}
        for f in cs.INT_FAULTS:
            outs[f] = fwd(fault=f)
        rec = {"tag": tag, "rid": rid, "base_tol": base_tol,
               "rowmax": {k: cs.row_errs(v, ref).tolist()
                          for k, v in outs.items()},
               "rowl2": {k: ((v - ref).norm(dim=-1)
                             / ref.norm(dim=-1)).tolist()
                         for k, v in outs.items()}}
        recs.append(rec)
        return rec, ref, outs["floor"], base_tol

    cs.int_logit_check = record
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models.model import init_params, quantize_for_serving
    _build.build_all()
    card = cs.card_line()
    print(card, flush=True)
    cfg = get_config("qwen2.5-3b")
    raw = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    qcfg = cfg.with_(quant=parse_quant("w8a8"))
    packed, _ = quantize_for_serving(qcfg, raw)
    del raw
    cs.serve(torch, card, qcfg, packed, "w8a8")
    del packed
    torch.cuda.empty_cache()
    cs.serve_f32(torch, "w8a8")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "records": recs}))
    print(f"wrote {len(recs)} records to {out}", flush=True)


def f32_seeds(seeds: range) -> None:
    import torch
    cs = _smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    sys.path.insert(0, str(cs.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all()
    print(cs.card_line(), flush=True)
    for seed in seeds:
        failures = []
        cs.fail = failures.append
        cs.serve_f32(torch, "w8a8", seed=seed)
        print(json.dumps({"phase": "f32_seed", "seed": seed,
                          "passed": not failures, "failures": failures}),
              flush=True)


def stats(e: list[float]) -> dict:
    """Candidate statistics of one request's row errors."""
    s = sorted(e)
    n = len(s)
    return {"max": s[-1], "mean": sum(s) / n,
            "rms": math.sqrt(sum(v * v for v in s) / n),
            "median": (s[(n - 1) // 2] + s[n // 2]) / 2,
            "q25": s[(n - 1) // 4], "min": s[0],
            "mean_sq": sum(v * v for v in s) / n}


def summary(path: Path) -> None:
    factor = _smoke().SERVE_INT_NOISE_FACTOR
    data = json.loads(path.read_text())
    print(data["card"])
    for rec in data["records"]:
        for kind in ("rowmax", "rowl2"):
            by = {k: stats(v) for k, v in rec[kind].items()}
            floor = by["floor"]
            for s, f in floor.items():
                # the mean square is bounded as chip_smoke.py bounds it
                # (factor x its floor), and its ratios are taken as RMS
                # ratios
                root = math.sqrt if s == "mean_sq" else (lambda r: r)
                cells = [f"{rec['tag']:>8} rid {rec['rid']:>2} {kind:6} "
                         f"{s:7} floor {f:.4g}"]
                for k, v in by.items():
                    if k == "floor":
                        continue
                    over, name = (f, "floor") if k == "engine" else \
                        (factor * f, "bound")
                    r = root(v[s] / over) if over else math.nan
                    cells.append(f"{k}/{name} {r:.3f}")
                print("  ".join(cells))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("int_rows.json"))
    ap.add_argument("--summary", type=Path, default=None,
                    help="print the statistics of a file this wrote")
    ap.add_argument("--f32-seeds", default=None, metavar="A-B",
                    help="phase 7's check at weight seeds A to B")
    args = ap.parse_args()
    if args.summary is not None:
        summary(args.summary)
    elif args.f32_seeds is not None:
        lo, hi = (int(v) for v in args.f32_seeds.split("-"))
        f32_seeds(range(lo, hi + 1))
    else:
        collect(args.out)


if __name__ == "__main__":
    main()
