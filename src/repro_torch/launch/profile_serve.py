"""Where a serving tick's time goes on the card.

Serves a full-size model (bf16, random weights; qwen2.5-3b, or any
registered ``--arch``: deepseek-v2-lite-dense for the MLA path,
granite-moe-1b-a400m and deepseek-v2-lite-16b for the MoE FFN, zamba2-7b
for the Mamba2 blocks and the shared attention block, qwen3-8b, yi-34b)
with 8 requests of
700 prompt tokens, then times, without and with ``torch.profiler``:

  * the prefill ticks (three 256-token chunks per slot: one fresh wave,
    then resumed waves), and
  * a window of decode-only ticks (8 active slots).

For each window it prints one JSON line: host wall ms per tick, device
busy ms per tick (the profiler's summed device time of kernels and
copies), the device's idle share, host op and stream-sync counts per
tick, the device ops that took the most time, the port's partials
kernels by name (which route ran), and the device time of the
flash-decoding combine that follows them (``_combine_page_partials``,
a few elementwise kernels that no kernel name tells apart): this script
wraps it in a ``record_function`` range (the model code carries none)
and sums the kernels launched inside.  The same way, every block's
attention sublayer and FFN sublayer (MLP or MoE), and every mamba
block's mixer, are wrapped in ranges named ATTENTION, FFN and MAMBA in
the profiled run only, whose device ms a tick are printed side by side.
Needs one card.
``--quant`` packs the weights first, in place (as the serving launcher
does; yi-34b fits on one card only so);
``--kv-bits 8`` or ``4`` stores the KV pool as int8 or int4 pages.
``--contiguous`` serves the same model with the paged engine and the
contiguous one (``ServeConfig(paged=False)``) in turn, paged,
contiguous, contiguous, paged, at a 1024-token chunk so that each
700-token prompt is one fresh wave (the contiguous engine's only kind),
the prefill window then one tick.  Each line names its ``layout``.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --ticks 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch deepseek-v2-lite-dense
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch deepseek-v2-lite-16b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --quant w4a16
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch yi-34b \
      --quant w4a16
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --kv-bits 4
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --contiguous
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch zamba2-7b
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import all_archs, get_config
from repro_torch.launch.serve import QUANT_CHOICES, kv_format, parse_quant
from repro_torch.models import attention, blocks, mla
from repro_torch.models.common import require_device
from repro_torch.models.model import init_params, quantize_for_serving
from repro_torch.serve import Request, ServeConfig, ServingEngine

COMBINE = "combine"                 # the combine's profiler range
ATTENTION = "attention"             # a block's attention sublayer
FFN = "ffn"                         # a block's MLP or MoE FFN sublayer
MAMBA = "mamba"                     # a mamba block's mixer
RANGES = (COMBINE, ATTENTION, FFN, MAMBA)
SUBLAYERS = {"attend": ATTENTION, "ffn_out": FFN, "mixer": MAMBA}
# name parts of the paged partials kernels: the GQA kernel's chunk route
# and FMA tile, the MLA kernels, and the GQA decode route
PARTIALS_KERNELS = ("partials_", "paged_decode_mma")


def _wrap_combine():
    """Wrap the combine, where the GQA and MLA layers call it, in a
    ``record_function`` range named COMBINE."""
    for mod in (attention, mla):
        fn = mod._combine_page_partials

        def run(*a, _fn=fn, **kw):
            with record_function(COMBINE):
                return _fn(*a, **kw)
        mod._combine_page_partials = run


def _wrap_sublayers():
    """Wrap each block kind's attention (``attend``), FFN (``ffn_out``)
    and Mamba2 mixer (``mixer``) in ``record_function`` ranges named
    ATTENTION, FFN and MAMBA, each where a class defines it (a subclass
    inherits the wrapped one).  Returns a function that restores them."""
    saved = [(block, name, vars(block)[name])
             for block in {b.module for b in blocks.BLOCKS.values()}
             for name in SUBLAYERS if name in vars(block)]
    for block, name, fn in saved:
        if name != "ffn_out":
            def run(*a, _fn=fn.__func__, _label=SUBLAYERS[name], **kw):
                with record_function(_label):
                    return _fn(*a, **kw)
            setattr(block, name, staticmethod(run))
        else:
            def ffn(self, *a, _fn=fn, **kw):
                with record_function(FFN):
                    return _fn(self, *a, **kw)
            block.ffn_out = ffn

    def restore():
        for block, name, fn in saved:
            setattr(block, name, fn)
    return restore


def _device_us(evt, own: bool = True) -> float:
    """An event's device time (us): its own, or with ``own`` False, that
    of the kernels launched inside it too (a span's)."""
    names = ("device_time_total", "cuda_time_total")
    for name in (("self_" + n for n in names) if own else names):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _window(eng, ticks: int, profiled: bool) -> dict:
    torch.cuda.synchronize()
    if not profiled:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        torch.cuda.synchronize()
        return {"wall_ms_per_tick": (time.perf_counter() - t0) * 1e3 / ticks}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device rows only (kernels, memcpy, memset): an aten op's own row
    # repeats the device time of the kernels it launched, and the
    # combine's range has a device row of its own (its span on the
    # device's timeline, gaps included)
    dev = [(e.key, _device_us(e), e.count) for e in avgs
           if e.device_type == DeviceType.CUDA and e.key not in RANGES
           and _device_us(e) > 0]
    busy = sum(r[1] for r in dev) / 1e3
    dev.sort(key=lambda r: -r[1])
    host = {e.key: e.count for e in avgs if e.device_type == DeviceType.CPU}
    spans = {k: [e for e in avgs
                 if e.key == k and e.device_type == DeviceType.CPU]
             for k in RANGES}
    combine = spans[COMBINE]
    return {"wall_ms_per_tick": wall / ticks,
            "device_busy_ms_per_tick": busy / ticks,
            "device_idle_share": 1 - busy / wall,
            "aten_ops_per_tick": sum(n for k, n in host.items()
                                     if k.startswith("aten::")) / ticks,
            "stream_syncs_per_tick": host.get("cudaStreamSynchronize", 0)
            / ticks,
            "nonzero_per_tick": host.get("aten::nonzero", 0) / ticks,
            "top_device_ops": [{"op": k[:80], "ms_per_tick": us / 1e3 / ticks,
                                "calls_per_tick": n / ticks}
                               for k, us, n in dev[:12]],
            "combine_device_ms_per_tick": sum(
                _device_us(e, own=False) for e in combine) / 1e3 / ticks,
            "combine_calls_per_tick": sum(e.count for e in combine) / ticks,
            # the blocks' sublayers, every layer of the tick summed
            **{f"{k}_device_ms_per_tick": sum(
                _device_us(e, own=False) for e in spans[k]) / 1e3 / ticks
               for k in (ATTENTION, FFN, MAMBA)},
            # the port's attention kernels by name (their routes)
            "partials_kernels": [{"op": k[:100], "ms_per_tick":
                                  us / 1e3 / ticks, "calls_per_tick":
                                  n / ticks}
                                 for k, us, n in dev
                                 if any(p in k for p in PARTIALS_KERNELS)]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=all_archs())
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--quant", default="none", choices=QUANT_CHOICES)
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 8, 4])
    ap.add_argument("--contiguous", action="store_true",
                    help="alternate the paged and contiguous engines")
    args = ap.parse_args(argv)
    if args.contiguous and args.kv_bits:
        ap.error("--contiguous serves an fp cache: the contiguous layout "
                 "stores the model's dtype")
    dev = require_device("cuda")
    _wrap_combine()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    if args.quant != "none":
        cfg = cfg.with_(quant=parse_quant(args.quant))
        params, _ = quantize_for_serving(cfg, params, consume=True)
    new_tokens = 4 * args.ticks + 8
    if args.contiguous:
        # one 1024-token chunk a prompt in both layouts (no max_seq: the
        # contiguous layout takes none), the paged one's table as wide
        layouts = (True, False, False, True)
        base = dict(max_prompt=1024)
    else:
        layouts = (True,)
        base = dict(max_prompt=256, max_seq=2048)
    chunks = -(-700 // base["max_prompt"])      # prefill ticks a prompt
    for paged in layouts:
        sc = ServeConfig(max_batch=8, page_size=16, paged=paged,
                         max_new_tokens=new_tokens,
                         kv_format=kv_format(args.kv_bits), **base)
        rng = np.random.RandomState(0)
        for profiled in (False, True):
            # the sublayers' ranges only where the profiler reads them:
            # the unprofiled walls carry no host range but the combine's
            restore = _wrap_sublayers() if profiled else (lambda: None)
            eng = ServingEngine(cfg, params, sc, device=dev)
            eng.warmup()
            for i in range(sc.max_batch):
                eng.submit(Request(i, [int(t) for t in
                                       rng.randint(0, cfg.vocab_size,
                                                   700)]))
            out = {"card": card, "arch": cfg.name, "quant": args.quant,
                   "kv_format": sc.kv_format,
                   "layout": "paged" if paged else "contiguous",
                   "max_prompt": sc.max_prompt,
                   "pool_bytes": eng.pool_bytes_per_shard(),
                   "profiled": profiled}
            out["prefill"] = _window(eng, chunks, profiled)
            if eng.sched.has_prefill_work():
                raise RuntimeError(f"prefill did not finish in {chunks} "
                                   "ticks")
            out["decode"] = _window(eng, args.ticks, profiled)
            out["decode"]["active_slots"] = len(eng.sched.decode_slots())
            restore()
            print(json.dumps(out), flush=True)
            del eng
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
