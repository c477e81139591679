"""Serving launcher of the port: session-API requests against an arch.

The counterpart of ``repro.launch.serve``: submits a mixed-priority batch
through ``submit() -> RequestHandle``, streams the first high-priority
request's tokens as decode ticks emit them, drains the rest, and reports
per-request TTFT (in engine ticks), the deadline ledger and the engine's
kernel-launch counts.  Weights are random, from ``init_params`` with a
seeded ``torch.Generator``; ``--quant`` packs them with
``quantize_for_serving`` (w8a8 / w4a8: the integer matmul kernel;
w4a16 / w2a16: the weight-only one); it raises for a model with MLA,
MoE or Mamba2 blocks (ROADMAP queue 1 items 11, 16 and 13).
``--kv-bits 8`` or ``4``
stores the KV pool's pages as int8 or int4 with a float32 scale a row
(``ServeConfig.kv_format``; the quantized paged kernels).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --device cuda --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
      --reduce --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --quant w4a16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      deepseek-v2-lite-dense --kv-bits 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      deepseek-v2-lite-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b \
      --quant w4a16 --ttft-deadline 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --reduce --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import all_archs, get_config, reduce_config
from repro_torch.core.quant import QuantConfig
from repro_torch.models.common import require_device
from repro_torch.models.model import init_params, quantize_for_serving
from repro_torch.serve import Request, ServeConfig, ServingEngine

QUANT_CHOICES = ["none", "w8a8", "w4a16", "w2a16", "w4a8"]


def parse_quant(name: str):
    """``--quant`` as the reference's launcher reads it: ``w{W}a16`` is
    weight-only, ``w{W}a{A}`` integer; 'none' -> None."""
    if name == "none":
        return None
    w = int(name[1])
    mode = "wo" if name.endswith("a16") else "int"
    a = 8 if mode == "wo" else int(name.split("a")[1])
    return QuantConfig(mode=mode, a_bits=a, w_bits=w)


def kv_format(bits: int) -> str:
    """``--kv-bits`` as ``ServeConfig.kv_format``: 0 -> 'fp'."""
    return "fp" if bits == 0 else f"int{bits}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_archs())
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--quant", default="none", choices=QUANT_CHOICES)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 8, 4],
                    help="KV pool page storage: 0 = model dtype (the "
                    "default), 8/4 = int8/int4 pages with per-row scales "
                    "(ServeConfig.kv_format)")
    ap.add_argument("--ttft-deadline", type=int, default=8,
                    help="deadline (engine ticks) stamped on the "
                    "high-priority half of the requests")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                    "(the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    if args.quant != "none":
        cfg = cfg.with_(quant=parse_quant(args.quant))
        params, n = quantize_for_serving(cfg, params, consume=True)
        print(f"serving with {args.quant}: packed {n} tensors")

    rng = np.random.RandomState(1)
    reqs = []
    for i in range(args.requests):
        n = int(rng.randint(2, 9))
        # odd rids are the deadline-critical class; even rids best-effort
        prio, deadline = (1, args.ttft_deadline) if i % 2 else (0, None)
        reqs.append(Request(i, [int(t) for t in
                                rng.randint(0, cfg.vocab_size, n)],
                            priority=prio, ttft_deadline=deadline))
    sc = ServeConfig(max_batch=args.max_batch, max_prompt=32,
                     max_new_tokens=args.max_new_tokens,
                     kv_format=kv_format(args.kv_bits))
    eng = ServingEngine(cfg, params, sc, device=dev)
    if sc.kv_format != "fp":
        print(f"KV pool pages stored as {sc.kv_format} "
              f"({eng.pool_bytes_per_shard() / 1e3:.1f}KB pool)")
    handles = [eng.submit(r) for r in reqs]

    demo = next((h for h in handles if h.req.priority > 0), handles[0])
    print(f"streaming req {demo.req.rid}: ", end="", flush=True)
    for tok in demo.stream():
        print(tok, end=" ", flush=True)
    print()
    eng.drain()

    for h in handles:
        r = h.req
        tag = f" prio={r.priority}"
        if r.ttft_deadline is not None:
            tag += (f" ttft={r.ttft_ticks}t/{r.ttft_deadline}t "
                    f"{'MISS' if r.deadline_miss else 'hit'}")
        print(f"req {r.rid}: {len(r.prompt)} prompt -> {r.out_tokens}"
              f"  [{h.status}{tag}]")
    print(f"deadline ledger: {eng.sched.deadline_hits} hit / "
          f"{eng.sched.deadline_misses} miss")
    st = eng.stats()
    print(f"device {dev}: {st['ticks']} ticks, {st['n_dispatches']} "
          f"dispatches, {st['kernel_launches']} kernel launches, "
          f"peak {st['peak_pages']} pool pages")


if __name__ == "__main__":
    main()
