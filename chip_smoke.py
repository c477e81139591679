#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero; nothing is caught and skipped):

  1. build every CUDA kernel of the port from ``src/repro_torch/kernels/
     csrc`` (one nvcc per source, in parallel) and print the card's name
     and power limit;
  2. hold each kernel against its plain PyTorch version on the card, in
     bf16 and float32, at the shapes the full-width qwen2.5-3b path gives
     it (H=16, KV=2, dh=128, page 16): the flash forward at a 256-token
     prefill chunk, the paged partials at decode (Sq=1) and at a resumed
     256-token chunk; time kernel, plain version and (flash only) the
     library's ``scaled_dot_product_attention`` with a cold L2, beside the
     least time the card could take;
  3. serve full-width, full-depth qwen2.5-3b in bf16 (random weights from
     ``init_params``) through ``ServingEngine.submit/tick``: 16 requests
     of 32-1024 prompt tokens (several span multiple chunks, two share a
     page-aligned prefix), 32 new tokens each.  Every kernel's launch
     count is set to 0 just before and read just after; each must be > 0.
     Two finished requests' logits are held against a plain contiguous
     forward of the same token sequence (teacher forcing);
  4. run a 2-layer float32 version of the same arch through the engine
     and the plain forward: the greedy tokens must be equal.

The second-to-last line is a JSON object listing the ported kernels; the
last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
BF16_FLOPS = 989e12                 # dense tensor-core bf16, H100 SXM
FLASH_TOL_BF16 = 2e-2               # bf16 output ulp + bf16 weights per tile
FLASH_TOL_F32 = 1e-4                # summation order only
PAGED_TOL_BF16 = 2e-2
PAGED_TOL_F32 = 1e-4
# teacher-forced logits, 36 bf16 layers: |engine - plain| <= this share of
# the row's largest |logit| (bf16 keeps ~3 significant digits per op)
SERVE_REL_TOL_BF16 = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed first."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def check_flash(torch, timer, dtype, B=8, S=256, H=16, KV=2, dh=128):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((B, S, n, dh), generator=g, device="cuda")
               .to(dtype) for n in (H, KV, KV))
    got = fa.flash_attention(q, k, v, kv_valid=S)
    want = fa.flash_attention_plain(q, k, v, S)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = FLASH_TOL_BF16 if dtype == torch.bfloat16 else FLASH_TOL_F32
    name = f"flash_attention_fwd[{str(dtype).split('.')[-1]}]"
    if not err <= tol:
        fail(f"{name}: max |kernel - plain| {err} > {tol}")
    rec = {"name": "flash_attention_fwd", "dtype": str(dtype),
           "shapes": {"q": [B, S, H, dh], "k": [B, S, KV, dh]},
           "max_abs_err": err, "tol": tol}
    if dtype != torch.bfloat16:
        return rec
    rec["kernel_ms"] = timer.ms(lambda: fa.flash_attention(q, k, v,
                                                           kv_valid=S))
    rec["plain_ms"] = timer.ms(lambda: fa.flash_attention_plain(q, k, v, S))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = timer.ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                              enable_gqa=True))
    pairs = B * H * S * (S + 1) // 2
    nbytes = (2 * B * S * H * dh + 2 * B * S * KV * dh) * q.element_size()
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 4 * dh * pairs)
    return rec


def paged_case(torch, dtype, B, Sq, H, KV, dh, ps, P, seed):
    """A pool as the serving engine leaves it: each slot maps distinct
    pages for its filled rows (no holes), the last query at qpos."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = B * P
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp, vp = (torch.randn((n, ps, KV, dh), generator=g, device="cuda")
              .to(dtype) for _ in range(2))
    q = torch.randn((B, Sq, H, dh), generator=g, device="cuda").to(dtype)
    fill = np.linspace(Sq + 24, P * ps - 8, B).astype(np.int64)
    tbl = np.full((B, P), -1, np.int32)
    perm = rng.permutation(n)
    k = 0
    for b in range(B):
        m = -(-int(fill[b]) // ps)
        tbl[b, :m] = perm[k:k + m]
        k += m
    qpos = (fill[:, None] - Sq + np.arange(Sq)[None, :]).astype(np.int32)
    kvv = fill.astype(np.int32)
    as_t = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
    return kp, vp, q, as_t(tbl), as_t(qpos), as_t(kvv), fill


def check_paged(torch, timer, dtype, Sq, B=8, H=16, KV=2, dh=128, ps=16,
                P=128):
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import (_combine_page_partials,
                                              _pages_per_split)
    kp, vp, q, tbl, qpos, kvv, fill = paged_case(torch, dtype, B, Sq, H, KV,
                                                 dh, ps, P, seed=2 + Sq)
    c = _pages_per_split(B, Sq, H, P, dh)
    got = pfd.paged_flash_decode_partials(kp, vp, q, tbl, qpos, kvv,
                                          pages_per_split=c)
    want = pfd.paged_flash_decode_partials_plain(kp, vp, q, tbl, qpos, kvv, c)
    torch.cuda.synchronize()
    skipped = want[0] <= -1e30
    if not (bool((got[0][skipped] == -1e30).all())
            and bool((got[1][skipped] == 0).all())
            and bool((got[2][skipped] == 0).all())):
        fail(f"paged partials Sq={Sq}: skipped splits are not the exact "
             "identities (-1e30, 0, 0)")
    err = (_combine_page_partials(*got) - _combine_page_partials(*want)) \
        .abs().max().item()
    tol = PAGED_TOL_BF16 if dtype == torch.bfloat16 else PAGED_TOL_F32
    if not err <= tol:
        fail(f"paged partials Sq={Sq} {dtype}: max |kernel - plain| {err} "
             f"> {tol}")
    rec = {"name": "paged_flash_decode_partials", "dtype": str(dtype),
           "shapes": {"q": [B, Sq, H, dh], "pool": list(kp.shape),
                      "tbl": [B, P], "pages_per_split": c},
           "max_abs_err": err, "tol": tol}
    if dtype != torch.bfloat16:
        return rec
    rec["kernel_ms"] = timer.ms(lambda: pfd.paged_flash_decode_partials(
        kp, vp, q, tbl, qpos, kvv, pages_per_split=c))
    rec["plain_ms"] = timer.ms(lambda: pfd.paged_flash_decode_partials_plain(
        kp, vp, q, tbl, qpos, kvv, c))
    rec["library_ms"] = None
    # this run's live rows: every mapped row below kv_valid is read once
    # per (slot, KV head); pairs are the unmasked (query, key) products
    live_rows = int(sum(-(-int(f) // ps) * ps for f in fill))
    pairs = int(sum(sum(min(int(p) + 1, int(f)) for p in qp)
                    for qp, f in zip(qpos.tolist(), fill)))
    el = q.element_size()
    n_split = -(-P // c)
    nbytes = (q.numel() * el + 2 * live_rows * KV * dh * el
              + B * P * 4 + B * Sq * 4 + B * 4
              + B * Sq * H * n_split * (2 + dh) * 4)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 4 * dh * H * pairs)
    return rec


# ---------------------------------------------------------------------------
# Phases 3-4: the serving path.
# ---------------------------------------------------------------------------

def plain_forward(torch, params, cfg, tokens):
    """Contiguous forward of one sequence with the plain attention (no
    pool, no page table, no kernel): (S, padded_vocab) logits."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.blocks import apply_mlp, apply_norm
    from repro_torch.models.common import dense, embed_lookup, rope
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = params.embed.device
    tok = torch.tensor([tokens], device=dev)
    s = tok.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    x = embed_lookup(params.embed, tok)
    for blk in params.blocks:
        a = blk.attn
        y = apply_norm(blk.ln1, x, cfg)
        q = rope(dense(y, a["wq"], a.get("bq")).reshape(1, s, h, dh), pos,
                 cfg.rope_theta)
        k = rope(dense(y, a["wk"], a.get("bk")).reshape(1, s, kv, dh), pos,
                 cfg.rope_theta)
        v = dense(y, a["wv"], a.get("bv")).reshape(1, s, kv, dh)
        o = flash_attention_plain(q, k, v)
        x = x + dense(o.reshape(1, s, h * dh), a["wo"])
        x = x + apply_mlp(blk.ffn, apply_norm(blk.ln2, x, cfg), cfg)
    x = apply_norm(params.final_norm, x, cfg)
    return dense(x, params.lm_head)[0]


def smoke_traffic(vocab: int, n: int = 16, seed: int = 0):
    """16 prompts of 32-1024 tokens in shuffled order; request 8 repeats
    request 0's first 512 tokens (a page-aligned shared prefix)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = np.linspace(32, 1024, n).astype(int)
    rng.shuffle(lens)
    lens[0] = 1024
    prompts = [[int(t) for t in rng.randint(0, vocab, int(m))] for m in lens]
    prompts[8] = prompts[0][:512] + prompts[8][512:]
    if len(prompts[8]) <= 512:
        prompts[8] = prompts[0][:512] + [int(t) for t in
                                          rng.randint(0, vocab, 200)]
    return prompts


def drive(torch, eng, requests, kernels):
    """Submit every request, then tick until all are done.  Returns the
    wall seconds and the launches per kernel of a decode-only tick."""
    for r in requests:
        eng.submit(r)
    per_decode = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_work():
        before = [m.launches for m in kernels]
        n0 = eng.n_dispatches
        prefill_due = eng.sched.has_pending() or eng.sched.has_prefill_work()
        eng.tick()
        if eng.n_dispatches - n0 == 1 and not prefill_due:
            per_decode = [m.launches - b for m, b in zip(kernels, before)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, per_decode


def serve_full(torch, card):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = get_config("qwen2.5-3b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    sc = ServeConfig(max_batch=8, max_prompt=256, page_size=16, max_seq=2048,
                     max_new_tokens=32, record_logits=True)
    eng = ServingEngine(cfg, params, sc, device="cuda")
    eng.warmup()
    reqs = [Request(i, p) for i, p in enumerate(smoke_traffic(cfg.vocab_size))]
    kernels = (fa, pfd)
    for m in kernels:
        m.launches = 0
    wall, per_decode = drive(torch, eng, reqs, kernels)
    launches = {"flash_attention_fwd": fa.launches,
                "paged_flash_decode_partials": pfd.launches}
    for r in reqs:
        if not r.done or r.failed or len(r.out_tokens) != sc.max_new_tokens:
            fail(f"request {r.rid}: done={r.done} failed={r.failed} "
                 f"tokens={len(r.out_tokens)}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    if eng.n_shared_admissions < 1:
        fail("the shared-prefix request was not admitted as a sharer")
    st = eng.stats()
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(json.dumps({"phase": "serve", "arch": cfg.name, "dtype": "bf16",
                      "layers": cfg.n_layers, "requests": len(reqs),
                      "tokens": n_tok, "wall_s": wall,
                      "tokens_per_s": n_tok / wall, "stats": st,
                      "launches": launches,
                      "launches_per_decode_tick": per_decode,
                      "card": card}), flush=True)
    # teacher-forced logits of two finished requests (the shared-prefix
    # one and the longest, both multi-chunk) against the plain forward
    errs = []
    with torch.inference_mode():
        for rid in (8, 0):
            r = reqs[rid]
            ref = plain_forward(torch, params, cfg,
                                r.prompt + r.out_tokens[:-1])
            ref = ref[len(r.prompt) - 1:].float().cpu()
            got = torch.from_numpy(np.stack(r.logits))
            rel = ((got - ref).abs().amax(-1)
                   / ref.abs().amax(-1).clamp_min(1e-30)).max().item()
            agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
            errs.append({"rid": rid, "max_rel_err": rel,
                         "argmax_agree": agree})
            if not rel <= SERVE_REL_TOL_BF16:
                fail(f"request {rid}: teacher-forced logits differ by "
                     f"{rel} of the row max (> {SERVE_REL_TOL_BF16})")
    print(json.dumps({"phase": "serve_check", "rel_tol": SERVE_REL_TOL_BF16,
                      "requests": errs}), flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return launches, per_decode


def serve_f32(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = get_config("qwen2.5-3b").with_(
        n_layers=2, pattern=(("scan", "attn_mlp", 2),), dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_params(cfg, gen, device="cuda")
    sc = ServeConfig(max_batch=4, max_prompt=256, page_size=16, max_seq=1024,
                     max_new_tokens=8)
    eng = ServingEngine(cfg, params, sc, device="cuda")
    rng = np.random.RandomState(5)
    reqs = [Request(i, [int(t) for t in rng.randint(0, cfg.vocab_size, n)])
            for i, n in enumerate((40, 300, 600, 17, 260, 90))]
    eng.run(reqs)
    bad = []
    with torch.inference_mode():
        for r in reqs:
            ref = plain_forward(torch, params, cfg,
                                r.prompt + r.out_tokens[:-1])
            want = ref[len(r.prompt) - 1:].argmax(-1).tolist()
            if want != r.out_tokens:
                bad.append((r.rid, r.out_tokens, want))
    print(json.dumps({"phase": "serve_f32", "layers": 2, "requests":
                      len(reqs), "token_mismatches": len(bad)}), flush=True)
    if bad:
        fail(f"f32 engine tokens differ from the plain forward: {bad}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout of "
             "the repository")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels_only = "--kernels-only" in sys.argv[1:]

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    ptxas = _build.build_all()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)

    timer = Timer(torch)
    recs = [check_flash(torch, timer, torch.bfloat16),
            check_flash(torch, timer, torch.float32),
            check_paged(torch, timer, torch.bfloat16, Sq=1),
            check_paged(torch, timer, torch.bfloat16, Sq=256),
            check_paged(torch, timer, torch.float32, Sq=1),
            check_paged(torch, timer, torch.float32, Sq=256)]
    for rec in recs:
        print(json.dumps(dict(phase="kernel", **rec)), flush=True)
    if kernels_only:
        return
    del timer
    torch.cuda.empty_cache()

    launches, per_decode = serve_full(torch, card)
    serve_f32(torch)

    flash_rec, paged_rec = recs[0], recs[2]
    per = dict(zip(("flash_attention_fwd", "paged_flash_decode_partials"),
                   per_decode or (None, None)))
    for rec in (recs[0], recs[2], recs[3]):
        print(json.dumps({
            "name": rec["name"], "shapes": rec["shapes"],
            "max_abs_err": rec["max_abs_err"], "tol": rec["tol"],
            "kernel_ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
            "launches_per_decode_step": per[rec["name"]]}), flush=True)
    src = "src/repro_torch/kernels/csrc/"
    line = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:36",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": flash_rec["max_abs_err"], "ms": flash_rec["kernel_ms"],
         "plain_ms": flash_rec["plain_ms"], "bound_ms": flash_rec["bound_ms"],
         "bound_by": flash_rec["bound_by"],
         "library_ms": flash_rec["library_ms"]},
        {"name": "paged_flash_decode_partials", "route": "cuda",
         "source": src + "paged_flash_decode.cu",
         "replaces": "src/repro/kernels/paged_flash_decode.py:129",
         "launches": launches["paged_flash_decode_partials"],
         "max_abs_err": paged_rec["max_abs_err"], "ms": paged_rec["kernel_ms"],
         "plain_ms": paged_rec["plain_ms"], "bound_ms": paged_rec["bound_ms"],
         "bound_by": paged_rec["bound_by"], "library_ms": None},
    ]}
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
