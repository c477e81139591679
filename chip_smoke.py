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
     256-token chunk; the bf16 flash forward (the tensor-core route) also
     at every HEAD_DIMS pair, at that chunk and at FLASH_EDGES (1, 63, 65
     and 188 rows, kv_valid short of the chunk, one sequence); the bf16
     paged partials (both routes on the tensor cores: decode rows, up to
     16 Sq x G, on the one-tile route at the engine's split of one
     64-key tile; chunks on the FA2 ring) also at every HEAD_DIMS pair
     and PAGED_EDGES case (1, 2, 3, 17, 65, 188 and 256 query positions,
     1, 2, 3, 4 and 8 pages a split and the engine's, page 16 and 32) on
     a pool with a hole, a mapped page past a slot's position and an
     inactive slot, every skipped split and every row that sees no key
     exactly (-1e30, 0, 0), each case within PAGED_EDGE_TOL_BF16, which a
     causal mask one key off (PAGED_SHIFT: one key more for a chunk,
     fewer at decode), planted in the plain version, must break; the
     decode route on fp, int8 and int4 pools timed at 1, 2, 4 and 8
     pages a split in one Timer (``paged_sweep``, with the combine's
     time), and the engine's split set beside the fastest;
     time kernel, plain version and (flash only) the library's
     ``scaled_dot_product_attention`` with a cold L2 (see ``Timer``),
     beside the least time the card could take;
  3. serve full-width, full-depth qwen2.5-3b in bf16 (random weights from
     ``init_params``) through ``ServingEngine.submit/tick``: 16 requests
     of 32-1024 prompt tokens (several span multiple chunks, two share a
     page-aligned prefix), 32 new tokens each.  Every kernel's launch
     count is set to 0 just before and read just after; each must be > 0.
     Every dispatch is logged with the launches it made: a fresh wave
     launches the flash kernel 36 times, a resumed wave (the paged
     kernel's chunk route) and a decode step (its decode route, one
     64-key tile a split) the paged kernel 36 times, neither launching
     the other.  Two finished
     requests' logits are held against a plain contiguous forward of the
     same token sequence (teacher forcing);
  4. run a 2-layer float32 version of the same arch through the engine
     and the plain forward: the greedy tokens must be equal;
  5. hold the packed matmul kernels against their plain versions at the
     shapes every ``dense`` of qwen2.5-3b gives them, M in {8 (decode),
     2048 (a prefill wave)} x (K, N) in the five projections: the integer
     kernel BITWISE (all six Table IV formats at the w_down shape, w8a8
     and w4a8 at every shape, and so again at M in INT_ROWS: both
     tensor-core routes, ragged rows), the weight-only kernel in bf16
     within one bf16 step of the output's largest value (w8/w4/w2 at
     every shape, and at M in WO_ROWS); time both beside their plain
     versions, their bounds and a labelled yardstick call;
  6. serve the same full-depth model packed by ``quantize_for_serving``
     at w4a16 and then at w8a8 with the phase-3 traffic: every request
     completes, the matmul kernels launch 7 x 36 + 1 = 253 times per
     decode dispatch, the attention kernels per dispatch as in phase 3,
     and two requests' teacher-forced logits match a
     plain contiguous forward over the SAME packed weights through the
     plain versions (at w8a8 by two statistics of the rows' errors, the
     largest and the mean square over positions, each within a multiple
     of its noise floor that no port kernel enters, see
     SERVE_INT_NOISE_FACTOR; each planted fault in the plain integer path
     must land INT_FAULT_MARGIN outside one of the two bounds);
  7. phase 4 again at w4a16 and w8a8 (at w8a8 the teacher-forced logits
     are held as in phase 6, and a token may differ only at a position
     whose top-two gap in the plain forward lies within twice the
     kernel-free rounding noise at that position; each such position is
     printed);
  8. serve deepseek-v2-lite at its full widths and depth with its dense
     MLA block in every layer (``deepseek-v2-lite-dense``, 27 layers,
     bf16, random weights from a seeded generator): 16 requests of
     288-1024 prompt tokens, all longer than the 256-token chunk, two
     sharing a page-aligned prefix.  Every dispatch is logged with the
     launches it made: a fresh wave launches the flash kernel 27 times, a
     resumed wave the paged kernel 27 times, a decode step the MLA kernel
     27 times, and nothing else.  Every request's teacher-forced logits
     are held against a plain naive-form forward (no kernel, no pool)
     within SERVE_MLA_REL_TOL; the same engine with a planted fault (the
     MLA kernel's softmax scale taken from r + dr), serving two of them,
     must land outside it;
  9. a 2-layer float32 deepseek-v2-lite-dense at full width through the
     engine: its greedy tokens must equal the plain forward's.

  10. serve qwen2.5-3b (phase-3 traffic, the phase-3 weights) and
      deepseek-v2-lite-dense (phase-8 traffic and weights) at full depth
      on int8 and on int4 KV pools (``ServeConfig.kv_format``).  Every
      dispatch is logged with its launches: on a quantized GQA pool every
      fresh, resumed and decode dispatch launches the quantized paged
      kernel 36 times and nothing else (a fresh chunk runs as a resume at
      offset 0, never through the flash kernel); on a quantized latent
      pool a fresh or resumed wave launches the fp paged kernel (192/128)
      27 times and a decode step the quantized MLA kernel 27 times; the
      launches are also summed by dispatch kind (on a GQA pool, fresh and
      resumed waves take the quantized kernel's chunk route, decode steps
      its decode route).  The
      pool's bytes (``pool_bytes_per_shard()``) are printed beside the
      bf16 pool's and held to POOL_RATIO_LIMIT.  Every request's
      teacher-forced logits are held against a plain contiguous forward
      that quantizes and dequantizes each K/V (or latent) row as the
      pool stores it, within SERVE_KV_NOISE_FACTOR times a kernel-free
      noise floor (and the fp path's bound); the same engine with a
      planted fault (each row's scale rolled by one within its page,
      handed to the kernel), serving requests 0 and 8, must land outside;
  11. a 2-layer float32 version of each model at int4 through the
      engine: greedy tokens equal the plain forward's, but at a printed
      near-tie under phase 7's per-position rule.
  12. overcommitted serving with swap preemption, at full width and
      depth: qwen2.5-3b on a bf16 pool (phase 3's weights), then on an
      int8 pool, and deepseek-v2-lite-dense on its latent pool (phase 8's
      weights), each serving OVERCOMMIT_ARRIVALS through an OVERCOMMIT
      pool (78 pages, reserve_decode_pages=False, eos_id -1).  The
      preemption log (tick, grower, victim, the victim's prefill_done and
      pos) must equal the one the port's engine computes on the CPU at one
      narrow float32 layer and hold OVERCOMMIT_MIN (victims mid-prompt and
      mid-decode, one preempted twice, one holding a prefix-shared page);
      every swap-in restores its snapshot bit for bit; every request
      completes with no fault; swap-ins equal preemptions; every page is
      free at the end; each dispatch launches its one attention kernel
      once a layer.  Each preempted request's teacher-forced logits are
      held as in phase 3 (bf16 pool), 10 (int8) and 8 (latent pool), and
      the same engine with its swap-ins restoring the pages rolled by one
      logical page, run until its first preempted request completes,
      must land outside the bound there.  Bytes per snapshot and the
      swap-out / swap-in times are printed beside the card.
  13. the dense arch files at full width and depth, after every earlier
      phase's weights are released: qwen3-8b (36 layers, H 32 / KV 8,
      qk_norm, its q_norm / k_norm drawn with QK_NORM_SPREAD from a seeded
      generator) on a bf16 pool (phase 3's checks) and on an int8 pool
      (phase 10's), then yi-34b (60 layers, d 7168, H 56 / KV 8) in bf16
      and the same weights packed in place to w4a16
      (``quantize_for_serving(..., consume=True)``), each with phase 3's
      traffic: launches per dispatch as in phases 3 and 10, the two
      requests' teacher-forced logits within SERVE_REL_TOL_BF16 (bf16,
      w4a16) or the floor-based bound (int8), and qwen3-8b's planted
      fault (q_norm and k_norm exchanged in the plain forward)
      QK_FAULT_MARGIN outside each bound.  The weights', the pool's and
      the card's bytes and the peak allocation are printed for each run.
  14. the contiguous cache layout (``ServeConfig(paged=False)``), after
      phase 13's weights are released: qwen2.5-3b (phase 3's weights)
      and deepseek-v2-lite-dense (phase 8's), full width and depth, bf16,
      phase 3's traffic through CONTIG_SERVE (8 slots, every prompt one
      1024-token chunk, 32 new tokens, the cache read as pages of 16 over
      each slot's 1056 rows).  Every request completes; a fresh wave
      launches the flash kernel once a layer and nothing else, a decode
      step the paged kernel's decode route (GQA) or the MLA kernel once a
      layer and nothing else.  The paged engine at the same chunk and
      page size (no prefix sharing) must give the same tokens, and the
      logits' largest difference is printed.  The shortest request's and
      request 0's teacher-forced logits are held as in phases 3 and 8;
      the engine with one key short at every decode call (GQA kv_valid =
      pos, MLA rows <= pos - 1) must land outside the bound on the
      shortest.  Then ``make_chunked_prefill_resume_step`` feeds a
      1024-token prompt into a contiguous qwen2.5-3b cache in four
      256-token chunks, each launching the paged kernel's chunk route
      once a layer, and its last logits are held to the single pass.
      The cache's bytes are printed beside the card.
  15. the paper's quantized CNNs (Table VI) at full size, after phase
      14's weights are released (``vision_phase``): MobileNetV1 (base 32,
      224 x 224 x 3, 1000 classes) in float32, 8b (a8w8) and 8b4b (a8w4),
      and ResNet-20 (base 16, 32 x 32 x 3, 10 classes) in float32, 8b and
      4b2b (a4w2), at batch 1 and at 64 / 256 images, on random weights
      from a seeded generator, every quantized weight packed once.  Each
      forward launches the integer kernel 15 (MobileNetV1) or 22
      (ResNet-20) times and no other kernel (counts at 0 just before,
      read just after); its logits equal, bit for bit, the same forward's
      with the plain matmul; float32 logits lie within VISION_F32_TOL of
      a float64 forward.  Latency, images/s, each distinct matmul call's
      kernel time beside its bound, the device time by part and the
      model's bytes are printed beside the card.
  16. granite-moe-1b-a400m (24 ``attn_moe`` blocks: GQA at H 16 / KV 8,
      dh 64, and a 32-expert top-8 MoE FFN) at full width and depth in
      bf16, after phase 15's weights are released (``moe_phase``).
      First the attention kernels at its shape against their plain
      versions (the flash forward, the paged kernel at the engine's
      decode split, on a resumed 256-row chunk and at every PAGED_EDGES
      case with the planted shift outside), and ``moe_ffn`` on the card
      in float32 on the CPU tests' planted ties and overflow, within
      MOE_UNIT's tol of the CPU port's and its routing bit for bit.  Then
      phase 3's traffic on the paged pool and on the contiguous cache,
      launches per dispatch as in phases 3 and 14, every dispatch's
      arguments recorded: a MoE dispatch's expert capacity comes from its
      shape, so a teacher-forced forward is no reference; the dispatches
      are replayed instead through an engine whose attention runs the
      kernels' plain versions on the kernel run's routing (and again on
      widened inputs, the floor, and with the gates not renormalised,
      the planted fault), and the logits are held as phase 7 holds its
      (``moe_logit_check``).  The routing agreement (a plain replay on
      its own routing) and the dropped assignments by dispatch kind,
      the weights', cache's and peak bytes, and a decode dispatch's and
      a fresh wave's wall, busy, attention and FFN device ms are printed
      beside the card.
  17. the published deepseek-v2-lite-16b (a two-scan program: one
      ``mla_mlp`` block, then 26 ``mla_moe`` blocks, each with 64 routed
      experts top-6 and 2 shared experts) at full width and depth in
      bf16, after every earlier phase's weights are released
      (``mla_moe_phase``).  First ``moe_ffn`` on the card in float32 at
      E 64, top 6 with shared experts, within MLA_MOE_UNIT's tol of the CPU
      port's and its routing bit for bit.  Then phase 16's serving and
      replays on phase 3's traffic, paged and contiguous: each dispatch
      runs its MLA kernel once a layer (the flash forward on a fresh
      wave, the paged partials on a resumed wave's expanded window, the
      MLA decode partials at decode), the replays patch the MLA module's
      kernel names as well as the GQA module's and launch no kernel, and
      a second planted fault leaves the shared experts' output out; each
      fault lands MOE_FAULT_MARGIN outside a bound.
  18. zamba2-7b (13 groups of 5 Mamba2 blocks and the shared attention
      block, then 3 Mamba2 blocks: 81 blocks, d 3584, 112 SSM heads of
      64, MHA at H 32, dh 112) at full width and depth in bf16, after
      every earlier phase's weights are released (``hybrid_phase``).
      First the attention kernels at its shape against their plain
      versions (the flash forward, the paged kernel at the engine's
      decode split and on a resumed 256-row chunk, each timed beside its
      bound and SDPA's time; every FLASH_EDGES and PAGED_EDGES case with
      the planted shift outside), and temperature sampling's
      frequencies against the softmax on the card.  Then phase 3's
      traffic, paged and contiguous: a fresh wave launches the flash
      kernel 13 times (once a shared-block position), a resumed wave or
      a decode step the paged kernel 13 times; no admission shares a
      prefix (recurrent state); the dispatches are replayed as in
      phase 16 (no routing to force), the logits held by
      ``moe_logit_check`` with the planted fault (a mamba decode step
      that does not decay its state) outside, and every slot's final
      conv and SSM state held against the plain replay's.  One
      overcommitted run (phase 12's arrivals and pool, 40 new tokens)
      restores every snapshot's pages and state rows bit for bit.  Peak
      memory, and a paged decode dispatch's and fresh wave's device ms by
      part (mamba, attention, MLP) are printed.

Phase 2 also holds the MLA path's kernels (phase 2b): the flash forward
at q/k 192 / v 128 on a fresh 256-token chunk (KV = H = 16), the paged
partials at the same widths on a resumed chunk's expanded window, and
the compressed-space MLA partials at B 8, H 16, r 512, dr 64, page 16,
P in {64, 128, 256} pages a slot, with a hole, a page past its slot's
position and an inactive slot, in bf16 and float32, at the engine's
split (one 64-key tile: 4 pages at page 16) and, in float32, at one page
a split; and at P 128 again with 1, 2 and 3 pages a split, and at page
size 32 with 1 and 2.  The bf16 MLA kernels (the tensor-core route) on
fp, int8 and int4 latent pools are timed at MLA_SWEEP_C pages a split
in one Timer, and held at every MLA_EDGES case (P 64, 128 and 256; page
16 and 32; 1, 2, 3, 4 and 8 pages a split; 1 and 2 query rows a slot)
within MLA_EDGE_TOL_BF16, which the plain version with the k_rope half
left out of the score must break in every case, and a causal limit one
key off in every case but the three of MLA_SHIFT_BLIND, every quantized
case bit for bit the fp route on its pool dequantized.  Phase 2d
(``group_checks``) runs the GQA kernels at the group sizes of phase 13's
models (GROUP_HEADS: H 32 / KV 8 and H 56 / KV 8, dk = dv = 128): every
FLASH_EDGES case, every PAGED_EDGES case on fp, int8 and int4 pools under
the same bounds and faults, the engine's calls timed, the decode route's
sweep over splits, and the weight-only matmul at yi-34b's MLP widths
(MM_SHAPES_YI, w4, M 8 and 2048).  Phase 2c holds the quantized kernels,
at int8 and int4, bf16 and float32: the quantized paged partials at
qwen2.5-3b's widths (P 128) at decode and on a resumed 256-row chunk,
at the engine's split and at 1, 2 and 3 pages a split; the quantized
MLA partials at B 8, H
16, r 512, dr 64, P 128 at the engine's split and with 1, 2 and 3 pages
a split and at page 32 with 1 and 2 (each bf16 case bit for bit the fp
route on the dequantized pool); every case with a hole, a page past its
slot's position and an inactive slot, whose splits must be the exact
identities.  The quantized paged partials also run in
bf16 at every PAGED_EDGES case (int8 and int4, dk 128, KV 2, page 16
and 32) and on a fresh 256-row chunk (offset 0, as the engine sends one
on a quantized pool), each within PAGED_EDGE_TOL_BF16, which the planted
causal mask one key off (PAGED_SHIFT) must break.  Every bf16 case takes
a tensor-core route (the decode route up to 16 Sq x G rows, the chunk
route above), which must equal, bit for bit, the fp kernel's same route
on the same pool dequantized by ``PageFormat.dequantize``; every bf16
case records that comparison.  The engine's choices are timed in bf16.
With the kernel checks, ``contiguous_yardstick`` times each decode
kernel at phase 14's decode shape, alone and with the combine, beside
``scaled_dot_product_attention`` over the contiguous window (the
library call of kernel table rows 2 and 4; never on the main path).

The second-to-last line is a JSON object listing the ported kernels; the
last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
``--kernels-only`` stops after the kernel checks (phases 1, 2, 2b, 2c,
2d and 5).
``--sweeps-only`` runs the build, the paged decode sweep, the
MLA sweep and the MLA_EDGES cases alone, at explicit pages a split: it
is how an earlier tree's readings behind the sweeps and
MLA_EDGE_TOL_BF16 are taken (a copy of this script in a checkout of
that tree, whose engine splits and ``kernel_checks`` differ).
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
BF16_FLOPS = 989e12                 # dense tensor-core bf16, H100 SXM
INT8_OPS = 1979e12                  # dense tensor-core int8, H100 SXM
FLASH_TOL_BF16 = 2e-2               # bf16 output ulp + bf16 weights per tile
FLASH_TOL_F32 = 1e-4                # summation order only
PAGED_TOL_BF16 = 2e-2
PAGED_TOL_F32 = 1e-4
# the PAGED_EDGES cases (bf16) are held to this as well: 3x the largest
# error the CUDA-core route read on them before the tensor-core chunk
# route existed (2.66e-3 on an H100), so that a causal mask one key off
# breaks it; each case plants that fault in the plain version and fails
# unless the fault lands outside (PERF.md §6).  The fault is the
# route's (PAGED_SHIFT): a chunk's rows each see one key MORE, a decode
# case's rows one key FEWER.  One key more is blind at decode: its query
# sits at kv_valid - 1, which masks the extra key, and reads exactly 0
PAGED_EDGE_TOL_BF16 = 8e-3
PAGED_SHIFT = {"chunk": 1, "decode": -1}
# MLA partials, combined: the kernel rounds its weights to bf16 as the
# plain version does, but from float32 exponents computed in another
# order, so a weight may land one bf16 step away; outputs are weighted
# means of pool rows of magnitude ~1
MLA_TOL_BF16 = 2e-2
MLA_TOL_F32 = 1e-4                  # summation order only
# the MLA_EDGES cases (bf16, fp / int8 / int4 latent pools) are held to
# this: 3x the largest error the CUDA-core route (FMA, the bf16 route
# before the tensor-core one) read on the same cases on an H100, 2.88e-3
# (PERF.md §6).  Two faults are planted in the plain version: the k_rope
# half left out of the score must land outside it in every case, and a
# causal limit one key off in every case but MLA_SHIFT_BLIND's
MLA_EDGE_TOL_BF16 = 8.63e-3
# the MLA_EDGES cases in which the one-key causal shift lands inside
# MLA_EDGE_TOL_BF16 on their seeded pools (one key among the ~8 k of a
# slot at P 256, page 32, moves the output by 0.0069-0.0079 there; the
# other 177 cases read at least 0.0095 on an H100, PERF.md §6)
MLA_SHIFT_BLIND = frozenset({"fp_P256_ps32_c2_sq1", "int8_P256_ps32_c2_sq1",
                             "int4_P256_ps32_c8_sq1"})
# the quantized kernels (phase 2c) dequantize each element exactly as
# their plain versions do (one float32 multiply by the row scale, one
# rounding to the query type) and then run the fp kernels' score and
# softmax code: the fp kernels' tolerances carry over.  At one page a
# split the quantized MLA kernel is expected bitwise equal to its plain
# version, as the fp one was (PERF.md's kernel table, row 4)
QPAGED_TOL_BF16, QPAGED_TOL_F32 = PAGED_TOL_BF16, PAGED_TOL_F32
QMLA_TOL_BF16, QMLA_TOL_F32 = MLA_TOL_BF16, MLA_TOL_F32
# teacher-forced logits of the 27-layer bf16 deepseek-v2-lite-dense engine
# against the plain naive-form forward, as a share of the row's largest
# |logit|.  The engine computes decode in the absorbed form (q_c = q_nope
# W_UK rounded to bf16, context in the latent space, then W_UV), the plain
# forward in the expanded form, so the two round in different places.
SERVE_MLA_REL_TOL = 5e-2
# teacher-forced logits, 36 bf16 layers: |engine - plain| <= this share of
# the row's largest |logit| (bf16 keeps ~3 significant digits per op)
SERVE_REL_TOL_BF16 = 5e-2
# phase 13's qwen3-8b: its q_norm / k_norm weights, which the init leaves
# at ones (where exchanging the two, or normalizing after RoPE, changes
# nothing), are drawn as exp(QK_NORM_SPREAD * N(0, 1)) from a seeded
# generator.  The planted fault, the plain forward with q_norm and k_norm
# exchanged (RoPE between the norm and the score makes the exchange
# visible), must land QK_FAULT_MARGIN times outside each logit bound.  The
# spread trades the two: a wider one moves the faulty logits further, but
# sharpens attention until bf16 rounding noise alone nears the bound
# (PERF.md §6 reads the margin on the card)
QK_NORM_SPREAD = 0.25
QK_FAULT_MARGIN = 1.3
# integer formats re-round every activation row to a few bits, so a
# difference of one ulp turns into a whole quantization step (1/127 of
# the row's absmax at a8) wherever it crosses a rounding boundary, and
# the engine's and the plain forward's rounding noise is amplified more
# than in bf16.  Their logits are held to this multiple of a noise floor
# measured in the same run without any port kernel: the plain forward
# against the plain forward with attention on widened inputs (float32
# for bf16, float64 for float32), which differs only in where attention
# rounds.  The bound is at least SERVE_REL_TOL_BF16 in bf16 and
# SERVE_REL_TOL_F32 in float32 (where a request may see no rounding flip
# at all, and the floor is 0).  The factor lies between two readings on
# an H100 (PERF.md): the sound engine's largest error over the
# floor, 1.22 (2-layer f32), and a planted fault's, 1.51-1.82 (full-depth
# bf16, one activation scale per call, by the largest row error; by the
# RMS of the row errors, see INT_FAULT_MARGIN, 1.75-1.87).
SERVE_INT_NOISE_FACTOR = 1.5
SERVE_REL_TOL_F32 = 1e-5            # float32 summation order only
# quantized KV pools (phase 10): teacher-forced logits against the plain
# forward that quantizes and dequantizes each K/V (or latent) row as the
# pool stores it, held to this multiple of a noise floor no port kernel
# enters (that forward against itself with widened attention), and at
# least the fp path's own bound.  The engine's rows are computed in other
# GEMM shapes than the plain forward's, and a rounding difference in a
# row can move one of its integers a whole step, as at w8a8; the integer
# formats' factor was kept, stated before the first run.  It lies
# between two readings on an H100 (PERF.md): the sound engine's largest
# error over its floor, 1.18 (qwen2.5-3b int4), and the smallest the
# planted fault reaches, 2.19 (MLA int4; every row's scale rolled by one
# within its page, handed to the kernel), which must land outside the
# bound in every run.
SERVE_KV_NOISE_FACTOR = 1.5
# pool bytes of a quantized format over the bf16 pool's: int8 moves K/V
# rows to 1 byte an element (+4 bytes of scale a row), int4 to half
POOL_RATIO_LIMIT = {"int8": 0.51, "int4": 0.26}
# faults planted in the plain integer path that the bound above must
# reject in every run: one activation scale per call instead of one per
# row, and the activation scale left out of the epilogue
INT_FAULTS = ("per_tensor_x_scale", "no_x_scale")
# the integer check holds the engine to two statistics of its logits'
# row errors, the largest and the mean square over positions
# (``int_stats``), each within SERVE_INT_NOISE_FACTOR times its own
# floor (for the mean square, an RMS within sqrt(1.5) = 1.22x the
# floor's); a planted fault must land at least this factor outside one of
# the two bounds on the scale of the errors (the mean square's ratio is
# taken as an RMS ratio, its square root), so that no rounding change of
# the engine can carry it inside by chance
INT_FAULT_MARGIN = 1.3
# packed matmuls: the integer kernel sums exactly in int32 and applies the
# same two float32 multiplies as its plain version, so it must be bitwise
# equal.  The weight-only kernel sums exact float32 products in another
# order than the plain version and rounds once to bf16: the two may land
# one bf16 step apart, i.e. up to 2^-8 of the output's largest |value|;
# the bound allows two steps.
MM_REL_TOL_BF16 = 2 ** -7
MM_ROWS = (8, 2048)                 # decode step; 8 slots x 256-token wave
# weight-only kernel: every route and both of the narrow route's x tiles
WO_ROWS = (1, 3, 8, 12, 16, 64, 100, 2048)
# integer kernel: one and two x tiles of the narrow route, the 16/17
# switch between the routes, a ragged last row tile of the wide one
INT_ROWS = (1, 3, 8, 12, 16, 17, 100, 2048)
# (K, N) of wq/wo, wk/wv, w_gate/w_up, w_down and lm_head of qwen2.5-3b
MM_SHAPES = ((2048, 2048), (2048, 256), (2048, 11008), (11008, 2048),
             (2048, 152064))
INT_FORMATS = ((8, 8), (8, 4), (8, 2), (4, 4), (4, 2), (2, 2))


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
    """Per-launch CUDA-event timing with the 50 MB L2 flushed first.

    A spin of ~1 ms on the card follows the flush, so that the host has
    queued the whole call (the wrapper's checks, allocations and launches)
    before the card reaches the start event: the window then holds device
    time only.  Without it a call shorter than the host's enqueue time
    would read that enqueue time instead.  A host pause longer than the
    spin still lands in its window (on an H100 one 0.011 ms call once
    read 0.167 ms as the mean of five), so the reading is the median of
    the windows."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

# the route each kernel record names: the bf16 flash forward and the bf16
# weight-only matmul run on tensor cores (the route chosen by dtype, and
# for the matmul by M, before launch; see the .cu heads), everything else
# on the CUDA cores
FLASH_DESIGN = {"bf16": "mma.sync m16n8k16 bf16, 2-slot cp.async K/V ring "
                        "(FA2, 4 warps x 16 query rows)",
                "f32": "FMA, flash_tile.cuh (f32 route)"}
WO_DESIGN = {"rows": "mma.sync m16n8k16 bf16, 4-slot cp.async ring, 128x128 "
                     "tiles of 4 warps (64x64)",
             "cols": "mma.sync m16n8k16 bf16 on W^T x^T, 4-slot cp.async "
                     "ring, split-K"}
# the paged GQA kernel's routes (`pick_route` in its .cu, chosen before
# launch by dtype, bits and Sq * G rows): bf16 on any pool (fp, int8 or
# int4) runs on tensor cores, decode rows (<= 16) on the one-tile route
# and chunks on the FA2 ring, float32 on the CUDA cores; a quantized
# pool's bf16 routes widen its raw rows to bf16 in shared memory
PAGED_DESIGN = {"chunk": "mma.sync m16n8k16 bf16, 2-slot cp.async K/V ring "
                         "through the page table (FA2, 4 warps x 16 query "
                         "rows)",
                "decode": "mma.sync m16n8k16 bf16, the <= 16 query rows as "
                          "one m16 tile, one cp.async 64-key K/V tile "
                          "through the page table (4 warps x 16 keys in S, "
                          "x dv/4 columns in O), one tile a split",
                "f32": "FMA (CUDA cores), flash_tile.cuh (f32 route)"}
QPAGED_DESIGN = dict(PAGED_DESIGN,
                     chunk="mma.sync m16n8k16 bf16, 2-slot cp.async ring of "
                           "the raw int rows and their scales through the "
                           "page table, widened into one bf16 K/V slot "
                           "(FA2, 4 warps x 16 query rows)",
                     decode="mma.sync m16n8k16 bf16, the <= 16 query rows as "
                            "one m16 tile, one cp.async 64-key tile of the "
                            "raw int rows and their scales through the page "
                            "table, widened into bf16 K/V tiles (4 warps x "
                            "16 keys in S, x dv/4 columns in O), one tile a "
                            "split")
# the MLA kernels' routes (`dispatch_dtype` in their .cu, chosen before
# launch by dtype alone, on fp, int8 and int4 latent pools alike)
MLA_DESIGN = {"bf16": "mma.sync m16n8k16 bf16, one cp.async 64-key tile "
                      "through the page table that is key and value (4 "
                      "warps x 16 keys in S, x 128 columns in O; a "
                      "quantized tile widened in shared memory)",
              "f32": "FMA (CUDA cores)"}
INT_DESIGN = {"rows": "mma.sync m16n8k32 s8, 4-slot cp.async ring, 128x128 "
                      "tiles of 4 warps (64x64)",
              "cols": "mma.sync m16n8k32 s8 on W^T x^T, 4-slot cp.async "
                      "ring, split-K"}
# bf16 flash edge shapes, at every HEAD_DIMS pair beside the engine's:
# (B, Sq = Skv, kv_valid or None); the ragged last query tile, one query,
# kv_valid short of Skv (and of the query rows), one sequence
FLASH_EDGES = ((8, 1, None), (8, 63, None), (8, 65, None), (8, 188, None),
               (8, 188, 150), (8, 256, 200), (8, 65, 17), (1, 256, None),
               (1, 188, 100))
# paged edge cases, untimed, at every HEAD_DIMS pair (KV 2; KV = H = 16
# at 192 / 128), on a pool with a hole mid-table, a mapped page past a
# slot's position and an inactive slot: query positions (1 and 2 are 8
# and 16 decode rows at G 8, 3 the first chunk there; 17 rows straddle
# the 16-row switch between the routes at G 1; 65 and 188 leave a ragged
# last tile), pages a split (1-3 leave splits shorter than a 64-key
# tile, 4 at page 16 and 2 at page 32 are one tile, 8 is several; None:
# the engine's choice) and page sizes, with P pages of 2048 / ps rows a
# slot
PAGED_EDGES_SQ = (1, 2, 3, 17, 65, 188, 256)
PAGED_EDGES_C = (1, 2, 3, 4, 8, None)
PAGED_EDGES_PS = (16, 32)
# pages a split the paged kernel's decode route is timed at, in one Timer
# (qwen2.5-3b's decode: B 8, H 16, KV 2, dh 128, P 128, page 16)
PAGED_SWEEP_C = (1, 2, 4, 8)
# (H, KV) of the other GQA configs served (phase 13), at dh 128: qwen3-8b
# (G 4) and yi-34b (G 7, whose query heads end partway through the
# kernels' 16-row tiles).  Phase 2d runs every FLASH_EDGES case, every
# PAGED_EDGES case on fp, int8 and int4 pools, and the engine's calls at
# each (a resumed 256-row chunk takes 2 splits at H 32, 1 of all 128 pages
# at H 56)
GROUP_HEADS = {"qwen3-8b": (32, 8), "yi-34b": (56, 8)}
# (K, N) of yi-34b's w_up and w_down, for the weight-only kernel at w4
MM_SHAPES_YI = ((7168, 20480), (20480, 7168))
# MLA decode edge cases, untimed, in bf16 on fp, int8 and int4 latent
# pools (mla_case's pool: a hole, a page past its slot's position, an
# inactive slot, last pages partly filled): P pages a slot, page sizes,
# pages a split (1-3: splits shorter than the kernel's 64-key tile; 4 at
# page 16 and 2 at page 32: the engine's one tile; 8 at page 16, 3-8 at
# page 32: splits of several tiles) and query rows Sq x H (Sq 2: two
# 16-row tiles).  The c values are explicit, so that a tree whose engine
# splits otherwise runs the same cases (kernel_checks holds the engine's
# choice to be among them)
MLA_EDGES_P = (64, 128, 256)
MLA_EDGES_PS = (16, 32)
MLA_EDGES_C = (1, 2, 3, 4, 8)
MLA_EDGES_SQ = (1, 2)
# pages a split the MLA kernels are timed at, in one Timer (P 128, page 16)
MLA_SWEEP_C = (1, 2, 4, 8)


def check_flash(torch, timer, dtype, B=8, S=256, H=16, KV=2, dh=128,
                dv=None, kv_valid=None, timed=True):
    """The flash forward at q/k width ``dh`` and v width ``dv`` (default
    ``dh``; MLA's fresh chunk: 192 and 128), Sq = Skv = ``S``."""
    from repro_torch.kernels import flash_attention as fa
    dv = dv or dh
    kvv = S if kv_valid is None else kv_valid
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((B, S, n, d), generator=g, device="cuda")
               .to(dtype) for n, d in ((H, dh), (KV, dh), (KV, dv)))
    got = fa.flash_attention(q, k, v, kv_valid=kvv)
    want = fa.flash_attention_plain(q, k, v, kvv)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    bf16 = dtype == torch.bfloat16
    tol = FLASH_TOL_BF16 if bf16 else FLASH_TOL_F32
    name = f"flash_attention_fwd[{str(dtype).split('.')[-1]}, dk {dh}, " \
        f"dv {dv}, B {B}, Sq {S}, kv_valid {kvv}]"
    if not err <= tol:
        fail(f"{name}: max |kernel - plain| {err} > {tol}")
    rec = {"name": "flash_attention_fwd", "dtype": str(dtype),
           "design": FLASH_DESIGN["bf16" if bf16 else "f32"],
           "shapes": {"q": [B, S, H, dh], "k": [B, S, KV, dh],
                      "v": [B, S, KV, dv], "kv_valid": kvv},
           "max_abs_err": err, "tol": tol}
    if not (bf16 and timed):
        return rec
    run = lambda: fa.flash_attention(q, k, v, kv_valid=kvv)  # noqa: E731
    rec["kernel_ms"] = timer.ms(run)
    rec["plain_ms"] = timer.ms(lambda: fa.flash_attention_plain(q, k, v,
                                                                kvv))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = timer.ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                              enable_gqa=True))
    rec["library_ratio"] = rec["kernel_ms"] / rec["library_ms"]
    pairs = B * H * S * (S + 1) // 2
    nbytes = (B * S * H * (dh + dv) + B * S * KV * (dh + dv)) * \
        q.element_size()
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes,
                                                2 * (dh + dv) * pairs)
    return rec


def flash_edge_checks(torch, timer, H=16, KV=2, dh=128, dv=None):
    """The bf16 flash route at every FLASH_EDGES shape; untimed."""
    return {f"B{b}_Sq{sq}_kv{kvv}": check_flash(
        torch, timer, torch.bfloat16, B=b, S=sq, H=H, KV=KV, dh=dh, dv=dv,
        kv_valid=kvv, timed=False) for b, sq, kvv in FLASH_EDGES}


def flash_checks(torch, timer):
    """The bf16 flash route at every HEAD_DIMS pair: the engine's chunk
    (B 8, 256 rows, H 16, KV 2; KV = H = 16 at MLA's 192 / 128), timed,
    and every FLASH_EDGES shape."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    recs = {}
    for dk, dv in HEAD_DIMS:
        kv = 16 if dk != dv else 2
        recs[f"dk{dk}_dv{dv}"] = check_flash(torch, timer, torch.bfloat16,
                                             KV=kv, dh=dk, dv=dv)
        for key, rec in flash_edge_checks(torch, timer, KV=kv, dh=dk,
                                          dv=dv).items():
            recs[f"dk{dk}_dv{dv}_{key}"] = rec
    return recs


def paged_route(torch, dtype, Sq, H, KV):
    """The paged GQA kernel's route for a call on any pool (the .cu's
    `pick_route`): a key of PAGED_DESIGN and QPAGED_DESIGN."""
    from repro_torch.models.attention import DECODE_ROWS
    if dtype == torch.float32:
        return "f32"
    return "chunk" if Sq * (H // KV) > DECODE_ROWS else "decode"


def paged_split(B, Sq, H, KV, P, ps, dv):
    """The engine's pages a split for a GQA call
    (``models/attention.py::page_split``): one 64-key tile at decode,
    ``_pages_per_split`` for a chunk."""
    from repro_torch.models.attention import page_split
    return page_split(B, Sq, H, KV, P, ps, dv)


def paged_case(torch, dtype, B, Sq, H, KV, dh, ps, P, seed, dv=None,
               odd=False):
    """A pool as the serving engine leaves it: each slot maps distinct
    pages for its filled rows, the last query at qpos.  With ``odd``:
    slot 0 has a hole mid-table, slot 1 maps one page past its filled
    rows, the last slot is inactive (position -1, nothing filled, its
    pages still mapped); the others' fills spread over the table."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = B * P
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp, vp = (torch.randn((n, ps, KV, d), generator=g, device="cuda")
              .to(dtype) for d in (dh, dv or dh))
    q = torch.randn((B, Sq, H, dh), generator=g, device="cuda").to(dtype)
    fill = np.linspace(Sq + 24, P * ps - 8, B).astype(np.int64)
    tbl = np.full((B, P), -1, np.int32)
    perm = rng.permutation(n)
    k = 0
    for b in range(B):
        m = min(-(-int(fill[b]) // ps) + (odd and b == 1), P)
        tbl[b, :m] = perm[k:k + m]
        k += m
    qpos = (fill[:, None] - Sq + np.arange(Sq)[None, :]).astype(np.int32)
    if odd:
        tbl[0, 1] = -1                               # a hole
        qpos[-1] = -1                                # the inactive slot
        fill[-1] = 0
    kvv = fill.astype(np.int32)
    as_t = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
    return kp, vp, q, as_t(tbl), as_t(qpos), as_t(kvv), fill


def identities_exact(got, want):
    """Whether every split the plain version skips (m = -1e30) is the
    exact identities (-1e30, 0, 0) in ``got``."""
    skipped = want[0] <= -1e30
    return (bool((got[0][skipped] == -1e30).all())
            and bool((got[1][skipped] == 0).all())
            and bool((got[2][skipped] == 0).all())), skipped


def check_paged(torch, timer, dtype, Sq, B=8, H=16, KV=2, dh=128, ps=16,
                P=128, dv=None, c=None, odd=False, edge=False, timed=True):
    """The paged partials at q/k width ``dh`` and v width ``dv`` (default
    ``dh``; MLA's resumed chunk: 192 and 128 with KV = H); ``c`` pages a
    split (default: the engine's choice, ``paged_split``); ``odd``:
    paged_case's hole, page past a position and inactive slot; ``edge``: a
    PAGED_EDGES case, held to PAGED_EDGE_TOL_BF16, which the plain version
    with every active row seeing one key more (a chunk) or fewer
    (decode), PAGED_SHIFT, must break.  Timed in bf16 only."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials
    dv = dv or dh
    kp, vp, q, tbl, qpos, kvv, fill = paged_case(torch, dtype, B, Sq, H, KV,
                                                 dh, ps, P, seed=2 + Sq,
                                                 dv=dv, odd=odd)
    c = c or paged_split(B, Sq, H, KV, P, ps, dv)
    got = pfd.paged_flash_decode_partials(kp, vp, q, tbl, qpos, kvv,
                                          pages_per_split=c)
    want = pfd.paged_flash_decode_partials_plain(kp, vp, q, tbl, qpos, kvv, c)
    torch.cuda.synchronize()
    name = f"paged partials Sq={Sq} H={H} KV={KV} dk {dh} dv {dv} ps {ps} " \
        f"c {c} odd {odd} {dtype}"
    # skipped splits, and query rows that see no key in their split
    exact, skipped = identities_exact(got, want)
    if odd and not bool(skipped[-1].all()):
        fail(f"{name}: the inactive slot's plain partials are not skipped")
    if not exact:
        fail(f"{name}: skipped splits are not the exact identities "
             "(-1e30, 0, 0)")
    out = _combine_page_partials(*want)
    err = (_combine_page_partials(*got) - out).abs().max().item()
    tol = PAGED_TOL_BF16 if dtype == torch.bfloat16 else PAGED_TOL_F32
    if edge:
        tol = PAGED_EDGE_TOL_BF16
    if not err <= tol:
        fail(f"{name}: max |kernel - plain| {err} > {tol}")
    route = paged_route(torch, dtype, Sq, H, KV)
    rec = {"name": "paged_flash_decode_partials", "dtype": str(dtype),
           "route": route, "design": PAGED_DESIGN[route],
           "shapes": {"q": [B, Sq, H, dh], "pool": list(kp.shape),
                      "v_pool": list(vp.shape), "tbl": [B, P],
                      "pages_per_split": c, "odd": odd},
           "max_abs_err": err, "tol": tol,
           "skipped": int(skipped.sum().item())}
    if edge:
        rec["planted_shift"] = PAGED_SHIFT[route]
        rec["planted_shift_err"] = planted_shift_err(
            torch, lambda qp: pfd.paged_flash_decode_partials_plain(
                kp, vp, q, tbl, qp, kvv, c), qpos, out, tol, name,
            PAGED_SHIFT[route])
    del got, want, out
    if dtype != torch.bfloat16 or not timed:
        return rec
    rec["kernel_ms"] = timer.ms(lambda: pfd.paged_flash_decode_partials(
        kp, vp, q, tbl, qpos, kvv, pages_per_split=c))
    rec["plain_ms"] = timer.ms(lambda: pfd.paged_flash_decode_partials_plain(
        kp, vp, q, tbl, qpos, kvv, c))
    rec["library_ms"] = None
    rec["bound_ms"], rec["bound_by"], rec["live_rows"], \
        rec["partials_bytes"] = paged_bound(
            tbl.cpu().numpy(), qpos.cpu().numpy(), fill, ps, c, H, KV, dh,
            dv, q.element_size())
    return rec


def planted_shift_err(torch, plain, qpos, out, tol, name, shift):
    """A PAGED_EDGES case's planted fault: the combined output of
    ``plain(qpos)`` with every active row seeing ``shift`` keys more (1)
    or fewer (-1), against ``out``; it must land outside ``tol``."""
    from repro_torch.models.attention import _combine_page_partials
    shifted = torch.where(qpos >= 0, qpos + shift, qpos)
    err = (_combine_page_partials(*plain(shifted)) - out).abs().max().item()
    if not err > tol:
        fail(f"{name}: a causal mask {shift:+d} key off reads {err}, inside "
             f"the edge bound {tol}")
    return err


def edge_summary(phase, edges):
    """One line over PAGED_EDGES records: the cases, the largest error and
    the planted fault's smallest error of each route, the skipped rows."""
    def by(route, key, agg):
        return agg((r[key] for r in edges.values() if r["route"] == route),
                   default=None)
    return {"phase": phase, "cases": len(edges),
            "by_route": {route: {
                "cases": sum(r["route"] == route for r in edges.values()),
                "max_abs_err": by(route, "max_abs_err", max),
                "planted_shift": PAGED_SHIFT[route],
                "min_planted_shift_err": by(route, "planted_shift_err", min)}
                for route in ("chunk", "decode")},
            "skipped_rows": sum(r["skipped"] for r in edges.values()),
            "min_planted_shift_err": min(r["planted_shift_err"]
                                         for r in edges.values()),
            "tol": PAGED_EDGE_TOL_BF16}


def paged_edge_checks(torch, timer, H=16, KV=2, dh=128, dv=None, fmt=None):
    """The bf16 paged partials at every PAGED_EDGES case on paged_case's
    odd pool (with ``fmt``: quantized on the card, ``check_paged_quant``
    at dh 128), each within PAGED_EDGE_TOL_BF16 with the PAGED_SHIFT fault
    outside; untimed."""
    recs = {}
    for ps in PAGED_EDGES_PS:
        for sq in PAGED_EDGES_SQ:
            for c in PAGED_EDGES_C:
                recs[f"ps{ps}_sq{sq}_c{c or 'eng'}"] = check_paged(
                    torch, timer, torch.bfloat16, sq, H=H, KV=KV, dh=dh,
                    dv=dv, ps=ps, P=2048 // ps, c=c, odd=True, edge=True,
                    timed=False) if fmt is None else check_paged_quant(
                    torch, timer, torch.bfloat16, fmt, sq, c, ps=ps,
                    edge=True, H=H, KV=KV)
        torch.cuda.empty_cache()
    return recs


def quant_edge_summary(phase, edges, others, **extra):
    """Prints ``edge_summary`` of the quantized PAGED_EDGES records
    ``edges``, with, by route, whether every quantized GQA record of
    ``edges`` and ``others`` on a tensor-core route equals, bit for bit,
    the fp kernel's same route on its pool dequantized.  Returns the keys
    of the records that do not."""
    tc = {k: r for k, r in list(others.items()) + list(edges.items())
          if r["name"] == "paged_flash_decode_partials_quant"
          and r["route"] in ("chunk", "decode")}
    print(json.dumps(dict(edge_summary(phase, edges), **extra, **{
        f"{route}_fp_route_bitwise": {
            "cases": sum(r["route"] == route for r in tc.values()),
            "all": all(r["fp_route_bitwise"] for r in tc.values()
                       if r["route"] == route)}
        for route in ("chunk", "decode")})), flush=True)
    return [k for k, r in tc.items() if not r["fp_route_bitwise"]]


def paged_bound(tbl_np, qpos_np, fill, ps, c, H, KV, dh, dv, el,
                bits=None):
    """(bound ms, bound by, live rows, partials bytes) of a GQA paged call
    on ``paged_case``'s pool: the pages the kernel reads (mapped, below
    the fill, not after the slot's last query) at ``el`` bytes an element
    (or ``bits`` a lane and 8 bytes of k and v scales a row), the queries,
    table, positions and bounds, and every float32 partial written
    (identities too); the operations are the live (query, key) pairs'."""
    import numpy as np
    B, P = tbl_np.shape
    Sq = qpos_np.shape[1]
    live_rows = ps * sum(1 for b in range(B) for j in range(P)
                         if tbl_np[b, j] >= 0 and j * ps < fill[b]
                         and j * ps <= qpos_np[b].max())
    mapped = np.repeat(tbl_np >= 0, ps, axis=1)              # (B, P*ps)
    kpos = np.arange(P * ps)
    pairs = int(sum(((kpos[None, :] <= qpos_np[b][:, None])
                     & (kpos[None, :] < fill[b]) & mapped[b][None, :]).sum()
                    for b in range(B)))
    row = KV * (dh + dv) * el if bits is None else \
        KV * (dh + dv) * bits / 8 + 8
    partials = B * Sq * H * -(-P // c) * (2 + dv) * 4
    nbytes = (live_rows * row + B * Sq * H * dh * el + B * P * 4
              + B * Sq * 4 + B * 4 + partials)
    ms, by = bound_ms(nbytes, 2 * (dh + dv) * H * pairs)
    return ms, by, live_rows, partials


def paged_sweep(torch, timer, B=8, H=16, KV=2, dh=128, ps=16, P=128):
    """The bf16 paged kernel's decode route on fp, int8 and int4 pools at
    qwen2.5-3b's decode (one query a slot, quant_gqa_case's pool: a hole,
    a page past a slot's filled rows and an inactive slot; the quantized
    pools are that pool quantized on the card), timed at each
    PAGED_SWEEP_C pages a split in one Timer, beside each split's bound
    and the time of the combine that follows the kernel in the engine
    (``_combine_page_partials`` on its partials); the kernel is checked
    against its plain version at each.  Reads nothing of the engine's
    split, so a copy of this script times a parent tree's kernel too."""
    from repro_torch.core.pageformat import INT4, INT8
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials
    dt = torch.bfloat16
    kf, vf, q, tbl, qpos, kvv, fill = paged_case(torch, dt, B, 1, H, KV, dh,
                                                 ps, P, seed=41, odd=True)
    tbl_np, qpos_np = tbl.cpu().numpy(), qpos.cpu().numpy()
    recs = {}
    for fmt in (None, INT8, INT4):
        kp, vp, kw = kf, vf, {}
        if fmt is not None:
            kp, ks = fmt.quantize_rows(kf)
            vp, vs = fmt.quantize_rows(vf)
            kw = dict(k_scale=ks, v_scale=vs, bits=fmt.bits)
        name = "fp" if fmt is None else fmt.name
        for c in PAGED_SWEEP_C:
            run = lambda: pfd.paged_flash_decode_partials(  # noqa: E731
                kp, vp, q, tbl, qpos, kvv, pages_per_split=c, **kw)
            got = run()
            want = pfd.paged_flash_decode_partials_plain(
                kp, vp, q, tbl, qpos, kvv, c, **kw)
            err = (_combine_page_partials(*got)
                   - _combine_page_partials(*want)).abs().max().item()
            if not err <= PAGED_TOL_BF16:
                fail(f"paged sweep {name} c={c}: max |kernel - plain| {err} "
                     f"> {PAGED_TOL_BF16}")
            del want
            b_ms, b_by, live, partials = paged_bound(
                tbl_np, qpos_np, fill, ps, c, H, KV, dh, dh, 2,
                None if fmt is None else fmt.bits)
            recs[f"{name}_c{c}"] = {
                "pool": name, "pages_per_split": c, "kernel_ms":
                timer.ms(run), "bound_ms": b_ms, "bound_by": b_by,
                "combine_ms": timer.ms(
                    lambda: _combine_page_partials(*got)),
                "partials_bytes": partials, "live_rows": live,
                "max_abs_err": err}
            del got
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "paged_sweep", "shapes": {
        "B": B, "Sq": 1, "H": H, "KV": KV, "dh": dh, "page": ps, "P": P},
        "cases": recs}), flush=True)
    return recs


def sweep_verdict(recs, engine_c):
    """Per pool of a paged sweep: the engine's split, the fastest split,
    and the engine's time over the fastest (the split is kept if it is
    within 10%; PERF.md says why otherwise)."""
    out = {}
    for pool in ("fp", "int8", "int4"):
        ms = {c: recs[f"{pool}_c{c}"]["kernel_ms"] for c in PAGED_SWEEP_C}
        best = min(ms, key=ms.get)
        out[pool] = {"engine_c": engine_c, "fastest_c": best,
                     "engine_over_fastest": ms[engine_c] / ms[best]}
    return out


def mla_case(torch, dtype, B, H, r, dr, ps, P, seed, Sq=1):
    """A latent pool as the serving engine leaves it, with the odd cases:
    slot 0 has an unmapped page mid-table, slot 1 a mapped page wholly
    past its position, the last slot is inactive (position -1, empty
    table); the other positions spread over the table, the last page
    partly filled.  ``Sq`` query rows a slot, all at its position."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = B * P
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = torch.randn((n, ps, r + dr), generator=g, device="cuda").to(dtype)
    q_c = torch.randn((B, Sq, H, r), generator=g, device="cuda").to(dtype)
    q_r = torch.randn((B, Sq, H, dr), generator=g, device="cuda").to(dtype)
    pos = np.linspace(ps + 3, P * ps - 5, B).astype(np.int64)
    tbl = np.full((B, P), -1, np.int32)
    perm = rng.permutation(n)
    k = 0
    for b in range(B - 1):
        m = int(pos[b]) // ps + 1 + (b == 1)        # slot 1: one page more
        m = min(m, P)
        tbl[b, :m] = perm[k:k + m]
        k += m
    tbl[0, 1] = -1                                   # a hole
    pos[-1] = -1
    as_t = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
    return pool, q_c, q_r, as_t(tbl), as_t(pos.astype(np.int32)), tbl, pos


def mla_split(ps, P, B=8, H=16, r=512):
    """The engine's MLA decode split (``models/mla.py::decode_split``) for
    one query a slot."""
    from repro_torch.models.mla import decode_split
    return decode_split(ps, B, 1, H, P, r)


def mla_route(torch, dtype):
    """The MLA kernels' route for a call (their .cu's `dispatch_dtype`):
    a key of MLA_DESIGN."""
    return "bf16" if dtype == torch.bfloat16 else "f32"


def mla_bound(pos_np, tbl_np, P, ps, c, B, H, r, dr, el, row_bytes):
    """(bound ms, bound by, live rows, partials bytes) of an MLA decode
    call (one query a slot): the live rows (mapped, at or before the
    slot's position) read once at ``row_bytes`` each, the queries, table
    and positions, and every float32 partial written (identities too)."""
    live = sum(min(int(p) + 1, (j + 1) * ps) - j * ps
               for b, p in enumerate(pos_np) for j in range(P)
               if tbl_np[b, j] >= 0 and j * ps <= p)
    n_split = -(-P // c)
    partials = B * H * n_split * (2 + r) * 4
    nbytes = (live * row_bytes + B * H * (r + dr) * el + B * P * 4 + B * 4
              + partials)
    ms, by = bound_ms(nbytes, 2 * H * (2 * r + dr) * live)
    return ms, by, live, partials


def check_mla(torch, timer, dtype, P, B=8, H=16, r=512, dr=64, ps=16,
              scale_dim=192, c=None):
    """The compressed-space MLA partials at deepseek-v2-lite's widths,
    ``P`` pages a slot; ``c`` pages a split (default: the engine's
    choice, one 64-key tile).  Only the default split is timed."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials
    pool, q_c, q_r, tbl, pos, tbl_np, pos_np = mla_case(
        torch, dtype, B, H, r, dr, ps, P, seed=20 + P)
    timed = c is None
    c = c or mla_split(ps, P, B, H, r)
    run = lambda: pfd.mla_paged_decode_partials(  # noqa: E731
        pool, q_c, q_r, tbl, pos, r, scale_dim, pages_per_split=c)
    plain = lambda: pfd.mla_paged_decode_partials_plain(  # noqa: E731
        pool, q_c, q_r, tbl, pos, r, scale_dim, c)
    got, want = run(), plain()
    torch.cuda.synchronize()
    exact, skipped = identities_exact(got, want)
    if not (bool(skipped[-1].all()) and exact):
        fail(f"mla partials P={P} ps={ps} c={c} {dtype}: skipped pages are "
             "not the exact identities (-1e30, 0, 0)")
    # the inactive last slot's combined output is 0 in both; compare all
    err = (_combine_page_partials(*got) - _combine_page_partials(*want)) \
        .abs().max().item()
    tol = MLA_TOL_BF16 if dtype == torch.bfloat16 else MLA_TOL_F32
    if not err <= tol:
        fail(f"mla partials P={P} ps={ps} c={c} {dtype}: max |kernel - "
             f"plain| {err} > {tol}")
    route = mla_route(torch, dtype)
    rec = {"name": "mla_paged_decode_partials", "dtype": str(dtype),
           "route": route, "design": MLA_DESIGN[route],
           "shapes": {"q_c": [B, 1, H, r], "q_rope": [B, 1, H, dr],
                      "pool": list(pool.shape), "tbl": [B, P],
                      "pages_per_split": c},
           "max_abs_err": err, "tol": tol}
    del got, want
    if dtype != torch.bfloat16 or not timed:
        return rec
    rec["kernel_ms"] = timer.ms(run)
    rec["plain_ms"] = timer.ms(plain)
    rec["library_ms"] = None
    el = pool.element_size()
    rec["bound_ms"], rec["bound_by"], rec["live_rows"], \
        rec["partials_bytes"] = mla_bound(pos_np, tbl_np, P, ps, c, B, H, r,
                                          dr, el, (r + dr) * el)
    return rec


def mla_sweep(torch, timer, B=8, H=16, r=512, dr=64, ps=16, P=128,
              scale_dim=192):
    """The bf16 MLA kernels on fp, int8 and int4 latent pools at the
    engine's decode shapes (mla_case's positions, P 128, page 16), timed
    at each MLA_SWEEP_C pages a split in one Timer, beside each split's
    bound and the time of the combine that follows the kernel in the
    engine (``_combine_page_partials`` on its partials); the kernel is
    checked against its plain version at each."""
    from repro_torch.core.pageformat import INT4, INT8
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials
    recs = {}
    for fmt in (None, INT8, INT4):
        pool, q_c, q_r, tbl, pos, tbl_np, pos_np = mla_case(
            torch, torch.bfloat16, B, H, r, dr, ps, P, seed=20 + P)
        kw, row_bytes = {}, (r + dr) * 2
        if fmt is not None:
            pq, psc = fmt.quantize_rows(pool)
            pool, kw = pq, dict(scale_pool=psc, bits=fmt.bits)
            row_bytes = (r + dr) * fmt.bits / 8 + 4
        name = "fp" if fmt is None else fmt.name
        for c in MLA_SWEEP_C:
            run = lambda: pfd.mla_paged_decode_partials(  # noqa: E731
                pool, q_c, q_r, tbl, pos, r, scale_dim, pages_per_split=c,
                **kw)
            got = run()
            want = pfd.mla_paged_decode_partials_plain(
                pool, q_c, q_r, tbl, pos, r, scale_dim, c, **kw)
            err = (_combine_page_partials(*got)
                   - _combine_page_partials(*want)).abs().max().item()
            if not err <= MLA_TOL_BF16:
                fail(f"mla sweep {name} c={c}: max |kernel - plain| {err} "
                     f"> {MLA_TOL_BF16}")
            del want
            b_ms, b_by, live, partials = mla_bound(
                pos_np, tbl_np, P, ps, c, B, H, r, dr, 2, row_bytes)
            recs[f"{name}_c{c}"] = {
                "pool": name, "pages_per_split": c, "kernel_ms":
                timer.ms(run), "bound_ms": b_ms, "bound_by": b_by,
                "combine_ms": timer.ms(
                    lambda: _combine_page_partials(*got)),
                "partials_bytes": partials, "live_rows": live,
                "max_abs_err": err}
            del got
        del pool
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "mla_sweep", "shapes": {
        "B": B, "H": H, "r": r, "dr": dr, "page": ps, "P": P},
        "cases": recs}), flush=True)
    return recs


def mla_edge_case(torch, fmt, P, ps, c, Sq, B=8, H=16, r=512, dr=64,
                  scale_dim=192):
    """One MLA_EDGES case in bf16 on mla_case's pool (quantized on the
    card by ``fmt``, or fp for None): the kernel against its plain
    version, the exact identities, the two planted faults in the plain
    version (every active slot seeing one key more; q_rope zeroed, i.e.
    the k_rope half left out of the score) and, on a quantized pool,
    the kernel on the pool dequantized by ``PageFormat.dequantize``,
    which must give the same bits.  Returns the record; the caller holds
    it to its bounds."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials
    dt = torch.bfloat16
    pool, q_c, q_r, tbl, pos, _, _ = mla_case(
        torch, dt, B, H, r, dr, ps, P, seed=80 + P + ps + c + Sq, Sq=Sq)
    kw, fp = {}, None
    if fmt is not None:
        pq, psc = fmt.quantize_rows(pool)
        del pool
        pool, kw = pq, dict(scale_pool=psc, bits=fmt.bits)

    def plain(pos_=pos, q_r_=q_r):
        return pfd.mla_paged_decode_partials_plain(
            pool, q_c, q_r_, tbl, pos_, r, scale_dim, c, **kw)
    got = pfd.mla_paged_decode_partials(pool, q_c, q_r, tbl, pos, r,
                                        scale_dim, pages_per_split=c, **kw)
    if fmt is not None:
        fp = pfd.mla_paged_decode_partials(
            fmt.dequantize(pool, kw["scale_pool"], dt), q_c, q_r, tbl, pos,
            r, scale_dim, pages_per_split=c)
    want = plain()
    torch.cuda.synchronize()
    exact, skipped = identities_exact(got, want)
    out = _combine_page_partials(*want)
    err = (_combine_page_partials(*got) - out).abs().max().item()
    shifted = torch.where(pos >= 0, pos + 1, pos)
    faults = {
        "shift": (_combine_page_partials(*plain(pos_=shifted)) - out)
        .abs().max().item(),
        "no_rope": (_combine_page_partials(*plain(q_r_=torch.zeros_like(q_r)))
                    - out).abs().max().item()}
    rec = {"name": "mla_paged_decode_partials"
           + ("" if fmt is None else "_quant"),
           "pool": "fp" if fmt is None else fmt.name, "route": "bf16",
           "shapes": {"q_c": [B, Sq, H, r], "pool": list(pool.shape),
                      "tbl": [B, P], "pages_per_split": c},
           "max_abs_err": err, "identities_exact": exact,
           "inactive_skipped": bool(skipped[-1].all()),
           "skipped": int(skipped.sum().item()), "planted": faults}
    if fp is not None:
        rec["fp_route_bitwise"] = bool(all(torch.equal(a, b)
                                           for a, b in zip(got, fp)))
    return rec


def mla_edge_checks(torch):
    """The bf16 MLA kernels at every MLA_EDGES case on fp, int8 and int4
    latent pools; untimed.  Every record is printed first, then each case
    is held: within MLA_EDGE_TOL_BF16, the k_rope fault outside it, the
    causal shift outside it but in the MLA_SHIFT_BLIND cases, skipped
    splits the exact identities, and every quantized case bit for bit the
    fp route on its pool dequantized."""
    from repro_torch.core.pageformat import INT4, INT8
    recs = {}
    for fmt in (None, INT8, INT4):
        for P in MLA_EDGES_P:
            for ps in MLA_EDGES_PS:
                for c in MLA_EDGES_C:
                    for sq in MLA_EDGES_SQ:
                        key = f"{'fp' if fmt is None else fmt.name}_P{P}" \
                            f"_ps{ps}_c{c}_sq{sq}"
                        recs[key] = mla_edge_case(torch, fmt, P, ps, c, sq)
            torch.cuda.empty_cache()
    for key, rec in recs.items():
        print(json.dumps(dict(phase="kernel_mla_edge", case=key, **rec)),
              flush=True)
    quant = [r for r in recs.values() if "fp_route_bitwise" in r]
    print(json.dumps({
        "phase": "mla_edges", "cases": len(recs),
        "max_abs_err": {p: max(r["max_abs_err"] for r in recs.values()
                               if r["pool"] == p)
                        for p in ("fp", "int8", "int4")},
        "min_planted": {f: min(r["planted"][f] for r in recs.values())
                        for f in ("shift", "no_rope")},
        "shift_outside": sum(r["planted"]["shift"] > MLA_EDGE_TOL_BF16
                             for r in recs.values()),
        "shift_inside": sorted(k for k, r in recs.items()
                               if r["planted"]["shift"] <= MLA_EDGE_TOL_BF16),
        "skipped_rows": sum(r["skipped"] for r in recs.values()),
        "quant_fp_route_bitwise": all(r["fp_route_bitwise"] for r in quant),
        "tol": MLA_EDGE_TOL_BF16}), flush=True)
    for key, rec in recs.items():
        if not (rec["identities_exact"] and rec["inactive_skipped"]):
            fail(f"mla edge {key}: skipped splits are not the exact "
                 "identities (-1e30, 0, 0)")
        if not rec["max_abs_err"] <= MLA_EDGE_TOL_BF16:
            fail(f"mla edge {key}: max |kernel - plain| "
                 f"{rec['max_abs_err']} > {MLA_EDGE_TOL_BF16}")
        if not rec["planted"]["no_rope"] > MLA_EDGE_TOL_BF16:
            fail(f"mla edge {key}: the k_rope half left out of the score "
                 f"reads {rec['planted']['no_rope']}, inside the edge bound "
                 f"{MLA_EDGE_TOL_BF16}")
        if key not in MLA_SHIFT_BLIND and \
                not rec["planted"]["shift"] > MLA_EDGE_TOL_BF16:
            fail(f"mla edge {key}: the causal limit one key off reads "
                 f"{rec['planted']['shift']}, inside the edge bound "
                 f"{MLA_EDGE_TOL_BF16}")
        if rec.get("fp_route_bitwise") is False:
            fail(f"mla edge {key}: the quantized kernel differs from the fp "
                 "route on the dequantized pool")


# ---------------------------------------------------------------------------
# Phase 2c: the quantized paged kernels against their plain versions.
# ---------------------------------------------------------------------------

def quant_gqa_case(torch, dtype, fmt, Sq, B=8, H=16, KV=2, dh=128, ps=16,
                   P=128, seed=0, fresh=False):
    """``paged_case``'s odd pool at qwen2.5-3b's widths (a hole, a page
    past a slot's filled rows, an inactive slot), its K/V quantized on the
    card by the port's ``PageFormat``.  ``fresh``: a fresh chunk instead,
    as the engine sends one on a quantized pool (at offset 0): every
    slot's Sq rows at positions 0..Sq-1 on its first ceil(Sq / ps) pages,
    the rest of its table unmapped."""
    import numpy as np
    kf, vf, q, tbl, qpos, kvv, fill = paged_case(torch, dtype, B, Sq, H, KV,
                                                 dh, ps, P, seed,
                                                 odd=not fresh)
    if fresh:
        tbl[:, -(-Sq // ps):] = -1
        qpos = torch.arange(Sq, dtype=torch.int32,
                            device="cuda").repeat(B, 1)
        kvv = torch.full((B,), Sq, dtype=torch.int32, device="cuda")
        fill = np.full(B, Sq)
    kq, ks = fmt.quantize_rows(kf)
    vq, vs = fmt.quantize_rows(vf)
    return (kq, vq, ks, vs, q, tbl, qpos, kvv, tbl.cpu().numpy(),
            qpos.cpu().numpy(), fill)


def check_paged_quant(torch, timer, dtype, fmt, Sq, c=None, timed=False,
                      ps=16, edge=False, fresh=False, H=16, KV=2):
    """The quantized GQA kernel at qwen2.5-3b's widths (or ``H`` / ``KV``
    heads at dh 128), 2048 / ps pages a slot, on quant_gqa_case's pool;
    ``c`` pages a split (default: the engine's choice, ``paged_split``).
    Each case is held against the plain version and its skipped splits
    and rows that see no key to the exact identities; a bf16 record
    (chunk or decode route) says whether it equals, bit for bit, the fp
    kernel's same route on the same pool dequantized to ``dtype`` by
    ``PageFormat.dequantize``, which quant_kernel_checks requires.
    ``edge``: held to PAGED_EDGE_TOL_BF16, which the plain version with
    every active row seeing one key more (a chunk) or fewer (decode),
    PAGED_SHIFT, must break (a PAGED_EDGES case, or the fresh chunk).
    ``fresh``: quant_gqa_case's fresh chunk."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials
    B, dh, P = 8, 128, 2048 // ps
    kq, vq, ks, vs, q, tbl, qpos, kvv, tbl_np, qpos_np, fill = \
        quant_gqa_case(torch, dtype, fmt, Sq, H=H, KV=KV, ps=ps, P=P,
                       seed=40 + Sq, fresh=fresh)
    if c is None:
        c = paged_split(B, Sq, H, KV, P, ps, dh)
    kw = dict(k_scale=ks, v_scale=vs, bits=fmt.bits)
    run = lambda: pfd.paged_flash_decode_partials(  # noqa: E731
        kq, vq, q, tbl, qpos, kvv, pages_per_split=c, **kw)
    plain = lambda: pfd.paged_flash_decode_partials_plain(  # noqa: E731
        kq, vq, q, tbl, qpos, kvv, c, **kw)
    got, want = run(), plain()
    route = paged_route(torch, dtype, Sq, H, KV)
    fp = None
    if route != "f32":
        fp = pfd.paged_flash_decode_partials(
            fmt.dequantize(kq, ks, dtype), fmt.dequantize(vq, vs, dtype), q,
            tbl, qpos, kvv, pages_per_split=c)
    torch.cuda.synchronize()
    name = f"quant paged partials {fmt.name} Sq={Sq} H={H} KV={KV} " \
        f"ps={ps} c={c} fresh={fresh} {dtype} ({route} route)"
    exact, skipped = identities_exact(got, want)
    if not fresh and not bool(skipped[-1].all()):
        fail(f"{name}: the inactive slot's plain partials are not skipped")
    if not exact:
        fail(f"{name}: skipped splits are not the exact identities "
             "(-1e30, 0, 0)")
    out = _combine_page_partials(*want)
    err = (_combine_page_partials(*got) - out).abs().max().item()
    tol = QPAGED_TOL_BF16 if dtype == torch.bfloat16 else QPAGED_TOL_F32
    if edge:
        tol = PAGED_EDGE_TOL_BF16
    if not err <= tol:
        fail(f"{name}: max |kernel - plain| {err} > {tol}")
    rec = {"name": "paged_flash_decode_partials_quant", "dtype": str(dtype),
           "format": fmt.name, "route": route,
           "design": QPAGED_DESIGN[route],
           "shapes": {"q": [B, Sq, H, dh], "pool": list(kq.shape),
                      "tbl": [B, P], "pages_per_split": c, "fresh": fresh},
           "max_abs_err": err, "tol": tol,
           "bitwise": bool(all(torch.equal(a, b) for a, b in zip(got, want))),
           "skipped": int(skipped.sum().item())}
    if fp is not None:
        rec["fp_route_bitwise"] = bool(all(torch.equal(a, b)
                                           for a, b in zip(got, fp)))
    if edge:
        rec["planted_shift"] = PAGED_SHIFT[route]
        rec["planted_shift_err"] = planted_shift_err(
            torch, lambda qp: pfd.paged_flash_decode_partials_plain(
                kq, vq, q, tbl, qp, kvv, c, **kw), qpos, out, tol, name,
            PAGED_SHIFT[route])
    del got, want, fp, out
    if not timed:
        return rec
    rec["kernel_ms"] = timer.ms(run)
    rec["plain_ms"] = timer.ms(plain)
    rec["library_ms"] = None
    rec["bound_ms"], rec["bound_by"], rec["live_rows"], \
        rec["partials_bytes"] = paged_bound(
            tbl_np, qpos_np, fill, ps, c, H, KV, dh, dh, q.element_size(),
            fmt.bits)
    return rec


def check_mla_quant(torch, timer, dtype, fmt, P=128, ps=16, c=None,
                    timed=False, B=8, H=16, r=512, dr=64, scale_dim=192):
    """The quantized MLA kernel at deepseek-v2-lite's widths on
    ``mla_case``'s pool quantized on the card (a hole, a page past its
    slot's position, an inactive slot); ``c`` pages a split (default:
    the engine's choice, one 64-key tile).  The record says whether the
    kernel equals, bit for bit, the fp kernel on the same pool
    dequantized to ``dtype`` by ``PageFormat.dequantize``, which
    quant_kernel_checks requires of the bf16 route."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials
    pool, q_c, q_r, tbl, pos, tbl_np, pos_np = mla_case(
        torch, dtype, B, H, r, dr, ps, P, seed=60 + P + ps)
    pq, psc = fmt.quantize_rows(pool)
    del pool
    c = c or mla_split(ps, P, B, H, r)
    kw = dict(scale_pool=psc, bits=fmt.bits)
    run = lambda: pfd.mla_paged_decode_partials(  # noqa: E731
        pq, q_c, q_r, tbl, pos, r, scale_dim, pages_per_split=c, **kw)
    plain = lambda: pfd.mla_paged_decode_partials_plain(  # noqa: E731
        pq, q_c, q_r, tbl, pos, r, scale_dim, c, **kw)
    got, want = run(), plain()
    fp = pfd.mla_paged_decode_partials(
        fmt.dequantize(pq, psc, dtype), q_c, q_r, tbl, pos, r, scale_dim,
        pages_per_split=c)
    torch.cuda.synchronize()
    name = f"quant mla partials {fmt.name} P={P} ps={ps} c={c} {dtype}"
    exact, skipped = identities_exact(got, want)
    if not (bool(skipped[-1].all()) and exact):
        fail(f"{name}: skipped pages are not the exact identities "
             "(-1e30, 0, 0)")
    err = (_combine_page_partials(*got) - _combine_page_partials(*want)) \
        .abs().max().item()
    tol = QMLA_TOL_BF16 if dtype == torch.bfloat16 else QMLA_TOL_F32
    if not err <= tol:
        fail(f"{name}: max |kernel - plain| {err} > {tol}")
    route = mla_route(torch, dtype)
    rec = {"name": "mla_paged_decode_partials_quant", "dtype": str(dtype),
           "format": fmt.name, "route": route, "design": MLA_DESIGN[route],
           "shapes": {"q_c": [B, 1, H, r], "q_rope": [B, 1, H, dr],
                      "pool": list(pq.shape), "tbl": [B, P],
                      "pages_per_split": c},
           "max_abs_err": err, "tol": tol,
           "bitwise": bool(all(torch.equal(a, b) for a, b in zip(got, want))),
           "fp_route_bitwise": bool(all(torch.equal(a, b)
                                        for a, b in zip(got, fp)))}
    del got, want, fp
    if not timed:
        return rec
    rec["kernel_ms"] = timer.ms(run)
    rec["plain_ms"] = timer.ms(plain)
    rec["library_ms"] = None
    rec["bound_ms"], rec["bound_by"], rec["live_rows"], \
        rec["partials_bytes"] = mla_bound(
            pos_np, tbl_np, P, ps, c, B, H, r, dr, q_c.element_size(),
            (r + dr) * fmt.bits / 8 + 4)
    return rec


def quant_kernel_checks(torch, timer):
    """Phase 2c: both quantized kernels at int8 and int4, bf16 and
    float32, the engine's split and one page a split and two and three
    (the GQA kernel at decode and on a resumed chunk; the MLA kernel also
    at page 32); then the GQA kernel in bf16 on a fresh chunk at the
    engine's split and at every PAGED_EDGES case, each held to
    PAGED_EDGE_TOL_BF16 with the planted fault outside.  The engine's
    choices are timed in bf16.  Each bf16 GQA case, on the chunk or the
    decode route, must equal the fp kernel's same route on its pool
    dequantized, bit for bit (the quantized routes add no arithmetic but
    the dequantizing): held once every record is printed, so that a
    failing run shows each case's comparison."""
    from repro_torch.core.pageformat import INT4, INT8
    recs, edges = {}, {}
    for fmt in (INT8, INT4):
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for sq in (1, 256):
                # c None: the engine's split (4 at decode, one 64-key
                # tile; 32 at Sq 256); c 1: the reference's per-page
                # partials (the engine's decode split before the tile)
                for c in (None, 1, 2, 3):
                    recs[f"gqa_{fmt.name}_sq{sq}_c{c or 'eng'}_{tag}"] = \
                        check_paged_quant(torch, timer, dt, fmt, sq, c,
                                          timed=c is None and tag == "bf16")
            # c None: the engine's split (one 64-key tile); c 1: the
            # reference's per-page partials; (32, 2): the tile at page 32
            for ps, c in ((16, None), (16, 1), (16, 2), (16, 3), (32, 1),
                          (32, 2)):
                recs[f"mla_{fmt.name}_ps{ps}_c{c or 'eng'}_{tag}"] = \
                    check_mla_quant(torch, timer, dt, fmt, ps=ps, c=c,
                                    timed=c is None and tag == "bf16")
            torch.cuda.empty_cache()
        recs[f"gqa_{fmt.name}_fresh_sq256_ceng_bf16"] = check_paged_quant(
            torch, timer, torch.bfloat16, fmt, 256, timed=True, edge=True,
            fresh=True)
        for key, rec in paged_edge_checks(torch, timer, fmt=fmt).items():
            edges[f"gqa_{fmt.name}_{key}"] = rec
    for rec in list(recs.values()) + list(edges.values()):
        print(json.dumps(dict(phase="kernel_quant", **rec)), flush=True)
    apart = quant_edge_summary("quant_paged_edges", edges, recs)
    # the MLA kernel's bf16 route on a quantized pool, likewise
    apart += [k for k, r in recs.items() if k.startswith("mla_")
              and r["route"] == "bf16" and not r["fp_route_bitwise"]]
    if apart:
        fail(f"quantized tensor-core route differs from the fp route on the "
             f"dequantized pool: {apart}")
    return recs


# ---------------------------------------------------------------------------
# Phase 2d: the kernels at the group sizes and widths of phase 13's models.
# ---------------------------------------------------------------------------

def group_checks(torch, timer):
    """Phase 2d: the attention kernels at each GROUP_HEADS (H, KV), dk = dv
    = 128, and the weight-only matmul at yi-34b's MLP widths.  Untimed:
    phase 2's and 2c's edge cases (``flash_edge_checks``,
    ``paged_edge_checks`` on fp, int8 and int4 pools) under the same
    tolerances and faults.  Timed, beside their bounds: the flash forward
    on the engine's 256-row chunk; the paged partials at decode and on a
    resumed 256-row chunk, the quantized ones on a resumed and a fresh
    chunk, all at the engine's split; the decode route at each
    PAGED_SWEEP_C split on fp, int8 and int4 pools (``paged_sweep``);
    ``wo_matmul`` w4 on w_up and w_down at M in MM_ROWS.  Returns the
    records by arch; prints the seconds it took."""
    from repro_torch.core.pageformat import INT4, INT8
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    out = {}
    for arch, (H, KV) in GROUP_HEADS.items():
        recs = {"flash": check_flash(torch, timer, bf16, H=H, KV=KV),
                "decode": check_paged(torch, timer, bf16, 1, H=H, KV=KV),
                "resumed": check_paged(torch, timer, bf16, 256, H=H, KV=KV)}
        for fmt in (INT8, INT4):
            recs[f"resumed_{fmt.name}"] = check_paged_quant(
                torch, timer, bf16, fmt, 256, timed=True, H=H, KV=KV)
            recs[f"fresh_{fmt.name}"] = check_paged_quant(
                torch, timer, bf16, fmt, 256, timed=True, edge=True,
                fresh=True, H=H, KV=KV)
        fedges = flash_edge_checks(torch, timer, H=H, KV=KV)
        edges = paged_edge_checks(torch, timer, H=H, KV=KV)
        qedges = {f"{fmt.name}_{key}": rec for fmt in (INT8, INT4)
                  for key, rec in paged_edge_checks(torch, timer, H=H, KV=KV,
                                                    fmt=fmt).items()}
        for key, rec in list(recs.items()) + list(fedges.items()) + \
                list(edges.items()) + list(qedges.items()):
            print(json.dumps(dict(phase="kernel_group", arch=arch, case=key,
                                  **rec)), flush=True)
        print(json.dumps(dict(edge_summary(f"paged_edges {arch}", edges),
                              heads=[H, KV])), flush=True)
        print(json.dumps({"phase": f"flash_edges {arch}", "heads": [H, KV],
                          "cases": len(fedges), "max_abs_err": max(
                              r["max_abs_err"] for r in fedges.values()),
                          "tol": FLASH_TOL_BF16}), flush=True)
        apart = quant_edge_summary(f"quant_paged_edges {arch}", qedges, recs,
                                   heads=[H, KV])
        if apart:
            fail(f"{arch}: quantized tensor-core route differs from the fp "
                 f"route on the dequantized pool: {apart}")
        sweep = paged_sweep(torch, timer, H=H, KV=KV)
        verdict = sweep_verdict(sweep, paged_split(8, 1, H, KV, 128, 16, 128))
        print(json.dumps({"phase": "paged_split_verdict", "arch": arch,
                          "pools": verdict}), flush=True)
        out[arch] = dict(recs, sweep=sweep)
    out["yi-34b"]["wo_matmul"] = {
        f"M{m}_K{k}_N{n}": check_matmul(torch, timer, "wo_matmul", m, k, n,
                                        16, 4, seed=900 + i)
        for i, (m, (k, n)) in enumerate((m, kn) for m in MM_ROWS
                                        for kn in MM_SHAPES_YI)}
    for key, rec in out["yi-34b"]["wo_matmul"].items():
        print(json.dumps(dict(phase="kernel_group", arch="yi-34b", case=key,
                              **rec)), flush=True)
    print(json.dumps({"phase": "group_checks",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 5: the packed matmuls against their plain versions.
# ---------------------------------------------------------------------------

def mm_cases():
    """(kernel, M, K, N, a_bits, w_bits) of every phase-5 case."""
    cases = []
    for m in MM_ROWS:
        for k, n in MM_SHAPES:
            fmts = INT_FORMATS if (k, n) == (11008, 2048) else \
                ((8, 8), (8, 4))
            cases += [("mpq_matmul", m, k, n, a, w) for a, w in fmts]
            cases += [("wo_matmul", m, k, n, 16, w) for w in (8, 4, 2)]
    # the weight-only kernel's two bf16 routes at other row counts (one
    # row, ragged rows below and above the 16-row switch, one and two x
    # tiles of the narrow route), untimed
    for m in WO_ROWS:
        if m not in MM_ROWS:
            cases += [("wo_matmul", m, k, n, 16, w) for k, n in MM_SHAPES
                      for w in (8, 4, 2)]
    # the integer kernel's two routes at other row counts, untimed
    for m in INT_ROWS:
        if m not in MM_ROWS:
            for k, n in MM_SHAPES:
                fmts = INT_FORMATS if (k, n) == (11008, 2048) else \
                    ((8, 8), (8, 4))
                cases += [("mpq_matmul", m, k, n, a, w) for a, w in fmts]
    return cases


def check_matmul(torch, timer, kind, M, K, N, a_bits, w_bits, seed):
    from repro_torch.core.packing import pack, unpack
    from repro_torch.core.quant import QuantConfig, quantize_activation
    from repro_torch.kernels import mpq_matmul as mm
    from repro_torch.kernels.ops import prepare_weight
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    if kind == "wo_matmul":
        pw = prepare_weight(w, QuantConfig(mode="wo", w_bits=w_bits))
        ws = pw.scale[None, :]
        run = lambda: mm.wo_matmul(x, pw.packed, ws,  # noqa: E731
                                   w_bits=w_bits)
        plain = lambda: mm.wo_matmul_plain(x, pw.packed,  # noqa: E731
                                           ws, w_bits=w_bits)
        fmt = f"w{w_bits}a16"
        ins = [x, pw.packed, ws]
        out_bytes, peak = M * N * 2, BF16_FLOPS
    else:
        pw = prepare_weight(w, QuantConfig(mode="int", a_bits=a_bits,
                                           w_bits=w_bits))
        xq, xs = quantize_activation(x, a_bits)
        if a_bits < 8:
            xq = pack(xq, a_bits, axis=1)
        ws = pw.scale[None, :]
        run = lambda: mm.mpq_matmul(xq, xs, pw.packed,  # noqa: E731
                                    ws, a_bits=a_bits, w_bits=w_bits)
        plain = lambda: mm.mpq_matmul_plain(  # noqa: E731
            xq, xs, pw.packed, ws, a_bits=a_bits, w_bits=w_bits)
        fmt = f"w{w_bits}a{a_bits}"
        ins = [xq, xs, pw.packed, ws]
        out_bytes, peak = M * N * 4, INT8_OPS
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if kind == "mpq_matmul":
        tol = 0.0
        if not torch.equal(got, want):
            fail(f"mpq_matmul {fmt} M={M} K={K} N={N}: not bitwise equal "
                 f"to its plain version (max |diff| {err})")
    else:
        tol = MM_REL_TOL_BF16 * want.float().abs().max().item()
        if not err <= tol:
            fail(f"wo_matmul {fmt} M={M} K={K} N={N}: max |kernel - plain| "
                 f"{err} > {tol}")
    design = (INT_DESIGN if kind == "mpq_matmul" else WO_DESIGN)[
        "cols" if M <= 16 else "rows"]
    rec = {"name": kind, "format": fmt, "design": design,
           "shapes": {"M": M, "K": K, "N": N}, "max_abs_err": err,
           "tol": tol}
    if M not in MM_ROWS:
        return rec
    rec["kernel_ms"] = timer.ms(run, iters=5, warmup=1)
    rec["plain_ms"] = timer.ms(plain, iters=3, warmup=1)
    # no PyTorch call computes either packed function, so library_ms is
    # None; one call on the unpacked operands is timed beside it as a
    # yardstick, here and nowhere in the port
    rec["library_ms"] = None
    if kind == "wo_matmul":
        w_deq = (unpack(pw.packed, w_bits, axis=0).float()
                 * pw.scale).to(torch.bfloat16).contiguous()
        call = "torch.matmul(x, pre-dequantized bf16 weight)"
        ms = timer.ms(lambda: x @ w_deq, iters=5, warmup=1)
        del w_deq
    else:
        call, ms = int_yardstick(torch, timer, xq, a_bits, pw.packed, w_bits)
    rec["yardstick"] = {"call": call, "ms": ms}
    nbytes = sum(t.numel() * t.element_size() for t in ins) + out_bytes
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 2.0 * M * K * N,
                                                peak)
    return rec


def int_yardstick(torch, timer, xq, a_bits, w_packed, w_bits):
    """The integer matmul's yardstick, (call, ms): ``torch._int_mm`` on
    the unpacked int8 operands, which computes the int32 sum only, not
    the packed function.  It takes more than 16 rows, so a shorter x is
    padded with zero rows to 32."""
    from repro_torch.core.packing import unpack
    xi = torch.nn.functional.pad(unpack(xq, a_bits, axis=1),
                                 (0, 0, 0, max(32 - xq.shape[0], 0)))
    xi, wi = xi.contiguous(), unpack(w_packed, w_bits, axis=0).contiguous()
    ms = timer.ms(lambda: torch._int_mm(xi, wi), iters=5, warmup=1)
    return ("torch._int_mm on unpacked int8 operands (x zero-padded to 32 "
            "rows at M <= 16): the int32 sum only"), ms


# ---------------------------------------------------------------------------
# Phases 3-4 and 6-7: the serving path.
# ---------------------------------------------------------------------------

def plain_quantized_matmul(torch, x, pw, quant, fault=None):
    """``ops.quantized_matmul`` with the plain versions of the kernels,
    written out here so that the reference shares no dispatch with the
    path it checks.  ``fault`` (one of INT_FAULTS) plants a fault in the
    integer path."""
    from repro_torch.core.packing import pack, pack_factor
    from repro_torch.core.quant import quantize, quantize_activation
    from repro_torch.kernels import mpq_matmul as mm
    lead = x.shape[:-1]
    kp = pw.packed.shape[0] * pack_factor(pw.w_bits)
    x2 = torch.nn.functional.pad(x.reshape(-1, pw.k), (0, kp - pw.k))
    if quant.mode == "int":
        if fault == "per_tensor_x_scale":
            xq, xs = quantize(x2, quant.a_bits)
            xs = xs.float().expand(x2.shape[0], 1).contiguous()
        else:
            xq, xs = quantize_activation(x2, quant.a_bits)
        if fault == "no_x_scale":
            xs = torch.ones_like(xs)
        if quant.a_bits < 8:
            xq = pack(xq, quant.a_bits, axis=1)
        out = mm.mpq_matmul_plain(xq, xs, pw.packed, pw.scale[None, :],
                                  a_bits=quant.a_bits, w_bits=pw.w_bits)
        out = out.to(x.dtype)
    else:
        out = mm.wo_matmul_plain(x2, pw.packed, pw.scale[None, :],
                                 w_bits=pw.w_bits)
    return out[:, :pw.n].reshape(*lead, pw.n)


def plain_dense(torch, x, w, quant, bias=None, fault=None):
    from repro_torch.kernels.ops import PackedWeight
    y = (plain_quantized_matmul(torch, x, w, quant, fault)
         if isinstance(w, PackedWeight) else x @ w)
    return y if bias is None else y + bias.to(y.dtype)


def widened_attention(q, k, v):
    """The plain attention on inputs widened to float32 (bf16 inputs) or
    float64 (float32 inputs), rounded back once: the same function as the
    plain version, rounded in other places.  No port kernel runs."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    wide = torch.float32 if q.dtype == torch.bfloat16 else torch.float64
    return flash_attention_plain(q.to(wide), k.to(wide),
                                 v.to(wide)).to(q.dtype)


def plain_forward(torch, params, cfg, tokens, attention=None, fault=None):
    """Contiguous forward of one sequence with the plain attention and,
    for packed weights, the plain matmuls (no pool, no page table, no
    kernel): (S, padded_vocab) logits.  With ``cfg.qk_norm`` each head of
    q and k is RMS-normed by ``q_norm`` / ``k_norm`` before RoPE.
    ``attention`` replaces the plain attention (``widened_attention``
    measures rounding noise); ``fault`` plants one of INT_FAULTS in every
    packed dense."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    attention = attention or flash_attention_plain
    from repro_torch.models.blocks import apply_norm
    from repro_torch.models.common import embed_lookup, rms_norm, rope
    if cfg.mlp_act != "silu_glu":
        fail(f"plain_forward covers SwiGLU MLPs, not {cfg.mlp_act}")
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qc = cfg.quant
    dense = lambda x, w, b=None: plain_dense(torch, x, w, qc, b,  # noqa
                                             fault)
    dev = params.embed.device
    tok = torch.tensor([tokens], device=dev)
    s = tok.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    x = embed_lookup(params.embed, tok)
    for blk in params.blocks:
        a, f = blk.attn, blk.ffn
        y = apply_norm(blk.ln1, x, cfg)
        q = dense(y, a["wq"], a.get("bq")).reshape(1, s, h, dh)
        k = dense(y, a["wk"], a.get("bk")).reshape(1, s, kv, dh)
        if cfg.qk_norm:
            q, k = rms_norm(q, a["q_norm"]), rms_norm(k, a["k_norm"])
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        v = dense(y, a["wv"], a.get("bv")).reshape(1, s, kv, dh)
        o = attention(q, k, v)
        x = x + dense(o.reshape(1, s, h * dh), a["wo"])
        y = apply_norm(blk.ln2, x, cfg)
        g = torch.nn.functional.silu(dense(y, f["w_gate"]).float())
        x = x + dense(g.to(x.dtype) * dense(y, f["w_up"]), f["w_down"])
    x = apply_norm(params.final_norm, x, cfg)
    return dense(x, params.lm_head)[0]


def row_errs(got, ref):
    """Each row's max |got - ref| / max |ref| in the row (a NaN counts as
    infinite)."""
    import torch
    d = (got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)
    return torch.nan_to_num(d, nan=float("inf"))


def rel_err(got, ref) -> float:
    """Largest over rows of max |got - ref| / max |ref| in the row."""
    return row_errs(got, ref).max().item()


def int_stats(got, ref) -> dict:
    """The integer check's statistics of ``row_errs``: ``max`` over rows
    and ``mean_sq``, the mean over positions of the squared row errors.
    At full depth in bf16 rounding noise reaches every row, and a fault
    that coarsens every row (a per-tensor activation scale) lands only
    1.5-1.9x the noise floor by any statistic linear in the errors; the
    mean square weighs error energy, where that is 2.3-3.5x."""
    e = row_errs(got, ref)
    return {"max": e.max().item(), "mean_sq": e.square().mean().item()}


def int_logit_check(torch, params, cfg, seq, start, got, base_tol, tag,
                    rid):
    """Hold an integer format's teacher-forced logits ``got`` (float32 on
    the CPU, rows ``start:`` of ``seq``) against the plain forward, by
    each statistic of ``int_stats``: within SERVE_INT_NOISE_FACTOR times
    the same statistic of the kernel-free noise floor (and at least
    ``base_tol``, squared for the mean square).  Every planted fault of
    INT_FAULTS must land outside at least one of the two bounds by
    INT_FAULT_MARGIN, on the errors' scale: ``fault_over_bound`` holds
    the fault's max over the max bound and its RMS over the RMS bound
    (the square root of the mean squares' ratio).  Returns the record,
    the plain logits, the widened-attention logits and the bounds."""
    def fwd(**kw):
        out = plain_forward(torch, params, cfg, seq, **kw)[start:]
        return out.float().cpu()

    ref = fwd()
    alt = fwd(attention=widened_attention)
    floor, err = int_stats(alt, ref), int_stats(got, ref)
    lowest = {"max": base_tol, "mean_sq": base_tol ** 2}
    tol = {s: max(lowest[s], SERVE_INT_NOISE_FACTOR * v)
           for s, v in floor.items()}
    faults = {f: int_stats(fwd(fault=f), ref) for f in INT_FAULTS}
    rec = {"rid": rid, "max_rel_err": err["max"],
           "mean_sq_rel_err": err["mean_sq"],
           "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float()
           .mean().item(), "noise_floor": floor["max"],
           "mean_sq_noise_floor": floor["mean_sq"], "rel_tol": tol["max"],
           "mean_sq_rel_tol": tol["mean_sq"], "faults": faults,
           "fault_over_bound": {f: {"max": e["max"] / tol["max"],
                                    "rms": math.sqrt(e["mean_sq"]
                                                     / tol["mean_sq"])}
                                for f, e in faults.items()}}
    for s, v in err.items():
        if not v <= tol[s]:
            fail(f"{tag}: request {rid}: teacher-forced logits read {v} "
                 f"by {s} of the row errors (> {tol[s]}; {rec})")
    for f, ratios in rec["fault_over_bound"].items():
        if not max(ratios.values()) >= INT_FAULT_MARGIN:
            fail(f"{tag}: request {rid}: planted fault {f} lands at "
                 f"{ratios} of the bounds, not {INT_FAULT_MARGIN}x "
                 f"outside either: the check cannot see it ({rec})")
    return rec, ref, alt, tol


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


def drive(torch, eng, requests, counters):
    """Submit every request, then tick until all are done.  Returns the
    wall seconds and each counter's (name -> zero-argument function)
    increase over a decode-only tick."""
    for r in requests:
        eng.submit(r)
    per_decode = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_work():
        before = {n: c() for n, c in counters.items()}
        n0 = eng.n_dispatches
        prefill_due = eng.sched.has_pending() or eng.sched.has_prefill_work()
        eng.tick()
        if eng.n_dispatches - n0 == 1 and not prefill_due:
            per_decode = {n: c() - before[n] for n, c in counters.items()}
    torch.cuda.synchronize()
    return time.perf_counter() - t0, per_decode


def weight_bytes(params) -> int:
    """Bytes of a model's weights: raw tensors and packed payloads."""
    from repro_torch.kernels.ops import PackedWeight
    return sum(t.numel() * t.element_size() for t in params.parameters()) \
        + sum(m.nbytes for m in params.modules()
              if isinstance(m, PackedWeight))


def memory(torch) -> dict:
    """The card's peak allocation since the last reset, and its size."""
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card_total_bytes": torch.cuda.get_device_properties(0)
            .total_memory}


def swap_qk_norms(torch, params):
    """Exchange every layer's ``q_norm`` and ``k_norm`` in place."""
    with torch.no_grad():
        for blk in params.blocks:
            qn = blk.attn["q_norm"].clone()
            blk.attn["q_norm"].copy_(blk.attn["k_norm"])
            blk.attn["k_norm"].copy_(qn)


def qk_fault_check(torch, params, plain, r, tol, tag):
    """QK_NORM_SPREAD's planted fault on the finished request ``r``:
    ``plain(seq)`` with ``params``' q_norm and k_norm exchanged, against
    ``plain(seq)`` on its teacher-forced rows, as a share of the row max;
    it must reach QK_FAULT_MARGIN x ``tol``.  Returns (error, error /
    tol)."""
    seq = r.prompt + r.out_tokens[:-1]
    start = len(r.prompt) - 1
    ref = plain(seq)[start:].float().cpu()
    swap_qk_norms(torch, params)
    try:
        bad = plain(seq)[start:].float().cpu()
    finally:
        swap_qk_norms(torch, params)
    err = rel_err(bad, ref)
    if not err >= QK_FAULT_MARGIN * tol:
        fail(f"{tag}: request {r.rid}: q_norm and k_norm exchanged move the "
             f"logits by {err} of the row max, not {QK_FAULT_MARGIN}x the "
             f"bound {tol}: the check cannot see it")
    return err, err / tol


def serve(torch, card, cfg, params, tag):
    """Phase 3 (tag 'bf16', raw weights), 6 (a packed format) or 13 (any
    GQA arch): serve the smoke traffic through submit/tick/drain and
    check the result.  Prints the weights', the pool's and the card's
    bytes and the peak allocation; with ``cfg.qk_norm`` the planted
    QK_NORM_SPREAD fault must land outside the logit bound."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mpq_matmul as mm
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    sc = ServeConfig(max_batch=8, max_prompt=256, page_size=16, max_seq=2048,
                     max_new_tokens=32, record_logits=True)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, sc, device="cuda")
    eng.warmup()
    reqs = [Request(i, p) for i, p in enumerate(smoke_traffic(cfg.vocab_size))]
    kernels = {"flash_attention_fwd": fa, "paged_flash_decode_partials": pfd}
    mm_name = None
    if cfg.quant is not None:
        mm_name = "mpq_matmul" if cfg.quant.mode == "int" else "wo_matmul"
        kernels[mm_name] = mm
    for m in kernels.values():
        m.launches = 0
    mm.reduce_launches = 0
    counters = {n: (lambda m=m: m.launches) for n, m in kernels.items()}
    # the matmuls' second, split-K reduce kernel (counted apart)
    counters["matmul_split_k_reduce"] = lambda: mm.reduce_launches
    log = record_dispatches(eng, counters)
    wall, per_decode = drive(torch, eng, reqs, counters)
    eng.drain()
    launches = {n: c() for n, c in counters.items()}
    per_decode = per_decode or {n: None for n in counters}
    # each dispatch kind runs its one attention kernel once per layer: a
    # fresh wave the flash forward, a resumed wave the paged kernel's
    # chunk route, a decode step its decode route
    want = {"fresh": "flash_attention_fwd",
            "resumed": "paged_flash_decode_partials",
            "decode": "paged_flash_decode_partials"}
    attn = ("flash_attention_fwd", "paged_flash_decode_partials")
    kinds = {k: 0 for k in want}
    by_kind = {k: {n: 0 for n in counters} for k in want}
    for kind, got in log:
        kinds[kind] += 1
        for n in counters:
            by_kind[kind][n] += got[n]
        exp = {n: (cfg.n_layers if n == want[kind] else 0) for n in attn}
        if {n: got[n] for n in attn} != exp:
            fail(f"{tag}: a {kind} dispatch launched {got}, want {exp} of "
                 "the attention kernels")
    if min(kinds.values()) < 1:
        fail(f"{tag}: dispatch kinds {kinds}: each must run at least once")
    for r in reqs:
        if not r.done or r.failed or len(r.out_tokens) != sc.max_new_tokens:
            fail(f"{tag}: request {r.rid}: done={r.done} failed={r.failed} "
                 f"tokens={len(r.out_tokens)}")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"{tag}: {name} was not launched on the main path")
    if mm_name is not None:
        want = 7 * cfg.n_layers + 1          # every dense, lm_head included
        if per_decode[mm_name] != want:
            fail(f"{tag}: {mm_name} launched {per_decode[mm_name]} "
                 f"times in a decode dispatch, want {want}")
    if eng.n_shared_admissions < 1:
        fail(f"{tag}: the shared-prefix request was not admitted as a "
             "sharer")
    st = eng.stats()
    n_tok = sum(len(r.out_tokens) for r in reqs)
    packed = sum(m.nbytes for m in params.modules()
                 if isinstance(m, PackedWeight))
    print(json.dumps({"phase": "serve", "arch": cfg.name, "dtype": "bf16",
                      "quant": tag, "layers": cfg.n_layers,
                      "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
                      "tokens_per_s": n_tok / wall, "stats": st,
                      "packed_weight_bytes": packed,
                      "weight_bytes": weight_bytes(params),
                      "pool_bytes": eng.pool_bytes_per_shard(),
                      **memory(torch), "launches": launches,
                      "launches_per_decode_tick": per_decode,
                      "dispatches": kinds, "launches_by_kind": by_kind,
                      "card": card}), flush=True)
    # teacher-forced logits of two finished requests (the shared-prefix
    # one and the longest, both multi-chunk) against the plain forward
    errs = []
    with torch.inference_mode():
        for rid in (8, 0):
            r = reqs[rid]
            seq = r.prompt + r.out_tokens[:-1]
            start = len(r.prompt) - 1
            got = torch.from_numpy(np.stack(r.logits))
            if cfg.quant is not None and cfg.quant.mode == "int":
                errs.append(int_logit_check(torch, params, cfg, seq, start,
                                            got, SERVE_REL_TOL_BF16, tag,
                                            rid)[0])
                continue
            ref = plain_forward(torch, params, cfg, seq)
            ref = ref[start:].float().cpu()
            rel = rel_err(got, ref)
            agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
            errs.append({"rid": rid, "max_rel_err": rel,
                         "argmax_agree": agree,
                         "rel_tol": SERVE_REL_TOL_BF16})
            if cfg.qk_norm:
                errs[-1]["qk_fault"], errs[-1]["qk_fault_over_bound"] = \
                    qk_fault_check(torch, params, lambda sq: plain_forward(
                        torch, params, cfg, sq), r, SERVE_REL_TOL_BF16, tag)
            if not rel <= SERVE_REL_TOL_BF16:
                fail(f"{tag}: request {rid}: teacher-forced logits differ "
                     f"by {rel} of the row max (> {SERVE_REL_TOL_BF16})")
    print(json.dumps({"phase": "serve_check", "quant": tag,
                      "requests": errs}), flush=True)
    del eng
    torch.cuda.empty_cache()
    return launches, per_decode, by_kind


def serve_f32(torch, quant=None, seed=3):
    """Phases 4 and 7: a 2-layer float32 qwen2.5-3b, its weights drawn
    from ``seed``, through the engine;
    its greedy tokens must equal the plain forward's.  At an integer
    format the teacher-forced logits are held as in phase 6 (bound
    SERVE_INT_NOISE_FACTOR x the kernel-free floor, planted faults
    outside it), and a token may differ only at a position whose top-two
    gap in the plain forward is within twice the kernel-free noise at
    that position (max |widened - plain| over its row): two logits that
    each move by that much can swap there."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models.model import init_params, quantize_for_serving
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = get_config("qwen2.5-3b").with_(
        n_layers=2, pattern=(("scan", "attn_mlp", 2),), dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    if quant is not None:
        cfg = cfg.with_(quant=parse_quant(quant))
        params, _ = quantize_for_serving(cfg, params)
    is_int = cfg.quant is not None and cfg.quant.mode == "int"
    sc = ServeConfig(max_batch=4, max_prompt=256, page_size=16, max_seq=1024,
                     max_new_tokens=8, record_logits=is_int)
    eng = ServingEngine(cfg, params, sc, device="cuda")
    rng = np.random.RandomState(5)
    reqs = [Request(i, [int(t) for t in rng.randint(0, cfg.vocab_size, n)])
            for i, n in enumerate((40, 300, 600, 17, 260, 90))]
    eng.run(reqs)
    bad, ties, checks = [], [], []
    with torch.inference_mode():
        for r in reqs:
            seq = r.prompt + r.out_tokens[:-1]
            start = len(r.prompt) - 1
            if not is_int:
                ref = plain_forward(torch, params, cfg, seq)[start:]
                want = ref.argmax(-1).tolist()
                if want != r.out_tokens:
                    bad.append((r.rid, r.out_tokens, want))
                continue
            got = torch.from_numpy(np.stack(r.logits))
            rec, ref, alt, _ = int_logit_check(
                torch, params, cfg, seq, start, got, SERVE_REL_TOL_F32,
                f"f32 {quant}", r.rid)
            checks.append(rec)
            want = ref.argmax(-1).tolist()
            for i, (g, w) in enumerate(zip(r.out_tokens, want)):
                if g == w:
                    continue
                pos = {"rid": r.rid, "pos": i, "engine": g, "plain": w,
                       "gap": (ref[i, w] - ref[i, g]).item(),
                       "noise": (alt[i] - ref[i]).abs().max().item(),
                       "engine_diff": (got[i] - ref[i]).abs().max().item()}
                (ties if pos["gap"] <= 2 * pos["noise"] else bad).append(pos)
    print(json.dumps({"phase": "serve_f32", "quant": quant or "none",
                      "layers": 2, "requests": len(reqs),
                      "token_mismatches": len(bad) + len(ties),
                      "within_bound": ties, "logit_checks": checks}),
          flush=True)
    if bad:
        fail(f"f32 engine tokens ({quant}) differ from the plain forward: "
             f"{bad}")


# ---------------------------------------------------------------------------
# Phases 8-9: MLA serving (deepseek-v2-lite's widths, its dense block).
# ---------------------------------------------------------------------------

def plain_mla_forward(torch, params, cfg, tokens, kv_fmt=None,
                      attention=None):
    """Contiguous forward of one sequence in MLA's naive (expanded) form
    for every position, with the plain attention (no pool, no page
    table, no kernel): (S, padded_vocab) logits.  ``kv_fmt`` quantizes
    and dequantizes each latent row (c_kv and k_rope together) as a
    quantized pool stores it; ``attention`` replaces the plain
    attention."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    attention = attention or flash_attention_plain
    from repro_torch.models.blocks import apply_norm
    from repro_torch.models.common import embed_lookup, rms_norm, rope
    if cfg.mlp_act != "silu_glu":
        fail(f"plain_mla_forward covers SwiGLU MLPs, not {cfg.mlp_act}")
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = params.embed.device
    tok = torch.tensor([tokens], device=dev)
    s = tok.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    x = embed_lookup(params.embed, tok)
    for blk in params.blocks:
        a, f = blk.attn, blk.ffn
        y = apply_norm(blk.ln1, x, cfg)
        q = (y @ a["w_q"]).reshape(1, s, h, dn + dr)
        ckv = y @ a["w_dkv"]
        c = rms_norm(ckv[..., :r], a["kv_norm"])
        kr = rope(ckv[..., r:][:, :, None, :], pos, cfg.rope_theta)
        if kv_fmt is not None:
            row = kv_roundtrip(kv_fmt, torch.cat([c, kr[:, :, 0]], dim=-1))
            c, kr = row[..., :r], row[..., r:][:, :, None, :]
        k = torch.cat([(c @ a["w_uk"]).reshape(1, s, h, dn),
                       kr.expand(1, s, h, dr)], dim=-1)
        v = (c @ a["w_uv"]).reshape(1, s, h, dv)
        qq = torch.cat([q[..., :dn], rope(q[..., dn:], pos, cfg.rope_theta)],
                       dim=-1)
        o = attention(qq, k, v)
        x = x + o.reshape(1, s, h * dv) @ a["w_o"]
        y = apply_norm(blk.ln2, x, cfg)
        g = torch.nn.functional.silu((y @ f["w_gate"]).float())
        x = x + (g.to(x.dtype) * (y @ f["w_up"])) @ f["w_down"]
    x = apply_norm(params.final_norm, x, cfg)
    return (x @ params.lm_head)[0]


def mla_traffic(vocab: int, n: int = 16, seed: int = 1):
    """16 prompts of 288-1024 tokens, every one longer than the 256-token
    chunk budget, in shuffled order; request 8 repeats request 0's first
    512 tokens (a page-aligned shared prefix)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = np.linspace(288, 1024, n).astype(int)
    rng.shuffle(lens)
    lens[0] = 1024
    prompts = [[int(t) for t in rng.randint(0, vocab, int(m))] for m in lens]
    prompts[8] = prompts[0][:512] + [int(t) for t in
                                      rng.randint(0, vocab, 200)]
    return prompts


def record_dispatches(eng, counters, keep_args=False):
    """Wrap the engine's two steps so that every dispatch logs its kind
    ('fresh' / 'resumed' prefill wave, or 'decode') and each counter's
    increase over it.  With ``keep_args`` an entry also keeps what
    replays it on another engine (``replay``): (the step's name, its
    arguments after the weights and the cache, its logits as float32 on
    the CPU); the copy-on-write page copies between dispatches are
    logged too, as kind 'copies'.  Each wrapper keeps its step as
    ``__wrapped__``."""
    import weakref
    log = []

    def wrap(step, kind, name):
        def run(params, cache, *args):
            before = {n: c() for n, c in counters.items()}
            out = step(params, cache, *args)
            entry = (kind(args), {n: c() - before[n]
                                  for n, c in counters.items()})
            if keep_args:       # copies: a CPU page table is a view
                entry += ((name, tuple(a if a is None else a.clone()
                                       for a in args),
                           out[0].float().cpu()),)
            log.append(entry)
            return out
        run.__wrapped__ = step
        return run
    # a paged wave passes offsets last (None: fresh); the contiguous
    # engine's waves are all fresh and pass none.  The kinds read no
    # engine: a closure over it would keep it, its cache and its
    # weights alive after ``del eng`` until the cycle collector runs
    fresh_only = not eng.sc.paged
    eng._prefill = wrap(eng._prefill,
                        lambda a: "fresh" if fresh_only or a[-1] is None
                        else "resumed", "_prefill")
    eng._decode = wrap(eng._decode, lambda a: "decode", "_decode")
    if keep_args:
        ref = weakref.ref(eng)

        def copies(pairs):
            log.append(("copies", {}, ("_apply_copies", (list(pairs),),
                                       None)))
            return type(ref())._apply_copies(ref(), pairs)
        eng._apply_copies = copies
    return log


MLA_SERVE = dict(max_batch=8, max_prompt=256, page_size=16, max_seq=2048,
                 max_new_tokens=32, record_logits=True)


def mla_engine_logits(torch, cfg, params, prompts, fault=False):
    """Serve ``prompts`` on a fresh engine; with ``fault`` the MLA decode
    kernel is called with the softmax scale taken from r + dr instead of
    nope + rope.  Returns the finished requests."""
    from repro_torch.models import mla
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(**MLA_SERVE), device="cuda")
    reqs = [Request(i, p) for i, p in enumerate(prompts)]
    good = mla.mla_paged_decode_partials
    if fault:
        mla.mla_paged_decode_partials = (
            lambda pool, qc, qr, tbl, pos, r, scale_dim, **kw:
            good(pool, qc, qr, tbl, pos, r, pool.shape[-1], **kw))
    try:
        eng.run(reqs)
    finally:
        mla.mla_paged_decode_partials = good
    del eng
    torch.cuda.empty_cache()
    return reqs


def serve_mla(torch, card, cfg, params):
    """Phase 8: serve the dense deepseek-v2-lite variant at full width and
    depth in bf16 through submit/tick/drain: every request completes, the
    launch counts per dispatch are exact, and every request's
    teacher-forced logits match the plain naive-form forward within
    SERVE_MLA_REL_TOL, which the planted scale fault must exceed."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    n_layers = cfg.n_layers
    eng = ServingEngine(cfg, params, ServeConfig(**MLA_SERVE), device="cuda")
    eng.warmup()
    prompts = mla_traffic(cfg.vocab_size)
    reqs = [Request(i, p) for i, p in enumerate(prompts)]
    counters = {"flash_attention_fwd": lambda: fa.launches,
                "paged_flash_decode_partials": lambda: pfd.launches,
                "mla_paged_decode_partials": lambda: pfd.mla_launches}
    log = record_dispatches(eng, counters)
    fa.launches = pfd.launches = pfd.mla_launches = 0
    wall, per_decode = drive(torch, eng, reqs, counters)
    eng.drain()
    launches = {n: c() for n, c in counters.items()}
    for r in reqs:
        if not r.done or r.failed or \
                len(r.out_tokens) != MLA_SERVE["max_new_tokens"]:
            fail(f"mla: request {r.rid}: done={r.done} failed={r.failed} "
                 f"tokens={len(r.out_tokens)}")
    # each dispatch kind runs its one kernel once per layer, no other
    want = {"fresh": "flash_attention_fwd",
            "resumed": "paged_flash_decode_partials",
            "decode": "mla_paged_decode_partials"}
    kinds = {k: 0 for k in want}
    for kind, got in log:
        kinds[kind] += 1
        exp = {n: (n_layers if n == want[kind] else 0) for n in counters}
        if got != exp:
            fail(f"mla: a {kind} dispatch launched {got}, want {exp}")
    if min(kinds.values()) < 1:
        fail(f"mla: dispatch kinds {kinds}: each must run at least once")
    if eng.n_shared_admissions < 1:
        fail("mla: the shared-prefix request was not admitted as a sharer")
    st = eng.stats()
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(json.dumps({"phase": "serve_mla", "arch": cfg.name,
                      "dtype": "bf16", "layers": n_layers,
                      "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
                      "tokens_per_s": n_tok / wall, "stats": st,
                      "dispatches": kinds, "launches": launches,
                      "launches_per_decode_tick": per_decode,
                      "latent_pool_bytes": sum(
                          t.numel() * t.element_size()
                          for t in eng.cache[0].values()),
                      "card": card}), flush=True)
    del eng
    torch.cuda.empty_cache()
    # teacher-forced logits of every request against the plain naive-form
    # forward; the same engine with the planted scale fault, serving the
    # shared-prefix request and the longest, must land outside the bound
    checks = []
    bad = mla_engine_logits(torch, cfg, params, [prompts[0], prompts[8]],
                            fault=True)
    faulty = {0: bad[0], 8: bad[1]}
    with torch.inference_mode():
        for rid in range(len(reqs)):
            rec = {"rid": rid}
            runs = [("engine", reqs[rid])]
            if rid in faulty:
                runs.append(("fault", faulty[rid]))
            for tag, r in runs:
                seq = r.prompt + r.out_tokens[:-1]
                start = len(r.prompt) - 1
                got = torch.from_numpy(np.stack(r.logits))
                ref = plain_mla_forward(torch, params, cfg, seq)
                ref = ref[start:].float().cpu()
                rec[tag] = rel_err(got, ref)
                if tag == "engine":
                    rec["argmax_agree"] = (got.argmax(-1) == ref.argmax(-1)) \
                        .float().mean().item()
            rec["rel_tol"] = SERVE_MLA_REL_TOL
            checks.append(rec)
    print(json.dumps({"phase": "serve_mla_check", "requests": checks}),
          flush=True)
    for rec in checks:
        if not rec["engine"] <= SERVE_MLA_REL_TOL:
            fail(f"mla: request {rec['rid']}: teacher-forced logits differ "
                 f"by {rec['engine']} of the row max (> {SERVE_MLA_REL_TOL})")
        if "fault" in rec and not rec["fault"] > SERVE_MLA_REL_TOL:
            fail(f"mla: request {rec['rid']}: the planted scale fault moves "
                 f"the logits by {rec['fault']} of the row max, inside the "
                 f"bound {SERVE_MLA_REL_TOL}: the check cannot see it")
    return launches, per_decode


def serve_mla_f32(torch):
    """Phase 9: a 2-layer float32 deepseek-v2-lite-dense at full width
    through the engine; its greedy tokens must equal the plain naive-form
    forward's."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("deepseek-v2-lite-dense").with_(
        n_layers=2, pattern=(("scan", "mla_mlp", 2),), dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                         device="cuda")
    rng = np.random.RandomState(6)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (40, 300, 600, 17, 260, 90)]
    reqs = mla_engine_logits(torch, cfg, params, prompts)
    bad, gaps = [], []
    with torch.inference_mode():
        for r in reqs:
            seq = r.prompt + r.out_tokens[:-1]
            ref = plain_mla_forward(torch, params, cfg, seq)
            ref = ref[len(r.prompt) - 1:]
            top2 = ref.float().topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).min().item())
            want = ref.argmax(-1).tolist()
            if want != r.out_tokens:
                bad.append((r.rid, r.out_tokens, want))
    print(json.dumps({"phase": "serve_mla_f32", "layers": 2,
                      "requests": len(reqs),
                      "tokens": sum(len(r.out_tokens) for r in reqs),
                      "token_mismatches": len(bad),
                      "smallest_top2_gap": min(gaps)}), flush=True)
    if bad:
        fail(f"f32 MLA engine tokens differ from the plain forward: {bad}")


# ---------------------------------------------------------------------------
# Phases 10-11: serving on quantized KV pools (both models).
# ---------------------------------------------------------------------------

def kv_roundtrip(fmt, x):
    """Rows (B, S, *feat) quantized and dequantized row by row, as a
    quantized pool stores and returns them."""
    q, scale = fmt.quantize_rows(x)
    return fmt.dequantize(q, scale, x.dtype)


def kv_attention(fmt, attention=None):
    """The plain attention (or ``attention``) on K/V rows that went
    through the pool's format row by row."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    attention = attention or flash_attention_plain
    return lambda q, k, v: attention(q, kv_roundtrip(fmt, k),
                                     kv_roundtrip(fmt, v))


def kv_plain(torch, params, cfg, fmt):
    """seq, widened -> plain contiguous logits of ``seq`` with the pool's
    per-row quantization, and no port kernel: the GQA forward, or MLA's
    naive form; ``widened`` runs the attention on widened inputs (the
    noise floor)."""
    if cfg.kv_lora_rank:
        return lambda seq, widened=False: plain_mla_forward(
            torch, params, cfg, seq, kv_fmt=fmt,
            attention=widened_attention if widened else None)
    return lambda seq, widened=False: plain_forward(
        torch, params, cfg, seq, attention=kv_attention(
            fmt, widened_attention if widened else None))


def rolled_scales(fn):
    """The planted fault: ``fn`` (a quantized kernel's wrapper) called
    with every row's scale rolled by one within its page."""
    def faulty(*args, **kw):
        return fn(*args, **{k: (v.roll(1, dims=1) if "scale" in k else v)
                            for k, v in kw.items()})
    return faulty


def kv_logit_check(torch, plain, r, base_tol):
    """Teacher-forced logits of the finished request ``r`` against the
    plain forward: (error, noise floor, bound).  The bound is
    SERVE_KV_NOISE_FACTOR times the floor (plain forward against itself
    with widened attention, no port kernel), and at least the fp path's
    own ``base_tol``."""
    import numpy as np
    seq = r.prompt + r.out_tokens[:-1]
    start = len(r.prompt) - 1
    got = torch.from_numpy(np.stack(r.logits))
    ref = plain(seq)[start:].float().cpu()
    alt = plain(seq, widened=True)[start:].float().cpu()
    floor = rel_err(alt, ref)
    return rel_err(got, ref), floor, max(base_tol,
                                         SERVE_KV_NOISE_FACTOR * floor)


def serve_kv(torch, card, cfg, params, fmt, prompts, want, base_tol,
             patch):
    """Phase 10 (and 13): serve ``prompts`` at full depth on a ``fmt`` pool
    through submit/tick/drain.  Every dispatch's launches are logged and
    held to ``want`` (dispatch kind -> the one kernel it launches, once
    a layer); the pool's bytes are printed beside the fp pool's; every
    request's teacher-forced logits are held to kv_logit_check's bound,
    and the same engine with the planted fault (``patch`` = (module,
    wrapper name)), serving requests 0 and 8, must land outside it.
    With ``cfg.qk_norm`` the planted QK_NORM_SPREAD fault must land
    outside the bound of requests 0 and 8.  Returns the launches of the
    run, in all and by dispatch kind."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.model import init_paged_cache
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    tag = f"{cfg.name} {fmt.name}"
    sc = ServeConfig(max_batch=8, max_prompt=256, page_size=16, max_seq=2048,
                     max_new_tokens=32, record_logits=True,
                     kv_format=fmt.name)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, sc, device="cuda")
    eng.warmup()
    reqs = [Request(i, p) for i, p in enumerate(prompts)]
    counters = {"flash_attention_fwd": lambda: fa.launches,
                "paged_flash_decode_partials": lambda: pfd.launches,
                "paged_flash_decode_partials_quant":
                    lambda: pfd.quant_launches,
                "mla_paged_decode_partials": lambda: pfd.mla_launches,
                "mla_paged_decode_partials_quant":
                    lambda: pfd.mla_quant_launches}
    log = record_dispatches(eng, counters)
    fa.launches = pfd.launches = pfd.quant_launches = 0
    pfd.mla_launches = pfd.mla_quant_launches = 0
    wall, per_decode = drive(torch, eng, reqs, counters)
    eng.drain()
    launches = {n: c() for n, c in counters.items()}
    for r in reqs:
        if not r.done or r.failed or len(r.out_tokens) != sc.max_new_tokens:
            fail(f"{tag}: request {r.rid}: done={r.done} failed={r.failed} "
                 f"tokens={len(r.out_tokens)}")
    kinds = {k: 0 for k in want}
    by_kind = {k: {n: 0 for n in counters} for k in want}
    for kind, got in log:
        kinds[kind] += 1
        for n in counters:
            by_kind[kind][n] += got[n]
        exp = {n: (cfg.n_layers if n == want[kind] else 0) for n in counters}
        if got != exp:
            fail(f"{tag}: a {kind} dispatch launched {got}, want {exp}")
    if min(kinds.values()) < 1:
        fail(f"{tag}: dispatch kinds {kinds}: each must run at least once")
    if eng.n_shared_admissions < 1:
        fail(f"{tag}: the shared-prefix request was not admitted as a "
             "sharer")
    pool = eng.pool_bytes_per_shard()
    fp_pool = sum(t.numel() * t.element_size() for t in init_paged_cache(
        cfg, eng.num_pages, sc.page_size, device="meta")[0].values())
    limit = POOL_RATIO_LIMIT[fmt.name]
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(json.dumps({"phase": "serve_kv", "arch": cfg.name,
                      "dtype": str(cfg.dtype), "kv_format": fmt.name,
                      "layers": cfg.n_layers,
                      "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
                      "tokens_per_s": n_tok / wall, "stats": eng.stats(),
                      "dispatches": kinds, "launches": launches,
                      "launches_per_decode_tick": per_decode,
                      "launches_by_kind": by_kind,
                      "pool_bytes_per_shard": pool, "fp_pool_bytes": fp_pool,
                      "pool_ratio": pool / fp_pool, "pool_ratio_limit": limit,
                      "weight_bytes": weight_bytes(params), **memory(torch),
                      "card": card}), flush=True)
    if not pool <= limit * fp_pool:
        fail(f"{tag}: pool {pool} bytes is {pool / fp_pool} of the bf16 "
             f"pool's {fp_pool}, above {limit}")
    del eng
    torch.cuda.empty_cache()
    # the planted fault serves the longest request and the sharer
    module, attr = patch
    good = getattr(module, attr)
    setattr(module, attr, rolled_scales(good))
    try:
        bad_eng = ServingEngine(cfg, params, sc, device="cuda")
        faulty = {rid: Request(rid, prompts[rid]) for rid in (0, 8)}
        bad_eng.run(list(faulty.values()))
    finally:
        setattr(module, attr, good)
    del bad_eng
    torch.cuda.empty_cache()
    plain = kv_plain(torch, params, cfg, fmt)
    checks = []
    with torch.inference_mode():
        for r in reqs:
            err, floor, tol = kv_logit_check(torch, plain, r, base_tol)
            rec = {"rid": r.rid, "max_rel_err": err, "noise_floor": floor,
                   "rel_tol": tol}
            if r.rid in faulty:
                rec["fault"], rec["fault_floor"], rec["fault_tol"] = \
                    kv_logit_check(torch, plain, faulty[r.rid], base_tol)
                if cfg.qk_norm:
                    rec["qk_fault"], rec["qk_fault_over_bound"] = \
                        qk_fault_check(torch, params, plain, r, tol, tag)
            checks.append(rec)
    print(json.dumps({"phase": "serve_kv_check", "arch": cfg.name,
                      "kv_format": fmt.name, "requests": checks}),
          flush=True)
    for rec in checks:
        if not rec["max_rel_err"] <= rec["rel_tol"]:
            fail(f"{tag}: request {rec['rid']}: teacher-forced logits differ "
                 f"by {rec['max_rel_err']} of the row max (> "
                 f"{rec['rel_tol']}; {rec})")
        if "fault" in rec and not rec["fault"] > rec["fault_tol"]:
            fail(f"{tag}: request {rec['rid']}: the planted fault (rolled "
                 f"row scales) moves the logits by {rec['fault']} of the "
                 f"row max, inside the bound {rec['fault_tol']}: the check "
                 "cannot see it")
    return launches, by_kind


def serve_kv_f32(torch, name, fmt):
    """Phase 11: a 2-layer float32 ``name`` at full width through the
    engine on a ``fmt`` pool; its greedy tokens must equal the plain
    forward's (with the pool's per-row quantization), except at a
    position whose top-two gap in the plain forward is within twice the
    kernel-free noise there (max |widened - plain| over the row), as in
    phase 7; each such position is printed."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = get_config(name)
    kind = cfg.pattern[0][1]
    cfg = cfg.with_(n_layers=2, pattern=(("scan", kind, 2),),
                    dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         device="cuda")
    sc = ServeConfig(max_batch=4, max_prompt=256, page_size=16, max_seq=1024,
                     max_new_tokens=8, kv_format=fmt.name)
    eng = ServingEngine(cfg, params, sc, device="cuda")
    rng = np.random.RandomState(8)
    reqs = [Request(i, [int(t) for t in rng.randint(0, cfg.vocab_size, n)])
            for i, n in enumerate((40, 300, 600, 17, 260, 90))]
    eng.run(reqs)
    del eng
    plain = kv_plain(torch, params, cfg, fmt)
    bad, ties = [], []
    with torch.inference_mode():
        for r in reqs:
            seq = r.prompt + r.out_tokens[:-1]
            start = len(r.prompt) - 1
            ref = plain(seq)[start:].float().cpu()
            want = ref.argmax(-1).tolist()
            if want == r.out_tokens:
                continue
            alt = plain(seq, widened=True)[start:].float().cpu()
            for i, (g, w) in enumerate(zip(r.out_tokens, want)):
                if g == w:
                    continue
                pos = {"rid": r.rid, "pos": i, "engine": g, "plain": w,
                       "gap": (ref[i, w] - ref[i, g]).item(),
                       "noise": (alt[i] - ref[i]).abs().max().item()}
                (ties if pos["gap"] <= 2 * pos["noise"] else bad).append(pos)
    print(json.dumps({"phase": "serve_kv_f32", "arch": name,
                      "kv_format": fmt.name, "layers": 2,
                      "requests": len(reqs),
                      "tokens": sum(len(r.out_tokens) for r in reqs),
                      "token_mismatches": len(bad) + len(ties),
                      "within_bound": ties}), flush=True)
    if bad:
        fail(f"f32 {name} {fmt.name} engine tokens differ from the plain "
             f"forward: {bad}")


# ---------------------------------------------------------------------------
# Phase 12: overcommitted serving with swap preemption.
# ---------------------------------------------------------------------------

# the overcommitted pool: 8 slots, 256-row chunks, page 16, and 78 pages,
# where the first wave's nine requests would reserve 147 for their worst
# cases (reserve_decode_pages=False), so that decode growth preempts.  With
# eos_id -1 every request emits max_new_tokens and the schedule depends on
# no token: only on this geometry and the prompts.  This traffic preempts
# 7 times on the CPU (``cpu_swap_log``): the sharer twice (first while it
# holds the source's 16 pages), a 280-token prompt once mid-prompt and
# once mid-decode, and three others mid-decode
OVERCOMMIT = dict(max_batch=8, max_prompt=256, page_size=16, max_seq=1024,
                  max_new_tokens=64, num_pages=78,
                  reserve_decode_pages=False, eos_id=-1, record_logits=True)
# (submit tick, prompt length) of each request, in rid order: a first wave
# at tick 0, the sharer at tick 2, and a second wave at tick 60 while the
# first drains; the sharer (rid OVERCOMMIT_SHARE[1]) repeats the source's
# first OVERCOMMIT_SHARE[2] tokens, whole pages it maps from the source
OVERCOMMIT_ARRIVALS = ((0, 300), (0, 17), (0, 47), (0, 60), (0, 85), (0, 101),
                       (0, 520), (2, 296), (3, 300), (60, 47), (60, 280),
                       (60, 900))
OVERCOMMIT_SHARE = (0, 7, 256)
# what the schedule must contain, checked on the card and in its CPU log
OVERCOMMIT_MIN = {"preemptions": 4, "mid_prompt": 1, "mid_decode": 1,
                  "twice": 1, "shared": 1}


def overcommit_traffic(vocab: int, seed: int = 9):
    """(submit tick, rid, prompt) of every phase-12 request."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prompts = [[int(t) for t in rng.randint(0, vocab, n)]
               for _, n in OVERCOMMIT_ARRIVALS]
    src, sharer, rows = OVERCOMMIT_SHARE
    prompts[sharer] = prompts[src][:rows] + prompts[sharer][rows:]
    return [(t, rid, p) for rid, ((t, _), p) in
            enumerate(zip(OVERCOMMIT_ARRIVALS, prompts))]


def watch_swaps(torch, eng, restore_check=True):
    """Log every preemption of ``eng`` as [tick, grower rid, victim rid,
    the victim's prefill_done, its pos], with whether the victim was
    mid-prompt and whether it held a page another slot references (the
    grower: the slot ``Scheduler.victim`` was told to spare); time every
    swap-out and swap-in on the host clock, the card synchronized before
    and after; with ``restore_check``, hold every swap-in's restored
    pages against its snapshot bit for bit (``torch.equal``, every
    leaf), and its recurrent state rows (a mamba block's) alike."""
    import numpy as np
    rec = {"log": [], "mid_prompt": [], "shared": [], "nbytes": [],
           "out_ms": [], "in_ms": [], "restored": 0}
    spared = {}
    victim, out, inn = eng.sched.victim, eng._swap_out, eng._swap_in
    on_card = eng.device.type == "cuda"

    def pick(exclude):
        spared["slot"] = exclude
        return victim(exclude)

    def timed(fn, *args):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        if on_card:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def swap_out(slot):
        meta = eng.sched.slots[slot]
        pages = eng.alloc.page_table[slot]
        rec["log"].append([eng.tick_no,
                           eng.sched.slots[spared["slot"]].req.rid,
                           meta.req.rid, meta.prefill_done,
                           int(eng.positions[slot])])
        rec["mid_prompt"].append(meta.prefill_done < len(meta.req.prompt))
        rec["shared"].append(
            bool((eng.alloc.refcount[pages[pages >= 0]] > 1).any()))
        rec["out_ms"].append(timed(out, slot))
        rec["nbytes"].append(eng.sched.swapped[-1].nbytes)

    def swap_in(slot, sw):
        rec["in_ms"].append(timed(inn, slot, sw))
        if not restore_check:
            return
        phys = torch.from_numpy(eng.alloc.page_table[
            slot, :sw.n_pages].astype(np.int64)).to(eng.device)
        for leaf, rows in zip(eng._pool_leaves(), sw.pool_rows):
            if not torch.equal(leaf[:, phys].cpu(), rows):
                fail(f"swap-in of request {sw.req.rid} did not restore its "
                     "snapshot bit for bit")
        for leaf, rows in zip(eng._state_leaves(), sw.slot_rows,
                              strict=True):
            if not torch.equal(leaf[:, slot].cpu(), rows):
                fail(f"swap-in of request {sw.req.rid} did not restore its "
                     "recurrent state rows bit for bit")
        rec["restored"] += 1
    eng.sched.victim, eng._swap_out, eng._swap_in = pick, swap_out, swap_in
    return rec


def swap_summary(rec):
    """The schedule's counts that OVERCOMMIT_MIN holds."""
    victims = [e[2] for e in rec["log"]]
    return {"preemptions": len(victims),
            "mid_prompt": sum(rec["mid_prompt"]),
            "mid_decode": len(victims) - sum(rec["mid_prompt"]),
            "twice": sum(victims.count(v) >= 2 for v in set(victims)),
            "shared": sum(rec["shared"])}


def roll_restores(eng):
    """The planted fault: every swap-in restores its pages rolled by one
    logical page."""
    good = eng._swap_in

    def faulty(slot, sw):
        sw.pool_rows = [t.roll(1, dims=1) for t in sw.pool_rows]
        good(slot, sw)
    eng._swap_in = faulty


def drive_plan(torch, eng, plan, until=None):
    """Submit each request once the engine's clock reaches its tick, and
    tick until all are done, or until ``until(requests by rid)`` holds
    after a tick.  Returns the requests by rid and the wall seconds."""
    from repro_torch.serve import Request
    plan, reqs = sorted(plan), {}
    on_card = eng.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while plan or eng.sched.has_work():
        while plan and plan[0][0] <= eng.tick_no:
            _, rid, prompt = plan.pop(0)
            reqs[rid] = Request(rid, prompt)
            eng.submit(reqs[rid])
        eng.tick()
        if until is not None and until(reqs):
            break
    if on_card:
        torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def cpu_swap_log(torch, cfg, sc, plan):
    """The preemption log ``plan`` must produce, computed on the CPU: the
    port's engine with one float32 layer of narrow widths, the same
    serving geometry and pool format, and the same prompts relabelled one
    to one onto a small vocabulary (prefix sharing sees the same equal
    tokens; with eos_id -1 no other decision reads a token)."""
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    ids = sorted({t for _, _, p in plan for t in p})
    relabel = {t: i for i, t in enumerate(ids)}
    narrow = dict(n_layers=1, d_model=64, n_heads=4, d_ff=128, head_dim=0,
                  vocab_size=len(ids), dtype=torch.float32)
    if cfg.kv_lora_rank:
        narrow.update(n_kv_heads=4, kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16,
                      pattern=(("scan", "mla_mlp", 1),))
    else:
        narrow.update(n_kv_heads=2, pattern=(("scan", "attn_mlp", 1),))
    small = cfg.with_(**narrow)
    params = init_params(small, torch.Generator().manual_seed(0),
                         device="cpu")
    eng = ServingEngine(small, params, sc, device="cpu")
    rec = watch_swaps(torch, eng, restore_check=False)
    drive_plan(torch, eng, [(t, rid, [relabel[x] for x in p])
                            for t, rid, p in plan])
    return rec["log"]


def serve_overcommit(torch, card, cfg, params, kv_format, logit_check,
                     want, tag):
    """Phase 12, one run: serve the phase-12 traffic at full width on an
    overcommitted ``kv_format`` pool.  The preemption log must equal the
    one computed on the CPU (``cpu_swap_log``) and hold OVERCOMMIT_MIN;
    every swap-in restores its snapshot bit for bit; every request
    completes with max_new_tokens tokens and no fault; swap-ins equal
    preemptions; every page is free at the end; every dispatch launches
    ``want[kind]`` once a layer and no other attention kernel.  Each
    preempted request's teacher-forced logits must pass ``logit_check``
    (request -> (error, bound)), and the same engine with its swap-ins
    rolled by one logical page (``roll_restores``) must land outside the
    bound.  The faulty engine runs only until its first preempted request
    completes (the schedule reads no token, so it preempts as the good
    one did), and the fault is read on the preempted requests done by
    then.  Returns the launches of the run by kernel."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.serve import ServeConfig, ServingEngine
    sc = ServeConfig(kv_format=kv_format, **OVERCOMMIT)
    plan = overcommit_traffic(cfg.vocab_size)
    t0 = time.perf_counter()
    expected = cpu_swap_log(torch, cfg, sc, plan)
    cpu_s = time.perf_counter() - t0
    counters = {"flash_attention_fwd": lambda: fa.launches,
                "paged_flash_decode_partials": lambda: pfd.launches,
                "paged_flash_decode_partials_quant":
                    lambda: pfd.quant_launches,
                "mla_paged_decode_partials": lambda: pfd.mla_launches,
                "mla_paged_decode_partials_quant":
                    lambda: pfd.mla_quant_launches}
    eng = ServingEngine(cfg, params, sc, device="cuda")
    eng.warmup()
    rec = watch_swaps(torch, eng)
    log = record_dispatches(eng, counters)
    fa.launches = pfd.launches = pfd.quant_launches = 0
    pfd.mla_launches = pfd.mla_quant_launches = 0
    reqs, wall = drive_plan(torch, eng, plan)
    launches = {n: c() for n, c in counters.items()}
    counts = swap_summary(rec)
    kinds = {k: 0 for k in want}
    by_kind = {k: {n: 0 for n in counters} for k in want}
    for kind, got in log:
        kinds[kind] += 1
        for n in counters:
            by_kind[kind][n] += got[n]
        exp = {n: (cfg.n_layers if n == want[kind] else 0) for n in counters}
        if got != exp:
            fail(f"{tag}: a {kind} dispatch launched {got}, want {exp}")
    st = eng.stats()
    n_tok = sum(len(r.out_tokens) for r in reqs.values())
    print(json.dumps({
        "phase": "overcommit", "arch": cfg.name, "dtype": str(cfg.dtype),
        "kv_format": kv_format, "layers": cfg.n_layers,
        "num_pages": sc.num_pages, "requests": len(reqs), "tokens": n_tok,
        "wall_s": wall, "stats": st, "preemption_log": rec["log"],
        "cpu_log_equal": rec["log"] == expected, "cpu_log_s": cpu_s,
        "schedule": counts, "snapshot_bytes": rec["nbytes"],
        "snapshot_bytes_median": statistics.median(rec["nbytes"] or [0]),
        "page_bytes": eng._page_nbytes,
        "swap_out_ms_median": statistics.median(rec["out_ms"] or [0]),
        "swap_in_ms_median": statistics.median(rec["in_ms"] or [0]),
        "swap_out_ms": rec["out_ms"], "swap_in_ms": rec["in_ms"],
        "restored_bitwise": rec["restored"], "dispatches": kinds,
        "launches": launches, "launches_by_kind": by_kind,
        "card": card}), flush=True)
    if rec["log"] != expected:
        fail(f"{tag}: the preemption log {rec['log']} differs from the "
             f"one computed on the CPU {expected}")
    for k, least in OVERCOMMIT_MIN.items():
        if counts[k] < least:
            fail(f"{tag}: the schedule has {counts[k]} {k}, want at least "
                 f"{least} ({counts})")
    for r in reqs.values():
        if not r.done or r.failed or len(r.out_tokens) != sc.max_new_tokens:
            fail(f"{tag}: request {r.rid}: done={r.done} failed={r.failed} "
                 f"tokens={len(r.out_tokens)}")
    if eng.iotlb.faults:
        fail(f"{tag}: faults {eng.iotlb.faults}")
    if not (eng.n_swap_ins == eng.n_preemptions == rec["restored"]):
        fail(f"{tag}: {eng.n_swap_ins} swap-ins, {eng.n_preemptions} "
             f"preemptions, {rec['restored']} restores checked")
    if eng.pages_in_use() != 0:
        fail(f"{tag}: {eng.pages_in_use()} pages still in use at the end")
    if min(kinds.values()) < 1:
        fail(f"{tag}: dispatch kinds {kinds}: each must run at least once")
    del eng
    torch.cuda.empty_cache()
    preempted = sorted(rid for rid, r in reqs.items() if r.preempts)
    bad_eng = ServingEngine(cfg, params, sc, device="cuda")
    roll_restores(bad_eng)
    bad_reqs, bad_wall = drive_plan(
        torch, bad_eng, plan,
        until=lambda rs: any(rid in rs and rs[rid].done for rid in preempted))
    bad_ticks = bad_eng.tick_no
    del bad_eng
    torch.cuda.empty_cache()
    checks = []
    with torch.inference_mode():
        for rid in preempted:
            r, bad = reqs[rid], bad_reqs.get(rid)
            err, tol = logit_check(r)
            ferr, ftol = logit_check(bad) if bad and bad.done else (None,
                                                                    None)
            checks.append({"rid": rid, "preempts": r.preempts,
                           "max_rel_err": err, "rel_tol": tol,
                           "fault": ferr, "fault_tol": ftol})
    print(json.dumps({"phase": "overcommit_check", "arch": cfg.name,
                      "kv_format": kv_format, "fault_ticks": bad_ticks,
                      "fault_wall_s": bad_wall, "requests": checks}),
          flush=True)
    for c in checks:
        if not c["max_rel_err"] <= c["rel_tol"]:
            fail(f"{tag}: request {c['rid']}: teacher-forced logits differ "
                 f"by {c['max_rel_err']} of the row max (> {c['rel_tol']})")
    if not any(c["fault"] is not None and c["fault"] > c["fault_tol"]
               for c in checks):
        fail(f"{tag}: the planted fault (pages restored rolled by one "
             f"logical page) lands inside the bound on every preempted "
             f"request ({checks}): the check cannot see it")
    return launches


def overcommit_phase(torch, card, gqa_cfg, gqa_params, mla_cfg, mla_params):
    """Phase 12: ``serve_overcommit`` at full width and depth, on
    qwen2.5-3b's bf16 pool (run A, phase 3's weights), then on its int8
    pool and on deepseek-v2-lite-dense's latent pool (run B, phase 8's
    weights).  Preempted requests are held as in phases 3, 10 and 8.
    Returns each kernel's launches summed over the runs."""
    import numpy as np
    from repro_torch.core.pageformat import INT8

    def held(plain, tol):
        def check(r):
            seq = r.prompt + r.out_tokens[:-1]
            got = torch.from_numpy(np.stack(r.logits))
            ref = plain(seq)[len(r.prompt) - 1:].float().cpu()
            return rel_err(got, ref), tol
        return check
    int8_plain = kv_plain(torch, gqa_params, gqa_cfg, INT8)

    def int8_check(r):
        err, _, tol = kv_logit_check(torch, int8_plain, r, SERVE_REL_TOL_BF16)
        return err, tol
    gqa_want = {"fresh": "flash_attention_fwd",
                "resumed": "paged_flash_decode_partials",
                "decode": "paged_flash_decode_partials"}
    runs = [
        (gqa_cfg, gqa_params, "fp", held(
            lambda seq: plain_forward(torch, gqa_params, gqa_cfg, seq),
            SERVE_REL_TOL_BF16), gqa_want),
        (gqa_cfg, gqa_params, "int8", int8_check,
         {k: "paged_flash_decode_partials_quant" for k in gqa_want}),
        (mla_cfg, mla_params, "fp", held(
            lambda seq: plain_mla_forward(torch, mla_params, mla_cfg, seq),
            SERVE_MLA_REL_TOL), dict(gqa_want,
                                      decode="mla_paged_decode_partials"))]
    total = {}
    for cfg, params, fmt, check, want in runs:
        got = serve_overcommit(torch, card, cfg, params, fmt, check, want,
                               f"overcommit {cfg.name} {fmt}")
        for n, v in got.items():
            total[n] = total.get(n, 0) + v
    return total


# ---------------------------------------------------------------------------
# Phase 13: the dense arch files, qwen3-8b and yi-34b.
# ---------------------------------------------------------------------------

def draw_qk_norms(torch, params, seed):
    """Every layer's ``q_norm`` and ``k_norm`` drawn as exp(QK_NORM_SPREAD
    * N(0, 1)) from ``seed``, in place."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for blk in params.blocks:
            for k in ("q_norm", "k_norm"):
                w = blk.attn[k]
                w.copy_(torch.exp(QK_NORM_SPREAD * torch.randn(
                    w.shape, generator=g, device=w.device)))


def dense_arch_phase(torch, card):
    """Phase 13: qwen3-8b and yi-34b at full width and depth, random
    weights from seeded generators, through ``serve`` (phase 3's traffic
    and checks): qwen3-8b (qk_norm, QK_NORM_SPREAD's norm weights) on a
    bf16 pool and on an int8 pool (``serve_kv``, phase 10's bound); yi-34b
    in bf16, then the same weights packed in place to w4a16
    (``quantize_for_serving(..., consume=True)``) and served again.
    Every earlier phase's weights are released before it.  Returns the
    launches of each run by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.pageformat import INT8
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.model import init_params, quantize_for_serving
    t0 = time.perf_counter()
    out = {}
    cfg = get_config("qwen3-8b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(13),
                         device="cuda")
    draw_qk_norms(torch, params, 14)
    out["qwen3-8b bf16"] = serve(torch, card, cfg, params, "bf16")[0]
    out["qwen3-8b int8"] = serve_kv(
        torch, card, cfg, params, INT8, smoke_traffic(cfg.vocab_size),
        {k: "paged_flash_decode_partials_quant"
         for k in ("fresh", "resumed", "decode")},
        SERVE_REL_TOL_BF16, (attn_mod, "paged_flash_decode_partials"))[0]
    del params
    torch.cuda.empty_cache()
    cfg = get_config("yi-34b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(15),
                         device="cuda")
    out["yi-34b bf16"] = serve(torch, card, cfg, params, "bf16")[0]
    qcfg = cfg.with_(quant=parse_quant("w4a16"))
    raw_bytes = weight_bytes(params)
    torch.cuda.reset_peak_memory_stats()
    params, n = quantize_for_serving(qcfg, params, consume=True)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "quantize_for_serving", "arch": cfg.name,
                      "quant": "w4a16", "consume": True, "packed_tensors": n,
                      "raw_weight_bytes": raw_bytes,
                      "weight_bytes": weight_bytes(params), **memory(torch)}),
          flush=True)
    out["yi-34b w4a16"] = serve(torch, card, qcfg, params, "w4a16")[0]
    del params
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "dense_archs",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 14: the contiguous cache layout (``ServeConfig(paged=False)``).
# ---------------------------------------------------------------------------

# phase 14's engines: phase 3's traffic with every prompt one chunk (the
# contiguous engine has no resumable prefill), 8 slots of slot_rows =
# 1056 rows, read by the kernels as pages of 16 rows
CONTIG_SERVE = dict(max_batch=8, max_prompt=1024, page_size=16,
                    max_new_tokens=32, record_logits=True)
# make_chunked_prefill_resume_step's check: a prompt fed in chunks
RESUME_PROMPT, RESUME_CHUNK = 1024, 256


def contig_engine(cfg, params, paged):
    """Phase 14's engine, contiguous or its paged twin.  Neither shares a
    prefix: a sharer resumes its prompt on the paged kernel's chunk
    route, where the contiguous engine runs one fresh chunk."""
    from repro_torch.serve import ServeConfig, ServingEngine
    sc = ServeConfig(paged=paged, prefix_sharing=False, **CONTIG_SERVE)
    return ServingEngine(cfg, params, sc, device="cuda")


def one_key_short(torch, mla):
    """Plant phase 14's fault: every decode call of the attention kernel
    leaves out the newest key, the slot's own row (GQA: kv_valid = pos;
    MLA: rows <= pos - 1).  Returns the function that takes it out."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mla as mla_mod
    if mla:
        good = mla_mod.mla_paged_decode_partials

        def short(pool, q_c, q_rope, tbl, pos, r, scale_dim, **kw):
            return good(pool, q_c, q_rope, tbl,
                        torch.where(pos >= 0, pos - 1, pos), r, scale_dim,
                        **kw)
        mla_mod.mla_paged_decode_partials = short
        return lambda: setattr(mla_mod, "mla_paged_decode_partials", good)
    good = attn_mod.paged_flash_decode_partials

    def short(k_pool, v_pool, q, tbl, qpos, kv_valid, **kw):
        if q.shape[1] == 1:
            kv_valid = (kv_valid - 1).clamp_min(0)
        return good(k_pool, v_pool, q, tbl, qpos, kv_valid, **kw)
    attn_mod.paged_flash_decode_partials = short
    return lambda: setattr(attn_mod, "paged_flash_decode_partials", good)


def contiguous_serve(torch, card, cfg, params, mla, plain, tol):
    """Phase 14, one model: serve phase 3's traffic through the
    contiguous engine (every request completes; a fresh wave launches
    the flash kernel once a layer and nothing else, a decode step the
    decode kernel, ``mla`` or GQA, once a layer and nothing else), then
    through the paged engine at the same chunk and page size: tokens
    equal, the logits' largest difference printed.  The shortest
    request's and request 0's (1024 tokens) teacher-forced logits must be
    within ``tol`` of ``plain(seq)``; the engine with one key short at
    decode (``one_key_short``) serving the two must land outside it on
    the shortest, where one key is the largest share of a slot's keys
    (request 0's reading is printed).  Returns the launches by kernel."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.serve import Request
    attn = "mla_paged_decode_partials" if mla else \
        "paged_flash_decode_partials"
    counters = {"flash_attention_fwd": lambda: fa.launches,
                "paged_flash_decode_partials": lambda: pfd.launches,
                "mla_paged_decode_partials": lambda: pfd.mla_launches}
    want = {"fresh": "flash_attention_fwd", "decode": attn}
    prompts = smoke_traffic(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng = contig_engine(cfg, params, paged=False)
    eng.warmup()
    reqs = [Request(i, p) for i, p in enumerate(prompts)]
    log = record_dispatches(eng, counters)
    fa.launches = pfd.launches = pfd.mla_launches = 0
    wall, per_decode = drive(torch, eng, reqs, counters)
    eng.drain()
    launches = {n: c() for n, c in counters.items()}
    kinds = {"fresh": 0, "resumed": 0, "decode": 0}
    for kind, got in log:
        kinds[kind] += 1
        exp = {n: (cfg.n_layers if n == want.get(kind) else 0)
               for n in counters}
        if got != exp:
            fail(f"contiguous {cfg.name}: a {kind} dispatch launched {got}, "
                 f"want {exp}")
    if kinds["resumed"] or min(kinds["fresh"], kinds["decode"]) < 1:
        fail(f"contiguous {cfg.name}: dispatch kinds {kinds}")
    for r in reqs:
        if not r.done or r.failed or \
                len(r.out_tokens) != CONTIG_SERVE["max_new_tokens"]:
            fail(f"contiguous {cfg.name}: request {r.rid}: done={r.done} "
                 f"failed={r.failed} tokens={len(r.out_tokens)}")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(json.dumps({"phase": "contiguous", "arch": cfg.name,
                      "dtype": str(cfg.dtype), "layers": cfg.n_layers,
                      "requests": len(reqs), "tokens": n_tok,
                      "wall_s": wall, "tokens_per_s": n_tok / wall,
                      "stats": eng.stats(), "dispatches": kinds,
                      "launches": launches,
                      "launches_per_decode_tick": per_decode,
                      "cache_bytes": eng.pool_bytes_per_shard(),
                      "cache_shape": list(next(iter(
                          eng.cache[0].values())).shape),
                      "weight_bytes": weight_bytes(params), **memory(torch),
                      "card": card}), flush=True)
    del eng
    torch.cuda.empty_cache()
    twin = contig_engine(cfg, params, paged=True)
    paged = twin.run([Request(i, p) for i, p in enumerate(prompts)])
    pool_bytes = twin.pool_bytes_per_shard()
    del twin
    torch.cuda.empty_cache()
    paged = {r.rid: r for r in paged}
    diff = max(float(np.abs(np.stack(r.logits)
                            - np.stack(paged[r.rid].logits)).max())
               for r in reqs)
    same = [r.rid for r in reqs if r.out_tokens == paged[r.rid].out_tokens]
    rec = {"phase": "contiguous_vs_paged", "arch": cfg.name,
           "same_tokens": len(same), "requests": len(reqs),
           "logits_max_abs_diff": diff, "paged_pool_bytes": pool_bytes}
    print(json.dumps(rec), flush=True)
    if len(same) != len(reqs):
        fail(f"contiguous {cfg.name}: tokens differ from the paged "
             f"engine's ({rec})")
    short = min(range(len(prompts)), key=lambda i: len(prompts[i]))
    checked = (short, 0)
    undo = one_key_short(torch, mla)
    try:
        bad = contig_engine(cfg, params, paged=False)
        faulty = bad.run([Request(i, prompts[i]) for i in checked])
        del bad
    finally:
        undo()
    torch.cuda.empty_cache()
    faulty = {r.rid: r for r in faulty}
    checks = []
    with torch.inference_mode():
        for rid in checked:
            out = {"rid": rid, "prompt": len(prompts[rid]), "rel_tol": tol}
            for tag, r in (("engine", reqs[rid]), ("fault", faulty[rid])):
                seq = r.prompt + r.out_tokens[:-1]
                start = len(r.prompt) - 1
                got = torch.from_numpy(np.stack(r.logits))
                ref = plain(torch, params, cfg, seq)[start:].float().cpu()
                out[tag] = rel_err(got, ref)
                if tag == "engine":
                    out["argmax_agree"] = (got.argmax(-1) == ref.argmax(-1)) \
                        .float().mean().item()
            checks.append(out)
    print(json.dumps({"phase": "contiguous_check", "arch": cfg.name,
                      "requests": checks}), flush=True)
    for out in checks:
        if not out["engine"] <= tol:
            fail(f"contiguous {cfg.name}: request {out['rid']}: "
                 f"teacher-forced logits differ by {out['engine']} of the "
                 f"row max (> {tol})")
    if not checks[0]["fault"] > tol:
        fail(f"contiguous {cfg.name}: one key short at decode moves request "
             f"{short}'s logits by {checks[0]['fault']} of the row max, "
             f"inside the bound {tol}: the check cannot see it")
    return launches


def resume_check(torch, cfg, params):
    """Phase 14: ``make_chunked_prefill_resume_step`` on a contiguous
    cache feeds a RESUME_PROMPT-token prompt in RESUME_CHUNK-token chunks,
    each dispatch launching the paged kernel's chunk route once a layer
    and nothing else; the last chunk's last-token logits must be within
    SERVE_REL_TOL_BF16 of the single-pass ``make_chunked_prefill_step``'s.
    Returns the paged kernel's launches."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.common import ContigView
    from repro_torch.models.model import init_cache
    from repro_torch.train.step import (make_chunked_prefill_resume_step,
                                        make_chunked_prefill_step)
    rng = np.random.RandomState(14)
    toks = torch.tensor(rng.randint(0, cfg.vocab_size, (1, RESUME_PROMPT)),
                        dtype=torch.int32, device="cuda")
    step = make_chunked_prefill_resume_step(
        cfg, ContigView(CONTIG_SERVE["page_size"], RESUME_PROMPT))
    lens = torch.tensor([RESUME_CHUNK], dtype=torch.int32, device="cuda")
    cache = init_cache(cfg, 1, RESUME_PROMPT, device="cuda")
    per, total = [], 0
    with torch.inference_mode():
        for off in range(0, RESUME_PROMPT, RESUME_CHUNK):
            f0, p0 = fa.launches, pfd.launches
            last, cache = step(params, cache, toks[:, off:off + RESUME_CHUNK],
                               lens, torch.tensor([off], dtype=torch.int32,
                                                  device="cuda"))
            per.append([fa.launches - f0, pfd.launches - p0])
            total += pfd.launches - p0
        del cache
        single, _ = make_chunked_prefill_step(cfg)(
            params, init_cache(cfg, 1, RESUME_PROMPT, device="cuda"), toks,
            torch.tensor([RESUME_PROMPT], dtype=torch.int32, device="cuda"))
    err = rel_err(last.float().cpu(), single.float().cpu())
    rec = {"phase": "contiguous_resume", "arch": cfg.name,
           "chunks": len(per), "launches_flash_paged": per,
           "max_rel_err": err, "rel_tol": SERVE_REL_TOL_BF16}
    print(json.dumps(rec), flush=True)
    if any(p != [0, cfg.n_layers] for p in per):
        fail(f"contiguous resume: launches (flash, paged) per dispatch {per}"
             f", want [0, {cfg.n_layers}]")
    if not err <= SERVE_REL_TOL_BF16:
        fail(f"contiguous resume: the last chunk's logits differ from the "
             f"single pass by {err} of the row max (> {SERVE_REL_TOL_BF16})")
    torch.cuda.empty_cache()
    return total


def contiguous_phase(torch, card):
    """Phase 14: qwen2.5-3b (phase 3's weights) and deepseek-v2-lite-dense
    (phase 8's) at full width and depth on the contiguous cache
    (``contiguous_serve``), and the resumed contiguous chunk on qwen2.5-3b
    (``resume_check``).  Runs after every earlier phase's weights are
    released.  Returns the launches by kernel, summed."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-3b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    total = contiguous_serve(torch, card, cfg, params, False, plain_forward,
                             SERVE_REL_TOL_BF16)
    total["paged_flash_decode_partials"] += resume_check(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    cfg = get_config("deepseek-v2-lite-dense")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    got = contiguous_serve(torch, card, cfg, params, True, plain_mla_forward,
                           SERVE_MLA_REL_TOL)
    del params
    torch.cuda.empty_cache()
    for n, v in got.items():
        total[n] += v
    print(json.dumps({"phase": "contiguous_layout", "launches": total,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return total


def contiguous_yardstick(torch, timer, B=8, cap=5376, rows=1056, ps=16,
                         H=16, KV=2, dh=128, mla=True):
    """The decode kernels beside one library call that computes what
    kernel and combine compute, at phase 14's decode shape: ``B`` slots
    of a ``cap``-row contiguous cache read through pages of ``ps`` rows
    over their first ``rows`` rows (the engine's view, its split of one
    64-key tile), each slot at its own fill.  The call is
    ``scaled_dot_product_attention`` over each slot's window masked at
    its fill, the query heads of one KV head taken as query rows of one
    head: GQA at H 16 / KV 2 / dh 128 (or ``H``, ``KV``, ``dh``: zamba2's
    32 / 32 / 112 in phase 18), and with ``mla`` MLA's absorbed form at
    dk 576 / dv 512 and one shared latent head.  Each is timed as the kernel
    alone, kernel + ``_combine_page_partials`` and the call, and the
    call's output must equal the kernel's combined one within the
    kernel's tolerance.  Never on the main path."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.attention import _combine_page_partials, page_split
    from repro_torch.models.common import ContigView, contig_pages
    from repro_torch.models.mla import decode_split
    g = torch.Generator(device="cuda").manual_seed(30)
    bf = torch.bfloat16
    pos_np = np.linspace(32, rows - 1, B).astype(np.int32)
    pos = torch.from_numpy(pos_np).cuda()
    view = ContigView(ps, rows)
    mask = (torch.arange(rows, device="cuda")[None] <= pos[:, None])
    mask = mask[:, None, None, :]
    live = int((pos_np + 1).sum())
    out = {}

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    # GQA: K / V (B, cap, KV, dh)
    k, v, q = rand(B, cap, KV, dh), rand(B, cap, KV, dh), rand(B, 1, H, dh)
    (kp, vp), tbl = contig_pages((k, v), view)
    c = page_split(B, 1, H, KV, tbl.shape[1], ps, dh)
    qpos, kv_valid = pos[:, None].contiguous(), (pos + 1).contiguous()
    kern = lambda: pfd.paged_flash_decode_partials(  # noqa: E731
        kp, vp, q, tbl, qpos, kv_valid, pages_per_split=c)
    both = lambda: _combine_page_partials(*kern())  # noqa: E731
    qs = q.reshape(B, KV, H // KV, dh)
    ks, vs = k[:, :rows].transpose(1, 2), v[:, :rows].transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, attn_mask=mask)
    err = (both().reshape(B, KV, H // KV, dh) - sdpa().float()).abs().max()
    out["gqa"] = {"shapes": {"q": [B, 1, H, dh], "cache": [B, cap, KV, dh],
                             "rows": rows, "page_size": ps,
                             "pages_per_split": c},
                  "max_abs_err_vs_kernel": err.item(), "tol": PAGED_TOL_BF16,
                  "kernel_ms": timer.ms(kern), "kernel_combine_ms":
                  timer.ms(both), "library_ms": timer.ms(sdpa)}
    out["gqa"]["bound_ms"], out["gqa"]["bound_by"] = bound_ms(
        live * KV * dh * 2 * 2 + q.numel() * 2 * 2,
        4 * live * H * dh)
    del k, v, kp, vp
    if mla:
        # MLA, absorbed: latent rows (B, cap, r + dr), queries q_c / q_rope
        r, dr = 512, 64
        H = 16
        pool, q_c, q_r = (rand(B, cap, r + dr), rand(B, 1, H, r),
                          rand(B, 1, H, dr))
        (pp,), tbl = contig_pages((pool,), view)
        c = decode_split(ps, B, 1, H, tbl.shape[1], r)
        kern = lambda: pfd.mla_paged_decode_partials(  # noqa: E731
            pp, q_c, q_r, tbl, pos, r, 192, pages_per_split=c)
        both = lambda: _combine_page_partials(*kern())  # noqa: E731
        qs = torch.cat([q_c, q_r], dim=-1)                 # (B, 1, H, 576)
        ks = pool[:, None, :rows]
        vs = pool[:, None, :rows, :r]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=mask, scale=192 ** -0.5)
        err = (both() - sdpa().float()).abs().max()
        out["mla"] = {"shapes": {"q_c": [B, 1, H, r],
                                 "q_rope": [B, 1, H, dr],
                                 "cache": [B, cap, r + dr], "rows": rows,
                                 "page_size": ps, "pages_per_split": c},
                      "max_abs_err_vs_kernel": err.item(),
                      "tol": MLA_TOL_BF16, "kernel_ms": timer.ms(kern),
                      "kernel_combine_ms": timer.ms(both),
                      "library_ms": timer.ms(sdpa)}
        out["mla"]["bound_ms"], out["mla"]["bound_by"] = bound_ms(
            live * (r + dr) * 2 + (q_c.numel() + q_r.numel()) * 2
            + B * H * r * 2, 2 * live * H * (r + dr) + 2 * live * H * r)
    for name, rec in out.items():
        print(json.dumps(dict(phase="contiguous_yardstick", path=name,
                              **rec)), flush=True)
        if not rec["max_abs_err_vs_kernel"] <= rec["tol"]:
            fail(f"yardstick {name}: SDPA over the window reads "
                 f"{rec['max_abs_err_vs_kernel']} from kernel + combine "
                 f"(> {rec['tol']}): it does not compute the same function")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the paper's quantized CNNs (Table VI) through the packed matmuls.
# ---------------------------------------------------------------------------

# Table VI's networks at full size, in benchmarks/table6_qnn.py's formats
# ((a_bits, w_bits); None is the float32 network, whose matmuls are
# cuBLAS's).  Batch 1 is one camera frame, the nano-UAV's case; the
# second batch measures throughput.  ``launches``: the integer kernel's
# launches a forward (MobileNetV1: stem, 13 pointwise, head; ResNet-20:
# stem, 18 convs, 2 shortcuts, head)
VISION_NETS = {
    "mobilenetv1": {"base": 32, "classes": 1000, "img": 224,
                    "batches": (1, 64), "launches": 15,
                    "formats": {"fp32": None, "8b": (8, 8), "8b4b": (8, 4)}},
    "resnet20": {"base": 16, "classes": 10, "img": 32, "batches": (1, 256),
                 "launches": 22,
                 "formats": {"fp32": None, "8b": (8, 8), "4b2b": (4, 2)}},
}
# the float32 forward's logits against a float64 forward of the same
# weights and images, as a share of the row's largest |logit|: each
# float32 dot sums at most 1024 products (9 a depthwise tap), rounding
# at ~1e-6 of its scale, through 14-22 layers
VISION_F32_TOL = 1e-4
VISION_ITERS = 10         # timed forwards a (network, format, batch)
# the integer kernel's device functions (csrc/mpq_matmul.cu), as parts
# of their names in the profiler
VISION_KERNELS = ("::int_mma_rows<", "::int_mma_cols<", "::int_reduce(")


def vision_params(torch, net):
    """(specs, apply, raw weights) of a full-size network, drawn by
    ``init_vision`` from a seeded generator.  MobileNetV1's are rescaled
    to He scales (std sqrt(2 / fan_in), depthwise sqrt(2 / 9)), as the
    CPU tests draw them: at the reference's init (depthwise 0.3,
    1 / sqrt(fan_in)) its activations shrink 1.5-3x a stage and the
    logits all but vanish."""
    from repro_torch.models import vision as V
    n = VISION_NETS[net]
    if net == "mobilenetv1":
        specs, apply = (V.mobilenet_specs(n["base"], n["classes"]),
                        V.mobilenet_apply)
    else:
        specs, apply = (V.resnet20_specs(n["base"], n["classes"]),
                        V.resnet20_apply)
    raw = V.init_vision(specs, torch.Generator(device="cuda").manual_seed(15),
                        device="cuda")
    if net == "mobilenetv1":
        for k, s in specs.items():
            if s.init == "normal" and k != "head":
                raw[k] *= ((2 / 9) ** 0.5 / 0.3 if k.startswith("dw")
                           else 2 ** 0.5)
    return specs, apply, raw


def pack_vision(specs, raw, quant):
    """Every quantize-eligible weight packed once by ``prepare_weight``
    from its flattened (kh * kw * cin, cout) form."""
    from repro_torch.kernels.ops import prepare_weight
    return {k: prepare_weight(v.reshape(-1, v.shape[-1]), quant)
            if specs[k].quantize else v for k, v in raw.items()}


def patched(pairs, fn):
    """``fn()`` with each (module, name, value) of ``pairs`` set, then
    the old values restored."""
    import inspect
    saved = [(m, a, inspect.getattr_static(m, a)) for m, a, _ in pairs]
    for m, a, v in pairs:
        setattr(m, a, v)
    try:
        return fn()
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def plain_vision(torch, fn):
    """``fn()`` with the vision module's packed matmul replaced by
    ``plain_quantized_matmul`` (the kernels' plain versions, on the
    card); everything else is the same code."""
    from repro_torch.models import vision as V
    return patched([(V, "quantized_matmul", lambda x, pw, quant:
                     plain_quantized_matmul(torch, x, pw, quant))], fn)


def forward_ms(torch, fn, iters=VISION_ITERS):
    """Median wall ms of ``fn()`` to its last kernel's end (host clock,
    the card synchronized) over ``iters`` calls, after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def vision_breakdown(torch, fn):
    """Device ms of one forward by part (``torch.profiler``, with ranges
    around the functions that make each part): ``im2col`` of the convs
    (pad, strided slices, concatenation), ``depthwise`` (its tap sum),
    and the packed matmul (``vision.quantized_matmul``), read as
    ``quantize`` (per-row activation scales and integers), ``pack``
    (activations below 8 bits), ``kernel`` (the integer kernel and its
    split-K reduce, summed by name: the profiler does not tie a launch
    through ctypes to its range) and ``pad_cast`` (the rest: K padded,
    the output cast and un-padded); ``rest`` is everything else (the
    float matmuls, batch norm, ReLU, residual adds, the mean pool).
    Also the busy device ms and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import _device_us as device_us
    from repro_torch.models import vision as V

    def ranged(f, name):
        def run(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return run
    parts = {"im2col": (V, "im2col"),
             "depthwise": (V, "depthwise_conv_q"),
             "quantized_matmul": (V, "quantized_matmul"),
             "quantize": (ops, "quantize_activation"),
             "pack": (ops, "pack"), "kernel": (ops, "mpq_matmul")}
    pairs = [(m, a, ranged(getattr(m, a), name))
             for name, (m, a) in parts.items()]

    def run():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return prof.key_averages()
    avgs = patched(pairs, run)
    dev = sorted(((e.key, device_us(e), e.count) for e in avgs
                  if e.device_type == DeviceType.CUDA and e.key not in parts
                  and device_us(e) > 0), key=lambda r: -r[1])
    span = {e.key: device_us(e, own=False) / 1e3 for e in avgs
            if e.device_type == DeviceType.CPU and e.key in parts}
    ms = {k: span.get(k, 0.0) for k in parts}
    busy = sum(r[1] for r in dev) / 1e3
    # the kernel's time inside the matmul's span (0 where the profiler
    # does not tie it there) and by name
    kernel = sum(r[1] for r in dev
                 if any(n in r[0] for n in VISION_KERNELS)) / 1e3
    qmm = ms["quantized_matmul"] - ms["kernel"]
    out = {"busy_ms": busy, "im2col": ms["im2col"],
           "depthwise": ms["depthwise"], "quantize": ms["quantize"],
           "pack": ms["pack"], "kernel": kernel,
           "pad_cast": qmm - ms["quantize"] - ms["pack"],
           "rest": busy - ms["im2col"] - ms["depthwise"] - qmm - kernel}
    out["kernel_share"] = out["kernel"] / busy if busy else None
    out["top"] = [{"op": k[:70], "ms": us / 1e3, "calls": n}
                  for k, us, n in dev[:8]]
    return out


def vision_calls(torch, fn):
    """The packed matmul's distinct calls in one forward, keyed (M, K, N,
    a_bits, w_bits) with K and N unpadded: [the first call's (x, pw,
    quant), the number of calls]."""
    from repro_torch.models import vision as V
    calls, good = {}, V.quantized_matmul

    def spy(x, pw, quant):
        key = (x.numel() // pw.k, pw.k, pw.n, quant.a_bits, pw.w_bits)
        calls.setdefault(key, [(x, pw, quant), 0])[1] += 1
        return good(x, pw, quant)
    patched([(V, "quantized_matmul", spy)], fn)
    return calls


def time_vision_call(torch, timer, x, pw, quant):
    """One packed-matmul call of a forward, as the integer kernel sees it
    (K padded to 256, N to 128; the activations quantized and packed as
    ``ops.quantized_matmul`` does): bitwise against its plain version,
    timed beside it, the yardstick and the bound.  ``bound_ms`` counts
    the conv's own work at its unpadded k and n: x (M, k) read once at
    a_bits, the (k, n) weight at w_bits and both scales, the float32
    (M, n) output written once, and 2 M k n operations at the int8
    tensor-core rate.  ``padded_bound_ms`` counts the same on the
    operands the kernel is given (K padded to 256, N to 128)."""
    from repro_torch.core.packing import pack, pack_factor
    from repro_torch.core.quant import quantize_activation
    from repro_torch.kernels import mpq_matmul as mm
    a, w = quant.a_bits, pw.w_bits
    kp = pw.packed.shape[0] * pack_factor(w)
    x2 = torch.nn.functional.pad(x.reshape(-1, pw.k),
                                 (0, kp - pw.k)).contiguous()
    xq, xs = quantize_activation(x2, a)
    if a < 8:
        xq = pack(xq, a, axis=1)
    xq, xs, ws = xq.contiguous(), xs.contiguous(), pw.scale[None, :]
    m, np_ = x2.shape[0], pw.packed.shape[1]
    run = lambda: mm.mpq_matmul(xq, xs, pw.packed, ws,  # noqa: E731
                                a_bits=a, w_bits=w)
    plain = lambda: mm.mpq_matmul_plain(xq, xs, pw.packed,  # noqa: E731
                                        ws, a_bits=a, w_bits=w)
    if not torch.equal(run(), plain()):
        fail(f"vision mpq_matmul a{a}w{w} M={m} K={kp} N={np_}: not "
             "bitwise equal to its plain version")
    k, n = pw.k, pw.n
    nbytes = (m * k * a + k * n * w) / 8 + (m + n) * 4 + m * n * 4
    bound, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS)
    padded = sum(t.numel() * t.element_size()
                 for t in (xq, xs, pw.packed, ws)) + m * np_ * 4
    rec = {"M": m, "K": kp, "N": np_, "k": k, "n": n,
           "ms": timer.ms(run, iters=5, warmup=1),
           "plain_ms": timer.ms(plain, iters=3, warmup=1),
           "bound_ms": bound, "bound_by": by,
           "padded_bound_ms": bound_ms(padded, 2.0 * m * kp * np_,
                                       INT8_OPS)[0],
           "useful_ops_share": pw.k * pw.n / (kp * np_),
           "yardstick_ms": int_yardstick(torch, timer, xq, a, pw.packed,
                                         w)[1]}
    return rec


def vision_phase(torch, card):
    """Phase 15: Table VI's quantized CNNs at full size on random weights
    (``vision_params``): MobileNetV1 (base 32, 224 x 224, 1000 classes)
    in float32, 8b and 8b4b, ResNet-20 (base 16, 32 x 32, 10 classes) in
    float32, 8b and 4b2b, each at batch 1 and a larger batch, with
    PackedWeight leaves packed once (``pack_vision``).  For each forward,
    every kernel's launch count is set to 0 just before and read just
    after: the integer kernel must launch ``launches`` times (0 in
    float32) and no other kernel at all.  The logits must be finite;
    float32's within VISION_F32_TOL of a float64 forward of the same
    weights, each integer format's bit for bit those of the same forward
    with the plain matmul (``plain_vision``).  Printed: the median
    latency and images/s, each distinct matmul call's kernel time beside
    its plain version, yardstick and bound (``time_vision_call``), the
    device time by part at the larger batch (``vision_breakdown``) and
    ``model_bytes`` (packing arithmetic).  Runs after every earlier
    phase's weights are released.  Returns the kernels line's record."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mpq_matmul as mm
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models import vision as V
    t0 = time.perf_counter()
    timer = Timer(torch)
    others = (lambda: fa.launches + pfd.launches + pfd.quant_launches
              + pfd.mla_launches + pfd.mla_quant_launches)
    total = {"launches": 0, "reduce_launches": 0}
    summary = {}
    for net, n in VISION_NETS.items():
        specs, apply, raw = vision_params(torch, net)
        g = torch.Generator(device="cuda").manual_seed(16)
        images = {b: torch.randn((b, n["img"], n["img"], 3), generator=g,
                                 device="cuda") for b in n["batches"]}
        fp32 = {}
        for tag, fmt in n["formats"].items():
            quant = (None if fmt is None else
                     QuantConfig(mode="int", a_bits=fmt[0], w_bits=fmt[1]))
            params = raw if quant is None else pack_vision(specs, raw, quant)
            for b, x in images.items():
                fn = lambda: apply(params, x, quant)  # noqa: E731
                want = n["launches"] if quant is not None else 0
                # the main path: counts at 0 just before, read just after
                fa.launches = pfd.launches = pfd.quant_launches = 0
                pfd.mla_launches = pfd.mla_quant_launches = 0
                mm.launches = mm.reduce_launches = 0
                y = fn()
                torch.cuda.synchronize()
                rec = {"phase": "vision", "net": net, "format": tag,
                       "batch": b, "launches": mm.launches,
                       "reduce_launches": mm.reduce_launches,
                       "other_launches": others()}
                if mm.launches != want or others():
                    fail(f"vision {net} {tag} batch {b}: {mm.launches} "
                         f"integer-kernel launches (want {want}) and "
                         f"{others()} of other kernels (want 0)")
                total["launches"] += mm.launches
                total["reduce_launches"] += mm.reduce_launches
                if tuple(y.shape) != (b, n["classes"]) or \
                        not bool(torch.isfinite(y).all()):
                    fail(f"vision {net} {tag} batch {b}: logits "
                         f"{tuple(y.shape)}, finite "
                         f"{bool(torch.isfinite(y).all())}")
                if quant is None:
                    y64 = apply({k: v.double() for k, v in raw.items()},
                                x.double(), None)
                    err = rel_err(y, y64)
                    rec.update(vs_float64=err, tol=VISION_F32_TOL)
                    if not err <= VISION_F32_TOL:
                        fail(f"vision {net} fp32 batch {b}: logits "
                             f"{err} of the row max from a float64 "
                             f"forward (> {VISION_F32_TOL})")
                    fp32[b] = y
                else:
                    plain = plain_vision(torch, fn)
                    if not torch.equal(y, plain):
                        fail(f"vision {net} {tag} batch {b}: logits differ "
                             f"from the plain matmul's by "
                             f"{(y - plain).abs().max().item()}")
                    rec.update(bitwise_plain=True,
                               vs_fp32=rel_err(y, fp32[b]),
                               argmax_as_fp32=(y.argmax(1) == fp32[b].argmax(
                                   1)).float().mean().item())
                    del plain
                rec["ms"] = forward_ms(torch, fn)
                rec["images_per_s"] = b / rec["ms"] * 1e3
                if quant is not None:
                    calls = vision_calls(torch, fn)
                    rec["calls"] = [dict(time_vision_call(torch, timer,
                                                          *c[0]),
                                         per_forward=c[1])
                                    for c in calls.values()]
                    rec["kernel_ms_per_forward"] = sum(
                        c["ms"] * c["per_forward"] for c in rec["calls"])
                    for key in ("bound_ms", "padded_bound_ms"):
                        rec[key + "_per_forward"] = sum(
                            c[key] * c["per_forward"] for c in rec["calls"])
                    del calls
                if b == max(n["batches"]):
                    rec["device_ms"] = vision_breakdown(torch, fn)
                    if quant is not None and not rec["device_ms"]["kernel"]:
                        fail(f"vision {net} {tag}: the profiler shows no "
                             f"device time of {VISION_KERNELS}")
                rec["model_bytes"] = V.model_bytes(specs, quant)
                print(json.dumps(rec), flush=True)
                big = max(rec.get("calls", [{}]),
                          key=lambda c: c.get("M", 0) * c.get("K", 0))
                summary[f"{net}_{tag}_b{b}"] = {
                    "ms": rec["ms"], "images_per_s": rec["images_per_s"],
                    "launches": rec["launches"],
                    "reduce_launches": rec["reduce_launches"],
                    **({} if quant is None else {
                        "kernel_ms": rec["kernel_ms_per_forward"],
                        "bound_ms": rec["bound_ms_per_forward"],
                        "padded_bound_ms":
                            rec["padded_bound_ms_per_forward"],
                        "largest": {k: big[k] for k in (
                            "M", "K", "N", "k", "n", "ms", "plain_ms",
                            "bound_ms", "padded_bound_ms")}})}
                del y
            del params
            torch.cuda.empty_cache()
        del raw, images, fp32
        torch.cuda.empty_cache()
    del timer
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "vision_phase", "card": card,
                      "launches": total, "peak_bytes":
                      torch.cuda.max_memory_allocated(),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return dict(total, runs=summary)


# ---------------------------------------------------------------------------
# Phase 16: the MoE FFN in attn_moe blocks (granite-moe-1b-a400m).
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
# the replayed logits (``moe_logit_check``): the kernel engine's logits
# against a replay of its own dispatches with the kernels' plain versions
# (same tokens, same dispatch shapes, so the same capacities, and the kernel
# run's routing, ``route_forcer``: no bf16 routing flip), held by the
# largest row error and the mean square of the row errors, each within
# this multiple of the same statistic of a kernel-free floor (the replay
# with attention on widened inputs against the plain replay) and at least
# SERVE_REL_TOL_BF16 (squared for the mean square), as phases 7 and 10
# hold theirs; the planted fault (gates not renormalised) must land
# MOE_FAULT_MARGIN times outside one of the two bounds
SERVE_MOE_NOISE_FACTOR = 1.5
MOE_FAULT_MARGIN = 1.3
# the fault replay runs the log's first dispatches only (every fresh
# wave of the first eight prompts, and decode steps after them): on the
# card the gates fault lands 4.4x (granite) and 9.7-9.8x (deepseek) outside
# the RMS bound (PERF.md §6)
MOE_FAULT_DISPATCHES = 24
# moe_ffn on the card in float32 against the CPU port (``moe_unit_checks``)
# on the CPU tests' (tests/torch_moe_cases.py) shapes, capacity factor,
# masks and planted ties and overflow: summation order only
MOE_UNIT = dict(B=3, S=20, D=32, E=8, K=2, F=16, shared=0, factors=(0.5,),
                masks={"none": None, "chunk": (20, 13, 5),
                       "masked_row": (20, 7, 0)}, tol=1e-5)
# the parts of a dispatch timed apart (``moe_breakdown``): the functions
# of models/moe.py and the attention sublayer of models/blocks.py
MOE_PARTS = ("route", "_dispatch", "_expert_swiglu", "_combine")


def moe_unit_case(torch, u, ties, factor, device):
    """Float32 weights (the routed banks, the router and, where ``u`` has
    shared experts, the ``shared`` subtree) and tokens at the shapes of
    ``u`` (MOE_UNIT or MLA_MOE_UNIT) from seed 0, with ``ties`` planted
    (two equal router columns, 'columns', or four tokens of zeros, whose
    E probabilities all tie, 'row'), and their config at capacity
    ``factor``.  At MOE_UNIT these are the CPU tests' inputs
    (``tests/torch_moe_cases.py::unit_inputs``)."""
    import numpy as np
    from repro_torch.models.config import ArchConfig
    b, s, d, e, f = u["B"], u["S"], u["D"], u["E"], u["F"]
    fs = f * u["shared"]
    rng = np.random.RandomState(0)
    p = {"router": rng.randn(d, e) * 0.3,
         "w_gate": rng.randn(e, d, f) / np.sqrt(d),
         "w_up": rng.randn(e, d, f) / np.sqrt(d),
         "w_down": rng.randn(e, f, d) / np.sqrt(f)}
    sh = {"w_gate": rng.randn(d, fs) / np.sqrt(d),
          "w_up": rng.randn(d, fs) / np.sqrt(d),
          "w_down": rng.randn(fs, d) / np.sqrt(fs)} if fs else None
    x = rng.randn(b, s, d).astype(np.float32)
    if ties == "columns":
        p["router"][:, 5] = p["router"][:, 2]
    else:
        x[0, 2] = x[1, 3] = x[2, 4] = x[0, 11] = 0.0
    cfg = ArchConfig(name="moe_unit", family="moe", n_layers=1, d_model=d,
                     n_heads=4, n_kv_heads=2, d_ff=0, vocab_size=64,
                     n_experts=e, top_k=u["K"], d_ff_expert=f,
                     n_shared_experts=u["shared"], capacity_factor=factor,
                     dtype=torch.float32)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    p = {k: t(v) for k, v in p.items()}
    if sh:
        p["shared"] = {k: t(v) for k, v in sh.items()}
    return p, t(x), cfg


def moe_unit_checks(torch, u, phase):
    """``moe_ffn`` on the card in float32 at the shapes of ``u`` (MOE_UNIT
    or MLA_MOE_UNIT, shared experts where it has them), at each of its
    capacity factors, on planted ties, with and without a chunk mask (one
    with a wholly masked row): output and aux within ``u["tol"]`` of the
    port's on the CPU, and each assignment's expert, capacity slot and
    ``keep`` bit for bit (the stable sort, ``searchsorted`` and the
    scatter on the card).  Printed as ``phase``."""
    import numpy as np
    from repro_torch.models import moe
    tol, recs = u["tol"], {}
    for factor in u["factors"]:
        for ties in ("columns", "row"):
            for mname, lens in u["masks"].items():
                runs = {}
                for dev in ("cpu", "cuda"):
                    p, x, cfg = moe_unit_case(torch, u, ties, factor, dev)
                    mask = None if lens is None else torch.from_numpy(
                        np.arange(u["S"])[None, :]
                        < np.asarray(lens)[:, None]).to(dev)
                    y, aux = moe.moe_ffn(p, x, cfg, mask)
                    r = moe.route(p, x.reshape(-1, u["D"]), cfg, mask)
                    routed = r.experts.reshape(-1) < u["E"]
                    runs[dev] = (y.cpu(), float(aux), r.idx_e.cpu(),
                                 r.idx_c.cpu(), r.keep.cpu(),
                                 int((~r.keep & routed).sum()), r.cap)
                (yc, ac, ec, cc, kc, dc, cap), (yg, ag, eg, cg, kg, dg, _) = \
                    runs["cpu"], runs["cuda"]
                key = f"f{factor}_{ties}_{mname}"
                rec = {"max_abs_err": (yg - yc).abs().max().item(),
                       "aux_err": abs(ag - ac), "tol": tol,
                       "routing_bitwise": bool(torch.equal(eg, ec)
                                               and torch.equal(cg, cc)
                                               and torch.equal(kg, kc)),
                       "dropped": [dc, dg], "capacity": cap}
                recs[key] = rec
                if not (rec["max_abs_err"] <= tol and rec["aux_err"] <= tol):
                    fail(f"{phase}: moe_ffn on the card, {key}: {rec}: "
                         f"beyond {tol} of the CPU port's")
                if not rec["routing_bitwise"]:
                    fail(f"{phase}: moe_ffn on the card, {key}: its routing "
                         "(experts, capacity slots, keep) differs from the "
                         "CPU port's")
    print(json.dumps({"phase": phase, "cases": recs}), flush=True)
    return recs


def moe_kernel_checks(torch):
    """The attention kernels at granite's shape (H 16 / KV 8, dh 64, G 2)
    in bf16 against their plain versions: the flash forward at a 256-row
    chunk, the paged kernel at the engine's decode split and on a
    resumed 256-row chunk (timed), and at every PAGED_EDGES case with
    the PAGED_SHIFT fault outside PAGED_EDGE_TOL_BF16."""
    timer = Timer(torch)
    recs = {"flash": check_flash(torch, timer, torch.bfloat16, H=16, KV=8,
                                 dh=64),
            "decode": check_paged(torch, timer, torch.bfloat16, Sq=1, H=16,
                                  KV=8, dh=64),
            "resumed": check_paged(torch, timer, torch.bfloat16, Sq=256,
                                   H=16, KV=8, dh=64)}
    edges = paged_edge_checks(torch, timer, H=16, KV=8, dh=64)
    for key, rec in list(recs.items()) + list(edges.items()):
        print(json.dumps(dict(phase="kernel_moe", arch=MOE_ARCH, case=key,
                              **rec)), flush=True)
    recs["edges"] = edge_summary(f"paged_edges {MOE_ARCH}", edges)
    print(json.dumps(recs["edges"]), flush=True)
    del timer
    torch.cuda.empty_cache()
    return recs


def live_rows(kind, args):
    """The slots a recorded dispatch computes for: a chunk's slots with
    a length, decode's with a position (the engine reads only those)."""
    return (args[1] > 0) if kind != "decode" else (args[1] >= 0)


def live_tokens(kind, args):
    """(B * S,) the tokens a recorded dispatch routes for a live slot."""
    import torch
    if kind == "decode":
        return (args[1] >= 0).reshape(-1)
    s = args[0].shape[1]
    ar = torch.arange(s, device=args[1].device)
    return (ar[None, :] < args[1][:, None]).reshape(-1)


def route_recorder(routes):
    """(module, name, value) pairs that make ``moe.route`` append each
    call's (experts, keep) to ``routes``, in call order."""
    from repro_torch.models import moe
    good = moe.route

    def rec(p, xf, cfg, token_mask=None):
        r = good(p, xf, cfg, token_mask)
        routes.append((r.experts, r.keep))
        return r
    return [(moe, "route", rec)]


def route_forcer(torch, routes, renormalise=True):
    """(module, name, value) pairs that make ``moe._top_k_gates``, call
    after call, choose the experts of ``routes`` (``route_recorder``'s
    record of the kernel run; a masked token's sentinel stands in for
    any expert, the mask puts it back), with the replay's own router
    probabilities at them as gates, renormalised as the port's are
    unless ``renormalise`` is False (the planted fault).  The capacity
    slots and ``keep`` then follow from the experts and the mask as in
    the kernel run."""
    from repro_torch.models import moe
    calls = iter(routes)

    def forced(probs, k):
        experts = next(calls)[0].clamp_max(probs.shape[-1] - 1)
        gates = probs.gather(1, experts)
        if renormalise:
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                            1e-9)
        return gates, experts
    return [(moe, "_top_k_gates", forced)]


# the replays' planted faults: the gates not renormalised ('fault'), the
# shared experts' output left out ('no_shared')
MOE_FAULTS = ("fault", "no_shared")


def replay_attention(torch, how):
    """(module, name, value) pairs for a replay: the attention kernels
    replaced by their plain versions, where the GQA module
    (``models/attention.py``) and the MLA module (``models/mla.py``) call
    them by name ('plain' and the faults), or by the plain versions on
    inputs widened to float32 ('widened', the noise floor: nothing rounds
    to bf16 inside attention); 'no_shared' also takes the shared experts'
    output out of the MoE FFN, 'no_decay' the decay out of every mamba
    decode step (``no_decay_mixer``; 'fault' is ``route_forcer``'s)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import moe
    wide = (lambda t: t.float()) if how == "widened" else (lambda t: t)

    def flash(q, k, v, *, kv_valid=None):
        return fa.flash_attention_plain(wide(q), wide(k), wide(v),
                                        kv_valid).to(q.dtype)

    def paged(k_pool, v_pool, q, tbl, qpos, kv_valid, *,
              pages_per_split=1, **quant):
        return pfd.paged_flash_decode_partials_plain(
            wide(k_pool), wide(v_pool), wide(q), tbl, qpos, kv_valid,
            pages_per_split, **quant)

    def mla_partials(pool, q_c, q_rope, tbl, pos, r, scale_dim, *,
                     scale_pool=None, bits=None, pages_per_split=1):
        # a quantized pool is dequantized to the (widened) query type
        return pfd.mla_paged_decode_partials_plain(
            pool if bits is not None else wide(pool), wide(q_c),
            wide(q_rope), tbl, pos, r, scale_dim, pages_per_split,
            scale_pool=scale_pool, bits=bits)

    pairs = [(attn_mod, "flash_attention", flash),
             (attn_mod, "paged_flash_decode_partials", paged),
             (mla_mod, "flash_attention", flash),
             (mla_mod, "mla_paged_decode_partials", mla_partials)]
    if how == "no_decay":
        pairs.append(no_decay_mixer(torch))
    if how == "no_shared":
        pairs.append((moe, "_shared_experts",
                      lambda sh, xf, cfg: torch.zeros_like(xf)))
    return pairs


def kernel_launches():
    """Every attention kernel's launch count, by wrapper."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    return {"flash_attention_fwd": fa.launches,
            "paged_flash_decode_partials": pfd.launches,
            "paged_flash_decode_partials_quant": pfd.quant_launches,
            "mla_paged_decode_partials": pfd.mla_launches,
            "mla_paged_decode_partials_quant": pfd.mla_quant_launches}


def replay(torch, cfg, params, sc, log, how, forced=None, states=None):
    """Feed the dispatches of ``log`` (``record_dispatches(...,
    keep_args=True)``), copy-on-write page copies included, through a new
    engine in their order, under ``replay_attention(how)``, which must
    launch no kernel, and where ``forced`` (the kernel run's routes) is
    given, on the kernel run's routing (``route_forcer``; the 'fault'
    replay's gates not renormalised), which it must reproduce: expert and
    ``keep`` of every assignment bit for bit.  Returns each dispatch's
    live rows' logits (CPU float32) and its routes; ``states``, a list,
    receives the engine's recurrent state leaves as the replay leaves
    them (phase 18)."""
    from repro_torch.serve import ServingEngine
    eng = ServingEngine(cfg, params, sc, device=params.embed.device)
    routes, out = [], []

    def run():
        with torch.inference_mode():
            for kind, _, (name, args, _) in log:
                if kind == "copies":
                    eng._apply_copies(*args)
                    continue
                logits, eng.cache = getattr(eng, name)(eng.params,
                                                       eng.cache, *args)
                out.append(logits[live_rows(kind, args)].float().cpu())
            if states is not None:
                states.extend(leaf.clone() for leaf in eng._state_leaves())
    pairs = route_recorder(routes) + replay_attention(torch, how)
    if forced is not None:
        pairs += route_forcer(torch, forced, renormalise=how != "fault")
    before = kernel_launches()
    patched(pairs, run)
    if kernel_launches() != before:
        fail(f"{cfg.name}: the {how!r} replay launched kernels: "
             f"{before} -> {kernel_launches()}")
    if forced is not None and not all(
            torch.equal(e, fe) and torch.equal(k, fk)
            for (e, k), (fe, fk) in zip(routes, forced, strict=False)):
        fail(f"{cfg.name}: the forced {how!r} replay routed otherwise than "
             "the kernel run")
    del eng
    torch.cuda.empty_cache()
    return out, routes


def moe_layers(cfg) -> int:
    """The layers whose FFN routes (``attn_moe`` and ``mla_moe``)."""
    return sum(e[2] for e in cfg.pattern if e[1].endswith("_moe"))


def moe_routing_stats(cfg, log, routes, plain_routes):
    """Routing of the kernel engine's run: its dropped assignments by
    dispatch kind (every routed token's, and the live slots' alone), and
    the share of live (token, k) choices the plain replay agrees on, at
    the same k and anywhere in the token's top k.  Returns (by kind, the
    two shares)."""
    e, n = cfg.n_experts, moe_layers(cfg)
    kinds = {k: {"dispatches": 0, "assignments": 0, "dropped": 0,
                 "live_assignments": 0, "live_dropped": 0, "agree": 0,
                 "agree_set": 0}
             for k in ("fresh", "resumed", "decode")}
    disp = [(kind, args) for kind, _, (_, args, _) in log if kind != "copies"]
    if len(routes) != n * len(disp) or len(plain_routes) != len(routes):
        fail(f"moe routing: {len(routes)} and {len(plain_routes)} routes "
             f"recorded for {len(disp)} dispatches of {n} MoE layers")
    for i, (kind, args) in enumerate(disp):
        rec = kinds[kind]
        rec["dispatches"] += 1
        live = live_tokens(kind, args)
        for layer in range(n):
            experts, keep = routes[i * n + layer]
            p_experts = plain_routes[i * n + layer][0]
            routed = experts < e
            dropped = ~keep.reshape(experts.shape) & routed
            rec["assignments"] += int(routed.sum())
            rec["dropped"] += int(dropped.sum())
            rec["live_assignments"] += int(live.sum()) * cfg.top_k
            rec["live_dropped"] += int(dropped[live].sum())
            rec["agree"] += int((experts == p_experts)[live].sum())
            # the same expert anywhere in the token's top k
            rec["agree_set"] += int((experts[:, :, None] == p_experts[
                :, None, :]).any(-1)[live].sum())
    total = sum(r["live_assignments"] for r in kinds.values())
    share = {key: sum(r[key] for r in kinds.values()) / total
             for key in ("agree", "agree_set")}
    for rec in kinds.values():
        n = rec["live_assignments"]
        agree, agree_set = rec.pop("agree"), rec.pop("agree_set")
        rec["agreement"] = agree / n if n else None
        rec["set_agreement"] = agree_set / n if n else None
    return kinds, share["agree"], share["agree_set"]


def moe_logit_check(torch, tag, kern, plain, wide, faults):
    """Hold the kernel engine's logits (``kern``, a dispatch's rows)
    against the plain replay's by ``int_stats`` (the largest row error
    and the mean square of the row errors), each within
    SERVE_MOE_NOISE_FACTOR times the widened replay's and at least
    SERVE_REL_TOL_BF16 (squared); each fault replay (``faults``: name ->
    rows of the first dispatches only) must land MOE_FAULT_MARGIN outside
    one of the bounds on the same dispatches' rows, the mean square's
    ratio taken as an RMS ratio.  Returns the record."""
    cat = lambda xs: torch.cat(xs)  # noqa: E731
    ref = cat(plain)
    err, floor = (int_stats(cat(x), ref) for x in (kern, wide))
    lowest = {"max": SERVE_REL_TOL_BF16, "mean_sq": SERVE_REL_TOL_BF16 ** 2}
    tol = {s: max(lowest[s], SERVE_MOE_NOISE_FACTOR * v)
           for s, v in floor.items()}
    got = cat(kern)
    rec = {"rows": int(ref.shape[0]), "max_rel_err": err["max"],
           "mean_sq_rel_err": err["mean_sq"], "noise_floor": floor["max"],
           "mean_sq_noise_floor": floor["mean_sq"], "rel_tol": tol["max"],
           "mean_sq_rel_tol": tol["mean_sq"],
           "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float()
           .mean().item()}
    for s, v in err.items():
        if not v <= tol[s]:
            fail(f"{tag}: the engine's logits read {v} by {s} of the row "
                 f"errors against the plain replay (> {tol[s]}; {rec})")
    for name, rows in faults.items():
        bad = int_stats(cat(rows), cat(plain[:len(rows)]))
        over = {"max": bad["max"] / tol["max"],
                "rms": math.sqrt(bad["mean_sq"] / tol["mean_sq"])}
        rec[name], rec[f"{name}_over_bound"] = bad, over
        if not max(over.values()) >= MOE_FAULT_MARGIN:
            fail(f"{tag}: the planted fault {name!r} lands at {over} of the "
                 f"bounds, not {MOE_FAULT_MARGIN}x outside either ({rec})")
    return rec


def moe_breakdown(torch, eng, entry, parts=MOE_PARTS):
    """One recorded dispatch run again on ``eng`` (its step as it served,
    the cache as the run left it): the median wall ms of five calls to
    the card's end (host clock), and ``torch.profiler``'s device ms in
    all (busy) and by part: the attention sublayers, the FFN sublayers,
    the mamba blocks' mixers (phase 18; 0 without), and of the MoE FFN
    each function of ``parts`` (the routing, the
    dispatch, the experts' GEMMs, the combine and, where the model has
    them, the shared experts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.profile_serve import (ATTENTION, FFN, MAMBA,
                                                  _wrap_sublayers)
    from repro_torch.launch.profile_serve import _device_us as device_us
    from repro_torch.models import moe
    kind, _, (name, args, _) = entry
    step = getattr(eng, name).__wrapped__      # the step, not its logger

    def ranged(f, label):
        def run(*a, **k):
            with record_function(label):
                return f(*a, **k)
        return run

    def call():
        with torch.inference_mode():
            step(eng.params, eng.cache, *args)
        torch.cuda.synchronize()
    call()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    pairs = [(moe, n, ranged(getattr(moe, n), n)) for n in parts]
    restore = _wrap_sublayers()
    try:
        def prof():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                call()
            return p.key_averages()
        avgs = patched(pairs, prof)
    finally:
        restore()
    labels = parts + (ATTENTION, FFN, MAMBA)
    span = {e.key: device_us(e, own=False) / 1e3 for e in avgs
            if e.device_type == DeviceType.CPU and e.key in labels}
    busy = sum(device_us(e) for e in avgs
               if e.device_type == DeviceType.CUDA and e.key not in labels
               ) / 1e3
    part_ms = {k: span.get(k, 0.0) for k in labels}
    ffn = sum(part_ms[k] for k in parts)
    # the FFN sublayers' range holds the parts, the aux loss and any dense
    # MLP layer too
    return {"kind": kind, "live_slots": int(live_rows(kind, args).sum()),
            "rows": list(args[0].shape), "wall_ms": statistics.median(times),
            "busy_ms": busy, "attention_ms": part_ms[ATTENTION],
            "mamba_ms": part_ms[MAMBA],
            "ffn_ms": ffn, "ffn_sublayers_ms": part_ms[FFN],
            **{f"ffn_{k.strip('_')}_ms": part_ms[k] for k in parts}}


def serve_moe(torch, card, cfg, params, paged, phase="serve_moe"):
    """Phase 16 (and 17), one layout: serve phase 3's traffic on the
    paged pool (phase 3's engine) or the contiguous cache (phase 14's),
    with every dispatch recorded (``record_dispatches(...,
    keep_args=True)``) and every route.  Every
    request completes; each dispatch launches its one attention kernel
    once a layer and the others none (GQA: the flash forward on a fresh
    wave, the paged partials otherwise; MLA: the MLA decode partials at
    decode).  Then the dispatches are replayed (``replay``) with the
    kernels' plain versions on the kernel run's routing, with them on
    widened inputs (the floor) on that routing too, and the first
    MOE_FAULT_DISPATCHES with each planted fault (the shared experts'
    only where the model has them), and the logits are held by
    ``moe_logit_check``: forced routing keeps bf16 routing flips (top k
    of E near-ties, capacity) out of the bound, which then reads the
    attention's and the FFN's rounding.  A plain replay on its own
    routing gives the routing agreement.
    Printed: launches, bytes, routing agreement and drops by dispatch
    kind, and the device time by part of a full decode dispatch and of
    a fresh wave.  Returns the launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    import numpy as np
    mla = bool(cfg.kv_lora_rank)
    shared = bool(cfg.n_shared_experts)
    layout = "paged" if paged else "contiguous"
    tag = f"{cfg.name} {layout}"
    sc = (ServeConfig(max_batch=8, max_prompt=256, page_size=16,
                      max_seq=2048, max_new_tokens=32, record_logits=True)
          if paged else ServeConfig(paged=False, prefix_sharing=False,
                                    **CONTIG_SERVE))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, sc, device=params.embed.device)
    eng.warmup()
    reqs = [Request(i, p) for i, p in enumerate(smoke_traffic(
        cfg.vocab_size))]
    counters = {"flash_attention_fwd": lambda: fa.launches,
                "paged_flash_decode_partials": lambda: pfd.launches}
    want = {"fresh": "flash_attention_fwd",
            "resumed": "paged_flash_decode_partials",
            "decode": "paged_flash_decode_partials"}
    if mla:
        counters["mla_paged_decode_partials"] = lambda: pfd.mla_launches
        want["decode"] = "mla_paged_decode_partials"
    log = record_dispatches(eng, counters, keep_args=True)
    routes = []
    fa.launches = pfd.launches = pfd.mla_launches = 0
    wall, per_decode = patched(route_recorder(routes),
                               lambda: drive(torch, eng, reqs, counters))
    eng.drain()
    launches = {n: c() for n, c in counters.items()}
    log = list(log)
    kinds = {k: 0 for k in want}
    for kind, got, _ in log:
        if kind == "copies":
            continue
        kinds[kind] += 1
        exp = {n: (cfg.n_layers if n == want[kind] else 0) for n in counters}
        if got != exp:
            fail(f"{tag}: a {kind} dispatch launched {got}, want {exp}")
    need = ("fresh", "resumed", "decode") if paged else ("fresh", "decode")
    if min(kinds[k] for k in need) < 1 or (not paged and kinds["resumed"]):
        fail(f"{tag}: dispatch kinds {kinds}")
    for r in reqs:
        if not r.done or r.failed or len(r.out_tokens) != sc.max_new_tokens:
            fail(f"{tag}: request {r.rid}: done={r.done} failed={r.failed} "
                 f"tokens={len(r.out_tokens)}")
        if not all(bool(np.isfinite(x).all()) for x in r.logits):
            fail(f"{tag}: request {r.rid}: logits are not finite")
    if paged and eng.n_shared_admissions < 1:
        fail(f"{tag}: the shared-prefix request was not admitted as a "
             "sharer")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    rec = {"phase": phase, "arch": cfg.name, "layout": layout,
           "dtype": str(cfg.dtype), "layers": cfg.n_layers,
           "moe_layers": moe_layers(cfg),
           "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "stats": eng.stats(),
           "dispatches": kinds, "launches": launches,
           "launches_per_decode_tick": per_decode,
           "cache_bytes": eng.pool_bytes_per_shard(),
           "weight_bytes": weight_bytes(params), **memory(torch),
           "card": card}
    # device time by part: the first decode dispatch with every slot
    # live, and the first fresh wave, run again on the engine
    entries = [x for x in log if x[0] != "copies"]
    full = [x for x in entries if x[0] == "decode"
            and bool(live_rows("decode", x[2][1]).all())]
    parts = MOE_PARTS + (("_shared_experts",) if shared else ())
    rec["breakdown"] = [moe_breakdown(torch, eng, x, parts) for x in (
        (full or [x for x in entries if x[0] == "decode"])[0],
        [x for x in entries if x[0] == "fresh"][0])]
    print(json.dumps(rec), flush=True)
    del eng
    torch.cuda.empty_cache()
    kern = [x[2][2][live_rows(x[0], x[2][1]).cpu()] for x in entries]
    # the plain replay on its own routing: the routing agreement, and the
    # logits' distance with routing flips in it (printed, not held)
    free, free_routes = replay(torch, cfg, params, sc, log, "plain")
    plain, _ = replay(torch, cfg, params, sc, log, "plain", forced=routes)
    wide, _ = replay(torch, cfg, params, sc, log, "widened", forced=routes)
    n = [i for i, x in enumerate(log) if x[0] != "copies"][
        MOE_FAULT_DISPATCHES - 1] + 1
    bad = {how: replay(torch, cfg, params, sc, log[:n], how,
                       forced=routes)[0]
           for how in MOE_FAULTS if shared or how != "no_shared"}
    by_kind, agreement, set_agreement = moe_routing_stats(
        cfg, log, routes, free_routes)
    check = moe_logit_check(torch, tag, kern, plain, wide, bad)
    unforced = int_stats(torch.cat(kern), torch.cat(free))
    print(json.dumps({"phase": f"{phase}_check", "arch": cfg.name,
                      "layout": layout, **check,
                      "unforced_max_rel_err": unforced["max"],
                      "unforced_mean_sq_rel_err": unforced["mean_sq"],
                      "fault_dispatches": len(bad["fault"]),
                      "routing_agreement": agreement,
                      "routing_set_agreement": set_agreement,
                      "routing": by_kind,
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    del log, routes, free_routes
    torch.cuda.empty_cache()
    return launches


def moe_phase(torch, card):
    """Phase 16: granite-moe-1b-a400m (24 attn_moe blocks, d 1024, H 16
    / KV 8, dh 64, 32 experts, top 8) at full width and depth in bf16,
    random weights from a seeded generator, after every earlier phase's
    weights are released: the attention kernels at its shape
    (``moe_kernel_checks``), ``moe_ffn`` on the card against the CPU
    (``moe_unit_checks``), then phase 3's traffic on the paged pool and
    on the contiguous cache (``serve_moe``).  Returns (the kernel
    records, the launches by kernel, summed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    recs = moe_kernel_checks(torch)
    recs["unit"] = moe_unit_checks(torch, MOE_UNIT, "moe_unit")
    cfg = get_config(MOE_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(16),
                         device="cuda")
    total = serve_moe(torch, card, cfg, params, paged=True)
    for n, v in serve_moe(torch, card, cfg, params, paged=False).items():
        total[n] += v
    del params
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "moe_phase", "launches": total,
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    return recs, total


# ---------------------------------------------------------------------------
# Phase 17: two-scan programs and mla_moe blocks (deepseek-v2-lite-16b).
# ---------------------------------------------------------------------------

MLA_MOE_ARCH = "deepseek-v2-lite-16b"
# moe_ffn on the card in float32 at deepseek's expert count and top k,
# with its two shared experts, against the CPU port: summation order only.
# 192 tokens: 24 slots an expert at factor 1.25 (deepseek's), 16 at 0.5
MLA_MOE_UNIT = dict(B=3, S=64, D=32, E=64, K=6, F=16, shared=2,
                    factors=(1.25, 0.5),
                    masks={"none": None, "chunk": (64, 41, 17),
                           "masked_row": (64, 23, 0)}, tol=1e-6)


def mla_moe_phase(torch, card):
    """Phase 17: the published deepseek-v2-lite-16b (``mla_mlp`` x 1 +
    ``mla_moe`` x 26: d 2048, 16 MLA heads, r 512, dr 64, 64 experts
    top 6 and 2 shared, d_ff_expert 1408) at full width and depth in
    bf16, random weights from a seeded generator on the card, after
    every earlier phase's weights are released: ``moe_ffn`` on the card
    against the CPU (``moe_unit_checks``), then phase 3's traffic on
    the paged latent pool and on the contiguous cache (``serve_moe``).
    Returns (the unit records, the launches by kernel, summed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import MlaMlpBlock, MlaMoeBlock
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    unit = moe_unit_checks(torch, MLA_MOE_UNIT, "mla_moe_unit")
    cfg = get_config(MLA_MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(17),
                         device="cuda")
    kinds = [type(b) for b in params.blocks]
    if kinds != [MlaMlpBlock] + [MlaMoeBlock] * 26 or not all(
            "shared" in b.ffn for b in params.blocks[1:]):
        fail(f"{cfg.name}: blocks {[k.__name__ for k in kinds]}, want one "
             "MlaMlpBlock and 26 MlaMoeBlocks with shared experts")
    print(json.dumps({"phase": "mla_moe_weights", "arch": cfg.name,
                      "weight_bytes": weight_bytes(params),
                      "parameters": sum(t.numel()
                                        for t in params.parameters()),
                      **memory(torch), "card": card}), flush=True)
    total = serve_moe(torch, card, cfg, params, paged=True,
                      phase="serve_mla_moe")
    for n, v in serve_moe(torch, card, cfg, params, paged=False,
                          phase="serve_mla_moe").items():
        total[n] += v
    del params
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "mla_moe_phase", "launches": total,
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    return unit, total


# ---------------------------------------------------------------------------
# Phase 18: Mamba2 blocks and the shared attention block (zamba2-7b).
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-7b"
# the attention kernels at zamba2's shape: MHA, H = KV = 32, dh 112
HYBRID_HEADS = (32, 32, 112)
# the replays' planted fault: a mamba decode step's state not decayed
HYBRID_FAULTS = ("no_decay",)
# the overcommitted run: phase 12's pool and arrivals at 40 new tokens
# (149 ticks, 2 preemptions in the port's CPU schedule; 64 took 232)
HYBRID_OVERCOMMIT = dict(OVERCOMMIT, max_new_tokens=40)
# temperature sampling on the card (``sampling_checks``): N draws of one
# row of V logits at each T, within SAMPLE_TV_BOUND in total variation of
# the softmax (twice the largest expected distance, as the CPU test)
SAMPLE_N, SAMPLE_V, SAMPLE_TV_BOUND = 40_000, 40, 0.035
SAMPLE_TEMPS = (0.5, 1.0, 2.0)


def no_decay_mixer(torch):
    """(module, name, value): ``MambaBlock.mixer`` with ``A_log`` taken
    as -inf at decode, so exp(dt * A) = 1: the state is not decayed."""
    from repro_torch.models import ssm
    from repro_torch.models.blocks import MambaBlock

    class Over:
        def __init__(self, p, **over):
            self.p, self.over = p, over

        def __getitem__(self, k):
            return self.over[k] if k in self.over else self.p[k]

    def mixer(p, x, cfg, *, cache, mode, pos, offset=None):
        if mode == "decode":
            p = Over(p, A_log=torch.full_like(p["A_log"], -math.inf))
        return ssm.apply_mamba(p, x, cfg, cache=cache, mode=mode, pos=pos,
                               offset=offset)
    return (MambaBlock, "mixer", staticmethod(mixer))


def paged_library_ms(torch, timer, Sq, H, KV, dh, B=8, ps=16, P=128):
    """``scaled_dot_product_attention`` over each slot's window of
    ``check_paged``'s case at (Sq, H, KV, dh) (its seed: the same pool),
    gathered first and masked at each query's position and the slot's
    fill: the library call of the same function (kernel + combine) on a
    contiguous window.  Never on the main path."""
    import torch.nn.functional as F
    from repro_torch.models.common import paged_gather
    kp, vp, q, tbl, qpos, kvv, _ = paged_case(torch, torch.bfloat16, B, Sq,
                                              H, KV, dh, ps, P, seed=2 + Sq)
    k, v = (paged_gather(x, tbl).transpose(1, 2) for x in (kp, vp))
    kpos = torch.arange(k.shape[2], device="cuda")
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < kvv[:, None, None]))[:, None]
    qt = q.transpose(1, 2)
    return timer.ms(lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, enable_gqa=True))


def hybrid_kernel_checks(torch):
    """The attention kernels at zamba2's shape (H 32 / KV 32, dh 112, G
    1) against their plain versions: in bf16 the flash forward at a
    256-row chunk, the paged kernel at the engine's decode split and on
    a resumed 256-row chunk (timed, each beside its bound and SDPA's
    time), every FLASH_EDGES and PAGED_EDGES case (the PAGED_SHIFT fault
    outside PAGED_EDGE_TOL_BF16); in float32 the same three calls on the
    FMA routes; the decode kernel at phase 14's contiguous decode shape
    beside SDPA (``contiguous_yardstick``); and an int8 pool at dh 112
    refused at the wrapper (``quant_width_refused``)."""
    timer = Timer(torch)
    H, KV, dh = HYBRID_HEADS
    recs = {}
    for tag, dt in (("", torch.bfloat16), ("_f32", torch.float32)):
        recs["flash" + tag] = check_flash(torch, timer, dt, H=H, KV=KV,
                                          dh=dh)
        recs["decode" + tag] = check_paged(torch, timer, dt, Sq=1, H=H,
                                           KV=KV, dh=dh)
        recs["resumed" + tag] = check_paged(torch, timer, dt, Sq=256, H=H,
                                            KV=KV, dh=dh)
    for key in ("decode", "resumed"):
        rec = recs[key]
        rec["library_ms"] = paged_library_ms(
            torch, timer, rec["shapes"]["q"][1], H, KV, dh)
        rec["library_call"] = "scaled_dot_product_attention over each " \
            "slot's gathered window (the kernel's output after the combine)"
    fl = flash_edge_checks(torch, timer, H=H, KV=KV, dh=dh)
    edges = paged_edge_checks(torch, timer, H=H, KV=KV, dh=dh)
    for key, rec in list(recs.items()) + list(fl.items()) + \
            list(edges.items()):
        print(json.dumps(dict(phase="kernel_hybrid", arch=HYBRID_ARCH,
                              case=key, **rec)), flush=True)
    recs["flash_edges"] = {"cases": len(fl), "max_abs_err": max(
        r["max_abs_err"] for r in fl.values()), "tol": FLASH_TOL_BF16}
    recs["edges"] = edge_summary(f"paged_edges {HYBRID_ARCH}", edges)
    print(json.dumps(recs["edges"]), flush=True)
    recs["yardstick"] = contiguous_yardstick(torch, timer, H=H, KV=KV,
                                             dh=dh, mla=False)["gqa"]
    recs["quant_dh112_refused"] = quant_width_refused(torch, H, KV, dh)
    del timer
    torch.cuda.empty_cache()
    return recs


def quant_width_refused(torch, H, KV, dh):
    """A quantized pool at a head width the quantized kernel is not built
    for (QUANT_HEAD_DIMS: 128) must raise at the wrapper, on the card,
    before any launch.  Returns the message."""
    from repro_torch.kernels import paged_flash_decode as pfd
    n, ps, b = 8, 16, 2
    pool = torch.zeros((n, ps, KV, dh), dtype=torch.int8, device="cuda")
    scale = torch.ones((n, ps), dtype=torch.float32, device="cuda")
    q = torch.zeros((b, 1, H, dh), dtype=torch.bfloat16, device="cuda")
    tbl = torch.zeros((b, 4), dtype=torch.int32, device="cuda")
    pos = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    kvv = torch.ones((b,), dtype=torch.int32, device="cuda")
    before = pfd.quant_launches
    try:
        pfd.paged_flash_decode_partials(pool, pool, q, tbl, pos, kvv,
                                        k_scale=scale, v_scale=scale, bits=8)
    except ValueError as e:
        if pfd.quant_launches != before or "not built" not in str(e):
            fail(f"the quantized call at dh {dh}: {e}, launches "
                 f"{pfd.quant_launches - before}")
        return str(e)
    fail(f"a quantized pool at dh {dh} was not refused at the wrapper")


def sampling_checks(torch):
    """Temperature sampling on the card: the engine's ``_sample`` on
    SAMPLE_N copies of one row of SAMPLE_V logits (two equal maxima), its
    generator on the card; the empirical frequencies within
    SAMPLE_TV_BOUND in total variation of softmax(row / T), at each
    SAMPLE_TEMPS; T = 0 the lower argmax."""
    import types
    import numpy as np
    from repro_torch.serve import ServingEngine
    row = np.random.RandomState(0).randn(SAMPLE_V).astype(np.float32) * 1.5
    row[7] = row[11] = row.max() + 0.3
    x = torch.from_numpy(row).cuda()
    out = {}
    for t in (0.0,) + SAMPLE_TEMPS:
        eng = types.SimpleNamespace(
            sc=types.SimpleNamespace(temperature=t),
            generator=torch.Generator(device="cuda").manual_seed(18))
        got = ServingEngine._sample(eng, x[None].expand(SAMPLE_N, -1))
        if t == 0:
            if not (got == 7).all():
                fail(f"sampling at T 0 is not the lower argmax: {got[:8]}")
            continue
        freq = np.bincount(got, minlength=SAMPLE_V) / SAMPLE_N
        want = torch.softmax(x / t, -1).cpu().numpy()
        out[str(t)] = tv = 0.5 * float(np.abs(freq - want).sum())
        if not tv <= SAMPLE_TV_BOUND:
            fail(f"sampling at T {t}: TV {tv} from the softmax > "
                 f"{SAMPLE_TV_BOUND}")
    print(json.dumps({"phase": "sampling", "draws": SAMPLE_N,
                      "tv_by_temperature": out, "bound": SAMPLE_TV_BOUND}),
          flush=True)
    return out


def state_errs(torch, got, ref):
    """Per (state leaf, slot): the largest |got - ref| over the largest
    |ref|; the largest of them, and of each leaf kind (conv / ssm, the
    leaves alternating in the engine's order)."""
    errs = {"conv": 0.0, "ssm": 0.0}
    for i, (g, r) in enumerate(zip(got, ref, strict=True)):
        kind = ("conv", "ssm")[i % 2]
        for b in range(g.shape[1]):
            rb = r[:, b].float()
            e = (g[:, b].float() - rb).abs().max() / rb.abs().max().clamp(
                min=1e-30)
            errs[kind] = max(errs[kind], e.item())
    return errs


def serve_hybrid(torch, card, cfg, params, paged):
    """Phase 18, one layout: phase 3's traffic on the paged pool (phase
    3's engine) or the contiguous cache (phase 14's), every dispatch
    recorded (``record_dispatches(..., keep_args=True)``).  Every request
    completes; a fresh wave launches the flash kernel, a resumed wave and
    a decode step the paged kernel, once a shared-block position (13)
    and the other kernel never; no admission shares a prefix (recurrent
    state).  The dispatches are replayed (``replay``) with the attention
    kernels' plain versions, on widened inputs (the floor) and, for the
    first MOE_FAULT_DISPATCHES, with each HYBRID_FAULTS fault; the logits
    are held by ``moe_logit_check`` (the largest row error and the mean
    square, each within SERVE_MOE_NOISE_FACTOR of the floor and at least
    SERVE_REL_TOL_BF16), and every slot's final conv and SSM state
    against the plain replay's within the same multiple of the widened
    replay's distance (at least SERVE_REL_TOL_BF16).  Printed: launches
    by dispatch kind, bytes, peak memory, and on the paged layout the
    device ms by part (mamba, attention, MLP) of a full decode dispatch
    and a fresh wave.  Returns the launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models.model import flat_leaves
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    import numpy as np
    layout = "paged" if paged else "contiguous"
    tag = f"{cfg.name} {layout}"
    n_attn = sum(e[2] * sum(c for k, c in e[1] if k == "shared_attn")
                 for e in cfg.pattern if e[0] == "group")
    sc = (ServeConfig(max_batch=8, max_prompt=256, page_size=16,
                      max_seq=2048, max_new_tokens=32, record_logits=True)
          if paged else ServeConfig(paged=False, prefix_sharing=False,
                                    **CONTIG_SERVE))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, sc, device=params.embed.device)
    eng.warmup()
    reqs = [Request(i, p) for i, p in enumerate(smoke_traffic(
        cfg.vocab_size))]
    counters = {"flash_attention_fwd": lambda: fa.launches,
                "paged_flash_decode_partials": lambda: pfd.launches}
    want = {"fresh": "flash_attention_fwd",
            "resumed": "paged_flash_decode_partials",
            "decode": "paged_flash_decode_partials"}
    log = record_dispatches(eng, counters, keep_args=True)
    fa.launches = pfd.launches = 0
    wall, per_decode = drive(torch, eng, reqs, counters)
    launches = {n: c() for n, c in counters.items()}
    log = list(log)
    kinds = {k: 0 for k in want}
    by_kind = {k: {n: 0 for n in counters} for k in want}
    for kind, got, _ in log:
        if kind == "copies":
            continue
        kinds[kind] += 1
        for n, v in got.items():
            by_kind[kind][n] += v
        exp = {n: (n_attn if n == want[kind] else 0) for n in counters}
        if got != exp:
            fail(f"{tag}: a {kind} dispatch launched {got}, want {exp}")
    need = ("fresh", "resumed", "decode") if paged else ("fresh", "decode")
    if min(kinds[k] for k in need) < 1 or (not paged and kinds["resumed"]):
        fail(f"{tag}: dispatch kinds {kinds}")
    for r in reqs:
        if not r.done or r.failed or len(r.out_tokens) != sc.max_new_tokens:
            fail(f"{tag}: request {r.rid}: done={r.done} failed={r.failed} "
                 f"tokens={len(r.out_tokens)}")
        if not all(bool(np.isfinite(x).all()) for x in r.logits):
            fail(f"{tag}: request {r.rid}: logits are not finite")
    if eng.n_shared_admissions:
        fail(f"{tag}: {eng.n_shared_admissions} admissions shared a prefix "
             "over recurrent state")
    states = [leaf.clone() for leaf in eng._state_leaves()]
    n_tok = sum(len(r.out_tokens) for r in reqs)
    rec = {"phase": "serve_hybrid", "arch": cfg.name, "layout": layout,
           "dtype": str(cfg.dtype), "blocks": cfg.n_blocks(),
           "attention_positions": n_attn, "requests": len(reqs),
           "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "stats": eng.stats(), "dispatches": kinds, "launches": launches,
           "launches_by_dispatch_kind": by_kind,
           "launches_per_decode_tick": per_decode,
           "cache_bytes": sum(x.numel() * x.element_size()
                              for x in flat_leaves(eng.cache)),
           "pool_bytes": eng.pool_bytes_per_shard(),
           "state_bytes_per_slot": sum(
               x.numel() * x.element_size() // x.shape[1]
               for x in eng._state_leaves()),
           "weight_bytes": weight_bytes(params), **memory(torch),
           "card": card}
    entries = [x for x in log if x[0] != "copies"]
    full = [x for x in entries if x[0] == "decode"
            and bool(live_rows("decode", x[2][1]).all())]
    # the paged layout's only: the contiguous 1024-row wave's would add
    # ~11 s to the phase for the same split
    rec["breakdown"] = [moe_breakdown(torch, eng, x, ()) for x in (
        (full or [x for x in entries if x[0] == "decode"])[0],
        [x for x in entries if x[0] == "fresh"][0])] if paged else None
    print(json.dumps(rec), flush=True)
    del eng
    torch.cuda.empty_cache()
    kern = [x[2][2][live_rows(x[0], x[2][1]).cpu()] for x in entries]
    plain_states, wide_states = [], []
    plain, _ = replay(torch, cfg, params, sc, log, "plain",
                      states=plain_states)
    wide, _ = replay(torch, cfg, params, sc, log, "widened",
                     states=wide_states)
    n = [i for i, x in enumerate(log) if x[0] != "copies"][
        MOE_FAULT_DISPATCHES - 1] + 1
    bad = {how: replay(torch, cfg, params, sc, log[:n], how)[0]
           for how in HYBRID_FAULTS}
    check = moe_logit_check(torch, tag, kern, plain, wide, bad)
    err = state_errs(torch, states, plain_states)
    floor = state_errs(torch, wide_states, plain_states)
    tol = {k: max(SERVE_REL_TOL_BF16, SERVE_MOE_NOISE_FACTOR * v)
           for k, v in floor.items()}
    for k, v in err.items():
        if not v <= tol[k]:
            fail(f"{tag}: the slots' final {k} state reads {v} of its "
                 f"largest value from the plain replay's (> {tol[k]})")
    print(json.dumps({"phase": "serve_hybrid_check", "arch": cfg.name,
                      "layout": layout, **check,
                      "state_rel_err": err, "state_noise_floor": floor,
                      "state_rel_tol": tol,
                      "fault_dispatches": len(bad[HYBRID_FAULTS[0]]),
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    del log, states, plain_states, wide_states
    torch.cuda.empty_cache()
    return launches


def hybrid_overcommit(torch, card, cfg, params):
    """Phase 18's overcommitted run: OVERCOMMIT_ARRIVALS through a
    HYBRID_OVERCOMMIT pool (reserve_decode_pages=False, swap).  At least one
    preemption; every swap-in restores its pages and its recurrent state
    rows bit for bit (``watch_swaps``); every request completes with no
    fault and every page is free at the end.  Snapshot bytes (the state
    rows' share among them) and swap times are printed."""
    from repro_torch.serve import ServeConfig, ServingEngine
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, ServeConfig(**HYBRID_OVERCOMMIT),
                        device=params.embed.device)
    eng.warmup()
    rec = watch_swaps(torch, eng)
    reqs, wall = drive_plan(torch, eng, overcommit_traffic(cfg.vocab_size))
    st = eng.stats()
    if not (st["n_preemptions"] >= 1
            and rec["restored"] == st["n_swap_ins"] == st["n_preemptions"]):
        fail(f"{cfg.name} overcommit: {st}, {rec['restored']} restores "
             "checked")
    bad = [r.rid for r in reqs.values() if not r.done or r.failed
           or len(r.out_tokens) != HYBRID_OVERCOMMIT["max_new_tokens"]]
    if bad or eng.iotlb.faults or eng.pages_in_use():
        fail(f"{cfg.name} overcommit: requests {bad} incomplete, faults "
             f"{eng.iotlb.faults}, {eng.pages_in_use()} pages in use")
    out = {"phase": "hybrid_overcommit", "arch": cfg.name, "stats": st,
           "swap": swap_summary(rec), "log": rec["log"],
           "snapshot_bytes": rec["nbytes"],
           "state_bytes_per_snapshot": eng._slot_state_nbytes,
           "swap_out_ms": rec["out_ms"], "swap_in_ms": rec["in_ms"],
           "wall_s": wall, "seconds": time.perf_counter() - t0,
           "card": card}
    print(json.dumps(out), flush=True)
    del eng
    torch.cuda.empty_cache()
    return out


def hybrid_phase(torch, card):
    """Phase 18: zamba2-7b (13 x (5 ``mamba`` + the ``shared_attn``
    block) + 3 ``mamba``: d 3584, 112 SSM heads of 64, state 64, MHA at
    H 32, dh 112) at full width and depth in bf16, random weights from a
    seeded generator on the card, after every earlier phase's weights are
    released: the attention kernels at its shape
    (``hybrid_kernel_checks``), temperature sampling (``sampling_checks``),
    phase 3's traffic on the paged pool and the contiguous cache
    (``serve_hybrid``), and one overcommitted run
    (``hybrid_overcommit``).  Returns (the records, the launches by
    kernel, summed over both layouts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import AttnMlpBlock, MambaBlock
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    recs = hybrid_kernel_checks(torch)
    recs["sampling"] = sampling_checks(torch)
    cfg = get_config(HYBRID_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(18),
                         device="cuda")
    if len(params.blocks) != 68 or not all(
            isinstance(b, MambaBlock) for b in params.blocks) or \
            type(params.shared) is not AttnMlpBlock:
        fail(f"{cfg.name}: {len(params.blocks)} own blocks, shared "
             f"{type(params.shared).__name__}; want 68 MambaBlocks and one "
             "shared AttnMlpBlock")
    print(json.dumps({"phase": "hybrid_weights", "arch": cfg.name,
                      "weight_bytes": weight_bytes(params),
                      "parameters": sum(t.numel()
                                        for t in params.parameters()),
                      **memory(torch), "card": card}), flush=True)
    total = serve_hybrid(torch, card, cfg, params, paged=True)
    for n, v in serve_hybrid(torch, card, cfg, params, paged=False).items():
        total[n] += v
    recs["overcommit"] = hybrid_overcommit(torch, card, cfg, params)
    del params
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "hybrid_phase", "launches": total,
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    return recs, total


def kernel_entry(name, source, replaces, launches, rec, design=None):
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + source,
            "replaces": replaces, "launches": launches,
            "design": design or rec["design"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


def kernel_checks(torch, timer):
    """Phases 2 and 2b: the attention kernels against their plain
    versions.  Returns (qwen2.5-3b records, MLA path records, bf16 flash
    records at every head pair, the paged decode route's sweep)."""
    flash = flash_checks(torch, timer)
    # the paged kernel at the engine's split (decode: one 64-key tile),
    # and float32 decode also at one page a split (the engine's decode
    # split before the tile, so the FMA kernel's record compares with an
    # earlier tree's value for value)
    recs = [flash["dk128_dv128"],
            check_flash(torch, timer, torch.float32),
            check_paged(torch, timer, torch.bfloat16, Sq=1),
            check_paged(torch, timer, torch.bfloat16, Sq=256),
            check_paged(torch, timer, torch.float32, Sq=1),
            check_paged(torch, timer, torch.float32, Sq=256),
            check_paged(torch, timer, torch.float32, Sq=1, c=1)]
    # deepseek-v2-lite's MLA path: the fresh chunk's naive form (dk 192,
    # dv 128, KV = H = 16), the resumed chunk's expanded window viewed as
    # a pool of B * P pages, and the compressed-space decode partials
    mla = {"flash": flash["dk192_dv128"],
           "paged": check_paged(torch, timer, torch.bfloat16, Sq=256, KV=16,
                                dh=192, dv=128),
           "flash_f32": check_flash(torch, timer, torch.float32, KV=16,
                                    dh=192, dv=128),
           "paged_f32": check_paged(torch, timer, torch.float32, Sq=256,
                                    KV=16, dh=192, dv=128)}
    # the engine's split (one 64-key tile), timed in bf16; float32 also
    # at one page a split (the reference's per-page partials)
    for P in (64, 128, 256):
        mla[f"mla_P{P}"] = check_mla(torch, timer, torch.bfloat16, P)
        mla[f"mla_P{P}_f32"] = check_mla(torch, timer, torch.float32, P)
        mla[f"mla_P{P}_c1_f32"] = check_mla(torch, timer, torch.float32, P,
                                            c=1)
        for ps in MLA_EDGES_PS:
            if mla_split(ps, P) not in MLA_EDGES_C:
                fail(f"the engine's MLA split at page {ps}, P {P} "
                     f"({mla_split(ps, P)}) is not an MLA_EDGES case")
    # the online softmax across pages (several pages a split) and across
    # the sub-tiles of one page (page size 32); untimed
    for ps, c in ((16, 1), (16, 2), (16, 3), (32, 1), (32, 2)):
        for tag, dt in (("", torch.bfloat16), ("_f32", torch.float32)):
            mla[f"mla_P128_ps{ps}_c{c}{tag}"] = check_mla(
                torch, timer, dt, 128, ps=ps, c=c)
    more = [r for k, r in flash.items()
            if k not in ("dk128_dv128", "dk192_dv128")]
    from repro_torch.kernels.paged_flash_decode import HEAD_DIMS
    edges = {f"dk{dk}_dv{dv}_{key}": rec for dk, dv in HEAD_DIMS
             for key, rec in paged_edge_checks(
                 torch, timer, KV=16 if dk != dv else 2, dh=dk,
                 dv=dv).items()}
    for rec in recs + list(mla.values()) + more + list(edges.values()):
        print(json.dumps(dict(phase="kernel", **rec)), flush=True)
    print(json.dumps(edge_summary("paged_edges", edges)), flush=True)
    sweep = paged_sweep(torch, timer)
    verdict = sweep_verdict(sweep, paged_split(8, 1, 16, 2, 128, 16, 128))
    print(json.dumps({"phase": "paged_split_verdict", "pools": verdict}),
          flush=True)
    mla["sweep"] = mla_sweep(torch, timer)
    mla_edge_checks(torch)
    return recs, mla, flash, sweep


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
    t_script = t0 = time.perf_counter()
    ptxas = _build.build_all()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)

    timer = Timer(torch)
    if "--sweeps-only" in sys.argv[1:]:
        paged_sweep(torch, timer)
        mla_sweep(torch, timer)
        mla_edge_checks(torch)
        return
    recs, mla_recs, flash_recs, paged_sw = kernel_checks(torch, timer)
    q_recs = quant_kernel_checks(torch, timer)
    g_recs = group_checks(torch, timer)
    yard = contiguous_yardstick(torch, timer)
    t0 = time.perf_counter()
    mm_recs = [check_matmul(torch, timer, *case, seed=i)
               for i, case in enumerate(mm_cases())]
    print(json.dumps({"phase": "matmul_checks", "cases": len(mm_recs),
                      "seconds": time.perf_counter() - t0}), flush=True)
    del timer
    torch.cuda.empty_cache()
    if kernels_only:
        for rec in mm_recs:
            print(json.dumps(dict(rec, launches_per_decode_step=None)))
        return

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models.model import init_params, quantize_for_serving
    cfg = get_config("qwen2.5-3b")
    raw = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    launches, per_decode, by_kind = serve(torch, card, cfg, raw, "bf16")
    for tag in ("w4a16", "w8a8"):
        qcfg = cfg.with_(quant=parse_quant(tag))
        packed, n = quantize_for_serving(qcfg, raw)
        print(json.dumps({"phase": "quantize_for_serving", "quant": tag,
                          "packed_tensors": n}), flush=True)
        q_launches, q_per, _ = serve(torch, card, qcfg, packed, tag)
        name = "wo_matmul" if tag.endswith("a16") else "mpq_matmul"
        launches[name], per_decode[name] = q_launches[name], q_per[name]
        del packed
        torch.cuda.empty_cache()
    from repro_torch.core.pageformat import INT4, INT8
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mla as mla_mod
    kv_launches = {}
    gqa_want = {k: "paged_flash_decode_partials_quant"
                for k in ("fresh", "resumed", "decode")}
    # the quantized GQA kernel's launches by dispatch kind, both pools
    gqa_kinds = {k: 0 for k in gqa_want}
    for fmt in (INT8, INT4):
        got, kv_kinds = serve_kv(torch, card, cfg, raw, fmt,
                                 smoke_traffic(cfg.vocab_size), gqa_want,
                                 SERVE_REL_TOL_BF16,
                                 (attn_mod, "paged_flash_decode_partials"))
        for n, v in got.items():
            kv_launches[n] = kv_launches.get(n, 0) + v
        for k in gqa_kinds:
            gqa_kinds[k] += kv_kinds[k]["paged_flash_decode_partials_quant"]
    serve_f32(torch)
    for tag in ("w4a16", "w8a8"):
        serve_f32(torch, tag)

    dense = get_config("deepseek-v2-lite-dense")
    mla_params = init_params(dense,
                             torch.Generator(device="cuda").manual_seed(2),
                             device="cuda")
    mla_launches, mla_per_decode = serve_mla(torch, card, dense, mla_params)
    mla_want = {"fresh": "paged_flash_decode_partials",
                "resumed": "paged_flash_decode_partials",
                "decode": "mla_paged_decode_partials_quant"}
    for fmt in (INT8, INT4):
        got, _ = serve_kv(torch, card, dense, mla_params, fmt,
                          mla_traffic(dense.vocab_size), mla_want,
                          SERVE_MLA_REL_TOL,
                          (mla_mod, "mla_paged_decode_partials"))
        for n, v in got.items():
            kv_launches[n] = kv_launches.get(n, 0) + v
    serve_mla_f32(torch)
    for name in ("qwen2.5-3b", "deepseek-v2-lite-dense"):
        serve_kv_f32(torch, name, INT4)
    oc_launches = overcommit_phase(torch, card, cfg, raw, dense, mla_params)
    del raw, mla_params
    torch.cuda.empty_cache()
    arch_launches = dense_arch_phase(torch, card)
    contig_launches = contiguous_phase(torch, card)
    vision = vision_phase(torch, card)
    torch.cuda.empty_cache()
    moe_recs, moe_launches = moe_phase(torch, card)
    _, mla_moe_launches = mla_moe_phase(torch, card)
    hyb_recs, hyb_launches = hybrid_phase(torch, card)

    for rec in (recs[0], recs[2], recs[3]):
        print(json.dumps({
            "name": rec["name"], "shapes": rec["shapes"],
            "max_abs_err": rec["max_abs_err"], "tol": rec["tol"],
            "kernel_ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
            "launches_per_decode_step": per_decode[rec["name"]]}),
            flush=True)
    for rec in mm_recs:
        print(json.dumps(dict(rec, launches_per_decode_step=per_decode[
            rec["name"]])), flush=True)
    for key, rec in mla_recs.items():
        if key == "sweep":
            continue
        print(json.dumps(dict(rec, path="deepseek-v2-lite-dense",
                              launches_per_decode_step=mla_per_decode[
                                  rec["name"]])), flush=True)
    for key in ("gqa_int8_sq1_ceng_bf16", "gqa_int4_sq1_ceng_bf16",
                "gqa_int8_sq256_ceng_bf16", "gqa_int4_sq256_ceng_bf16",
                "gqa_int8_fresh_sq256_ceng_bf16",
                "gqa_int4_fresh_sq256_ceng_bf16",
                "mla_int8_ps16_ceng_bf16", "mla_int4_ps16_ceng_bf16"):
        print(json.dumps(dict(q_recs[key], case=key)), flush=True)

    def mla_path(name, rec):
        return {"launches": mla_launches[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shapes": rec["shapes"]}
    def numbers(rec):
        return {k: rec[k] for k in ("max_abs_err", "kernel_ms", "plain_ms",
                                    "bound_ms", "bound_by", "shapes")}
    # the decode-time w_down case (K = 11008) stands for each matmul
    rep = {r["name"]: r for r in mm_recs
           if r["shapes"] == {"M": 8, "K": 11008, "N": 2048}
           and r["format"] in ("w4a16", "w8a8")}
    # ... with the prefill-time w_up case (M 2048) beside it
    pre = {r["name"]: r for r in mm_recs
           if r["shapes"] == {"M": 2048, "K": 2048, "N": 11008}
           and r["format"] in ("w4a16", "w8a8")}

    def packed_entry(name, replaces):
        """A packed matmul's entry: decode on w_down, with its yardstick
        and the prefill case on w_up beside it."""
        return dict(kernel_entry(name, "mpq_matmul.cu", replaces,
                                 launches[name], rep[name]),
                    yardstick=rep[name]["yardstick"],
                    prefill={k: pre[name][k] for k in (
                        "design", "max_abs_err", "kernel_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms", "yardstick",
                        "shapes")})

    def sweep_ms(pool):
        return {str(c): mla_recs["sweep"][f"{pool}_c{c}"]["kernel_ms"]
                for c in MLA_SWEEP_C}

    def paged_sweep_ms(pool):
        return {str(c): paged_sw[f"{pool}_c{c}"]["kernel_ms"]
                for c in PAGED_SWEEP_C}

    def yardstick(rec):
        """A decode kernel's library call: SDPA over the contiguous window
        (``contiguous_yardstick``), with the kernel's times at its shape
        beside it."""
        return {"library_ms": rec["library_ms"], "library": dict(
            rec, call="scaled_dot_product_attention over each slot's "
            "contiguous window, masked at its fill")}

    def pair(rec):
        return {k: rec[k] for k in (
            "max_abs_err", "kernel_ms", "plain_ms", "library_ms",
            "library_ratio", "bound_ms", "bound_by", "shapes")}

    def arch_runs(name):
        """Phase 13's launches of kernel ``name``, by run."""
        return {run: got[name] for run, got in arch_launches.items()
                if got.get(name)}

    def at_groups(name, keys):
        """Phase 2d's numbers at each GROUP_HEADS arch: ``keys`` -> the
        record's numbers, and the decode route's times by split."""
        return {arch: dict({k: numbers(g_recs[arch][key])
                            for k, key in keys.items()},
                           decode_ms_by_split={
                               str(c): g_recs[arch]["sweep"][
                                   f"{name}_c{c}"]["kernel_ms"]
                               for c in PAGED_SWEEP_C})
                for arch in GROUP_HEADS}
    # flash and paged: the qwen2.5-3b path's numbers, with the MLA path's
    # (dk 192, dv 128) beside them
    line = {"kernels": [
        dict(kernel_entry("flash_attention_fwd", "flash_attention.cu",
                          "src/repro/kernels/flash_attention.py:36",
                          launches["flash_attention_fwd"], recs[0]),
             library_ratio=recs[0]["library_ratio"],
             launches_overcommit=oc_launches["flash_attention_fwd"],
             mla_path=dict(mla_path("flash_attention_fwd", mla_recs["flash"]),
                           library_ratio=mla_recs["flash"]["library_ratio"]),
             dk32=pair(flash_recs["dk32_dv32"]),
             dk64=pair(flash_recs["dk64_dv64"]),
             dh64=dict(pair(moe_recs["flash"]), arch=MOE_ARCH),
             launches_moe=moe_launches["flash_attention_fwd"],
             launches_mla_moe=mla_moe_launches["flash_attention_fwd"],
             dh112=dict(pair(hyb_recs["flash"]), arch=HYBRID_ARCH,
                        edges=hyb_recs["flash_edges"]),
             launches_hybrid=hyb_launches["flash_attention_fwd"],
             launches_dense_archs=arch_runs("flash_attention_fwd"),
             launches_contiguous=contig_launches["flash_attention_fwd"],
             **{arch: pair(g_recs[arch]["flash"]) for arch in GROUP_HEADS}),
        # the decode route's numbers at the engine's split (one 64-key
        # tile), with its times at each PAGED_SWEEP_C split, the chunk
        # route's (a resumed 256-row chunk) and each route's launches in
        # phase 3 beside them
        dict(kernel_entry("paged_flash_decode_partials",
                          "paged_flash_decode.cu",
                          "src/repro/kernels/paged_flash_decode.py:129",
                          launches["paged_flash_decode_partials"], recs[2],
                          {r: PAGED_DESIGN[r] for r in ("decode", "chunk")}),
             pages_per_split=recs[2]["shapes"]["pages_per_split"],
             ms_by_split=paged_sweep_ms("fp"),
             launches_overcommit=oc_launches["paged_flash_decode_partials"],
             launches_by_route={
                 "decode": by_kind["decode"]["paged_flash_decode_partials"],
                 "chunk": by_kind["resumed"]["paged_flash_decode_partials"]},
             resumed=numbers(recs[3]),
             mla_path=mla_path("paged_flash_decode_partials",
                               mla_recs["paged"]),
             launches_dense_archs=arch_runs("paged_flash_decode_partials"),
             launches_contiguous=contig_launches[
                 "paged_flash_decode_partials"],
             launches_moe=moe_launches["paged_flash_decode_partials"],
             launches_mla_moe=mla_moe_launches[
                 "paged_flash_decode_partials"],
             launches_hybrid=hyb_launches["paged_flash_decode_partials"],
             dh112={"arch": HYBRID_ARCH,
                    "decode": dict(numbers(hyb_recs["decode"]),
                                   library_ms=hyb_recs["decode"][
                                       "library_ms"]),
                    "resumed": dict(numbers(hyb_recs["resumed"]),
                                    library_ms=hyb_recs["resumed"][
                                        "library_ms"]),
                    "edges": hyb_recs["edges"],
                    "yardstick": hyb_recs["yardstick"]},
             dh64={"arch": MOE_ARCH,
                   "decode": numbers(moe_recs["decode"]),
                   "resumed": numbers(moe_recs["resumed"]),
                   "edges": moe_recs["edges"]},
             **yardstick(yard["gqa"]),
             **at_groups("fp", {"decode": "decode", "resumed": "resumed"})),
        # rows 4-5: the bf16 route at the engine's split (one 64-key
        # tile), with its times at each MLA_SWEEP_C split beside it
        dict(kernel_entry("mla_paged_decode_partials", "mla_paged_decode.cu",
                          "src/repro/kernels/paged_flash_decode.py:299",
                          mla_launches["mla_paged_decode_partials"],
                          mla_recs["mla_P128"], MLA_DESIGN),
             launches_overcommit=oc_launches["mla_paged_decode_partials"],
             launches_contiguous=contig_launches["mla_paged_decode_partials"],
             launches_mla_moe=mla_moe_launches["mla_paged_decode_partials"],
             pages_per_split=mla_recs["mla_P128"]["shapes"][
                 "pages_per_split"],
             ms_by_split=sweep_ms("fp"), **yardstick(yard["mla"])),
        dict(packed_entry("wo_matmul", "src/repro/kernels/mpq_matmul.py:56"),
             launches_dense_archs=arch_runs("wo_matmul"),
             **{"yi-34b": {k: numbers(r) for k, r in
                           g_recs["yi-34b"]["wo_matmul"].items()}}),
        # with phase 15's: the quantized CNNs' launches and times
        dict(packed_entry("mpq_matmul", "src/repro/kernels/mpq_matmul.py:32"),
             vision=vision),
        # the quantized kernels: int8 at decode (the engine's split, with
        # its times at each PAGED_SWEEP_C split), with int4 and the
        # resumed and fresh 256-row chunks (GQA) beside it, and the GQA
        # kernel's launches in phase 10 by route (a fresh or resumed wave
        # takes the chunk route, a decode step the decode route)
        dict(kernel_entry("paged_flash_decode_partials_quant",
                          "paged_flash_decode.cu",
                          "src/repro/kernels/paged_flash_decode.py:168",
                          kv_launches["paged_flash_decode_partials_quant"],
                          q_recs["gqa_int8_sq1_ceng_bf16"],
                          {r: QPAGED_DESIGN[r] for r in ("decode", "chunk")}),
             pages_per_split=q_recs["gqa_int8_sq1_ceng_bf16"]["shapes"][
                 "pages_per_split"],
             ms_by_split=paged_sweep_ms("int8"),
             launches_by_route={
                 "decode": gqa_kinds["decode"],
                 "chunk": gqa_kinds["fresh"] + gqa_kinds["resumed"]},
             launches_by_dispatch=gqa_kinds,
             launches_overcommit=oc_launches[
                 "paged_flash_decode_partials_quant"],
             int4=dict(numbers(q_recs["gqa_int4_sq1_ceng_bf16"]),
                       ms_by_split=paged_sweep_ms("int4")),
             resumed_int8=numbers(q_recs["gqa_int8_sq256_ceng_bf16"]),
             resumed_int4=numbers(q_recs["gqa_int4_sq256_ceng_bf16"]),
             fresh_int8=numbers(q_recs["gqa_int8_fresh_sq256_ceng_bf16"]),
             fresh_int4=numbers(q_recs["gqa_int4_fresh_sq256_ceng_bf16"]),
             launches_dense_archs=arch_runs(
                 "paged_flash_decode_partials_quant"),
             **at_groups("int8", {f"{w}_{f}": f"{w}_{f}"
                                  for w in ("resumed", "fresh")
                                  for f in ("int8", "int4")})),
        dict(kernel_entry("mla_paged_decode_partials_quant",
                          "mla_paged_decode.cu",
                          "src/repro/kernels/paged_flash_decode.py:337",
                          kv_launches["mla_paged_decode_partials_quant"],
                          q_recs["mla_int8_ps16_ceng_bf16"], MLA_DESIGN),
             pages_per_split=q_recs["mla_int8_ps16_ceng_bf16"]["shapes"][
                 "pages_per_split"],
             ms_by_split=sweep_ms("int8"),
             int4=dict(numbers(q_recs["mla_int4_ps16_ceng_bf16"]),
                       ms_by_split=sweep_ms("int4"))),
    ]}
    print(json.dumps({"phase": "script",
                      "seconds": time.perf_counter() - t_script}),
          flush=True)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
