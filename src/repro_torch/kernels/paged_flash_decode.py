"""Paged flash-decode partials: CUDA kernels, wrappers, plain versions.

The counterpart of ``repro.kernels.paged_flash_decode``, four kernels
built with nvcc for ``sm_90a`` and called through ctypes:

* the Pallas ``_gqa_page_kernel`` becomes ``csrc/paged_flash_decode.cu``
  (:func:`paged_flash_decode_partials`).  The port runs it for every GQA
  decode step and resumed prefill chunk (:func:`repro_torch.models.
  attention.apply_attention`), and for MLA's resumed chunk on the window
  expanded through W_UK/W_UV (dk 192, dv 128; :func:`repro_torch.models.
  mla.apply_mla`);
* the Pallas ``_gqa_page_kernel_quant`` becomes the same source's
  quantized entry point: :func:`paged_flash_decode_partials` with
  ``k_scale``/``v_scale``/``bits``, on int8 or packed int4 pools
  (``ServeConfig.kv_format``), for every GQA dispatch, fresh chunks
  included;
* the Pallas ``_mla_page_kernel`` becomes ``csrc/mla_paged_decode.cu``
  (:func:`mla_paged_decode_partials`): MLA's absorbed decode against the
  latent pool, with the partials kept in the compressed space;
* the Pallas ``_mla_page_kernel_quant`` becomes that source's quantized
  entry point: :func:`mla_paged_decode_partials` with ``scale_pool``/
  ``bits``, on an int8 or packed int4 latent pool.

Both are followed by the reference's combine.  A quantized kernel
dequantizes each page as it stages it, with the reference's op sequence
(unpack, one float32 multiply by the row scale, a rounding to the query
type), and runs the fp kernel's score and softmax code.

The GQA source chooses its route before launch by (dtype, bits, rows =
Sq x H / KV): bf16 on any pool (fp, int8 or int4) runs on the tensor
cores, decode rows (rows <= 16, every GQA decode step) on
``paged_decode_mma`` (the rows as one ``mma.sync`` m16 tile against one
``cp.async`` key tile at a time) and chunks (rows > 16: every resumed
GQA chunk, MLA's expanded window and every GQA chunk on an int8 or int4
pool, fresh ones included) on ``paged_partials_mma`` (a ``cp.async`` K/V
ring read through the page table); a quantized pool's raw rows and
scales are widened to bf16 in shared memory on both.  Float32 runs the
CUDA-core tile of ``flash_tile.cuh``.  The MLA source chooses by dtype
alone: bf16 on any latent pool (fp, int8 or int4) runs
``mla_partials_mma`` (the scores and the context on ``mma.sync`` from
one ``cp.async`` key tile of 64 latent rows, which are key and value at
once; a quantized pool's raw rows are widened to bf16 in shared memory),
float32 the FMA kernel.  No route falls back on another (the ``.cu``
heads say how each works).

The partials come per SPLIT of the logical page axis: split ``s`` covers
pages ``[s*c, (s+1)*c)`` with ``c = pages_per_split``.  With ``c = 1``
they are the reference's per-logical-page partials, identities and all.
A resumed chunk's per-page partials grow as Sq x P (hundreds of MB per
layer at serving widths), so the caller raises ``c`` and the kernel
walks each split's pages in order — the same reduction as the combine.
Decode, GQA's and MLA's, takes one tile of TILE_KEYS keys a split, more
only where its partials would pass the caller's memory budget
(:func:`repro_torch.models.attention.page_split`,
:func:`repro_torch.models.mla.decode_split`).

Each wrapper takes the plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  Each launch
adds one to the module's count of that kernel: ``launches`` (GQA fp),
``quant_launches`` (GQA quantized), ``mla_launches`` (MLA fp) and
``mla_quant_launches`` (MLA quantized).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.pageformat import INT4, INT8
from repro_torch.kernels import _build
from repro_torch.models.common import paged_gather, paged_gather_quant

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (dk, dv) pairs the GQA kernel is built for: equal widths, and MLA's
# expanded window (nope 128 + rope 64, v 128)
HEAD_DIMS = ((32, 32), (64, 64), (112, 112), (128, 128), (192, 128))
# head widths the quantized GQA kernel is built for: qwen2.5-3b's
QUANT_HEAD_DIMS = (128,)
# (r, dr) the MLA kernels are built for: deepseek-v2's latent widths
MLA_DIMS = ((512, 64),)
# keys in one tile of the bf16 decode routes (MMA_BK in
# paged_flash_decode.cu and mla_paged_decode.cu); the engine's decode
# split covers one tile, GQA's and MLA's alike
TILE_KEYS = 64
FORMATS = {8: INT8, 4: INT4}      # quantized pools by storage bits

launches = 0          # GQA kernel launches (CUDA path only)
quant_launches = 0    # quantized GQA kernel launches (CUDA path only)
mla_launches = 0      # MLA kernel launches (CUDA path only)
mla_quant_launches = 0  # quantized MLA kernel launches (CUDA path only)

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _quant_window(pool, scales, tbl, bits, dtype):
    """A slot window gathered through ``tbl``: the pool's rows as they
    are (``bits`` None), or dequantized to ``dtype``."""
    if bits is None:
        return paged_gather(pool, tbl)
    return paged_gather_quant(pool, scales, tbl, FORMATS[bits], dtype)


def paged_flash_decode_partials_plain(k_pool, v_pool, q, tbl, qpos, kv_valid,
                                      pages_per_split: int = 1, *,
                                      k_scale=None, v_scale=None,
                                      bits=None) -> Partials:
    """Plain PyTorch version: the reference's ``_page_partials_chunk`` on
    a :func:`paged_gather` window (quantized pools: a
    :func:`paged_gather_quant` window, dequantized to the query type),
    with the page axis cut into splits of ``pages_per_split`` pages (1 =
    the reference's per-page partials).  Rows under a -1 entry, causally
    future rows and rows at or past ``kv_valid`` are masked to exactly
    -1e30, so a split with nothing live yields the exact identities
    (-1e30, 0, 0)."""
    b, sq, hq, dh = q.shape
    ps, kv = k_pool.shape[1], k_pool.shape[2]
    g = hq // kv
    tbl, n_split = _pad_table(tbl, pages_per_split)
    c = pages_per_split
    kw = _quant_window(k_pool, k_scale, tbl, bits, q.dtype).float()
    vw = _quant_window(v_pool, v_scale, tbl, bits, q.dtype)
    skv = kw.shape[1]
    qx = (q * dh ** -0.5).to(q.dtype).reshape(b, sq, kv, g, dh)
    s = torch.einsum("bqkgd,bskd->bqkgs", qx.float(), kw)
    kpos = torch.arange(skv, device=q.device)
    res = (tbl >= 0)[:, kpos // ps]                 # (B, Skv) mapped rows
    mask = res[:, None, :] & (kpos[None, None, :] <= qpos[:, :, None]) & \
        (kpos[None, None, :] < kv_valid[:, None, None])
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    sp = s.reshape(b, sq, kv, g, n_split, c * ps)
    m = sp.amax(dim=-1)                              # (B, Sq, KV, G, S)
    w = torch.where(sp <= NEG_INF / 2, 0.0, torch.exp(sp - m[..., None]))
    l = w.sum(dim=-1)
    vp = vw.reshape(b, n_split, c * ps, kv, vw.shape[-1]).float()
    acc = torch.einsum("bqkgjs,bjskd->bqkgjd", w.to(q.dtype).float(), vp)
    return m, l, acc


def _pad_table(tbl, pages_per_split: int):
    """The table padded with unmapped pages to whole splits, and the
    number of splits."""
    b, p = tbl.shape
    n_split = -(-p // pages_per_split)
    if n_split * pages_per_split != p:
        pad = torch.full((b, n_split * pages_per_split - p), -1,
                         dtype=tbl.dtype, device=tbl.device)
        tbl = torch.cat([tbl, pad], dim=1)
    return tbl, n_split


def _check_scales(what, pools, scales, bits, dtype):
    """Check a quantized call's pools (int8 rows), row scales ((N, ps)
    float32, one per pool) and ``bits``; an fp call passes neither."""
    if bits is None:
        if any(s is not None for s in scales):
            raise ValueError(f"{what}: scale pools without bits")
        for p in pools:
            if p.dtype != dtype:
                raise TypeError(f"{what}: pool dtype {p.dtype}, queries "
                                f"{dtype}")
        return
    if bits not in FORMATS:
        raise ValueError(f"{what}: bits {bits} not in {tuple(FORMATS)}")
    for p, s in zip(pools, scales):
        if p.dtype != torch.int8:
            raise TypeError(f"{what}: a quantized pool holds int8 rows, "
                            f"got {p.dtype}")
        if s is None or s.dtype != torch.float32 or \
                tuple(s.shape) != tuple(p.shape[:2]):
            raise ValueError(f"{what}: want float32 row scales of shape "
                             f"{tuple(p.shape[:2])} beside each pool")


def _check(k_pool, v_pool, q, tbl, qpos, kv_valid, pages_per_split,
           k_scale, v_scale, bits):
    """Validate a call; returns the full (dk, dv) of the pools' rows."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4 or \
            v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"paged_flash_decode_partials: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
                         ": want q (B, Sq, H, dk), pools K (N, ps, KV, dk) "
                         "and V (N, ps, KV, dv)")
    if q.dtype not in DTYPES:
        raise TypeError(f"paged_flash_decode_partials: query dtype "
                        f"{q.dtype}; want one of {list(DTYPES)}")
    _check_scales("paged_flash_decode_partials", (k_pool, v_pool),
                  (k_scale, v_scale), bits, q.dtype)
    f = 1 if bits is None else FORMATS[bits].pack
    dk, dv = k_pool.shape[3] * f, v_pool.shape[3] * f
    b, sq, hq, dh = q.shape
    kv = k_pool.shape[2]
    if dk != dh or hq % kv:
        raise ValueError("paged_flash_decode_partials: head_dim mismatch or "
                         f"H {hq} not a multiple of KV {kv}")
    if tbl.dim() != 2 or tbl.shape[0] != b or tuple(qpos.shape) != (b, sq) \
            or tuple(kv_valid.shape) != (b,):
        raise ValueError("paged_flash_decode_partials: want tbl (B, P), "
                         "qpos (B, Sq), kv_valid (B,)")
    for name, t in (("tbl", tbl), ("qpos", qpos), ("kv_valid", kv_valid)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_flash_decode_partials: {name} must be "
                            f"int32, got {t.dtype}")
    ts = [q, k_pool, v_pool, tbl, qpos, kv_valid] + \
        [t for t in (k_scale, v_scale) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("paged_flash_decode_partials: tensors on "
                         "different devices")
    if pages_per_split < 1:
        raise ValueError(f"pages_per_split {pages_per_split} < 1")
    return dk, dv


def paged_flash_decode_partials(k_pool, v_pool, q, tbl, qpos, kv_valid, *,
                                k_scale=None, v_scale=None, bits=None,
                                pages_per_split: int = 1) -> Partials:
    """Flash partials of q (B, Sq, H, dk) against the pools K (N, ps, KV,
    dk) and V (N, ps, KV, dv) through the page table ``tbl`` (B, P) int32
    (-1 = unmapped), for query positions ``qpos`` (B, Sq) and filled-row
    bounds ``kv_valid`` (B,); scores scaled by dk^-0.5.  Returns float32
    ``m``, ``l`` (B, Sq, KV, G, S) and ``acc`` (B, Sq, KV, G, S, dv) with
    S = ceil(P / pages_per_split).

    QUANTIZED pools (the reference's keywords): ``bits`` 8 or 4, int8
    pools of last dim dk * bits / 8 (resp. dv), and ``k_scale`` /
    ``v_scale`` (N, ps) float32 row scales, read through the same table;
    the softmax scale and ``acc`` use the full widths.

    On the card the dtype and the rows Sq x H / KV pick the kernel's
    route before launch: bf16 runs on the tensor cores, decode rows
    (<= 16) on ``paged_decode_mma`` and chunks on ``paged_partials_mma``;
    float32 runs ``paged_partials_kernel`` on the CUDA cores."""
    global launches, quant_launches
    dk, dv = _check(k_pool, v_pool, q, tbl, qpos, kv_valid, pages_per_split,
                    k_scale, v_scale, bits)
    if q.device.type == "cpu":
        return paged_flash_decode_partials_plain(
            k_pool, v_pool, q, tbl, qpos, kv_valid, pages_per_split,
            k_scale=k_scale, v_scale=v_scale, bits=bits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_partials: no kernel for "
                         f"{q.device}")
    b, sq, hq, _ = q.shape
    ps, kv = k_pool.shape[1], k_pool.shape[2]
    p = tbl.shape[1]
    if bits is None and (dk, dv) not in HEAD_DIMS or \
            bits is not None and (dk != dv or dk not in QUANT_HEAD_DIMS) \
            or ps % 16:
        raise ValueError(f"paged_flash_decode_partials: (dk, dv) {(dk, dv)} "
                         f"not built (fp {HEAD_DIMS}, quantized dk = dv in "
                         f"{QUANT_HEAD_DIMS}) or page_size {ps} not a "
                         "multiple of 16")
    ins = [q, k_pool, v_pool, tbl, qpos, kv_valid]
    if bits is not None:
        ins += [k_scale, v_scale]
    for t in ins:
        if not t.is_contiguous():
            raise ValueError("paged_flash_decode_partials: inputs must be "
                             "contiguous")
    n_split = -(-p // pages_per_split)
    shape = (b, sq, kv, hq // kv, n_split)
    m = torch.empty(shape, dtype=torch.float32, device=q.device)
    l = torch.empty(shape, dtype=torch.float32, device=q.device)
    acc = torch.empty(shape + (dv,), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(q.device):
        if bits is None:
            rc = lib.paged_flash_decode_partials(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tbl.data_ptr(), qpos.data_ptr(), kv_valid.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                b, sq, hq, kv, dk, dv, ps, p, pages_per_split,
                DTYPES[q.dtype], stream)
        else:
            rc = lib.paged_flash_decode_partials_quant(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), tbl.data_ptr(),
                qpos.data_ptr(), kv_valid.data_ptr(), m.data_ptr(),
                l.data_ptr(), acc.data_ptr(), b, sq, hq, kv, dk, ps, p,
                pages_per_split, bits, DTYPES[q.dtype], stream)
    _build.check(lib, rc, "paged_flash_decode_partials")
    if bits is None:
        launches += 1
    else:
        quant_launches += 1
    return m, l, acc


def _lib():
    lib = _build.load("paged_flash_decode")
    fn = lib.paged_flash_decode_partials
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fq = lib.paged_flash_decode_partials_quant
        fq.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fq.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# MLA: compressed-space partials against the (N, ps, r + dr) latent pool.
# ---------------------------------------------------------------------------

def mla_paged_decode_partials_plain(pool, q_c, q_rope, tbl, pos, r: int,
                                    scale_dim: int,
                                    pages_per_split: int = 1, *,
                                    scale_pool=None, bits=None) -> Partials:
    """Plain PyTorch version: the reference's ``_mla_window_partials`` on
    a :func:`paged_gather` window (a quantized latent pool: a
    :func:`paged_gather_quant` window, each whole row dequantized to the
    query type before the split at ``r``), with the page axis cut into
    splits of ``pages_per_split`` pages (1 = the reference's per-page
    partials).  Rows under a -1 entry and rows past the slot's position
    are masked to exactly -1e30, so a split with nothing live (and every
    split of a slot at position -1) yields the exact identities (-1e30,
    0, 0)."""
    b, sq, h, _ = q_c.shape
    ps = pool.shape[1]
    tbl, n_split = _pad_table(tbl, pages_per_split)
    buf = _quant_window(pool, scale_pool, tbl, bits, q_c.dtype).float()
    c_all, kr_all = buf[..., :r], buf[..., r:]
    sc = torch.einsum("bqhr,bsr->bqhs", q_c.float(), c_all)
    sc = sc + torch.einsum("bqhd,bsd->bqhs", q_rope.float(), kr_all)
    sc = sc * scale_dim ** -0.5
    kpos = torch.arange(buf.shape[1], device=pool.device)
    res = (tbl >= 0)[:, kpos // ps]                     # (B, W) mapped rows
    mask = res & (kpos[None, :] <= pos[:, None])
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    scp = sc.reshape(b, sq, h, n_split, pages_per_split * ps)
    m = scp.amax(dim=-1)                                # (B, Sq, H, S)
    w = torch.where(scp <= NEG_INF / 2, 0.0, torch.exp(scp - m[..., None]))
    l = w.sum(dim=-1)
    cp = c_all.reshape(b, n_split, pages_per_split * ps, r)
    acc = torch.einsum("bqhjs,bjsr->bqhjr", w.to(q_c.dtype).float(), cp)
    return m, l, acc


def _mla_check(pool, q_c, q_rope, tbl, pos, r, pages_per_split, scale_pool,
               bits):
    if pool.dim() != 3 or q_c.dim() != 4 or q_rope.dim() != 4 or \
            q_rope.shape[:3] != q_c.shape[:3]:
        raise ValueError(f"mla_paged_decode_partials: pool "
                         f"{tuple(pool.shape)}, q_c {tuple(q_c.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}: want pool (N, ps, "
                         "r + dr), q_c (B, Sq, H, r), q_rope (B, Sq, H, dr)")
    if not (q_c.dtype == q_rope.dtype) or q_c.dtype not in DTYPES:
        raise TypeError(f"mla_paged_decode_partials: query dtypes "
                        f"{q_c.dtype}/{q_rope.dtype}; want one of "
                        f"{list(DTYPES)}")
    _check_scales("mla_paged_decode_partials", (pool,), (scale_pool,), bits,
                  q_c.dtype)
    width = pool.shape[2] * (1 if bits is None else FORMATS[bits].pack)
    if q_c.shape[3] != r or width != r + q_rope.shape[3]:
        raise ValueError(f"mla_paged_decode_partials: r {r}, q_c width "
                         f"{q_c.shape[3]}, q_rope width {q_rope.shape[3]} "
                         f"and pool row width {width} disagree")
    b = q_c.shape[0]
    if tbl.dim() != 2 or tbl.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError("mla_paged_decode_partials: want tbl (B, P), "
                         "pos (B,)")
    for name, t in (("tbl", tbl), ("pos", pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"mla_paged_decode_partials: {name} must be "
                            f"int32, got {t.dtype}")
    ts = [pool, q_c, q_rope, tbl, pos] + \
        ([] if scale_pool is None else [scale_pool])
    if len({t.device for t in ts}) != 1:
        raise ValueError("mla_paged_decode_partials: tensors on different "
                         "devices")
    if pages_per_split < 1:
        raise ValueError(f"pages_per_split {pages_per_split} < 1")


def mla_paged_decode_partials(pool, q_c, q_rope, tbl, pos, r: int,
                              scale_dim: int, *, scale_pool=None, bits=None,
                              pages_per_split: int = 1) -> Partials:
    """Compressed-space flash partials of MLA's absorbed queries ``q_c``
    (B, Sq, H, r) and ``q_rope`` (B, Sq, H, dr) against the latent pool
    (N, ps, r + dr) through the page table ``tbl`` (B, P) int32 (-1 =
    unmapped), every query row of slot b attending rows <= ``pos[b]``
    (B,) int32 (-1 = inactive slot); scores scaled by ``scale_dim``^-0.5
    (the reference's nope + rope).  Returns float32 ``m``, ``l``
    (B, Sq, H, S) and ``acc`` (B, Sq, H, S, r) with S = ceil(P /
    pages_per_split).

    QUANTIZED latent pool (the reference's keywords): ``bits`` 8 or 4, an
    int8 pool of last dim (r + dr) * bits / 8 and ``scale_pool`` (N, ps)
    float32 row scales; one scale covers a whole row, which is
    dequantized before the split at ``r``.

    On the card the dtype picks the kernel's route before launch: bf16
    runs on the tensor cores (``mla_partials_mma``), float32 on the CUDA
    cores (``mla_partials_kernel``)."""
    global mla_launches, mla_quant_launches
    _mla_check(pool, q_c, q_rope, tbl, pos, r, pages_per_split, scale_pool,
               bits)
    if pool.device.type == "cpu":
        return mla_paged_decode_partials_plain(
            pool, q_c, q_rope, tbl, pos, r, scale_dim, pages_per_split,
            scale_pool=scale_pool, bits=bits)
    if pool.device.type != "cuda":
        raise ValueError(f"mla_paged_decode_partials: no kernel for "
                         f"{pool.device}")
    b, sq, h, _ = q_c.shape
    ps, dr = pool.shape[1], q_rope.shape[3]
    p = tbl.shape[1]
    if (r, dr) not in MLA_DIMS or ps % 16:
        raise ValueError(f"mla_paged_decode_partials: (r, dr) {(r, dr)} not "
                         f"in {MLA_DIMS} or page_size {ps} not a multiple "
                         "of 16")
    ins = [pool, q_c, q_rope, tbl, pos] + \
        ([] if scale_pool is None else [scale_pool])
    for t in ins:
        if not t.is_contiguous():
            raise ValueError("mla_paged_decode_partials: inputs must be "
                             "contiguous")
    aligned = [pool] + ([q_c, q_rope] if q_c.dtype == torch.bfloat16
                        else [])
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("mla_paged_decode_partials: the pool (and bf16 "
                         "queries) must be 16-byte aligned (the kernels "
                         "read their rows in 16-byte vectors)")
    n_split = -(-p // pages_per_split)
    shape = (b, sq, h, n_split)
    m = torch.empty(shape, dtype=torch.float32, device=pool.device)
    l = torch.empty(shape, dtype=torch.float32, device=pool.device)
    acc = torch.empty(shape + (r,), dtype=torch.float32, device=pool.device)
    lib = _mla_lib()
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(pool.device):
        if bits is None:
            rc = lib.mla_paged_decode_partials(
                pool.data_ptr(), q_c.data_ptr(), q_rope.data_ptr(),
                tbl.data_ptr(), pos.data_ptr(), m.data_ptr(), l.data_ptr(),
                acc.data_ptr(), b, sq, h, r, dr, ps, p, pages_per_split,
                float(scale_dim) ** -0.5, DTYPES[q_c.dtype], stream)
        else:
            rc = lib.mla_paged_decode_partials_quant(
                pool.data_ptr(), scale_pool.data_ptr(), q_c.data_ptr(),
                q_rope.data_ptr(), tbl.data_ptr(), pos.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(), b, sq, h, r, dr,
                ps, p, pages_per_split, float(scale_dim) ** -0.5, bits,
                DTYPES[q_c.dtype], stream)
    _build.check(lib, rc, "mla_paged_decode_partials")
    if bits is None:
        mla_launches += 1
    else:
        mla_quant_launches += 1
    return m, l, acc


def _mla_lib():
    lib = _build.load("mla_paged_decode")
    fn = lib.mla_paged_decode_partials
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fq = lib.mla_paged_decode_partials_quant
        fq.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fq.restype = ctypes.c_int
    return lib
