"""Paged flash-decode partials: CUDA kernel, wrapper, plain version.

The counterpart of ``repro.kernels.paged_flash_decode`` (fp body only):
the Pallas ``_gqa_page_kernel`` becomes ``csrc/paged_flash_decode.cu``
(CUDA C++ for ``sm_90a``), built with nvcc and called through ctypes.
The port runs it for every decode step and every resumed prefill chunk
(:func:`repro_torch.models.attention.apply_attention`), followed by the
reference's combine.

The partials come per SPLIT of the logical page axis: split ``s`` covers
pages ``[s*c, (s+1)*c)`` with ``c = pages_per_split``.  With ``c = 1``
they are the reference's per-logical-page partials, identities and all.
A resumed chunk's per-page partials grow as Sq x P (hundreds of MB per
layer at serving widths), so the caller raises ``c`` and the kernel
walks each split's pages in order — the same reduction as the combine.

:func:`paged_flash_decode_partials` takes the plain PyTorch version only
for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  Each launch adds one to the module's ``launches`` count.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.common import paged_gather

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

launches = 0          # kernel launches (CUDA path only)

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def paged_flash_decode_partials_plain(k_pool, v_pool, q, tbl, qpos, kv_valid,
                                      pages_per_split: int = 1) -> Partials:
    """Plain PyTorch version: the reference's ``_page_partials_chunk`` on
    a :func:`paged_gather` window, with the page axis cut into splits of
    ``pages_per_split`` pages (1 = the reference's per-page partials).
    Rows under a -1 entry, causally future rows and rows at or past
    ``kv_valid`` are masked to exactly -1e30, so a split with nothing
    live yields the exact identities (-1e30, 0, 0)."""
    b, sq, hq, dh = q.shape
    ps, kv = k_pool.shape[1], k_pool.shape[2]
    p = tbl.shape[1]
    g = hq // kv
    c = pages_per_split
    n_split = -(-p // c)
    if n_split * c != p:                 # pad the table with unmapped pages
        pad = torch.full((b, n_split * c - p), -1, dtype=tbl.dtype,
                         device=tbl.device)
        tbl = torch.cat([tbl, pad], dim=1)
    kw = paged_gather(k_pool, tbl).float()
    vw = paged_gather(v_pool, tbl)
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


def _check(k_pool, v_pool, q, tbl, qpos, kv_valid, pages_per_split):
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_flash_decode_partials: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
                         ": want q (B, Sq, H, dh), pools (N, ps, KV, dh)")
    b, sq, hq, dh = q.shape
    kv = k_pool.shape[2]
    if k_pool.shape[3] != dh or hq % kv:
        raise ValueError("paged_flash_decode_partials: head_dim mismatch or "
                         f"H {hq} not a multiple of KV {kv}")
    if tbl.dim() != 2 or tbl.shape[0] != b or tuple(qpos.shape) != (b, sq) \
            or tuple(kv_valid.shape) != (b,):
        raise ValueError("paged_flash_decode_partials: want tbl (B, P), "
                         "qpos (B, Sq), kv_valid (B,)")
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"paged_flash_decode_partials: dtypes {q.dtype}/"
                        f"{k_pool.dtype}/{v_pool.dtype}; want one of "
                        f"{list(DTYPES)}")
    for name, t in (("tbl", tbl), ("qpos", qpos), ("kv_valid", kv_valid)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_flash_decode_partials: {name} must be "
                            f"int32, got {t.dtype}")
    if len({t.device for t in (q, k_pool, v_pool, tbl, qpos,
                               kv_valid)}) != 1:
        raise ValueError("paged_flash_decode_partials: tensors on "
                         "different devices")
    if pages_per_split < 1:
        raise ValueError(f"pages_per_split {pages_per_split} < 1")


def paged_flash_decode_partials(k_pool, v_pool, q, tbl, qpos, kv_valid, *,
                                pages_per_split: int = 1) -> Partials:
    """Flash partials of q (B, Sq, H, dh) against the pools (N, ps, KV,
    dh) through the page table ``tbl`` (B, P) int32 (-1 = unmapped), for
    query positions ``qpos`` (B, Sq) and filled-row bounds ``kv_valid``
    (B,).  Returns float32 ``m``, ``l`` (B, Sq, KV, G, S) and ``acc``
    (B, Sq, KV, G, S, dh) with S = ceil(P / pages_per_split)."""
    global launches
    _check(k_pool, v_pool, q, tbl, qpos, kv_valid, pages_per_split)
    if q.device.type == "cpu":
        return paged_flash_decode_partials_plain(
            k_pool, v_pool, q, tbl, qpos, kv_valid, pages_per_split)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_partials: no kernel for "
                         f"{q.device}")
    b, sq, hq, dh = q.shape
    ps, kv = k_pool.shape[1], k_pool.shape[2]
    p = tbl.shape[1]
    if dh not in HEAD_DIMS or ps % 16:
        raise ValueError(f"paged_flash_decode_partials: head_dim {dh} not "
                         f"in {HEAD_DIMS} or page_size {ps} not a multiple "
                         "of 16")
    for t in (q, k_pool, v_pool, tbl, qpos, kv_valid):
        if not t.is_contiguous():
            raise ValueError("paged_flash_decode_partials: inputs must be "
                             "contiguous")
    n_split = -(-p // pages_per_split)
    shape = (b, sq, kv, hq // kv, n_split)
    m = torch.empty(shape, dtype=torch.float32, device=q.device)
    l = torch.empty(shape, dtype=torch.float32, device=q.device)
    acc = torch.empty(shape + (dh,), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.paged_flash_decode_partials(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tbl.data_ptr(), qpos.data_ptr(), kv_valid.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            b, sq, hq, kv, dh, ps, p, pages_per_split, DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "paged_flash_decode_partials")
    launches += 1
    return m, l, acc


def _lib():
    lib = _build.load("paged_flash_decode")
    fn = lib.paged_flash_decode_partials
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
