"""Causal flash attention forward: CUDA kernel, wrapper, plain version.

The counterpart of ``repro.kernels.flash_attention``: the Pallas
``_flash_kernel`` becomes ``csrc/flash_attention.cu`` (CUDA C++ for
``sm_90a``), built with nvcc and called through ctypes.  The port runs it
for every fresh prefill chunk: GQA's (:func:`repro_torch.models.attention.
apply_attention`) and MLA's naive form (:func:`repro_torch.models.mla.
apply_mla`), whose keys are wider than its values (dk 192, dv 128).

:func:`flash_attention` takes the plain PyTorch version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.  The
kernel's route follows the dtype: bf16 (the serving path) runs on the
tensor cores (``mma.sync`` with a ``cp.async`` K/V ring), float32 on the
CUDA cores, since float32 on tensor cores would be TF32 (the ``.cu``
head says how each works).  Each launch adds one to the module's
``launches`` count.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (dk, dv) pairs the kernel is built for: equal widths, and MLA's naive
# form (nope 128 + rope 64, v 128)
HEAD_DIMS = ((32, 32), (64, 64), (112, 112), (128, 128), (192, 128))

launches = 0          # kernel launches (CUDA path only)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: ``_flash_kernel``'s arithmetic over one
    window covering every key.  q (B, Sq, H, dk); k (B, Skv, KV, dk); v
    (B, Skv, KV, dv).  Scores, max, denominator and the PV sum in float32;
    ``q * dk^-0.5`` and the weights rounded to the input type first, as
    the reference does."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    kv_valid = skv if kv_valid is None else kv_valid
    qs = (q * dh ** -0.5).to(q.dtype).reshape(b, sq, kv, g, dh)
    s = torch.einsum("bqkgd,bskd->bqkgs", qs.float(), k.float())
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < kv_valid)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _check(q, k, v, kv_valid):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want q "
                         "(B, Sq, H, dk), k (B, Skv, KV, dk) and v "
                         "(B, Skv, KV, dv)")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError("flash_attention: batch/head_dim mismatch or H "
                         f"{q.shape[2]} not a multiple of KV {k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; want one of {list(DTYPES)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if kv_valid is not None and kv_valid < 0:
        raise ValueError(f"flash_attention: kv_valid {kv_valid} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Causal attention of q (B, Sq, H, dk) over k (B, Skv, KV, dk) and
    v (B, Skv, KV, dv): query row i attends keys j <= i with j < kv_valid
    (default Skv), scores scaled by dk^-0.5.  Returns (B, Sq, H, dv) in
    q's type."""
    global launches
    _check(q, k, v, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    b, sq, h, dk = q.shape
    skv, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (dk, dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: (dk, dv) {(dk, dv)} not in "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    o = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, skv, h, kv, dk, dv, skv if kv_valid is None else kv_valid,
            DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "flash_attention_fwd")
    launches += 1
    return o


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib
