"""Packed sub-byte matmuls: CUDA kernels, wrappers, plain versions.

The counterpart of ``repro.kernels.mpq_matmul`` and of its oracles in
``repro.kernels.ref``: the Pallas bodies ``_wo_kernel`` and
``_int_kernel`` become ``csrc/mpq_matmul.cu`` (CUDA C++ for ``sm_90a``),
built with nvcc and called through ctypes.  The port runs them for every
``dense`` of a model whose weights were packed by
:func:`repro_torch.models.model.quantize_for_serving`
(:func:`repro_torch.kernels.ops.quantized_matmul`).

Both compute ``ref.py``'s function over the strided packed layout of
:mod:`repro_torch.core.packing`, whatever the two operands' pack factors.
The inputs are those of the reference's ``pallas_call`` wrappers: packed
operands, ``x_scale (M, 1)`` and ``w_scale (1, N)`` in float32.  Tiles
are the kernels' own business, so there are no tile arguments.

:func:`mpq_matmul` and :func:`wo_matmul` take the plain PyTorch version
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise.  The integer kernel and a bf16 x's weight-only kernel run on the
tensor cores (one route for M <= 16 rows, one above, chosen in the
library; they need K % 128 == 0 (64 at a8w8 and for the weight-only
kernel) and N % 16 == 0, which ``ops.prepare_weight``'s padding gives,
and raise otherwise), a float32 x's on the CUDA cores.  Each call
on the card launches its kernel once and adds one to the module's
``launches`` count.  A call whose K is split over extra
blocks (few rows, see the ``.cu`` head) launches a second, small kernel
that adds the partials and applies the scales; it adds one to
``reduce_launches`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import pack_factor, unpack
from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # main-kernel launches (CUDA path only)
reduce_launches = 0   # split-K reduce launches (CUDA path only)


def mpq_matmul_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                     w_packed: torch.Tensor, w_scale: torch.Tensor, *,
                     a_bits: int, w_bits: int) -> torch.Tensor:
    """Plain PyTorch version of ``ref.mpq_matmul_ref``: unpack both
    operands, take the exact integer dot, dequantize.  Returns (M, N)
    float32.

    The integer dot runs as a float64 matmul: every partial sum of
    int8 x int8 products over K < 2^37 is an integer below 2^53, so it
    is exact in any order, on the CPU and on the card alike (PyTorch has
    no int32 matmul on CUDA).  Then ``(float)acc * x_scale * w_scale``,
    two float32 multiplies in that order, as the reference."""
    x = unpack(x_q, a_bits, axis=1).to(torch.float64)
    w = unpack(w_packed, w_bits, axis=0).to(torch.float64)
    acc = (x @ w).to(torch.int32)
    return acc.float() * x_scale * w_scale


def wo_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                    w_scale: torch.Tensor, *, w_bits: int) -> torch.Tensor:
    """Plain PyTorch version of ``ref.wo_matmul_ref``: x times the
    unpacked weight with float32 products and sum, the per-channel scale
    after the sum, one rounding to x's type.  Both operands are widened
    to float32 first: a bf16 matmul would round its result to bf16
    before the scale."""
    w = unpack(w_packed, w_bits, axis=0)
    acc = x.float() @ w.float()
    return (acc * w_scale.float()).to(x.dtype)


def _check_common(name, x, w_packed, w_scale, k_x, fw):
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError(f"{name}: want 2-D operands, got x {tuple(x.shape)}"
                         f" and w_packed {tuple(w_packed.shape)}")
    if w_packed.dtype != torch.int8:
        raise TypeError(f"{name}: w_packed dtype {w_packed.dtype}, want int8")
    k = w_packed.shape[0] * fw
    if k_x != k:
        raise ValueError(f"{name}: x holds K={k_x} but w_packed "
                         f"{tuple(w_packed.shape)} holds K={k}")
    n = w_packed.shape[1]
    if tuple(w_scale.shape) != (1, n) or w_scale.dtype != torch.float32:
        raise ValueError(f"{name}: w_scale {tuple(w_scale.shape)} "
                         f"{w_scale.dtype}, want (1, {n}) float32")
    if not (x.device == w_packed.device == w_scale.device):
        raise ValueError(f"{name}: operands on different devices")
    return k, n


def _cuda_checks(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


def mpq_matmul(x_q: torch.Tensor, x_scale: torch.Tensor,
               w_packed: torch.Tensor, w_scale: torch.Tensor, *,
               a_bits: int, w_bits: int) -> torch.Tensor:
    """Integer matmul: packed int{8,4,2} x_q (M, K / fa) times packed
    int{8,4,2} w_packed (K / fw, N), dequantized by x_scale (M, 1) and
    w_scale (1, N).  Returns (M, N) float32."""
    global launches, reduce_launches
    fa, fw = pack_factor(a_bits), pack_factor(w_bits)
    if x_q.dtype != torch.int8:
        raise TypeError(f"mpq_matmul: x_q dtype {x_q.dtype}, want int8")
    k, n = _check_common("mpq_matmul", x_q, w_packed, w_scale,
                         x_q.shape[-1] * fa, fw)
    m = x_q.shape[0]
    if tuple(x_scale.shape) != (m, 1) or x_scale.dtype != torch.float32:
        raise ValueError(f"mpq_matmul: x_scale {tuple(x_scale.shape)} "
                         f"{x_scale.dtype}, want ({m}, 1) float32")
    if x_scale.device != x_q.device:
        raise ValueError("mpq_matmul: operands on different devices")
    if x_q.device.type == "cpu":
        return mpq_matmul_plain(x_q, x_scale, w_packed, w_scale,
                                a_bits=a_bits, w_bits=w_bits)
    _cuda_checks("mpq_matmul", (x_q, x_scale, w_packed, w_scale))
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    splits = lib.mpq_matmul_splits(m, n, k, a_bits, w_bits)
    part = (torch.empty((splits, m, n), dtype=torch.int32, device=x_q.device)
            if splits > 1 else None)
    with torch.cuda.device(x_q.device):
        rc = lib.mpq_matmul(
            x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, n, k, a_bits,
            w_bits, splits, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mpq_matmul")
    launches += 1
    reduce_launches += int(splits > 1)
    return out


def wo_matmul(x: torch.Tensor, w_packed: torch.Tensor, w_scale: torch.Tensor,
              *, w_bits: int) -> torch.Tensor:
    """Weight-only matmul: x (M, K) in float32 or bf16 times packed
    int{8,4,2} w_packed (K / fw, N), times w_scale (1, N) after the sum.
    Returns (M, N) in x's type."""
    global launches, reduce_launches
    fw = pack_factor(w_bits)
    if x.dtype not in DTYPES:
        raise TypeError(f"wo_matmul: x {x.dtype}; want {list(DTYPES)}")
    k, n = _check_common("wo_matmul", x, w_packed, w_scale, x.shape[-1], fw)
    if x.device.type == "cpu":
        return wo_matmul_plain(x, w_packed, w_scale, w_bits=w_bits)
    _cuda_checks("wo_matmul", (x, w_packed, w_scale))
    m = x.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    splits = lib.wo_matmul_splits(m, n, k, w_bits, DTYPES[x.dtype])
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    with torch.cuda.device(x.device):
        rc = lib.wo_matmul(
            x.data_ptr(), w_packed.data_ptr(), w_scale.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), m, n,
            k, w_bits, DTYPES[x.dtype], splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "wo_matmul")
    launches += 1
    reduce_launches += int(splits > 1)
    return out


def _lib():
    lib = _build.load("mpq_matmul")
    if lib.mpq_matmul.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.wo_matmul_splits.argtypes = [i] * 5
        lib.wo_matmul_splits.restype = i
        lib.mpq_matmul_splits.argtypes = [i] * 5
        lib.mpq_matmul_splits.restype = i
        lib.wo_matmul.argtypes = [p] * 5 + [i] * 6 + [p]
        lib.wo_matmul.restype = i
        lib.mpq_matmul.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.mpq_matmul.restype = i
    return lib
