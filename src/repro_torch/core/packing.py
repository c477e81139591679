"""Sub-byte operand packing: the memory format of the packed weights.

The counterpart of ``repro.core.packing``, byte for byte.  int4 and int2
tensors live packed in device memory (2 resp. 4 lanes per byte) and are
expanded only inside the matmul kernels (``kernels/csrc/mpq_matmul.cu``).
The layout is STRIDED along the packed axis:

    factor f = 8 // bits,  axis length K = f * Kp
    byte j (j in [0, Kp)) stores lanes i = 0..f-1
    lane i of byte j  <=>  original element at index  i*Kp + j

so unpacking lane i yields the contiguous block ``[i*Kp, (i+1)*Kp)`` and
the whole tensor is ``cat(lane_0, ..., lane_{f-1})`` along that axis.
Values are signed two's complement within each b-bit lane; lane i sits
at bits ``[i*bits, (i+1)*bits)`` of its byte.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import qmax, qmin


def pack_factor(bits: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be one of (2,4,8), got {bits}")
    return 8 // bits


def pack(q: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Pack b-bit signed values (stored in int8) along ``axis``.

    The result is int8 with ``axis`` shrunk by ``8 // bits``; the
    identity (a copy in int8) for b=8."""
    f = pack_factor(bits)
    if f == 1:
        return q.to(torch.int8)
    axis = axis % q.dim()
    k = q.shape[axis]
    if k % f:
        raise ValueError(f"axis length {k} not divisible by pack factor {f}")
    kp = k // f
    mask = (1 << bits) - 1
    qi = q.to(torch.int32)
    word = torch.zeros_like(qi.narrow(axis, 0, kp))
    for i in range(f):
        lane = qi.narrow(axis, i * kp, kp)
        word = word | ((lane & mask) << (i * bits))
    # the int32 words fit one byte by construction (f * bits == 8)
    return word.to(torch.uint8).view(torch.int8)


def unpack(packed: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack`; returns sign-extended int8 values."""
    f = pack_factor(bits)
    if f == 1:
        return packed.to(torch.int8)
    axis = axis % packed.dim()
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    w = packed.view(torch.uint8).to(torch.int32)
    lanes = []
    for i in range(f):
        v = (w >> (i * bits)) & mask
        lanes.append(((v + half) & mask) - half)     # sign-extend the lane
    return torch.cat(lanes, dim=axis).to(torch.int8)


def packed_shape(shape, bits: int, axis: int = 0):
    f = pack_factor(bits)
    axis = axis % len(shape)
    if shape[axis] % f:
        raise ValueError(f"dim {shape[axis]} not divisible by {f}")
    return tuple(s // f if i == axis else s for i, s in enumerate(shape))


def random_qtensor(generator: torch.Generator, shape, bits: int,
                   device=None) -> torch.Tensor:
    """Uniform random int8 values spanning the full b-bit signed range,
    drawn from ``generator`` (which must live on ``device``)."""
    return torch.randint(qmin(bits), qmax(bits) + 1, tuple(shape),
                         generator=generator, dtype=torch.int8,
                         device=device)
