"""Symmetric integer quantization: the numeric format of the packed path.

The counterpart of ``repro.core.quant``.  A :class:`QuantConfig` names the
operand format once (the paper's CSR-held format state, Flex-V's int8/4/2
operands of Table IV), and every ``dense`` of the model reads it.

Conventions, as in the reference:
  * signed symmetric quantization, zero point 0;
  * b-bit range ``[-2^(b-1), 2^(b-1) - 1]`` (int4 -> [-8, 7]);
  * weights: static per-output-channel (or per-tensor) scales;
  * activations: dynamic per-row (per-token) scales;
  * integer products accumulate in int32 and are dequantized with
    ``x_scale * w_scale``;
  * KV pool rows (:func:`quantize_page_rows`): one dynamic scale per
    cache row, over all of its feature axes.

Integer outputs are bitwise equal to the reference's: the division is in
float32 and ``torch.round`` rounds half to even, as ``jnp.round`` does.

The reference's QuantConfig also has a switch between its Pallas kernel
and its pure-jnp oracle.  The port does not carry it over: every kernel
wrapper chooses by the tensor's device (the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor), so such a field could only
hide the kernel on the card.  Mode ``'qat'`` (fake quantization with a
straight-through estimator) comes with training, ROADMAP queue 1 item 16,
and raises here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SUPPORTED_BITS = (2, 4, 8)


def qmin(bits: int) -> int:
    return -(1 << (bits - 1))


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The operand format of every quantized ``dense``.

    mode:
      'bf16' — no quantization (the model's own dtype);
      'int'  — packed int activations x packed int weights, int32
               accumulation (the integer matmul kernel);
      'wo'   — weight-only: packed sub-byte weights expanded inside the
               kernel, activations stay in the model's dtype (the
               weight-only matmul kernel).
    """
    mode: str = "bf16"
    a_bits: int = 8
    w_bits: int = 8
    # 'channel' (per output channel) or 'tensor' for weight scales.
    w_granularity: str = "channel"

    def __post_init__(self):
        if self.mode == "qat":
            raise ValueError(
                "QuantConfig.mode='qat' (fake quantization for training) is "
                "not in the port yet (ROADMAP queue 1 item 16)")
        if self.mode not in ("bf16", "int", "wo"):
            raise ValueError(f"QuantConfig.mode: unknown quant mode "
                             f"{self.mode!r}")
        if self.mode != "bf16":
            if self.a_bits not in SUPPORTED_BITS:
                raise ValueError(f"QuantConfig.a_bits={self.a_bits} not in "
                                 f"{SUPPORTED_BITS}")
            if self.w_bits not in SUPPORTED_BITS:
                raise ValueError(f"QuantConfig.w_bits={self.w_bits} not in "
                                 f"{SUPPORTED_BITS}")
        if self.w_granularity not in ("channel", "tensor"):
            raise ValueError(f"QuantConfig.w_granularity: bad value "
                             f"{self.w_granularity!r}")

    def tag(self) -> str:
        if self.mode == "bf16":
            return "bf16"
        if self.mode == "wo":
            return f"w{self.w_bits}a16"
        return f"w{self.w_bits}a{self.a_bits}"


def compute_scale(x: torch.Tensor, bits: int, axis,
                  eps: float = 1e-8) -> torch.Tensor:
    """absmax scale so that max|x| maps to qmax(bits); ``axis=None``
    reduces over every axis (keeping them as size 1)."""
    ax = tuple(range(x.dim())) if axis is None else axis
    amax = torch.amax(torch.abs(x.float()), dim=ax, keepdim=True)
    return torch.clamp_min(amax, eps) / qmax(bits)


def quantize(x: torch.Tensor, bits: int, axis=None,
             scale: Optional[torch.Tensor] = None):
    """Quantize to b-bit signed integers (stored widened in int8).

    Returns (q, scale): q int8 whose values fit the b-bit range, scale
    float32 broadcastable against ``x``'s shape."""
    if scale is None:
        scale = compute_scale(x, bits, axis=axis)
    q = torch.round(x.float() / scale)
    q = torch.clamp(q, qmin(bits), qmax(bits)).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_weight(w: torch.Tensor, bits: int, granularity: str = "channel"):
    """Static weight quantization of a (in_features, out_features) ``w``;
    per-channel scales are per OUTPUT channel (a reduction over axis 0).
    Returns (q int8, scale float32 of shape (out,) or (1,))."""
    axis = 0 if granularity == "channel" else None
    q, scale = quantize(w, bits, axis=axis)
    return q, scale.reshape(-1).float()


def quantize_page_rows(rows: torch.Tensor, bits: int, eps: float = 1e-8):
    """Per-row symmetric quantization for the paged KV pool.  ``rows``:
    (B, S, *feat), one cache row per (slot, position); the absmax spans
    every trailing feature axis, so each row has one float32 scale and
    the scale pool beside a page pool is (num_pages, page_size).
    Returns (q int8 of rows.shape, scales float32 of rows.shape[:2])."""
    scale = compute_scale(rows, bits, axis=tuple(range(2, rows.dim())),
                          eps=eps)
    q, _ = quantize(rows, bits, scale=scale)
    return q, scale.reshape(rows.shape[:2]).float()


def dequantize_page_rows(q: torch.Tensor, scales: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_page_rows` (after any unpack): ``q``
    (B, S, *feat) integer values, ``scales`` (B, S) float32, broadcast
    over the feature axes."""
    s = scales.reshape(tuple(scales.shape) + (1,) * (q.dim() - scales.dim()))
    return (q.float() * s).to(dtype)


def quantize_activation(x: torch.Tensor, bits: int):
    """Dynamic per-row (per-token) activation quantization.  ``x``:
    (..., K).  Returns q int8 (..., K) and scales (..., 1) float32."""
    q, scale = quantize(x, bits, axis=-1)
    return q, scale.float()
