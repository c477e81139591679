"""The layer model code calls for packed weights.

The counterpart of ``repro.kernels.ops``.  It owns:
  * offline weight preparation (per-channel quantization and strided
    sub-byte packing, K padded to 256 and N to 128), bitwise equal to
    the reference's;
  * padding of the activations to the packed K and un-padding of N;
  * dynamic per-row activation quantization (and packing below 8 bits)
    for the integer path;
  * the call into the two kernels of :mod:`.mpq_matmul`, which choose by
    device: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor.

The reference's tile planner (``core/tiling.py``) has no counterpart:
tiles are chosen inside the CUDA kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.packing import pack, pack_factor
from repro_torch.core.quant import (QuantConfig, quantize_activation,
                                    quantize_weight)
from repro_torch.kernels.mpq_matmul import mpq_matmul, wo_matmul


class PackedWeight(nn.Module):
    """An offline-prepared weight: the packed sub-byte payload
    ``packed`` (K_pad // fw, N_pad) int8 and the dequantization scales
    ``scale`` (N_pad,) float32, as buffers (so ``.to(device)`` moves
    them), with the unpadded ``k``, ``n`` and the weight bits."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor, k: int,
                 n: int, w_bits: int):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)
        self.k, self.n, self.w_bits = int(k), int(n), int(w_bits)

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + self.scale.numel() * 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def prepare_weight(w: torch.Tensor, cfg: QuantConfig) -> PackedWeight:
    """Quantize (per channel, or per tensor) and pack a (K, N) weight.
    K is zero-padded to a multiple of 256 and N to 128, as in the
    reference; zero lanes add nothing to the dot product."""
    k, n = w.shape
    k_pad, n_pad = _round_up(k, 256), _round_up(n, 128)
    q, scale = quantize_weight(w, cfg.w_bits, cfg.w_granularity)
    if cfg.w_granularity == "tensor":
        scale = scale.expand(n)
    q = F.pad(q, (0, n_pad - n, 0, k_pad - k))
    scale = F.pad(scale, (0, n_pad - n)).contiguous()
    return PackedWeight(pack(q, cfg.w_bits, axis=0).contiguous(), scale, k,
                        n, cfg.w_bits)


def quantized_matmul(x: torch.Tensor, pw: PackedWeight,
                     cfg: QuantConfig) -> torch.Tensor:
    """y = x @ W for a prepared weight, in the format ``cfg`` names.

    x: (..., K) in float32 or bf16.  Returns (..., N) in x's type: the
    weight-only path writes it directly, the integer path dequantizes to
    float32 and casts."""
    mode = None if cfg is None else cfg.mode
    if mode not in ("int", "wo"):
        raise ValueError(f"quantized_matmul needs mode int/wo, got {mode}")
    lead = x.shape[:-1]
    k, n = pw.k, pw.n
    kp = pw.packed.shape[0] * pack_factor(pw.w_bits)
    x2 = x.reshape(-1, k)
    if k != kp:
        x2 = F.pad(x2, (0, kp - k))
    x2 = x2.contiguous()
    w_scale = pw.scale[None, :]
    if mode == "int":
        x_q, x_scale = quantize_activation(x2, cfg.a_bits)
        if pack_factor(cfg.a_bits) > 1:
            x_q = pack(x_q, cfg.a_bits, axis=1)
        out = mpq_matmul(x_q.contiguous(), x_scale.contiguous(), pw.packed,
                         w_scale, a_bits=cfg.a_bits,
                         w_bits=pw.w_bits).to(x.dtype)
    else:
        out = wo_matmul(x2, pw.packed, w_scale, w_bits=pw.w_bits)
    return out[:, :n].reshape(*lead, n)
