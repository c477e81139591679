"""Quantized CNNs of the paper's QNN benchmarks (Table VI).

The counterpart of ``repro.models.vision``.  Convolutions are lowered to
im2col + matmul, as PULP-NN (the library the paper measures) lowers them
for the Flex-V dot-product unit, so that every quantized convolution and
the classifier head run the packed matmul kernels
(:func:`repro_torch.kernels.ops.quantized_matmul`: the integer kernel of
``csrc/mpq_matmul.cu`` in mode 'int', the weight-only one in mode 'wo').
Networks:

  * MobileNetV1 (width multiplier ``base``): 8-bit activations with 8-
    or 4-bit weights (the paper's "MobileNetV1 8b" and "8b4b");
  * ResNet-20 (CIFAR): 4-bit activations, 2-bit weights ("4b2b").

Weights quantize per output channel, activations dynamically per row,
as on the language-model path (:mod:`repro_torch.core.quant`).  The
depthwise convolution, batch norm, ReLU, mean pooling and an
unquantized ``cols @ w`` stay PyTorch ops, as the reference computes
them outside any Pallas body.

The entry points take a flat dict of tensors, each either a raw weight
or a :class:`~repro_torch.kernels.ops.PackedWeight` of the flattened
(kh * kw * cin, cout) weight, and run where their tensors live: a CUDA
tensor launches the kernels, a CPU tensor takes their plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.ops import (PackedWeight, prepare_weight,
                                     quantized_matmul)
from repro_torch.models.common import ParamSpec, materialize, require_device


def _quantized(quant: Optional[QuantConfig]) -> bool:
    return quant is not None and quant.mode != "bf16"


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """x: (B, H, W, C) -> patches (B, Ho, Wo, kh * kw * C): taps (i, j)
    outer, channels inner, the order of a (kh, kw, cin, cout) weight
    flattened to (kh * kw * cin, cout)."""
    _, h, w, _ = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    cols = [x[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


def _qmm(cols: torch.Tensor, wf: torch.Tensor,
         quant: Optional[QuantConfig]) -> torch.Tensor:
    """The matmul of a conv or head layer on a raw (K, N) weight: plain
    in float, else packed on this call and run by the packed kernels."""
    if not _quantized(quant):
        return cols @ wf
    return quantized_matmul(cols, prepare_weight(wf, quant), quant)


def conv2d_q(x: torch.Tensor, w, quant: Optional[QuantConfig], stride=1,
             pad=0) -> torch.Tensor:
    """Conv via im2col + (quantized) matmul.  ``w``: a raw (kh, kw, cin,
    cout) weight, or a PackedWeight of the flattened (kh * kw * cin,
    cout) one, whose square kernel is read from its K."""
    if isinstance(w, PackedWeight):
        kh = kw = int(round((w.k // x.shape[-1]) ** 0.5))
        return quantized_matmul(im2col(x, kh, kw, stride, pad), w, quant)
    kh, kw, cin, cout = w.shape
    cols = im2col(x, kh, kw, stride, pad)
    return _qmm(cols, w.reshape(kh * kw * cin, cout), quant)


def depthwise_conv_q(x: torch.Tensor, w: torch.Tensor, stride=1,
                     pad=1) -> torch.Tensor:
    """Depthwise conv with a (kh, kw, C) weight, in x's float type
    (PULP-NN keeps it in higher precision for its share of compute).

    The reference's sum over im2col's patches, taken tap by tap on
    strided views of the padded input: no (kh * kw)-fold patch tensor is
    written, which took 36 of a 51 ms MobileNetV1 forward at batch 64 on
    an H100 (PERF.md)."""
    kh, kw, _ = w.shape
    _, h, wd, _ = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            tap = x[:, i:i + (ho - 1) * stride + 1:stride,
                    j:j + (wo - 1) * stride + 1:stride, :] * w[i, j]
            out = tap if out is None else out + tap
    return out


def bn_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            relu: bool = True) -> torch.Tensor:
    y = x * scale + bias
    return torch.relu(y) if relu else y


def _head(p: dict, h: torch.Tensor, quant: Optional[QuantConfig]):
    w = p["head"]
    if isinstance(w, PackedWeight):
        return quantized_matmul(h, w, quant)
    return _qmm(h, w, quant)


# ---------------------------------------------------------------------------
# MobileNetV1
# ---------------------------------------------------------------------------

MBV1_LAYERS = [  # (cout_mult_of_base, stride) for the 13 dw-pw pairs
    (2, 1), (4, 2), (4, 1), (8, 2), (8, 1), (16, 2), (16, 1),
    (16, 1), (16, 1), (16, 1), (16, 1), (32, 2), (32, 1)]


def mobilenet_specs(base: int = 32, n_classes: int = 1000,
                    in_ch: int = 3) -> dict:
    specs = {"stem": ParamSpec((3, 3, in_ch, base), quantize=True)}
    cin = base
    for i, (mult, _) in enumerate(MBV1_LAYERS):
        cout = base * mult
        specs[f"dw{i}"] = ParamSpec((3, 3, cin), scale=0.3)
        specs[f"pw{i}"] = ParamSpec((1, 1, cin, cout), quantize=True)
        specs[f"bn{i}_s"] = ParamSpec((cout,), init="ones")
        specs[f"bn{i}_b"] = ParamSpec((cout,), init="zeros")
        cin = cout
    specs["head"] = ParamSpec((cin, n_classes), quantize=True)
    return specs


def mobilenet_apply(p: dict, x: torch.Tensor,
                    quant: Optional[QuantConfig]) -> torch.Tensor:
    """x: (B, H, W, 3) -> logits (B, n_classes)."""
    h = torch.relu(conv2d_q(x, p["stem"], quant, stride=2, pad=1))
    for i, (_, stride) in enumerate(MBV1_LAYERS):
        h = torch.relu(depthwise_conv_q(h, p[f"dw{i}"], stride=stride,
                                        pad=1))
        h = conv2d_q(h, p[f"pw{i}"], quant)
        h = bn_relu(h, p[f"bn{i}_s"], p[f"bn{i}_b"])
    return _head(p, h.mean(dim=(1, 2)), quant)


def mobilenet_macs(base: int = 32, img: int = 224, in_ch: int = 3) -> int:
    macs = (img // 2) ** 2 * 9 * in_ch * base
    cin, res = base, img // 2
    for mult, stride in MBV1_LAYERS:
        cout = base * mult
        res = res // stride
        macs += res * res * (9 * cin + cin * cout)
        cin = cout
    return macs


# ---------------------------------------------------------------------------
# ResNet-20 (CIFAR)
# ---------------------------------------------------------------------------

def resnet20_specs(base: int = 16, n_classes: int = 10) -> dict:
    specs = {"stem": ParamSpec((3, 3, 3, base), quantize=True)}
    cin = base
    for s, width_mult in enumerate([1, 2, 4]):
        cout = base * width_mult
        for b in range(3):
            stride = 2 if (s > 0 and b == 0) else 1
            specs[f"s{s}b{b}c1"] = ParamSpec((3, 3, cin, cout),
                                             quantize=True)
            specs[f"s{s}b{b}c2"] = ParamSpec((3, 3, cout, cout),
                                             quantize=True)
            if stride != 1 or cin != cout:
                specs[f"s{s}b{b}sc"] = ParamSpec((1, 1, cin, cout),
                                                 quantize=True)
            cin = cout
    specs["head"] = ParamSpec((cin, n_classes), quantize=True)
    return specs


def resnet20_apply(p: dict, x: torch.Tensor,
                   quant: Optional[QuantConfig]) -> torch.Tensor:
    """x: (B, 32, 32, 3) -> logits (B, n_classes)."""
    h = torch.relu(conv2d_q(x, p["stem"], quant, pad=1))
    for s in range(3):
        for b in range(3):
            stride = 2 if (s > 0 and b == 0) else 1
            y = torch.relu(conv2d_q(h, p[f"s{s}b{b}c1"], quant,
                                    stride=stride, pad=1))
            y = conv2d_q(y, p[f"s{s}b{b}c2"], quant, pad=1)
            sc = p.get(f"s{s}b{b}sc")
            hs = conv2d_q(h, sc, quant, stride=stride) if sc is not None \
                else h
            h = torch.relu(y + hs)
    return _head(p, h.mean(dim=(1, 2)), quant)


def init_vision(specs: dict, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """Random weights with the reference's distributions (not its bits),
    drawn in the specs' order from ``generator`` (which must live on
    ``device``)."""
    dev = require_device(device)
    return {k: materialize(s, generator, dtype, dev)
            for k, s in specs.items()}


def model_bytes(specs: dict, quant: Optional[QuantConfig]) -> int:
    """Deployed model size (Table VI 'Model size'): packed sub-byte
    weights and float32 scales for the quantize-eligible tensors, float32
    for the rest."""
    total = 0
    for s in specs.values():
        n = math.prod(s.shape)
        if _quantized(quant) and s.quantize:
            total += n * quant.w_bits // 8 + 4 * s.shape[-1]
        else:
            total += 4 * n
    return total
