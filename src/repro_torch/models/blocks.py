"""Residual blocks: the ``attn_mlp`` transformer block of the port.

The counterpart of ``repro.models.blocks`` for the dense GQA family:
pre-norm attention, then a pre-norm SwiGLU (or GELU) MLP.  A block is an
``nn.Module`` holding its weights as frozen parameters in the reference's
tree (``ln1``, ``attn``, ``ln2``, ``ffn``), so the weight bridge maps
leaves one to one.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.models.attention import apply_attention, attn_specs
from repro_torch.models.common import ParamSpec, dense, layer_norm, rms_norm


def norm_specs(cfg) -> dict:
    d = cfg.d_model
    s = {"w": ParamSpec((d,), init="ones", dtype=torch.float32)}
    if cfg.norm == "layer":
        s["b"] = ParamSpec((d,), init="zeros", dtype=torch.float32)
    return s


def apply_norm(p, x, cfg):
    if cfg.norm == "layer":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "gelu":
        return {"w_up": ParamSpec((d, f)), "w_down": ParamSpec((f, d))}
    return {"w_gate": ParamSpec((d, f)), "w_up": ParamSpec((d, f)),
            "w_down": ParamSpec((f, d))}


def apply_mlp(p, x, cfg):
    if cfg.mlp_act == "gelu":
        h = dense(x, p["w_up"])
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
        return dense(h, p["w_down"])
    g = dense(x, p["w_gate"])
    u = dense(x, p["w_up"])
    # SiLU in float32, cast to the activation type, then times u.
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return dense(h, p["w_down"])


def attn_mlp_specs(cfg) -> dict:
    return {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
            "ln2": norm_specs(cfg), "ffn": mlp_specs(cfg)}


def _frozen(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class AttnMlpBlock(nn.Module):
    """One ``attn_mlp`` block; ``leaves`` is its tree of tensors in the
    layout :func:`attn_mlp_specs` declares."""

    def __init__(self, cfg, leaves: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(leaves["ln1"])
        self.attn = _frozen(leaves["attn"])
        self.ln2 = _frozen(leaves["ln2"])
        self.ffn = _frozen(leaves["ffn"])

    def tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: {k: v.data for k, v in getattr(self, name).items()}
                for name in ("ln1", "attn", "ln2", "ffn")}

    def forward(self, x, cache, mode, pos, pages, offset):
        a, cache = apply_attention(
            self.attn, apply_norm(self.ln1, x, self.cfg), self.cfg,
            cache=cache, mode=mode, pos=pos, pages=pages, offset=offset)
        x = x + a
        x = x + apply_mlp(self.ffn, apply_norm(self.ln2, x, self.cfg),
                          self.cfg)
        return x, cache
