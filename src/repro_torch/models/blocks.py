"""Residual blocks of the port: ``attn_mlp``, ``mla_mlp``, ``attn_moe``,
``mla_moe``, ``mamba`` and ``shared_attn``.

The counterpart of ``repro.models.blocks`` for six block kinds: pre-norm
attention (GQA, or MLA over the latent pool), then a pre-norm SwiGLU (or
GELU) MLP, or (``attn_moe``, ``mla_moe``) the same attention then the MoE
FFN of :mod:`repro_torch.models.moe`, which masks a chunk's padding from
routing in mode 'chunk' only.  Every block returns its aux loss (0.0 for
an MLP).  A block is an ``nn.Module`` holding its weights in
the reference's tree (``ln1``, ``attn``, ``ln2``, ``ffn``), so the weight
bridge maps leaves one to one: raw weights as frozen parameters, and the
packed weights of a quantized model as :class:`~repro_torch.kernels.ops.
PackedWeight` submodules.  :data:`BLOCKS` maps a block kind to its specs,
its contiguous and paged cache specs and its module.  A ``mamba`` block
(pre-norm Mamba2 mixer, :mod:`repro_torch.models.ssm`, and the residual)
keeps a per-slot recurrent state in both layouts: its paged cache spec is
None, so paging bypasses it.  ``shared_attn`` is the ``attn_mlp`` block
whose weights the model holds once (zamba2's shared attention block,
:mod:`repro_torch.models.model`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels.ops import PackedWeight
from repro_torch.models.attention import (apply_attention, attn_specs,
                                          kv_cache_spec, paged_kv_cache_spec)
from repro_torch.models.mla import (apply_mla, mla_cache_spec, mla_specs,
                                    paged_mla_cache_spec)
from repro_torch.models.common import (ParamSpec, chunk_lengths,
                                       chunk_valid_mask, dense, layer_norm,
                                       rms_norm)
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.ssm import apply_mamba, mamba_cache_spec, mamba_specs


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
        return {"w_up": ParamSpec((d, f), quantize=True),
                "w_down": ParamSpec((f, d), quantize=True)}
    return {"w_gate": ParamSpec((d, f), quantize=True),
            "w_up": ParamSpec((d, f), quantize=True),
            "w_down": ParamSpec((f, d), quantize=True)}


def apply_mlp(p, x, cfg):
    if cfg.mlp_act == "gelu":
        h = dense(x, p["w_up"], cfg.quant)
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
        return dense(h, p["w_down"], cfg.quant)
    g = dense(x, p["w_gate"], cfg.quant)
    u = dense(x, p["w_up"], cfg.quant)
    # SiLU in float32, cast to the activation type, then times u.
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return dense(h, p["w_down"], cfg.quant)


def attn_mlp_specs(cfg) -> dict:
    return {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
            "ln2": norm_specs(cfg), "ffn": mlp_specs(cfg)}


class Leaves(nn.Module):
    """One part of a block's tree (``ln1``, ``attn``, ...), read like the
    dict it mirrors (``p["wq"]``, ``p.get("bq")``): tensors as frozen
    parameters, packed weights as submodules, and a nested subtree (the
    MoE FFN's ``shared``) as a child ``Leaves``."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        self._names = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Leaves(v))
            elif isinstance(v, PackedWeight):
                self.add_module(k, v)
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k: str):
        if k not in self._names:
            raise KeyError(k)
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._names

    def get(self, k: str, default=None):
        return self[k] if k in self._names else default

    def tree(self) -> Dict[str, object]:
        """The leaves: tensors, PackedWeight modules as they are, and a
        subtree as its nested dict."""
        def leaf(v):
            if isinstance(v, Leaves):
                return v.tree()
            return v if isinstance(v, PackedWeight) else v.data
        return {k: leaf(self[k]) for k in self._names}


class AttnMlpBlock(nn.Module):
    """One ``attn_mlp`` block; ``leaves`` is its tree of tensors in the
    layout :func:`attn_mlp_specs` declares."""

    attend = staticmethod(apply_attention)

    def __init__(self, cfg, leaves: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Leaves(leaves["ln1"])
        self.attn = Leaves(leaves["attn"])
        self.ln2 = Leaves(leaves["ln2"])
        self.ffn = Leaves(leaves["ffn"])

    def tree(self) -> Dict[str, Dict[str, object]]:
        return {name: getattr(self, name).tree()
                for name in ("ln1", "attn", "ln2", "ffn")}

    def ffn_out(self, h, mode, pos):
        """The FFN sublayer on the normed ``h``: (output, aux loss)."""
        return apply_mlp(self.ffn, h, self.cfg), 0.0

    def forward(self, x, cache, mode, pos, pages, offset, view):
        a, cache = self.attend(
            self.attn, apply_norm(self.ln1, x, self.cfg), self.cfg,
            cache=cache, mode=mode, pos=pos, pages=pages, offset=offset,
            view=view)
        x = x + a
        y, aux = self.ffn_out(apply_norm(self.ln2, x, self.cfg), mode, pos)
        return x + y, cache, aux


def mla_mlp_specs(cfg) -> dict:
    return {"ln1": norm_specs(cfg), "attn": mla_specs(cfg),
            "ln2": norm_specs(cfg), "ffn": mlp_specs(cfg)}


class MlaMlpBlock(AttnMlpBlock):
    """One ``mla_mlp`` block (the reference's ``_mla_block_specs`` /
    ``_apply_mla_block`` with a dense MLP): MLA attention over the latent
    pool, then the same MLP; ``leaves`` in the layout of
    :func:`mla_mlp_specs`."""

    attend = staticmethod(apply_mla)


def attn_moe_specs(cfg) -> dict:
    return {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
            "ln2": norm_specs(cfg), "ffn": moe_specs(cfg)}


def _chunk_token_mask(x, mode, pos):
    """(B, S) valid-token mask in mode 'chunk', else None: decode's
    inactive slots and 'prefill''s padding are routed like any token."""
    if mode != "chunk":
        return None
    b, s = x.shape[:2]
    return chunk_valid_mask(chunk_lengths(pos, b, x.device), s)


class AttnMoeBlock(AttnMlpBlock):
    """One ``attn_moe`` block (the reference's ``_apply_attn_block`` with
    ``ffn="moe"``): GQA attention, then the MoE FFN; ``leaves`` in the
    layout of :func:`attn_moe_specs`."""

    def ffn_out(self, h, mode, pos):
        return moe_ffn(self.ffn, h, self.cfg,
                       token_mask=_chunk_token_mask(h, mode, pos))


def mla_moe_specs(cfg) -> dict:
    return {"ln1": norm_specs(cfg), "attn": mla_specs(cfg),
            "ln2": norm_specs(cfg), "ffn": moe_specs(cfg)}


class MlaMoeBlock(AttnMoeBlock):
    """One ``mla_moe`` block (the reference's ``_apply_mla_block`` with
    ``ffn="moe"``): MLA attention over the latent pool, then the MoE FFN
    with its shared experts; ``leaves`` in the layout of
    :func:`mla_moe_specs`."""

    attend = staticmethod(apply_mla)


def mamba_block_specs(cfg) -> dict:
    return {"ln": norm_specs(cfg), "mamba": mamba_specs(cfg)}


class MambaBlock(nn.Module):
    """One ``mamba`` block (the reference's ``_apply_mamba_block``): the
    Mamba2 mixer on the normed stream, added to it; ``leaves`` in the
    layout of :func:`mamba_block_specs`.  Its cache is the slot's
    recurrent state ({"conv", "ssm"}), whatever the layout: ``pages``
    and ``view`` are not read."""

    mixer = staticmethod(apply_mamba)

    def __init__(self, cfg, leaves: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.ln = Leaves(leaves["ln"])
        self.mamba = Leaves(leaves["mamba"])

    def tree(self) -> Dict[str, Dict[str, object]]:
        return {"ln": self.ln.tree(), "mamba": self.mamba.tree()}

    def forward(self, x, cache, mode, pos, pages, offset, view):
        y, cache = self.mixer(self.mamba, apply_norm(self.ln, x, self.cfg),
                              self.cfg, cache=cache, mode=mode, pos=pos,
                              offset=offset)
        return x + y, cache, 0.0


class Block(NamedTuple):
    """A block kind: its param specs (cfg), contiguous cache spec (cfg,
    batch, capacity), paged cache spec (cfg, num_pages, page_size, fmt;
    None: a per-slot state, the contiguous spec in both layouts) and
    module."""
    specs: Callable
    cache_spec: Callable
    paged_cache_spec: Optional[Callable]
    module: type


BLOCKS = {
    "attn_mlp": Block(attn_mlp_specs, kv_cache_spec, paged_kv_cache_spec,
                      AttnMlpBlock),
    "mla_mlp": Block(mla_mlp_specs, mla_cache_spec, paged_mla_cache_spec,
                     MlaMlpBlock),
    "attn_moe": Block(attn_moe_specs, kv_cache_spec, paged_kv_cache_spec,
                      AttnMoeBlock),
    "mla_moe": Block(mla_moe_specs, mla_cache_spec, paged_mla_cache_spec,
                     MlaMoeBlock),
    "mamba": Block(mamba_block_specs,
                   lambda cfg, batch, cap: mamba_cache_spec(cfg, batch),
                   None, MambaBlock),
}
# zamba2's shared attention block: the attn_mlp block, its weights held
# once by the model
BLOCKS["shared_attn"] = BLOCKS["attn_mlp"]
