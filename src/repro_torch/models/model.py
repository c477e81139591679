"""LM assembly: embedding -> blocks -> final norm -> lm_head.

The counterpart of ``repro.models.model`` for serving.
The reference scans stacked parameters with ``lax.scan``; the port keeps
one block module per layer (:data:`~repro_torch.models.blocks.BLOCKS`) in
an ``nn.ModuleList`` and loops over it.  The block program is a list of
stages (:func:`_stages`): a ``scan`` stage is ``count`` blocks of one
kind, ``attn_mlp`` (GQA), ``mla_mlp`` (MLA), ``attn_moe`` (GQA and the
MoE FFN), ``mla_moe`` (MLA and the MoE FFN, with shared experts where the
config has them) or ``mamba`` (Mamba2), as deepseek-v2-lite-16b's one
``mla_mlp`` block and then 26 ``mla_moe`` blocks; a ``group`` stage runs
its inner blocks in order, ``repeats`` times, as zamba2-7b's 13 x (5
``mamba`` + 1 ``shared_attn``).  ``shared_attn`` is an ``attn_mlp`` block
whose weights the model holds ONCE (``Transformer.shared``, the
reference's ``params["shared"]``): the same module runs at every such
position, each with its own cache.  The xLSTM kinds and embeds input
raise.  ``forward`` returns the sum of every stage's aux losses, as the
reference does.

The paged cache keeps the reference's layout, one pool per layer kind of
a stage with the page axis at 1, stacked over the stage's layers: leaves
``k``/``v`` (layers, num_pages, page_size, KV, dh) for GQA, ``ckv``
(layers, num_pages, page_size, r + dr) for MLA, so that swap snapshots
and later wire slices move the same bytes.  A quantized ``kv_format``
stores those pools as int8 (int4 packed two a byte) with (layers,
num_pages, page_size) float32 scale leaves ``k_scale``/``v_scale`` or
``ckv_scale``.  A mamba block's state is per slot in both layouts:
``conv`` (layers, B, K - 1, C) and ``ssm`` (layers, B, H, P, N) float32.
A ``scan`` stage's cache is a dict of its leaves; a ``group`` stage's is
``{"b<j>": leaves}`` for each inner block j that has a cache, stacked
over the repeats (the shared block's KV caches too, one a repeat).  The
contiguous cache (``init_cache``, the reference's ``paged=False``
layout) keeps per layer a (layers, B, cap, KV, dh) ``k`` / ``v``, or a
(layers, B, cap, r + dr) ``ckv``, of the model's dtype, ``cap`` the
prompt length plus ``decode_margin`` rounded up to 256
(``cache_capacity``); ``forward`` takes it with ``pages`` None and reads
it through a ``view`` (:class:`~repro_torch.models.common.ContigView`).
``forward`` updates either cache in place.  :func:`flat_leaves` lists a
cache's leaves in the reference's flattening order (stages in order,
keys sorted at every level), the order of swap snapshots.

  mode='prefill' — the whole prompt from row 0, the contiguous cache
                   becoming its rows padded with zeros
  mode='chunk'   — chunked prefill: ``pos`` is the (B,) valid length of a
                   right-padded chunk (0 = inactive slot); with ``offset``
                   the chunk is RESUMED at rows [offset, offset + len)
  mode='decode'  — one token per slot at row ``pos`` (B,) (-1 = inactive)

:func:`quantize_for_serving` packs every quantize-eligible weight (the
attention and MLP projections and ``lm_head``) into a
:class:`~repro_torch.kernels.ops.PackedWeight` in the format of
``cfg.quant``; ``forward`` then runs each of those ``dense`` through the
packed matmul kernels.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.pageformat import get_format
from repro_torch.kernels.ops import PackedWeight, prepare_weight
from repro_torch.models.blocks import BLOCKS, apply_norm, norm_specs
from repro_torch.models.common import (ContigView, ParamSpec, dense,
                                       embed_lookup, materialize,
                                       require_device)
from repro_torch.models.config import ArchConfig


class Stage(NamedTuple):
    """One entry of ``cfg.pattern``: ``kinds`` the blocks of one repeat in
    order (a ``scan`` stage: one kind), run ``repeats`` times."""
    group: bool
    kinds: Tuple[str, ...]
    repeats: int


def _stages(cfg: ArchConfig) -> List[Stage]:
    """The block program as stages, one an entry of ``cfg.pattern`` in
    order: token-input programs of ``scan`` and ``group`` stages over the
    kinds of :data:`BLOCKS`."""
    stages = []
    for e in cfg.pattern:
        if e[0] == "scan":
            stages.append(Stage(False, (e[1],), e[2]))
        else:
            kinds = tuple(k for k, c in e[1] for _ in range(c))
            stages.append(Stage(True, kinds, e[2]))
    if cfg.input_mode == "tokens" and all(
            k in BLOCKS for st in stages for k in st.kinds):
        return stages
    raise ValueError(
        f"{cfg.name}: pattern {cfg.pattern} (input {cfg.input_mode}) is not "
        "in this slice of the port, which serves token-input programs of "
        f"{', '.join(BLOCKS)} blocks (ROADMAP queue 1 item 13: the xLSTM "
        "blocks and embeds input)")


def _layer_kinds(cfg: ArchConfig) -> List[str]:
    """Each block's kind in the order ``forward`` runs them, stages in
    order, a group's repeats in order; ``shared_attn`` included."""
    return [k for st in _stages(cfg) for _ in range(st.repeats)
            for k in st.kinds]


def _own_kinds(cfg: ArchConfig) -> List[str]:
    """The kinds of the blocks that hold their own weights (every kind but
    ``shared_attn``), in ``forward``'s order: ``Transformer.blocks``."""
    return [k for k in _layer_kinds(cfg) if k != "shared_attn"]


def has_shared(cfg: ArchConfig) -> bool:
    return "shared_attn" in _layer_kinds(cfg)


def param_specs(cfg: ArchConfig) -> dict:
    """The weights' specs; ``blocks`` holds one block a layer with weights
    of its own, in ``forward``'s order (the reference stacks a stage's
    layers), and ``shared`` the shared block's, once."""
    d, vp = cfg.d_model, cfg.padded_vocab
    specs = {
        "embed": ParamSpec((vp, d), init="embed", scale=0.02),
        "blocks": [BLOCKS[kind].specs(cfg) for kind in _own_kinds(cfg)],
    }
    if has_shared(cfg):
        specs["shared"] = BLOCKS["attn_mlp"].specs(cfg)
    specs["final_norm"] = norm_specs(cfg)
    specs["lm_head"] = ParamSpec((d, vp), scale=0.02, quantize=True)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, capacity: int, *,
                num_pages: Optional[int] = None,
                page_size: Optional[int] = None,
                kv_format: str = "fp") -> list:
    """Cache spec: per stage, its stacked (layers, ...) leaves, a group's
    under ``b<j>`` for each inner block j with a cache, stacked over the
    repeats: contiguous (batch, capacity, ...) or, with ``num_pages`` /
    ``page_size``, paged pools (``ParamSpec.pooled``) beside the per-slot
    (batch, ...) state of the kinds without a paged spec.  ``kv_format``
    picks the page storage format of a paged cache
    (:mod:`repro_torch.core.pageformat`): "fp" pools of the model's
    dtype, or "int8"/"int4" int8 pools with float32 row-scale leaves;
    each leaf keeps its own dtype."""
    fmt = get_format(kv_format)

    def stacked(kind, n):
        block = BLOCKS[kind]
        pooled = num_pages is not None and block.paged_cache_spec is not None
        spec = (block.paged_cache_spec(cfg, num_pages, page_size, fmt)
                if pooled else block.cache_spec(cfg, batch, capacity))
        return {name: ParamSpec((n,) + s.shape, init=s.init, dtype=s.dtype,
                                pooled=pooled)
                for name, s in spec.items()}

    stages = []
    for st in _stages(cfg):
        if st.group:
            stages.append({f"b{j}": stacked(kind, st.repeats)
                           for j, kind in enumerate(st.kinds)})
        else:
            stages.append(stacked(st.kinds[0], st.repeats))
    return stages


def flat_leaves(tree) -> list:
    """The leaves of a cache (or of its specs) in the reference's
    flattening order: stages in order, dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in flat_leaves(v)]
    return [tree]


def cache_capacity(cfg: ArchConfig, prompt_len: int) -> int:
    """Rows a slot of the contiguous cache holds: ``prompt_len`` plus
    ``decode_margin``, rounded up to a multiple of 256."""
    cap = prompt_len + cfg.decode_margin
    return ((cap + 255) // 256) * 256


class Transformer(nn.Module):
    """The model's weights: ``embed``, ``blocks`` (ModuleList, the blocks
    with weights of their own in ``forward``'s order), ``shared`` (the
    shared attention block, one module run at every ``shared_attn``
    position; None without one), ``final_norm`` and ``lm_head``, all
    frozen.  ``lm_head`` is a :class:`PackedWeight` once the model is
    packed."""

    def __init__(self, cfg: ArchConfig, leaves: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(leaves["embed"], requires_grad=False)
        self.blocks = nn.ModuleList(
            BLOCKS[kind].module(cfg, b)
            for kind, b in zip(_own_kinds(cfg), leaves["blocks"],
                               strict=True))
        self.shared = (BLOCKS["attn_mlp"].module(cfg, leaves["shared"])
                       if has_shared(cfg) else None)
        self.final_norm = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in leaves["final_norm"].items()})
        head = leaves["lm_head"]
        self.lm_head = (head if isinstance(head, PackedWeight) else
                        nn.Parameter(head, requires_grad=False))

    def tree(self) -> dict:
        """The weights as the nested dict ``param_specs`` declares, the
        shared block once, under ``shared``."""
        t = {"embed": self.embed.data,
             "blocks": [b.tree() for b in self.blocks]}
        if self.shared is not None:
            t["shared"] = self.shared.tree()
        t["final_norm"] = {k: v.data for k, v in self.final_norm.items()}
        t["lm_head"] = (self.lm_head if isinstance(self.lm_head, PackedWeight)
                        else self.lm_head.data)
        return t


def forward(params: Transformer, inputs: torch.Tensor, cfg: ArchConfig, *,
            cache: list, mode: str, pos=0,
            pages: Optional[torch.Tensor] = None,
            offset: Optional[torch.Tensor] = None,
            view: Optional[ContigView] = None,
            ) -> Tuple[torch.Tensor, list, float]:
    """Returns (logits (B, S, padded_vocab), cache, aux_loss): the aux
    loss is the sum of the blocks' (the MoE load-balancing loss, a float32
    tensor; the host float 0.0 for a model without experts).

    ``cache`` is the paged cache of :func:`init_paged_cache` with
    ``pages`` its (B, P) int32 page table, or the contiguous cache of
    :func:`init_cache` with ``pages`` None, read by the paged kernels
    through ``view`` (default: page 16, the whole capacity); it is
    updated in place.  Blocks run in the reference's order: a group
    stage's inner blocks in order, repeat after repeat.  ``offset``: the
    (B,) int32 start rows of a resumed chunk (mode='chunk' only).  Mode
    'train' (no cache) comes with ROADMAP queue 1 item 16."""
    if cache is None:
        raise ValueError(f"forward(mode={mode!r}) needs a cache: the "
                         "cacheless 'train' forward comes with ROADMAP "
                         "queue 1 item 16")
    x = embed_lookup(params.embed, inputs)
    aux = 0.0   # a host float while no block has experts: no launch
    blocks = iter(params.blocks)
    for stage, st in zip(cache, _stages(cfg), strict=True):
        for r in range(st.repeats):
            for j, kind in enumerate(st.kinds):
                leaves = stage[f"b{j}"] if st.group else stage
                layer = {name: leaf[r] for name, leaf in leaves.items()}
                block = (params.shared if kind == "shared_attn"
                         else next(blocks))
                x, _, a = block(x, layer, mode, pos, pages, offset, view)
                aux = aux + a
    x = apply_norm(params.final_norm, x, cfg)
    logits = dense(x, params.lm_head, cfg.quant)
    return logits, cache, aux


# ---------------------------------------------------------------------------
# Init entry points.
# ---------------------------------------------------------------------------

def _materialize_tree(tree, generator, dtype, device):
    if isinstance(tree, ParamSpec):
        return materialize(tree, generator, dtype, device)
    if isinstance(tree, dict):
        return {k: _materialize_tree(v, generator, dtype, device)
                for k, v in tree.items()}
    return [_materialize_tree(v, generator, dtype, device) for v in tree]


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Transformer:
    """Random weights with the reference's distributions (not its bits),
    drawn from ``generator`` (which must live on ``device``)."""
    dev = require_device(device)
    return Transformer(cfg, _materialize_tree(param_specs(cfg), generator,
                                              cfg.dtype, dev))


def init_cache(cfg: ArchConfig, batch: int, prompt_len: int, *,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Zeroed contiguous cache: per stage, (layers, batch, cap, ...)
    leaves of the model's dtype, cap = ``cache_capacity(cfg,
    prompt_len)``."""
    dev = require_device(device)
    cap = cache_capacity(cfg, prompt_len)
    return _materialize_tree(cache_specs(cfg, batch, cap), None, cfg.dtype,
                             dev)


def init_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int, *,
                     kv_format: str = "fp", batch: Optional[int] = None,
                     device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Zeroed paged cache: per stage, (layers, num_pages, page_size, ...)
    pools (``cache_specs``): of the model's dtype, or for a quantized
    ``kv_format`` int8 pools beside (layers, num_pages, page_size)
    float32 scales; a model with per-slot state (mamba blocks) also
    holds (layers, ``batch``, ...) state leaves, so it needs ``batch``."""
    dev = require_device(device)
    if batch is None:
        if not all(s.pooled for s in flat_leaves(cache_specs(
                cfg, 0, 0, num_pages=1, page_size=page_size))):
            raise ValueError(f"{cfg.name}: its blocks keep per-slot state; "
                             "init_paged_cache needs batch")
        batch = 0
    return _materialize_tree(cache_specs(cfg, batch, 0, num_pages=num_pages,
                                         page_size=page_size,
                                         kv_format=kv_format),
                             None, cfg.dtype, dev)


def _n_quantizable(spec) -> int:
    if isinstance(spec, ParamSpec):
        return int(spec.quantize)
    vals = spec.values() if isinstance(spec, dict) else spec
    return sum(_n_quantizable(v) for v in vals)


def _pack_tree(spec, tree, quant):
    """The packed tree of the raw ``tree`` laid out as ``spec``: each
    quantize-eligible leaf packed into a :class:`PackedWeight`, the rest
    as they are.  Each leaf is taken out of ``tree`` as it is packed, so
    that no reference to a raw leaf outlives its packing here."""
    if isinstance(spec, ParamSpec):
        return prepare_weight(tree, quant) if spec.quantize else tree
    if isinstance(spec, dict):
        return {k: _pack_tree(s, tree.pop(k), quant) for k, s in spec.items()}
    return [_pack_tree(s, tree.pop(0), quant) for s in spec]


def quantize_for_serving(cfg: ArchConfig, params: Transformer, *,
                         consume: bool = False) -> Tuple[Transformer, int]:
    """Pack every quantize-eligible weight (``ParamSpec.quantize``) into
    a :class:`PackedWeight` in the format of ``cfg.quant``, ``lm_head``
    included.  Returns (the packed model, the count the reference's
    ``quantize_for_serving`` returns for this config): the reference
    stacks a scan stage's layers, so each eligible block weight counts
    once a stage however many layers the stage has.

    With ``consume`` the raw model gives up its tensors first (each of its
    parameters is left empty, and it must not be used again): a raw leaf
    is then freed as soon as it is packed, so the peak is the raw model
    plus the largest leaf's packing, not the raw and packed models
    together (yi-34b on one card).  The packed model is the same, bit for
    bit; its unpacked leaves (embedding, norms, biases) are the raw
    model's tensors in both forms."""
    if cfg.quant is None or cfg.quant.mode not in ("int", "wo"):
        raise ValueError("quantize_for_serving needs an int/wo QuantConfig "
                         f"on cfg.quant, got {cfg.quant}")
    kinds = set(_layer_kinds(cfg))
    later = []
    if "mamba" in kinds or any(st.group for st in _stages(cfg)):
        # the reference packs a stage's stacked in_proj / out_proj layer by
        # layer and the shared block's weights once
        later.append("packed Mamba2 and shared-block weights are not in "
                     "this slice of the port (ROADMAP queue 1 item 13)")
    if kinds & {"mla_mlp", "mla_moe"}:
        # MLA decode absorbs W_UK / W_UV into einsums on the raw weights
        later.append("packed MLA weights are not in this slice of the port "
                     "(ROADMAP queue 1 item 11)")
    if kinds & {"attn_moe", "mla_moe"}:
        # the reference keeps the (E, d, f) expert banks raw under its
        # fake-quant emulation, which the port does not have
        later.append("a quantized MoE model runs the reference's fake-quant "
                     "emulation of its expert banks, not in the port yet "
                     "(ROADMAP queue 1 item 16)")
    if later:
        raise NotImplementedError(f"{cfg.name}: " + "; ".join(later))
    specs = param_specs(cfg)
    tree = params.tree()
    if consume:
        for p in params.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    packed = _pack_tree(specs, tree, cfg.quant)
    blocks = specs.pop("blocks")
    firsts = [0]
    for st in _stages(cfg)[:-1]:
        firsts.append(firsts[-1] + st.repeats)
    n = _n_quantizable(specs) + sum(_n_quantizable(blocks[i])
                                    for i in firsts)
    return Transformer(cfg, packed), n
