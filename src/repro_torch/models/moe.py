"""Mixture-of-Experts FFN of the port: top-k capacity routing on one card.

The counterpart of ``repro.models.moe``'s one-device path (its
``_moe_dense_path``).  Each token picks its ``top_k`` experts from a
float32 router; each (token, k) assignment is ranked within its expert by
a stable sort, in flattened (token, k) order, which gives it an (expert,
capacity slot) coordinate; assignments ranked at or past the capacity are
dropped.  The experts' SwiGLU runs as three batched GEMMs over an (E, cap,
d) buffer, and each token sums its kept experts' rows weighted by its
renormalised gates.

What the reference fixes and the port keeps, each tested against it:

  * ties in top-k go to the lower expert index (``jax.lax.top_k``): a
    stable descending sort, not ``torch.topk``, which promises no order;
  * the capacity (:func:`_capacity`) is taken from every token of the
    dispatch, padding and inactive slots included; only mode 'chunk'
    masks tokens (``token_mask``), which are routed to the sentinel
    expert E, count in the aux loss's denominator and fill no slot;
  * the router runs in float32, the gates are renormalised with
    ``max(sum, 1e-9)`` and cast to the activation type before the
    weighted sum; SiLU runs in float32 and is cast back.

The dispatch makes no host sync: a dropped or masked assignment writes
one scratch row past the E * cap slots, which is sliced off, in place of
the reference's ``mode="drop"`` scatter.  The expert-parallel
``_moe_shardmap`` and its ``_ep_layout`` have no use on one card (ROADMAP
queue 1 item 19), and the fake-quant emulation of the expert banks comes
with item 16.

Shared experts (deepseek-v2's ``shared`` subtree, ``n_shared_experts``
experts of width ``d_ff_expert`` fused into one SwiGLU of their summed
width) see every token of the dispatch, padding included, as the
reference's do: three ``dense`` products on the flattened tokens, SiLU in
float32 cast back, added to the routed output.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import ParamSpec, dense


def moe_specs(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    # the reference's fan_in skips the leading "expert" axis of a bank:
    # an (E, d, f) bank's std is d ** -0.5, not (E * d) ** -0.5
    specs = {
        "router": ParamSpec((d, e), scale=0.02),
        "w_gate": ParamSpec((e, d, f), scale=d ** -0.5, quantize=True),
        "w_up": ParamSpec((e, d, f), scale=d ** -0.5, quantize=True),
        "w_down": ParamSpec((e, f, d), scale=f ** -0.5, quantize=True),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs["shared"] = {
            "w_gate": ParamSpec((d, fs), quantize=True),
            "w_up": ParamSpec((d, fs), quantize=True),
            "w_down": ParamSpec((fs, d), quantize=True),
        }
    return specs


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    """Slots an expert holds in a dispatch of ``n_tokens`` tokens: 512
    aligned from 512 up, else at least 8 and a multiple of 8."""
    c = int(math.ceil(n_tokens * top_k / n_experts * factor))
    if c >= 512:
        return ((c + 511) // 512) * 512
    return max(8, ((c + 7) // 8) * 8)


def _rank_in_group(ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element of the 1-D ``ids`` within its equal-id group,
    in stable (index) order: int32."""
    a = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order].contiguous()
    seg = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    ranks_sorted = (torch.arange(a, dtype=torch.int32, device=ids.device)
                    - seg.to(torch.int32))
    return torch.zeros(a, dtype=torch.int32, device=ids.device).scatter_(
        0, order, ranks_sorted)


def _top_k_gates(probs: torch.Tensor, k: int):
    """Each row's ``k`` largest probabilities, ties to the lower expert
    (a stable descending sort, as ``jax.lax.top_k``), renormalised to sum
    to 1: (gates (T, k) float32, experts (T, k) int64)."""
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), experts


class Routing(NamedTuple):
    """One dispatch's routing: ``experts`` (T, k) int64 (E for a masked
    token) and ``gates`` (T, k) float32, in top-k order; per (token, k)
    assignment in flattened order, ``idx_e`` / ``idx_c`` its expert and
    capacity slot (E and 0 where dropped) and ``keep`` (rank < cap, a
    masked token's included, as the reference has it); ``cap`` slots an
    expert; ``aux`` the load-balancing loss."""
    experts: torch.Tensor
    gates: torch.Tensor
    idx_e: torch.Tensor
    idx_c: torch.Tensor
    keep: torch.Tensor
    cap: int
    aux: torch.Tensor


def route(p, xf: torch.Tensor, cfg,
          token_mask: Optional[torch.Tensor] = None) -> Routing:
    """Top-k capacity routing of the (T, d) tokens ``xf``;
    ``token_mask`` (T,) or (B, S) marks the tokens that are routed
    (False: chunk padding, sent to the sentinel expert E)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gates, experts = _top_k_gates(probs, k)
    if token_mask is not None:
        tm = token_mask.reshape(t, 1)
        gates = torch.where(tm, gates, 0.0)
        experts = torch.where(tm, experts, e)
    # load-balancing auxiliary loss (Switch-style); the sentinel's bin is
    # dropped, as the reference's scatter-add drops index E
    me = probs.mean(0)
    ce = torch.zeros(e + 1, dtype=torch.float32, device=xf.device)
    ce.index_add_(0, experts.reshape(-1),
                  torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                             device=xf.device))
    aux = e * torch.sum(me * ce[:e])
    cap = _capacity(t, e, k, cfg.capacity_factor)
    e_flat = experts.reshape(t * k)
    rank = _rank_in_group(e_flat)
    keep = rank < cap
    idx_e = torch.where(keep, e_flat, e)
    idx_c = torch.where(keep, rank, 0)
    return Routing(experts, gates, idx_e, idx_c, keep, cap, aux)


def _dispatch(xf: torch.Tensor, slot: torch.Tensor, n_slots: int,
              k: int) -> torch.Tensor:
    """The (n_slots, d) expert buffer: assignment i's token row at
    ``slot[i]``; a slot at or past ``n_slots`` (dropped or masked) goes to
    a scratch row, which is sliced off."""
    t, d = xf.shape
    buf = torch.zeros((n_slots + 1, d), dtype=xf.dtype, device=xf.device)
    rows = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf[torch.clamp_max(slot, n_slots)] = rows
    return buf[:n_slots]


def _expert_swiglu(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Batched per-expert SwiGLU: (E, cap, d) -> (E, cap, d)."""
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    h = torch.nn.functional.silu(g.float()).to(dtype) * u
    return torch.bmm(h, wd)


def _combine(y_flat: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Each token's sum of its assignments' expert rows (``y_flat``
    (E * cap, d)) times their gates: a dropped assignment reads slot
    E * cap - 1 and is zeroed by ``keep``, as the reference's."""
    n, d = y_flat.shape
    y_a = y_flat[torch.clamp_max(slot, n - 1)]
    y_a = torch.where(keep[:, None], y_a, torch.zeros((), dtype=y_a.dtype,
                                                      device=y_a.device))
    y_a = y_a * gates.reshape(t * k, 1).to(y_flat.dtype)
    return y_a.reshape(t, k, d).sum(dim=1)


def _moe_dense_path(p, xf: torch.Tensor, r: Routing, cfg) -> torch.Tensor:
    """Dispatch, the experts' SwiGLU and the combine: (T, d) -> (T, d)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    slot = r.idx_e * r.cap + r.idx_c
    buf = _dispatch(xf, slot, e * r.cap, k).view(e, r.cap, d)
    y_e = _expert_swiglu(buf, p["w_gate"], p["w_up"], p["w_down"], xf.dtype)
    return _combine(y_e.reshape(e * r.cap, d), slot, r.keep, r.gates, t, k)


def _shared_experts(sh, xf: torch.Tensor, cfg) -> torch.Tensor:
    """The shared experts' SwiGLU on every token: (T, d) -> (T, d)."""
    g = dense(xf, sh["w_gate"], cfg.quant)
    u = dense(xf, sh["w_up"], cfg.quant)
    h = torch.nn.functional.silu(g.float()).to(xf.dtype) * u
    return dense(h, sh["w_down"], cfg.quant)


def moe_ffn(p, x: torch.Tensor, cfg,
            token_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss float32 scalar).

    ``token_mask``: optional (B, S) bool; False positions (chunked-prefill
    padding) are routed to the sentinel expert, so they take no expert
    capacity, and their gates are zeroed.  The capacity counts every
    token of ``x``, masked or not, and the shared experts (where ``p``
    has a ``shared`` subtree) run on every token too."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    r = route(p, xf, cfg, token_mask)
    y = _moe_dense_path(p, xf, r, cfg)
    if "shared" in p:
        y = y + _shared_experts(p["shared"], xf, cfg)
    return y.reshape(b, s, d), r.aux
