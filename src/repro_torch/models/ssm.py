"""Mamba2 (SSD) mixer of the port: the chunked scan for a prompt chunk, one
step for decode.

The counterpart of ``repro.models.ssm``.  Per chunk of length L the
intra-chunk term is a causal, decay-weighted (C_i . B_j) quadratic form,
and the inter-chunk term carries the (H, P, N) state through a loop over
the chunks: O(S L) + O(S / L) instead of O(S^2).  Every slot keeps a
fixed-size state, whatever its length: the last K - 1 conv inputs
``conv`` (B, K - 1, C) of the model's dtype and the SSM state ``ssm`` (B,
H, P, N) in float32.  They live per slot in either cache layout (the
paged engine bypasses paging for them) and are updated in place.

What the reference fixes and the port keeps:

  * the intra-chunk weights and ``x * dt`` are rounded to bfloat16 even in
    a float32 model, and their product is summed in float32 (the
    reference's ``preferred_element_type``): here the rounded tensors are
    widened again before the ``einsum``, since a bfloat16 ``einsum`` in
    torch would return bfloat16;
  * the chunk length is ``min(ssm_chunk, S)`` halved until it divides S;
  * ``dt`` is ``softplus`` (``logaddexp(x, 0)``, the reference's form) and
    0 on a chunk's padding, so padded steps leave the state exactly as it
    was (decay exp(0) = 1, nothing injected): the final state is the
    state after each slot's own length.

The scan and the conv are plain PyTorch: the reference computes them
outside any Pallas kernel, so the port has no kernel of theirs to write.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ParamSpec, broadcast_offset,
                                       chunk_lengths, chunk_valid_mask, dense,
                                       rms_norm)


def ssm_dims(cfg) -> Tuple[int, int, int]:
    """(d_inner, SSM heads, conv channels) of ``cfg``."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_ch = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_ch


def mamba_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, h, conv_ch = ssm_dims(cfg)
    n = cfg.ssm_state
    return {
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * n + h), quantize=True),
        "conv_w": ParamSpec((cfg.conv_dim, conv_ch), scale=0.2),
        "conv_b": ParamSpec((conv_ch,), init="zeros"),
        "A_log": ParamSpec((h,), init="zeros"),
        "D": ParamSpec((h,), init="ones"),
        "dt_bias": ParamSpec((h,), init="zeros"),
        "norm": ParamSpec((d_inner,), init="ones", dtype=torch.float32),
        "out_proj": ParamSpec((d_inner, d), quantize=True),
    }


def mamba_cache_spec(cfg, batch: int) -> dict:
    """A slot's recurrent state, the same in both cache layouts."""
    d_inner, h, conv_ch = ssm_dims(cfg)
    return {
        "conv": ParamSpec((batch, cfg.conv_dim - 1, conv_ch), init="zeros"),
        "ssm": ParamSpec((batch, h, cfg.ssm_headdim, cfg.ssm_state),
                         init="zeros", dtype=torch.float32),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]):
    """Depthwise causal conv along the sequence: u (B, S, C), w (K, C).
    Returns (out (B, S, C), the last K - 1 inputs (B, K - 1, C))."""
    k, s = w.shape[0], u.shape[1]
    if state is None:
        state = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    ext = torch.cat([state.to(u.dtype), u], dim=1)
    out = ext[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + s] * w[i]
    out = out + b
    new_state = ext[:, -(k - 1):, :] if k > 1 else state
    return F.silu(out.float()).to(u.dtype), new_state


def conv_state_from_chunk(u: torch.Tensor, k: int, lengths: torch.Tensor,
                          old_state: torch.Tensor,
                          history: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The conv state after a right-padded chunk: each slot's last K - 1
    VALID inputs.  ``history`` is the (B, K - 1, C) state before the
    chunk (a resumed chunk shorter than K - 1 keeps the tail of the last
    one), None for none; a row of length 0 keeps ``old_state``."""
    b = u.shape[0]
    if history is None:
        history = torch.zeros((b, k - 1, u.shape[2]), dtype=u.dtype,
                              device=u.device)
    ext = torch.cat([history.to(u.dtype), u], dim=1)
    idx = lengths.to(torch.int64)[:, None] + torch.arange(
        k - 1, device=u.device)[None, :]
    st = torch.gather(ext, 1, idx[:, :, None].expand(-1, -1, u.shape[2]))
    active = (lengths > 0)[:, None, None]
    return torch.where(active, st.to(old_state.dtype), old_state)


def chunk_len(s: int, chunk: int) -> int:
    """The scan's chunk length for ``s`` steps: ``min(chunk, s)`` halved
    until it divides ``s``, as the reference takes it."""
    l = min(chunk, s)
    while s % l:
        l //= 2
    return l


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and widened back to float32, as the
    reference rounds the scan's intra-chunk weights and ``x * dt``."""
    return t.to(torch.bfloat16).float()


def _ssd_chunked(xh, dt, a, b_in, c_in, h0, chunk: int):
    """The chunked SSD scan.  xh (B, S, H, P); dt and a = dt * A (B, S,
    H); b_in, c_in (B, S, N); h0 (B, H, P, N) float32.  Returns y (B, S,
    H, P) float32 and the final state."""
    bsz, s, hh, p = xh.shape
    n = b_in.shape[-1]
    l = chunk_len(s, chunk)
    nc = s // l
    xc = xh.reshape(bsz, nc, l, hh, p)
    dtc = dt.reshape(bsz, nc, l, hh).float()
    ac = a.reshape(bsz, nc, l, hh).float()
    bc = b_in.reshape(bsz, nc, l, n).float()
    cc = c_in.reshape(bsz, nc, l, n).float()
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=xh.device))
    h_prev, ys = h0, []
    for c in range(nc):
        x_c, dt_c, a_c, b_c, c_c = (xc[:, c], dtc[:, c], ac[:, c], bc[:, c],
                                    cc[:, c])
        cum = torch.cumsum(a_c, dim=1)                      # (B, L, H)
        tot = cum[:, -1]                                    # (B, H)
        # intra: y_i += sum_{j<=i} (c_i.b_j) exp(cum_i - cum_j) dt_j x_j
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # (B, L, L, H)
        decay = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)
        w_ij = _bf16(cb[..., None] * decay)
        del seg, decay
        xdt = _bf16(x_c.float() * dt_c[..., None])
        y_c = torch.einsum("bijh,bjhp->bihp", w_ij, xdt)
        del w_ij
        # inter: y_i += exp(cum_i) * c_i . h_prev
        y_c = y_c + torch.einsum("bin,bhpn->bihp", c_c, h_prev) * torch.exp(
            cum)[..., None]
        # state: h = exp(tot) h_prev + sum_j exp(tot - cum_j) dt_j b_j x_j^T
        sdec = torch.exp(tot[:, None, :] - cum)             # (B, L, H)
        s_c = torch.einsum("blh,bln,blhp->bhpn", sdec * dt_c, b_c,
                           x_c.float())
        h_prev = h_prev * torch.exp(tot)[:, :, None, None] + s_c
        ys.append(y_c)
    y = torch.stack(ys, dim=1).reshape(bsz, s, hh, p)
    return y, h_prev


def apply_mamba(p, x: torch.Tensor, cfg, *, cache: Optional[dict],
                mode: str, pos, offset: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The Mamba2 mixer on x (B, S, d).

    mode 'chunk': ``pos`` is the (B,) valid length of a right-padded chunk
    (0 = a slot not in the wave: its state is kept); with ``offset`` a
    slot whose offset is > 0 resumes its cached conv and SSM state, one
    at 0 starts afresh.  mode 'decode': one token a slot, ``pos`` (B,)
    with -1 for an inactive slot, whose state is kept.  mode 'prefill':
    the whole prompt from its start; the state becomes the last K - 1
    inputs and the final SSM state.  ``cache`` = {"conv", "ssm"} is
    updated in place and returned."""
    b, s, _ = x.shape
    d_inner, h, _ = ssm_dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_headdim
    dev = x.device
    zxbcdt = dense(x, p["in_proj"], cfg.quant)
    z, xr, bc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner, 2 * n, h],
                                    dim=-1)
    conv_in = torch.cat([xr, bc], dim=-1)

    conv_state = cache["conv"] if mode == "decode" else None
    resume = None
    if mode == "chunk" and offset is not None:
        resume = broadcast_offset(offset, b, dev) > 0
        conv_state = torch.where(resume[:, None, None], cache["conv"],
                                 torch.zeros_like(cache["conv"]))
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    xc, b_in, c_in = torch.split(conv_out, [d_inner, n, n], dim=-1)

    a_param = -torch.exp(p["A_log"].float())                     # (H,)
    u = dt_raw.float() + p["dt_bias"].float()
    dt = torch.logaddexp(u, torch.zeros_like(u))                  # (B, S, H)
    if mode == "chunk":
        len_b = chunk_lengths(pos, b, dev)
        valid = chunk_valid_mask(len_b, s)
        dt = torch.where(valid[:, :, None], dt, 0.0)
    xh = xc.reshape(b, s, h, pdim)

    if mode == "decode":
        if s != 1:
            raise ValueError(f"mode='decode' takes one token per slot, "
                             f"got {s}")
        h0 = cache["ssm"].float()
        dt1 = dt[:, 0]                                            # (B, H)
        da = torch.exp(dt1 * a_param[None, :])
        inj = (dt1[:, :, None, None] * b_in[:, 0].float()[:, None, None]) \
            * xh[:, 0].float()[..., None]                         # (B,H,P,N)
        h_new = h0 * da[:, :, None, None] + inj
        # an inactive slot (pos < 0) keeps its state
        live = torch.broadcast_to(torch.as_tensor(
            pos, dtype=torch.int32, device=dev).reshape(-1), (b,)) >= 0
        h_new = torch.where(live[:, None, None, None], h_new, h0)
        new_conv = torch.where(live[:, None, None], new_conv, cache["conv"])
        y = torch.matmul(h_new, c_in[:, 0].float()[:, None, :, None])[
            :, None, :, :, 0]                                     # (B,1,H,P)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h_new)
    elif mode in ("chunk", "prefill"):
        h0 = torch.zeros((b, h, pdim, n), dtype=torch.float32, device=dev)
        if resume is not None:
            h0 = torch.where(resume[:, None, None, None], cache["ssm"].float(),
                             h0)
        a = dt * a_param[None, None, :]
        y, h_final = _ssd_chunked(xh, dt, a, b_in, c_in, h0, cfg.ssm_chunk)
        if mode == "prefill":
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(h_final)
        else:
            active = len_b > 0
            conv = conv_state_from_chunk(
                conv_in, p["conv_w"].shape[0], len_b, cache["conv"],
                history=conv_state if resume is not None else None)
            ssm = torch.where(active[:, None, None, None], h_final,
                              cache["ssm"].float())
            cache["conv"].copy_(conv)
            cache["ssm"].copy_(ssm)
    else:
        raise ValueError(f"apply_mamba: mode {mode!r}; the port serves "
                         "'chunk', 'decode' and 'prefill' (the cacheless "
                         "'train' forward comes with ROADMAP queue 1 item 16)")

    y = y + xh.float() * p["D"].float()[:, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # mamba2's gated RMS norm before the out projection, gated by z
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"])
    return dense(y, p["out_proj"], cfg.quant), cache
