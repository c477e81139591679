"""Multi-head Latent Attention (DeepSeek-V2) over the paged latent pool
or a contiguous latent cache.

The counterpart of ``repro.models.mla`` for serving on one device.
The cache keeps one latent row per token and layer, the normalised
``c_kv`` (kv_lora_rank wide) followed by the roped ``k_rope``
(qk_rope_dim wide): 576 values at deepseek-v2's widths, against 2 * H *
dh = 4096 for full K/V.  Three modes, each on a hand-written kernel:

  * a FRESH chunk (mode='chunk', no offset) runs the naive (expanded)
    form: k_nope and v come up through W_UK / W_UV, the roped k_rope is
    broadcast over heads, and the causal flash kernel attends with q/k
    width nope + rope and v width v_head_dim; then the chunk's latent rows
    go into the pool;
  * a RESUMED chunk (mode='chunk' with offset) scatters its latent rows
    first, expands the slot's whole cached window through W_UK / W_UV,
    and attends it with the paged flash-decode kernel: the expanded
    window is viewed as a pool of one page per (slot, logical page), and
    the table maps the slot's mapped pages onto it;
  * a DECODE step scatters its latent row, absorbs W_UK into the query
    (``q_c``) and runs the compressed-space MLA kernel against the latent
    pool itself, one 64-key tile a split (:func:`decode_split`);
    W_UV is applied to the combined context afterwards.

A QUANTIZED latent pool (``ServeConfig.kv_format`` int8/int4: an int8
``ckv`` and a ``ckv_scale`` of row scales, one a row for c_kv and k_rope
alike) quantizes each latent row once as it writes it.  Decode runs the
quantized MLA kernel, which dequantizes each page as it reads it; a
resumed chunk gathers and dequantizes the window before expanding it; a
fresh chunk runs as a resume at offset 0, as the reference's does, so
that every latent row a query sees comes back from the pool.

A CONTIGUOUS latent cache (``pages`` None: a ``ckv`` of (B, cap, r +
dr), the reference's ``paged=False`` layout) runs the same kernels:
'prefill' and a fresh chunk the naive form on the flash kernel, their
latent rows written by pad-and-select; a resumed chunk and decode write
their rows (``contig_scatter``) and read the cache as pages through an
identity table (``contig_pages``), a resumed chunk expanding that window
as above and decode running the MLA kernel on it.

The small absorbed einsums and every projection stay ``torch`` matmuls,
as the reference leaves them to XLA outside its kernels.  The cache is
written in place.  'train' comes with ROADMAP queue 1 item 16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.pageformat import FP
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_flash_decode import mla_paged_decode_partials
from repro_torch.models.attention import (_combine_page_partials,
                                          _page_partials, cache_page_format,
                                          mode_error, tile_split)
from repro_torch.models.common import (ContigView, ParamSpec,
                                       broadcast_offset, chunk_lengths,
                                       chunk_valid_mask, contig_fill,
                                       contig_pages, contig_prefill,
                                       contig_scatter, dense, paged_gather,
                                       paged_gather_quant, paged_scatter,
                                       paged_scatter_quant, rms_norm, rope)


def mla_dims(cfg):
    return cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim


def mla_specs(cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = mla_dims(cfg)
    return {
        "w_q": ParamSpec((d, h * (dn + dr)), quantize=True),
        "w_dkv": ParamSpec((d, r + dr), quantize=True),
        "kv_norm": ParamSpec((r,), init="ones", dtype=torch.float32),
        "w_uk": ParamSpec((r, h * dn), quantize=True),
        "w_uv": ParamSpec((r, h * dv), quantize=True),
        "w_o": ParamSpec((h * dv, d), quantize=True),
    }


def mla_cache_spec(cfg, batch: int, capacity: int) -> dict:
    """Contiguous layout: a (batch, capacity, r + dr) latent cache per
    layer, a slot's rows at [0, capacity)."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    return {"ckv": ParamSpec((batch, capacity, r + dr), init="zeros")}


def paged_mla_cache_spec(cfg, num_pages: int, page_size: int,
                         fmt=FP) -> dict:
    """One (num_pages, page_size, r + dr) latent pool per layer, shared by
    every slot and mapped through the engine's per-slot page table.  A
    quantized ``fmt`` stores an int8 pool of last dim
    ``fmt.packed_feat(r + dr)`` and a ``ckv_scale`` of (num_pages,
    page_size) float32 row scales on the same page axis."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    if not fmt.quantized:
        return {"ckv": ParamSpec((num_pages, page_size, r + dr),
                                 init="zeros")}
    return {
        "ckv": ParamSpec((num_pages, page_size, fmt.packed_feat(r + dr)),
                         init="zeros", dtype=torch.int8),
        "ckv_scale": ParamSpec((num_pages, page_size), init="zeros",
                               dtype=torch.float32),
    }


def _write(cache, pages, entry, t, ok, fmt, view):
    """Scatter latent rows into the pool (quantized when it is), or into
    a contiguous cache (``pages`` None).  Returns the pool and table the
    kernels read: for a contiguous cache, its ``view`` as pages."""
    if pages is None:
        contig_scatter(cache["ckv"], entry, t, ok)
        (pool,), pages = contig_pages((cache["ckv"],), view)
        return pool, pages
    if fmt is None:
        paged_scatter(cache["ckv"], pages, entry, t, ok)
    else:
        paged_scatter_quant(cache["ckv"], cache["ckv_scale"], pages, entry,
                            t, ok, fmt)
    return cache["ckv"], pages


def _compress(p, x, cfg):
    """x -> (c_kv normalised (B, S, r), k_rope before RoPE (B, S, dr))."""
    r = cfg.kv_lora_rank
    ckv_full = dense(x, p["w_dkv"], cfg.quant)
    c_kv, k_r = ckv_full[..., :r], ckv_full[..., r:]
    return rms_norm(c_kv, p["kv_norm"]), k_r


def _expand(p, c, k_rope, cfg):
    """Latent rows -> the naive form's keys (B, S, H, dn + dr), k_rope
    broadcast over heads, and values (B, S, H, dv)."""
    b, s = c.shape[:2]
    h = cfg.n_heads
    dn, dr, dv = mla_dims(cfg)
    k_nope = dense(c, p["w_uk"], cfg.quant).reshape(b, s, h, dn)
    v = dense(c, p["w_uv"], cfg.quant).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    return k.contiguous(), v.contiguous()


def _resume(p, qq, cache, pages, entry, t, ok, off_b, len_b, cfg, fmt,
            view):
    """Resumed chunk: scatter the chunk's latent rows, expand the slot's
    cached window (history and this chunk; dequantized first from a
    quantized pool) through W_UK / W_UV, and attend it with absolute
    causal masking through the paged kernel."""
    b, s = qq.shape[:2]
    r = cfg.kv_lora_rank
    pool, pages = _write(cache, pages, entry, t, ok, fmt, view)
    buf = (paged_gather(pool, pages) if fmt is None else     # (B, P*ps, r+dr)
           paged_gather_quant(pool, cache["ckv_scale"], pages, fmt,
                              entry.dtype))
    k_w, v_w = _expand(p, buf[..., :r], buf[..., r:], cfg)
    n_pg, ps = pages.shape[1], pool.shape[1]
    # the expanded window as pools of B*P pages, page b*P + j holding
    # logical page j of slot b; unmapped pages stay unmapped
    k_pool = k_w.reshape(b * n_pg, ps, *k_w.shape[2:])
    v_pool = v_w.reshape(b * n_pg, ps, *v_w.shape[2:])
    own = torch.arange(b * n_pg, dtype=torch.int32,
                       device=pages.device).reshape(b, n_pg)
    tbl = torch.where(pages >= 0, own, -1).to(torch.int32)
    qpos = (off_b[:, None] + torch.arange(s, dtype=torch.int32,
                                          device=qq.device)[None, :])
    m, l, acc = _page_partials(qq, k_pool, v_pool, tbl, qpos.contiguous(),
                               (off_b + len_b).contiguous())
    o = _combine_page_partials(m, l, acc)
    return o.reshape(b, s, cfg.n_heads, -1).to(qq.dtype)


def decode_split(page_size: int, b: int, sq: int, h: int, p: int,
                 r: int) -> int:
    """The pages a split MLA decode runs at: one key tile of the bf16
    kernel (:func:`~repro_torch.models.attention.tile_pages_per_split`,
    4 pages at page 16, 2 at page 32), or more where the float32
    partials of (``b``, ``sq``, ``h``) query rows of width ``r`` over
    ``p`` pages would otherwise pass ``PARTIALS_BYTES_BUDGET``, as
    ``_pages_per_split`` caps them (at 32 k tokens, page 16, B 32: 32
    pages a split, 64 MiB a layer, not 512 MiB): GQA decode's
    :func:`~repro_torch.models.attention.tile_split` at width ``r``.

    It reads the page size and table width alone (no device or dtype),
    so the CPU and the card cut the page axis alike.  One page a split
    would write per-page float32 partials of H x r (32 KB a page at H 16,
    r 512) against an 18 KB bf16 page read; one tile a split writes a
    quarter of them at page 16.  Of 1, 2, 4 and 8 pages a split at page
    16, the bf16 kernel is fastest at 4 on an H100 (``chip_smoke.py``'s
    ``mla_sweep``, PERF.md §6)."""
    return tile_split(page_size, b, sq, h, p, r)


def _decode(p, q_nope, q_rope, cache, pages, entry, pos_b, x_dtype, cfg,
            fmt, view):
    """Decode: scatter the latent row at ``pos`` (-1 = no write), absorb
    W_UK into the query, attend the latent pool in the compressed space
    with the MLA kernel (its quantized entry on a quantized pool),
    combine, and apply W_UV.  Returns (B, 1, H, dv) in the activation
    type."""
    b, s, h, _ = q_nope.shape
    r = cfg.kv_lora_rank
    dn, dr, dv = mla_dims(cfg)
    pool, pages = _write(cache, pages, entry, pos_b[:, None],
                         (pos_b >= 0)[:, None], fmt, view)
    quant = ({} if fmt is None else
             dict(scale_pool=cache["ckv_scale"], bits=fmt.bits))
    w_uk = p["w_uk"].reshape(r, h, dn)
    q_c = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk.float())
    c = decode_split(pool.shape[1], b, s, h, pages.shape[1], r)
    m, l, acc = mla_paged_decode_partials(
        pool, q_c.to(x_dtype).contiguous(), q_rope.contiguous(),
        pages, pos_b, r, dn + dr, pages_per_split=c, **quant)
    ctx_c = _combine_page_partials(m, l, acc)           # (B, 1, H, r) f32
    w_uv = p["w_uv"].reshape(r, h, dv)
    return torch.einsum("bqhr,rhv->bqhv", ctx_c, w_uv.float()).to(x_dtype)


def apply_mla(p, x: torch.Tensor, cfg, *, cache: dict, mode: str, pos,
              pages: Optional[torch.Tensor] = None,
              offset: Optional[torch.Tensor] = None,
              view: Optional[ContigView] = None,
              ) -> Tuple[torch.Tensor, dict]:
    """MLA sublayer over the paged latent pool ``cache`` = {"ckv": (N, ps,
    r + dr)} (a quantized pool: an int8 ``ckv`` and its ``ckv_scale``),
    or with ``pages`` None a contiguous ``ckv`` of (B, cap, r + dr) read
    through ``view``; updated in place and returned.

    mode 'chunk': ``pos`` is the (B,) valid length of a right-padded chunk
    (0 = inactive slot); without ``offset`` its tokens sit at rows [0,
    len), with a (B,) ``offset`` at [offset, offset + len).  mode
    'decode': ``pos`` is the (B,) row of each slot's token (-1 = inactive
    slot).  mode 'prefill' (contiguous cache only): the whole prompt
    from row ``pos`` (0), its latent rows padded into the cache.
    ``pages``: (B, P) int32 page table."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = mla_dims(cfg)
    dev = x.device
    ar = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    if mode == "chunk":
        len_b = chunk_lengths(pos, b, dev)
        ok = chunk_valid_mask(len_b, s)
        off_b = (torch.zeros((b,), dtype=torch.int32, device=dev)
                 if offset is None else broadcast_offset(offset, b, dev))
        positions = off_b[:, None] + ar
    elif mode in ("decode", "prefill"):
        if mode == "decode" and s != 1:
            raise ValueError(f"mode='decode' takes one token per slot, "
                             f"got {s}")
        if mode == "prefill" and pages is not None:
            raise ValueError("mode='prefill' writes a contiguous cache; "
                             "a paged one takes mode='chunk'")
        pos_b = broadcast_offset(pos, b, dev)
        positions = torch.clamp(pos_b[:, None] + ar, min=0)
    else:
        raise mode_error(mode)

    q = dense(x, p["w_q"], cfg.quant).reshape(b, s, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], positions, cfg.rope_theta)
    c_kv, k_r = _compress(p, x, cfg)
    k_rope = rope(k_r[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    entry = torch.cat([c_kv, k_rope], dim=-1)           # (B, S, r + dr)

    fmt = (None if pages is None else
           cache_page_format(cache, cfg.kv_lora_rank + dr))
    if mode == "prefill" or (mode == "chunk" and offset is None
                             and fmt is None):
        # the whole prompt, or a fresh chunk: naive form over the rows of
        # this dispatch (padded queries sit after every valid token, so
        # they never leak into valid outputs), then the valid latent rows
        # go into the cache.  A quantized pool takes the next branch at
        # offset 0 instead.
        k, v = _expand(p, c_kv, k_rope, cfg)
        qq = torch.cat([q_nope, q_rope], dim=-1).contiguous()
        o = flash_attention(qq, k, v, kv_valid=s)
        if mode == "prefill":
            contig_prefill(cache["ckv"], entry)
        elif pages is None:
            contig_fill(cache["ckv"], entry, ok)
        else:
            paged_scatter(cache["ckv"], pages, entry, positions, ok)
    elif mode == "chunk":
        qq = torch.cat([q_nope, q_rope], dim=-1).contiguous()
        o = _resume(p, qq, cache, pages, entry, positions, ok, off_b, len_b,
                    cfg, fmt, view)
    else:
        o = _decode(p, q_nope, q_rope, cache, pages, entry, pos_b, x.dtype,
                    cfg, fmt, view)
    y = dense(o.reshape(b, s, h * dv), p["w_o"], cfg.quant)
    return y, cache
