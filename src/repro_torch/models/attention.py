"""GQA attention over the paged KV pool or a contiguous cache.

The counterpart of ``repro.models.attention`` for one device.  The
reference's mesh, ``shard_map`` and ``lshard`` branches collapse away, and
so do its replicated-pool helpers (``_chunked_attention_local``,
``_resume_attention_local``, ``_decode_attention_local``): the port runs
the two kernels instead, by default, on every dispatch.

  * a FRESH chunk (mode='chunk', no offset) runs the causal flash kernel
    over the chunk's own K/V, then scatters them into the pool;
  * a RESUMED chunk (mode='chunk' with offset) and a paged DECODE step
    scatter the new K/V into the pool first, then run the paged
    flash-decode kernel through the page table, followed by the
    reference's combine :func:`_combine_page_partials`.  Decode cuts the
    page axis into splits of one 64-key tile (:func:`page_split`), where
    the reference takes one page a split.

A QUANTIZED pool (``ServeConfig.kv_format`` int8/int4: int8 ``k``/``v``
pools with ``k_scale``/``v_scale`` row scales, recognised by its leaves,
:func:`cache_page_format`) quantizes the new rows once as it writes them
and runs the quantized paged kernel, which dequantizes each page as it
reads it.  Its fresh chunks run as a resume at offset 0, as the
reference's do: every K/V row a query sees then comes back from the pool,
so the logits do not depend on how a prompt was chunked or shared.

With ``cfg.qk_norm`` (qwen3) each head of q and k is RMS-normed by the
float32 ``q_norm`` / ``k_norm`` weights (dh,) before RoPE, as the
reference does; the normed, roped k is what every dispatch writes into
the pool.

The pool is written in place (:func:`~repro_torch.models.common.
paged_scatter`, :func:`~repro_torch.models.common.paged_scatter_quant`).

A CONTIGUOUS cache (``pages`` None: {"k", "v"} of (B, cap, KV, dh), the
reference's ``paged=False`` layout, always of the model's dtype) runs the
same two kernels.  'prefill' (the whole prompt from row 0, the rows past
it zeroed) and a fresh chunk run the flash kernel and write the rows
(:func:`cache_fill`); a resumed chunk and decode write their rows
(:func:`~repro_torch.models.common.contig_scatter`, no host sync) and run
the paged kernel through the cache viewed as pages and an identity table
(:func:`~repro_torch.models.common.contig_pages`), so a contiguous
dispatch and a paged one at the same page size and table width cut the
keys into the same splits.  'train' comes with ROADMAP queue 1 item 16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.pageformat import FP, format_for_packed
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_flash_decode import (TILE_KEYS,
                                                    paged_flash_decode_partials)
from repro_torch.models.common import (ContigView, ParamSpec,
                                       broadcast_offset, chunk_lengths,
                                       chunk_valid_mask, contig_fill,
                                       contig_pages, contig_prefill,
                                       contig_scatter, dense, paged_scatter,
                                       paged_scatter_quant, rms_norm, rope)

NEG_INF = -1e30
# Bytes the float32 partials of one dispatch may take.  Per-page partials
# of a resumed chunk grow as Sq x P; above this the pages are walked in
# splits of several pages inside the kernel (see paged_flash_decode).
PARTIALS_BYTES_BUDGET = 64 << 20
# query rows (Sq x H / KV) up to which a GQA call is decode: one m16 tile
# of the bf16 kernel's decode route, which takes one key tile a split
DECODE_ROWS = 16


def attn_specs(cfg) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, h * dh), quantize=True),
        "wk": ParamSpec((d, kv * dh), quantize=True),
        "wv": ParamSpec((d, kv * dh), quantize=True),
        "wo": ParamSpec((h * dh, d), quantize=True),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h * dh,), init="zeros")
        specs["bk"] = ParamSpec((kv * dh,), init="zeros")
        specs["bv"] = ParamSpec((kv * dh,), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((dh,), init="ones", dtype=torch.float32)
        specs["k_norm"] = ParamSpec((dh,), init="ones", dtype=torch.float32)
    return specs


def kv_cache_spec(cfg, batch: int, capacity: int) -> dict:
    """Contiguous layout: (batch, capacity, KV, dh) K and V per layer, a
    slot's rows at [0, capacity)."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": ParamSpec((batch, capacity, kv, dh), init="zeros"),
            "v": ParamSpec((batch, capacity, kv, dh), init="zeros")}


def paged_kv_cache_spec(cfg, num_pages: int, page_size: int,
                        fmt=FP) -> dict:
    """One (num_pages, page_size, KV, dh) pool per layer shared by every
    slot, mapped through the engine's per-slot page table.  A quantized
    ``fmt`` (:mod:`repro_torch.core.pageformat`) stores int8 pools of
    last dim ``fmt.packed_feat(dh)`` and adds ``k_scale``/``v_scale``,
    (num_pages, page_size) float32 row scales on the same page axis."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    if not fmt.quantized:
        return {"k": ParamSpec((num_pages, page_size, kv, dh), init="zeros"),
                "v": ParamSpec((num_pages, page_size, kv, dh), init="zeros")}
    dp = fmt.packed_feat(dh)
    return {
        "k": ParamSpec((num_pages, page_size, kv, dp), init="zeros",
                       dtype=torch.int8),
        "v": ParamSpec((num_pages, page_size, kv, dp), init="zeros",
                       dtype=torch.int8),
        "k_scale": ParamSpec((num_pages, page_size), init="zeros",
                             dtype=torch.float32),
        "v_scale": ParamSpec((num_pages, page_size), init="zeros",
                             dtype=torch.float32),
    }


def cache_page_format(cache: dict, full_feat: int):
    """A paged cache's storage format, or None for fp: a scale leaf
    beside the pool marks it quantized, and the ratio of the full
    feature width to the stored last dim names the bits."""
    key = "k_scale" if "k_scale" in cache else \
        ("ckv_scale" if "ckv_scale" in cache else None)
    if key is None:
        return None
    pool = cache["ckv"] if key == "ckv_scale" else cache["k"]
    return format_for_packed(full_feat, pool.shape[-1])


def _pages_per_split(b: int, sq: int, hq: int, p: int, dv: int) -> int:
    """Pages each kernel block walks: 1 (the reference's per-page
    partials) unless that would put more than PARTIALS_BYTES_BUDGET in the
    float32 ``acc``; a chunk's split, and decode's floor under
    :func:`tile_split`."""
    per_split = max(1, b * sq * hq * dv * 4)
    n_split = max(1, min(p, PARTIALS_BYTES_BUDGET // per_split))
    return -(-p // n_split)


def tile_pages_per_split(page_size: int, p: int) -> int:
    """Pages one key tile of the bf16 decode kernels covers, TILE_KEYS //
    ``page_size`` (4 at page 16, 2 at page 32), at least 1 and at most
    the table's ``p``.  One page a split would write float32 partials as
    large as the pages they come from; one tile a split writes a
    quarter of them at page 16 and fills the tile's 64 keys."""
    return max(1, min(TILE_KEYS // page_size, p))


def tile_split(page_size: int, b: int, sq: int, hq: int, p: int,
               dv: int) -> int:
    """Decode's pages a split: one key tile (:func:`tile_pages_per_split`),
    or more where the float32 partials of (``b``, ``sq``, ``hq``) query
    rows of width ``dv`` over ``p`` pages would otherwise pass
    PARTIALS_BYTES_BUDGET, as :func:`_pages_per_split` caps them."""
    return max(tile_pages_per_split(page_size, p),
               _pages_per_split(b, sq, hq, p, dv))


def page_split(b: int, sq: int, hq: int, kv: int, p: int, page_size: int,
               dv: int) -> int:
    """Pages a split of the GQA partials: decode (``sq * hq / kv`` <=
    DECODE_ROWS query rows) takes :func:`tile_split`, chunks
    :func:`_pages_per_split`.  It reads the rows, page size, table width
    and budget alone (no device or dtype), so the CPU and the card cut
    the page axis alike."""
    if sq * (hq // kv) <= DECODE_ROWS:
        return tile_split(page_size, b, sq, hq, p, dv)
    return _pages_per_split(b, sq, hq, p, dv)


def _page_partials(q, k_pool, v_pool, tbl, qpos, kv_valid, **quant):
    """Flash partials of ``q`` against the pool through ``tbl``: m, l
    (B, Sq, KV, G, S) and acc (..., S, dv) over S page splits
    (:func:`page_split`).  ``quant``: a quantized pool's ``k_scale``,
    ``v_scale`` and ``bits``."""
    b, sq, hq, _ = q.shape
    ps, kv = k_pool.shape[1], k_pool.shape[2]
    dv = v_pool.shape[-1] * (8 // quant["bits"] if quant else 1)
    c = page_split(b, sq, hq, kv, tbl.shape[1], ps, dv)
    return paged_flash_decode_partials(k_pool, v_pool, q, tbl, qpos,
                                       kv_valid, pages_per_split=c, **quant)


def _combine_page_partials(m, l, acc):
    """Flash-decoding reduction over the page (split) axis, as the
    reference: fully-masked pages and slots contribute exact zeros."""
    mg = m.amax(dim=-1)
    corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - mg[..., None]))
    lg = torch.sum(l * corr, dim=-1)
    accg = torch.sum(acc * corr[..., None], dim=-2)
    return accg / torch.clamp(lg, min=1e-30)[..., None]


def cache_fill(cache: dict, k_new, v_new, lengths) -> dict:
    """Write a fresh chunk into rows [0, len) of each slot of a contiguous
    cache, IN PLACE, and return it.  ``k_new``/``v_new``: (B, S, KV, dh);
    ``lengths``: (B,) valid counts <= S (0 = slot not admitted: its rows
    stay as they are).  A pad-and-select, as the reference: rows >= len
    keep their contents."""
    len_b = chunk_lengths(lengths, cache["k"].shape[0], k_new.device)
    ok = chunk_valid_mask(len_b, k_new.shape[1])
    contig_fill(cache["k"], k_new, ok)
    contig_fill(cache["v"], v_new, ok)
    return cache


def cache_update(cache: dict, k_new, v_new, index) -> dict:
    """Write one token's K/V (B, 1, KV, dh) at row ``index`` (scalar or
    (B,); negative = no write) of each slot of a contiguous cache, IN
    PLACE, and return it."""
    b = cache["k"].shape[0]
    t = broadcast_offset(index, b, k_new.device)[:, None]
    ok = torch.ones_like(t, dtype=torch.bool)
    contig_scatter(cache["k"], k_new, t, ok)
    contig_scatter(cache["v"], v_new, t, ok)
    return cache


def _paged_attend(q, k, v, cache, pages, t, ok, qpos, kv_valid, fmt, view):
    """Scatter the new rows at logical positions ``t`` (where ``ok``),
    quantized when the pool's format ``fmt`` is (None = fp), then attend
    ``q`` over the slots' cached windows through the table.  A contiguous
    cache (``pages`` None) is read through its ``view`` as pages."""
    quant = {}
    pools = (cache["k"], cache["v"])
    if pages is None:
        contig_scatter(cache["k"], k, t, ok)
        contig_scatter(cache["v"], v, t, ok)
        pools, pages = contig_pages(pools, view)
    elif fmt is None:
        paged_scatter(cache["k"], pages, k, t, ok)
        paged_scatter(cache["v"], pages, v, t, ok)
    else:
        paged_scatter_quant(cache["k"], cache["k_scale"], pages, k, t, ok,
                            fmt)
        paged_scatter_quant(cache["v"], cache["v_scale"], pages, v, t, ok,
                            fmt)
        quant = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"],
                     bits=fmt.bits)
    m, l, acc = _page_partials(q, pools[0], pools[1], pages, qpos,
                               kv_valid, **quant)
    o = _combine_page_partials(m, l, acc)
    b, sq = q.shape[:2]
    return o.reshape(b, sq, -1, o.shape[-1]).to(q.dtype)


def mode_error(mode: str) -> ValueError:
    """The rejection of a mode this slice of the port does not serve."""
    item = {"train": "16, training", "verify": "14, speculative decoding"}
    return ValueError(f"mode {mode!r}: this slice of the port serves "
                      "'prefill', 'chunk' and 'decode'"
                      + (f" (ROADMAP queue 1 item {item[mode]})"
                         if mode in item else ""))


def apply_attention(p, x: torch.Tensor, cfg, *, cache: dict, mode: str,
                    pos, pages: Optional[torch.Tensor] = None,
                    offset: Optional[torch.Tensor] = None,
                    view: Optional[ContigView] = None,
                    ) -> Tuple[torch.Tensor, dict]:
    """Attention sublayer: QKV projections, RoPE, attention, out proj.

    mode 'chunk': ``pos`` is the (B,) valid length of a right-padded chunk
    (0 = inactive slot).  Without ``offset`` the chunk's tokens sit at rows
    [0, len); with a (B,) ``offset`` at [offset, offset + len), attending
    the cached history [0, offset) too.  mode 'decode': ``pos`` is the (B,)
    row of each slot's token (-1 = inactive slot).  mode 'prefill'
    (contiguous cache only): the whole prompt from row ``pos`` (0), its
    K/V padded into the cache.  ``pages``: (B, P) int32 page table into
    ``cache`` = {"k", "v"} pools of (N, ps, KV, dh) (a quantized pool:
    int8 pools and their ``k_scale``/``v_scale``); None for a contiguous
    cache {"k", "v"} of (B, cap, KV, dh), read through ``view``.  The
    cache is updated in place and returned."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = x.device
    q = dense(x, p["wq"], cfg.quant, p.get("bq")).reshape(b, s, h, dh)
    k = dense(x, p["wk"], cfg.quant, p.get("bk")).reshape(b, s, kv, dh)
    v = dense(x, p["wv"], cfg.quant, p.get("bv")).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
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
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    fmt = None if pages is None else cache_page_format(cache, dh)
    if mode == "prefill":
        o = flash_attention(q, k, v, kv_valid=s)
        contig_prefill(cache["k"], k)
        contig_prefill(cache["v"], v)
    elif mode == "chunk" and offset is None and fmt is None:
        # fresh chunk: one causal pass over the padded chunk (padded
        # queries sit after every valid token, so they never leak into
        # valid outputs), then the valid rows go into the cache.  A
        # quantized pool takes the next branch at offset 0 instead, so
        # that the chunk's own rows are read back quantized too.
        o = flash_attention(q, k, v, kv_valid=s)
        if pages is None:
            cache_fill(cache, k, v, len_b)
        else:
            paged_scatter(cache["k"], pages, k, positions, ok)
            paged_scatter(cache["v"], pages, v, positions, ok)
    elif mode == "chunk":
        o = _paged_attend(q, k, v, cache, pages, positions, ok, positions,
                          off_b + len_b, fmt, view)
    else:
        t = pos_b[:, None]
        o = _paged_attend(q, k, v, cache, pages, t, t >= 0, t, pos_b + 1,
                          fmt, view)
    y = dense(o.reshape(b, s, h * dh), p["wo"], cfg.quant)
    return y, cache
