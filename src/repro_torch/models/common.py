"""Declarative parameters and shared layers of the port.

The counterpart of ``repro.models.common``.  Parameters are declared as
trees of :class:`ParamSpec` (shape + init) and materialized with an
explicit ``torch.Generator`` on an explicit device.  The init follows the
reference's distributions (normal with std ``1/sqrt(fan_in)``, ``embed``
with std 1, zeros for biases, ones for norm weights) but not its bits:
``jax.random`` and torch generators give different numbers from one seed,
so parity tests bridge the JAX weights instead (:mod:`repro_torch.weights`).

``dense`` honours the quantization format: a :class:`~repro_torch.kernels.
ops.PackedWeight` (made by ``quantize_for_serving``) runs the packed matmul
kernels.  Norms, RoPE and the SiLU gate are computed in float32 and cast
back, as the reference does.  ``paged_scatter`` (and its quantized twin
``paged_scatter_quant``) writes the pool IN PLACE (JAX returns a new
array; here the pool is a tensor the engine owns), and so does
``contig_scatter`` a contiguous (B, cap, ...) cache.  ``contig_pages``
views a contiguous cache as a pool of pages and an identity page table,
so that the paged kernels read it unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.ops import PackedWeight, quantized_matmul


def require_device(device) -> torch.device:
    """Resolve an entry point's ``device`` argument.  A CUDA device with
    no card present raises: the port never carries on silently on the
    CPU.  Pass ``device="cpu"`` to run the plain PyTorch versions of the
    kernels (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override (default 1/sqrt(fan_in))
    dtype: Optional[torch.dtype] = None  # override model dtype (norms: f32)
    quantize: bool = False         # eligible for sub-byte packing (serving)
    pooled: bool = False           # a paged cache's page pool (axis 1 =
    #                                pages), not a per-slot state leaf

    def std(self) -> float:
        if self.init == "embed":
            return 1.0
        if self.scale is not None:
            return self.scale
        # the reference's fan_in: every axis but the output one (a
        # (kh, kw, cin, cout) conv weight's is kh * kw * cin)
        fan_in = (math.prod(self.shape[:-1]) if len(self.shape) > 1
                  else self.shape[-1])
        return fan_in ** -0.5


def materialize(spec: ParamSpec, generator: Optional[torch.Generator],
                dtype: torch.dtype, device) -> torch.Tensor:
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    v = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (v * spec.std()).to(dt)


# ---------------------------------------------------------------------------
# Shared layers.
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w, quant: Optional[QuantConfig] = None,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ bias), honouring the quantization format.

    ``w`` is a raw (K, N) weight or a :class:`PackedWeight`, which needs an
    int/wo ``quant`` and runs :func:`quantized_matmul`.  A raw weight
    under an int/wo format is the reference's fake-quant emulation of the
    deployment numerics; it comes with QAT (ROADMAP queue 1 item 16) and
    raises here: pack the weights with ``quantize_for_serving``."""
    if isinstance(w, PackedWeight):
        if quant is None or quant.mode not in ("int", "wo"):
            raise ValueError(f"dense: a PackedWeight needs an int/wo "
                             f"QuantConfig, got {quant}")
        y = quantized_matmul(x, w, quant)
    elif quant is not None and quant.mode in ("int", "wo"):
        raise NotImplementedError(
            f"dense: a raw weight under quant mode {quant.mode!r} is the "
            "fake-quant emulation, not in the port yet (ROADMAP queue 1 "
            "item 16); pack the weights with quantize_for_serving")
    else:
        y = x @ w
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def chunk_lengths(pos, batch: int, device=None) -> torch.Tensor:
    """Per-slot valid lengths from a mode='chunk' ``pos`` ((B,) or scalar)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return torch.broadcast_to(pos.reshape(-1), (batch,)).contiguous()


def chunk_valid_mask(len_b: torch.Tensor, seq: int) -> torch.Tensor:
    """(B, S) True at valid (non-padding) positions of a right-padded
    chunk whose per-slot valid counts are ``len_b``."""
    ar = torch.arange(seq, dtype=torch.int32, device=len_b.device)
    return ar[None, :] < len_b[:, None]


def broadcast_offset(offset, batch: int, device=None) -> torch.Tensor:
    """Per-slot start rows from a resumable-chunk ``offset`` ((B,) or
    scalar)."""
    off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    return torch.broadcast_to(off.reshape(-1), (batch,)).contiguous()


def contig_scatter(buf: torch.Tensor, rows: torch.Tensor, t: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Scatter per-slot rows into a CONTIGUOUS (B, cap, *rest) cache at
    logical positions ``t`` (B, S), IN PLACE, and return the buffer.
    Rows that are invalid, negative or at or past ``cap`` are dropped, as
    the reference's ``mode="drop"`` scatter drops them.

    No host sync: every row goes to flat row ``b * cap + t mod cap``, and
    a dropped row writes back the value it finds there.  So the S
    positions of a slot must differ modulo ``cap``, as the consecutive
    positions of one chunk (S <= cap) or one decode row do."""
    bsz, cap = buf.shape[:2]
    if rows.shape[1] > cap:
        raise ValueError(f"contig_scatter: {rows.shape[1]} rows a slot, "
                         f"more than the cache's {cap}")
    rest = tuple(buf.shape[2:])
    t = t.to(torch.int64)
    ok = valid & (t >= 0) & (t < cap)
    slot = torch.arange(bsz, dtype=torch.int64, device=buf.device)[:, None]
    dest = (slot * cap + torch.remainder(t, cap)).reshape(-1)
    flat = buf.view((bsz * cap,) + rest)
    new = rows.reshape((-1,) + rest).to(buf.dtype)
    keep = ok.reshape((-1,) + (1,) * len(rest))
    flat[dest] = torch.where(keep, new, flat[dest])
    return buf


def contig_fill(buf: torch.Tensor, rows: torch.Tensor,
                ok: torch.Tensor) -> None:
    """Pad-and-select a fresh chunk into a CONTIGUOUS (B, cap, *rest)
    cache, IN PLACE: row i of slot b takes ``rows[b, i]`` where ``ok[b,
    i]`` (B, S) and keeps its contents elsewhere, rows at or past S
    included."""
    s = rows.shape[1]
    if s > buf.shape[1]:
        raise ValueError(f"contig_fill: a {s}-row chunk, more than the "
                         f"cache's {buf.shape[1]} rows")
    head = buf[:, :s]
    mask = ok.reshape(tuple(ok.shape) + (1,) * (buf.dim() - 2))
    head.copy_(torch.where(mask, rows.to(head.dtype), head))


def contig_prefill(buf: torch.Tensor, rows: torch.Tensor) -> None:
    """'prefill': a CONTIGUOUS (B, cap, *rest) cache becomes the prompt's
    rows (B, S, *rest) padded with zeros to its capacity, every slot's,
    as the reference's padded cache (in place)."""
    s = rows.shape[1]
    if s > buf.shape[1]:
        raise ValueError(f"contig_prefill: a {s}-token prompt, more than "
                         f"the cache's {buf.shape[1]} rows")
    buf[:, :s] = rows.to(buf.dtype)
    buf[:, s:] = 0


@dataclasses.dataclass(frozen=True)
class ContigView:
    """How the paged kernels read a contiguous cache: pages of
    ``page_size`` rows, and the first ``rows`` rows of each slot (None =
    the whole capacity).  The serving engine passes its page size and
    ``slot_rows``, so that a contiguous dispatch cuts the page axis into
    the splits of the paged engine's table."""
    page_size: int = 16
    rows: Optional[int] = None


def contig_pages(bufs, view: Optional[ContigView]):
    """Contiguous (B, cap, *rest) caches as the paged kernels read them:
    each a pool of B*cap/page_size pages (a reshape, no copy), and one
    identity table ``tbl[b, j] = b*cap/page_size + j`` (B, P) int32 over
    the first P = ceil(rows / page_size) pages of each slot.  Returns
    (pools, tbl)."""
    view = view or ContigView()
    bsz, cap = bufs[0].shape[:2]
    ps = view.page_size
    if ps <= 0 or cap % ps:
        raise ValueError(f"contig_pages: page size {ps} does not divide "
                         f"the cache's {cap} rows")
    n_pg = cap // ps
    rows = cap if view.rows is None else min(view.rows, cap)
    width = max(1, -(-rows // ps))
    pools = [b.view((bsz * n_pg, ps) + tuple(b.shape[2:])) for b in bufs]
    tbl = torch.arange(bsz * n_pg, dtype=torch.int32,
                       device=bufs[0].device).view(bsz, n_pg)[:, :width]
    return pools, tbl.contiguous()


def paged_gather(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Gather each slot's logical cache window out of a paged row pool.

    ``pool``: (num_pages, page_size, *rest); ``pages``: (B, P) int32 page
    table (-1 = unmapped).  Returns (B, P*page_size, *rest) rows in
    logical order.  Rows under unmapped entries are garbage (the index
    clamps) and MUST be masked by the caller.  The port's attention never
    builds this window on the card: it is the layout definition and the
    plain version the paged kernel is held against."""
    n, ps = pool.shape[:2]
    flat = pool.reshape((n * ps,) + tuple(pool.shape[2:]))
    ar = torch.arange(ps, dtype=torch.int64, device=pool.device)
    idx = pages.clamp_min(0).to(torch.int64)[:, :, None] * ps + ar
    return flat[idx.reshape(pages.shape[0], -1)]


def _scatter_index(pool_shape, pages: torch.Tensor, t: torch.Tensor,
                   valid: torch.Tensor):
    """(dest, sel) of a paged scatter: ``sel`` the flat (B*S) indices of
    the rows that are written and ``dest`` their flat pool rows.  Rows
    that are invalid, negative, past the slot's logical window or under
    an unmapped (-1) entry are left out, as the reference's
    ``mode="drop"`` scatter drops them.  One ``nonzero`` (a host sync)
    however many leaves the index then writes."""
    ps = pool_shape[1]
    p = pages.shape[1]
    t = t.to(torch.int64)
    page = torch.gather(pages.to(torch.int64), 1,
                        torch.clamp(torch.div(t, ps, rounding_mode="floor"),
                                    0, p - 1))
    ok = valid & (page >= 0) & (t >= 0) & (t < p * ps)
    sel = ok.reshape(-1).nonzero().squeeze(1)
    dest = (page * ps + torch.remainder(t, ps)).reshape(-1)[sel]
    return dest, sel


def _put(pool: torch.Tensor, index, rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` (B, S, *rest) into ``pool`` (N, ps, *rest) at a
    :func:`_scatter_index`, in place."""
    dest, sel = index
    n, ps = pool.shape[:2]
    rest = tuple(pool.shape[2:])
    flat = pool.view((n * ps,) + rest)
    flat[dest] = rows.reshape((-1,) + rest)[sel].to(pool.dtype)
    return pool


def paged_scatter(pool: torch.Tensor, pages: torch.Tensor,
                  rows: torch.Tensor, t: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Scatter per-slot rows into a paged pool at logical positions,
    IN PLACE, and return the pool.

    ``pool``: (num_pages, page_size, *rest); ``pages``: (B, P) page
    table; ``rows``: (B, S, *rest); ``t``: (B, S) int32 logical
    positions; ``valid``: (B, S) bool.  Writes that are invalid, negative,
    past the slot's logical window, or land on an unmapped (-1) entry are
    dropped, as the reference's ``mode="drop"`` scatter drops them."""
    return _put(pool, _scatter_index(pool.shape, pages, t, valid), rows)


def paged_scatter_quant(pool: torch.Tensor, scales: torch.Tensor,
                        pages: torch.Tensor, rows: torch.Tensor,
                        t: torch.Tensor, valid: torch.Tensor, fmt):
    """:func:`paged_scatter` for a QUANTIZED pool, in place: quantize
    ``rows`` (one absmax scale a row, packed per ``fmt``, a
    :class:`~repro_torch.core.pageformat.PageFormat`) and write the bytes
    into ``pool`` and the float32 row scales into the pool-shaped
    ``scales`` (num_pages, page_size) through one destination index, so a
    quantized leaf costs the host sync of an fp one.  A row's bytes
    depend only on its own values, so rewriting identical rows (resume,
    copy-on-write refill) reproduces identical pool bytes.  Returns
    (pool, scales)."""
    q, s = fmt.quantize_rows(rows)
    index = _scatter_index(pool.shape, pages, t, valid)
    return _put(pool, index, q), _put(scales, index, s)


def paged_gather_quant(pool: torch.Tensor, scales: torch.Tensor,
                       pages: torch.Tensor, fmt, dtype) -> torch.Tensor:
    """Gather and dequantize each slot's window out of a quantized pool:
    (B, P*page_size, *rest) rows of ``dtype``.  Rows under unmapped
    entries are garbage, as in :func:`paged_gather`, and MUST be masked
    by the caller."""
    return fmt.dequantize(paged_gather(pool, pages),
                          paged_gather(scales, pages), dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * w.float() + b.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, NeoX half-split convention.

    x: (B, S, H, D), positions: (B, S) int32."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), -ar / half)
    ang = positions[..., None].float() * freq          # (B, S, half)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.to(torch.int64)]
