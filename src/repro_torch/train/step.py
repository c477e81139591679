"""Serving step builders: the counterparts of the reference's
``make_prefill_step``, ``make_decode_step``, ``make_chunked_prefill_step``
and ``make_chunked_prefill_resume_step`` (a contiguous cache) and of
``make_paged_decode_step`` and ``make_paged_chunked_prefill_step`` (the
paged cache).

Plain functions, run eagerly (the reference jits them), with the
reference's signatures and return values.  Each updates its cache in
place and returns it with the logits.  A contiguous step that reads the
cache through the paged kernels (decode, a resumed chunk) takes the
:class:`~repro_torch.models.common.ContigView` it reads it through when
it is made: the serving engine passes its page size and ``slot_rows``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ContigView
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import forward


def _last_valid(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each slot's logits at its last valid token (row 0 for length 0)."""
    idx = torch.clamp(lengths.to(torch.int64) - 1, min=0)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


def make_prefill_step(cfg: ArchConfig):
    """The whole prompt into a contiguous cache (mode 'prefill'); returns
    the last position's logits."""
    def prefill(params, inputs, cache):
        logits, cache, _ = forward(params, inputs, cfg, cache=cache,
                                   mode="prefill")
        return logits[:, -1, :], cache
    return prefill


def make_decode_step(cfg: ArchConfig, view: Optional[ContigView] = None):
    """Decode against a contiguous cache: ``pos`` a scalar, or (B,) per
    slot with -1 for an inactive slot (no write; its logits are
    garbage)."""
    def decode(params, cache, token, pos):
        logits, cache, _ = forward(params, token, cfg, cache=cache,
                                   mode="decode", pos=pos, view=view)
        return logits[:, -1, :], cache
    return decode


def make_chunked_prefill_step(cfg: ArchConfig):
    """Single-pass chunked prefill into a contiguous cache: slot tokens
    at rows [0, length) (0 = slot not admitted, its rows untouched).
    Returns each slot's last-valid-token logits."""
    def prefill(params, cache, tokens, lengths):
        logits, cache, _ = forward(params, tokens, cfg, cache=cache,
                                   mode="chunk", pos=lengths)
        return _last_valid(logits, lengths), cache
    return prefill


def make_chunked_prefill_resume_step(cfg: ArchConfig,
                                     view: Optional[ContigView] = None):
    """RESUMABLE chunked prefill into a contiguous cache: slot tokens at
    rows [offset, offset + length), attending the cached history [0,
    offset) too.  Returns each slot's last-valid-token logits."""
    def prefill(params, cache, tokens, lengths, offsets):
        logits, cache, _ = forward(params, tokens, cfg, cache=cache,
                                   mode="chunk", pos=lengths,
                                   offset=offsets, view=view)
        return _last_valid(logits, lengths), cache
    return prefill


def make_paged_decode_step(cfg: ArchConfig):
    """Decode against the paged cache: ``pages`` (B, P) maps each slot's
    logical rows to pool pages; -1 entries are unmapped."""
    def decode(params, cache, token, pos, pages):
        logits, cache, _ = forward(params, token, cfg, cache=cache,
                                   mode="decode", pos=pos, pages=pages)
        return logits[:, -1, :], cache
    return decode


def make_paged_chunked_prefill_step(cfg: ArchConfig):
    """RESUMABLE chunked prefill into the paged cache: slot tokens sit at
    rows [offset, offset + length); ``offsets=None`` is an all-fresh wave
    (rows [0, length), the flash kernel).  Returns each slot's
    last-valid-token logits."""
    def prefill(params, cache, tokens, lengths, pages, offsets):
        logits, cache, _ = forward(params, tokens, cfg, cache=cache,
                                   mode="chunk", pos=lengths, pages=pages,
                                   offset=offsets)
        return _last_valid(logits, lengths), cache
    return prefill
