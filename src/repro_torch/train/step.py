"""Serving step builders: the counterparts of the reference's
``make_paged_decode_step`` and ``make_paged_chunked_prefill_step``.

Plain functions, run eagerly (the reference jits them).  Both update the
paged cache in place and return it with the logits.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import forward


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
        idx = torch.clamp(lengths.to(torch.int64) - 1, min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device),
                      idx]
        return last, cache
    return prefill
