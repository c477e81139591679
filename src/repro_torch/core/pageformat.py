"""Page storage formats of the paged KV pool.

The counterpart of ``repro.core.pageformat``.  ``ServeConfig.kv_format``
picks one format for every pool page:

  * ``"fp"``   — rows stored in the model's dtype (the default);
  * ``"int8"`` — rows quantized to int8 with one float32 absmax scale
                 per row (per (page, slot-in-page)), kept in a
                 pool-shaped scale leaf ``(num_pages, page_size)`` beside
                 the pool;
  * ``"int4"`` — as int8, with the rows packed two lanes a byte in
                 :mod:`repro_torch.core.packing`'s strided layout.

Rows are quantized once, when they are written into the pool
(:func:`repro_torch.models.common.paged_scatter_quant`), and dequantized
when they are read: inside the paged kernels on the card, and in their
plain versions on the CPU (:func:`~repro_torch.models.common.
paged_gather_quant`).  A scale leaf has the page axis of its pool, so
copy-on-write page copies move the scales with their pages.

Quantized bytes and scales equal the reference's eager
``PageFormat.quantize_rows`` bit for bit: the scale is ``amax / qmax``
divided in float32 and ``torch.round`` rounds half to even as
``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.quant import dequantize_page_rows, quantize_page_rows

#: the ``ServeConfig.kv_format`` vocabulary, in capacity order
KV_FORMATS = ("fp", "int8", "int4")


@dataclasses.dataclass(frozen=True)
class PageFormat:
    """How one pool page's rows are stored.  ``bits is None`` is the
    model's dtype; otherwise rows are symmetric-quantized to ``bits``
    with one float32 absmax scale a row and packed ``8 // bits`` lanes a
    byte along the last feature axis."""
    name: str
    bits: Optional[int] = None

    @property
    def quantized(self) -> bool:
        return self.bits is not None

    @property
    def pack(self) -> int:
        """Shrink factor of the stored last axis (1 for fp and int8)."""
        return 1 if self.bits is None else packing.pack_factor(self.bits)

    def packed_feat(self, feat: int) -> int:
        """Stored last-axis length of a ``feat``-wide row."""
        if feat % self.pack:
            raise ValueError(
                f"kv_format={self.name!r} packs {self.pack} lanes/byte but "
                f"the page feature dim {feat} is not divisible by {self.pack}")
        return feat // self.pack

    def quantize_rows(self, rows: torch.Tensor):
        """(B, S, *feat) rows -> (packed int8 rows, (B, S) float32
        scales), one absmax scale over every trailing axis of a row."""
        assert self.quantized, "fp pages are stored verbatim"
        q, scales = quantize_page_rows(rows, self.bits)
        return packing.pack(q, self.bits, axis=-1), scales

    def dequantize(self, q: torch.Tensor, scales: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
        """Packed int8 rows and their row scales -> rows of ``dtype``:
        unpack, one float32 multiply, one rounding to ``dtype``."""
        assert self.quantized, "fp pages are stored verbatim"
        return dequantize_page_rows(packing.unpack(q, self.bits, axis=-1),
                                    scales, dtype)


FP = PageFormat("fp")
INT8 = PageFormat("int8", bits=8)
INT4 = PageFormat("int4", bits=4)

_FORMATS = {f.name: f for f in (FP, INT8, INT4)}


def get_format(name: str) -> PageFormat:
    if name not in _FORMATS:
        raise ValueError(f"unknown kv_format {name!r}; one of {KV_FORMATS}")
    return _FORMATS[name]


def format_for_packed(full_feat: int, stored_feat: int) -> PageFormat:
    """The quantized format that stores a ``full_feat``-wide row in
    ``stored_feat`` bytes: a cache names its format by its own shapes (a
    scale leaf beside the pool, and the ratio of the widths)."""
    for fmt in (INT8, INT4):
        if stored_feat * fmt.pack == full_feat:
            return fmt
    raise ValueError(
        f"no page format stores a {full_feat}-wide feature in {stored_feat} "
        f"bytes/row (known ratios: 1x int8, 2x int4)")
