"""Serving configuration and request record.

The counterpart of ``repro.serve.config``.  ``ServeConfig`` validates
itself at construction and raises with the field's name on anything this
slice of the port does not serve yet, naming the ROADMAP item (queue 1)
that will add it.  The reference's ``use_pallas_decode`` is a TPU knob and
has no counterpart: the CUDA kernels are always on.  ``kv_format`` picks
the pool's page storage (:data:`~repro_torch.core.pageformat.KV_FORMATS`):
"fp" pages of the model's dtype, or "int8"/"int4" pages with one float32
scale a row, served by the quantized paged kernels.

``paged=False`` serves the contiguous cache: one (cap, ...) region a
slot, ``slot_rows = max_prompt + max_new_tokens`` rows of it in use, with
the reference's rejections of what only the paged engine has.  Its
``page_size`` is the page of the view through which the paged kernels
read that cache, so it must divide the cache's capacity (a multiple of
256; on the card also a multiple of 16).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.pageformat import KV_FORMATS


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4
    max_prompt: int = 64            # prefill CHUNK budget per dispatch
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    eos_id: int = -1                # -1 = never
    seed: int = 0                   # the sampling generator's seed
    strict_iotlb: bool = True       # False: record fault, reject admission
    paged: bool = True              # page the KV cache (False: contiguous)
    page_size: int = 16             # cache rows per page
    num_pages: Optional[int] = None  # pool pages; None = one full window
    #                                  per slot
    pool_rows: Optional[int] = None  # alternative pool spec in cache ROWS
    max_seq: Optional[int] = None   # per-slot row capacity (prompt+decode);
    #                                  None = max_prompt + max_new_tokens.
    #                                  Prompts longer than max_prompt (but
    #                                  within max_seq - max_new_tokens) are
    #                                  served by RESUMABLE chunked prefill.
    reserve_decode_pages: bool = True
    # True: admission accounts for every in-flight request's worst-case
    #   decode growth, so the pool never exhausts mid-decode.
    # False: overcommit — admission claims only the prompt's pages and
    #   the first decode page, and growth that finds the pool empty
    #   triggers ``preemption``.
    preemption: str = "swap"
    # "swap": the lowest-priority, youngest other resident's pages go to
    #   host memory and come back byte for byte through the swap queue;
    # "terminate": the growing request ends with a capacity fault.
    prefix_sharing: bool = True
    # Refcounted page tables: a prompt sharing a whole-page prefix with a
    # resident request maps the resident's pages (copy-on-write at the
    # first divergent page) and resumes prefill at the first unshared row.
    decode_sharing: bool = False
    kv_format: str = "fp"           # page storage: one of KV_FORMATS
    record_logits: bool = False     # keep per-token logits on each Request
    swap_budget_bytes: Optional[int] = None
    # Cap on the host bytes the swap queue holds; None = unbounded.  A
    # swap that would pass it is denied (a ``swap_budget`` fault) and the
    # grower takes the capacity path.
    spill_dir: Optional[str] = None
    host_pool_pages: int = 0
    spec_draft: Optional[str] = None

    def __post_init__(self):
        def bad(field, why):
            raise ValueError(f"ServeConfig.{field} {why}")

        def later(field, value, item, what):
            bad(field, f"= {value!r} is not served by this slice of the "
                f"PyTorch port yet: {what} comes with ROADMAP queue 1 "
                f"item {item}")
        if self.swap_budget_bytes is not None and self.swap_budget_bytes <= 0:
            bad("swap_budget_bytes", "must be positive (None = unbounded), "
                f"got {self.swap_budget_bytes}")
        if self.max_batch <= 0:
            bad("max_batch", f"must be positive, got {self.max_batch}")
        if self.max_prompt <= 0:
            bad("max_prompt", f"must be positive, got {self.max_prompt}")
        if self.max_new_tokens <= 0:
            bad("max_new_tokens", "must be >= 1 (every request emits at "
                f"least the post-prompt token), got {self.max_new_tokens}")
        if self.temperature < 0:
            bad("temperature", f"must be >= 0, got {self.temperature}")
        if self.preemption not in ("swap", "terminate"):
            bad("preemption", "must be 'swap' or 'terminate', "
                f"got {self.preemption!r}")
        if self.kv_format not in KV_FORMATS:
            bad("kv_format", f"must be one of {KV_FORMATS}, "
                f"got {self.kv_format!r}")
        if self.host_pool_pages:
            later("host_pool_pages", self.host_pool_pages, 14,
                  "the tiered page pool")
        if self.spill_dir is not None:
            later("spill_dir", self.spill_dir, 14, "swap spill")
        if self.spec_draft is not None:
            later("spec_draft", self.spec_draft, 14, "speculative decoding")
        if self.decode_sharing:
            later("decode_sharing", self.decode_sharing, 14,
                  "decode-token twin sharing")
        if not self.paged:
            # the reference's paged=False rejections: its decode_sharing,
            # spec_draft and host_pool_pages ones come after the item-14
            # ``later`` calls above, which reject those fields for either
            # layout first, under the same field names
            if self.kv_format != "fp":
                bad("kv_format", f"({self.kv_format!r}) needs the paged "
                    "engine (paged=True); only pool pages carry per-row "
                    "scales — the contiguous layout stores model dtype")
            if self.max_seq is not None:
                bad("max_seq", "is only honored by the paged engine "
                    "(paged=True); the contiguous layout fixes slot "
                    "capacity at max_prompt + max_new_tokens")
        if self.page_size <= 0:
            bad("page_size", f"must be positive, got {self.page_size}")
        if not self.paged:
            return
        if self.num_pages is not None and self.num_pages <= 0:
            bad("num_pages", f"must be positive, got {self.num_pages}")
        if self.pool_rows is not None:
            if self.num_pages is not None:
                bad("pool_rows", "and num_pages are two spellings of the "
                    "same pool — set only one")
            if self.pool_rows <= 0:
                bad("pool_rows", f"must be positive, got {self.pool_rows}")
            if self.pool_rows % self.page_size:
                bad("page_size", f"({self.page_size}) does not divide the "
                    f"pool (pool_rows={self.pool_rows})")
            self.num_pages = self.pool_rows // self.page_size
        if self.max_seq is not None and \
                self.max_seq < self.max_new_tokens + 1:
            bad("max_seq", f"({self.max_seq}) cannot hold even a 1-token "
                f"prompt plus max_new_tokens={self.max_new_tokens} rows")

    @property
    def slot_rows(self) -> int:
        """Per-slot logical row capacity."""
        if self.paged and self.max_seq is not None:
            return self.max_seq
        return self.max_prompt + self.max_new_tokens


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    priority: int = 0
    # Admission order is priority-aware: higher admits first, FIFO within
    # a class.
    ttft_deadline: Optional[int] = None
    # TTFT deadline in ENGINE TICKS from submission; None = best-effort.
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    failed: bool = False            # rejected by IOTLB containment
    preempts: int = 0               # times swapped out
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    # per-emitted-token logits rows (float32), kept when
    # ServeConfig.record_logits
    submit_seq: Optional[int] = None    # scheduler-stamped FIFO tie-break
    submit_tick: Optional[int] = None   # engine tick at submit()
    first_token_tick: Optional[int] = None  # engine tick of first token
    deadline_miss: Optional[bool] = None

    def __post_init__(self):
        def bad(field, why):
            raise ValueError(f"Request.{field} {why}")
        if isinstance(self.priority, bool) or \
                not isinstance(self.priority, int):
            bad("priority", f"must be an int, got {self.priority!r}")
        if self.ttft_deadline is not None and (
                isinstance(self.ttft_deadline, bool)
                or not isinstance(self.ttft_deadline, int)
                or self.ttft_deadline <= 0):
            bad("ttft_deadline", "must be a positive int of engine ticks "
                f"(None = no deadline), got {self.ttft_deadline!r}")

    @property
    def ttft_ticks(self) -> Optional[int]:
        """Ticks from submission to first token; None until emitted."""
        if self.first_token_tick is None or self.submit_tick is None:
            return None
        return self.first_token_tick - self.submit_tick
