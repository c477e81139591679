"""Serving EXECUTOR: session API, dispatch, device data movement.

The counterpart of ``repro.serve.engine`` for greedy paged serving on one
card.  Three layers, one owner per concern, as in the reference:

  * ``scheduler.py`` — POLICY: admission order, chunk budgets, prefix
    matching, the deadline ledger;
  * ``allocator.py`` — ACCOUNTING: free list, refcounted page tables,
    copy-on-write, growth reservations, the 32-entry IOTLB;
  * this file — EXECUTION: owns the weights, the paged KV pool and the
    two steps (chunked prefill, decode), stages each tick's inputs on the
    host in numpy, applies page copies, and samples: greedily, or at
    ``ServeConfig.temperature`` > 0 from the softmax of the logits over
    the temperature, with one ``torch.Generator`` an engine seeded from
    ``ServeConfig.seed``.

Session surface: ``submit(req)`` returns a :class:`RequestHandle` at once
(the request waits on the scheduler's pending queue); ``tick()`` advances
the serving clock, admits into free slots with at most one prefill
dispatch, then runs one decode dispatch for every prompt-complete slot.
``drain()`` finishes everything and closes the engine; ``run()`` submits
and ticks until idle.  Fresh prompts and resumed chunks dispatch as
separate waves, as the reference does, so each chunk's numerics depend
only on its own offset.

Every attention dispatch runs a CUDA kernel on the card: the flash
forward for a fresh wave, the paged flash-decode partials for a resumed
wave and for GQA decode, and the compressed-space MLA partials for MLA
decode.  On a quantized pool (``ServeConfig.kv_format`` int8/int4) a GQA
dispatch of every kind runs the quantized paged kernel, and MLA decode
the quantized MLA kernel.  The engine is the same for both attention
kinds and every format: it treats the pool leaves (``k``/``v`` or MLA's
``ckv``, and their scale leaves) alike.  A model packed by
``quantize_for_serving`` (the format on ``cfg.quant``) also runs every
``dense`` through the packed matmul kernels.  ``stats()`` reports the kernel launches of the last
dispatch and in total.

Overcommit (``reserve_decode_pages=False``): when decode growth finds
the pool empty, ``ServeConfig.preemption`` "swap" picks the scheduler's
victim, copies its pages to host tensors, releases them, and parks the
request on the swap queue, which drains before fresh admissions and
restores the pages byte for byte into fresh ones; "terminate" ends the
grower with a capacity fault.  ``swap_budget_bytes`` caps the queue's
host bytes.

The contiguous cache (``ServeConfig(paged=False)``, the reference's
layout): one region of ``cache_capacity(slot_rows)`` rows a slot, a
whole-slot IOTLB window each, no allocator.  A prompt must fit one chunk
(a longer one fails the IOTLB check at admission, as in the reference);
decode reads the cache through the paged kernels, viewed as pages of
``page_size`` rows over its first ``slot_rows`` rows, the paged engine's
table width (pages of 16 rows where ``page_size`` does not divide the
capacity).  No overcommit, preemption, swap, prefix sharing or
copy-on-write, as in the reference.

Recurrent state (mamba blocks): a cache leaf is a page POOL (page axis
at 1) or a PER-SLOT state leaf (batch axis at 1), ``_pooled`` flags them
in the reference's leaf order.  A swap snapshot holds a slot's pages
(``pool_rows``) and its state rows (``slot_rows``), restored bit for bit
into the new slot; a slot's state counts toward ``swap_budget_bytes``;
copy-on-write copies touch pools only; and prefix sharing stays off
unless every leaf is pooled (a sharer cannot inherit recurrent state), as
in the reference.  The contiguous cache carries the same state leaves.

Not in this slice (ServeConfig rejects them): swap spill and the tiered
pool, oversized contexts, speculative decoding, decode twins.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.iotlb import FaultRecord, Iotlb, IotlbFault, Window
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mpq_matmul as _mpq
from repro_torch.kernels import paged_flash_decode as _paged
from repro_torch.models.common import ContigView, require_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (Transformer, cache_capacity,
                                      cache_specs, flat_leaves, init_cache,
                                      init_paged_cache)
from repro_torch.serve.allocator import PageAllocator
from repro_torch.serve.config import Request, ServeConfig
from repro_torch.serve.scheduler import Scheduler, SwappedRequest
from repro_torch.train.step import (make_chunked_prefill_step,
                                    make_decode_step,
                                    make_paged_chunked_prefill_step,
                                    make_paged_decode_step)

_DEFER = "defer"                    # admission verdict: retry after frees


def _kernel_launches() -> int:
    return (_flash.launches + _paged.launches + _paged.quant_launches
            + _paged.mla_launches + _paged.mla_quant_launches
            + _mpq.launches + _mpq.reduce_launches)


class RequestHandle:
    """Client-side view of one submitted request (see the reference's
    ``RequestHandle``): non-blocking ``status``/``tokens_so_far``, and
    ``stream``/``result``, which drive ``engine.tick()`` themselves."""

    def __init__(self, engine: "ServingEngine", req: Request):
        self._eng = engine
        self.req = req

    @property
    def status(self) -> str:
        """'pending' | 'running' | 'swapped' | 'done' | 'failed'."""
        if self.req.done:
            return "failed" if self.req.failed else "done"
        return self._eng.sched.state_of(self.req)

    @property
    def tokens_so_far(self) -> List[int]:
        return list(self.req.out_tokens)

    def stream(self):
        """Yield tokens as decode emits them, ticking the engine when
        none are buffered."""
        sent = 0
        while True:
            while sent < len(self.req.out_tokens):
                yield self.req.out_tokens[sent]
                sent += 1
            if self.req.done:
                return
            self._eng.tick()

    def result(self) -> Request:
        while not self.req.done:
            self._eng.tick()
        return self.req

    def __repr__(self):
        return (f"RequestHandle(rid={self.req.rid}, status={self.status!r}, "
                f"tokens={len(self.req.out_tokens)})")


# the contiguous cache's own page, where ServeConfig.page_size does not
# divide its capacity: the reference's contiguous engine reads no page size
CONTIG_PAGE = 16


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: Transformer,
                 serve_cfg: ServeConfig, *, device="cuda"):
        self.device = require_device(device)
        pdev, want = params.embed.device, self.device
        if pdev.type != want.type or (
                want.index is not None and pdev.index != want.index):
            raise ValueError(f"params live on {pdev}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        bsz, ps = serve_cfg.max_batch, serve_cfg.page_size
        rows = serve_cfg.slot_rows
        if serve_cfg.paged:
            self.pages_per_slot = -(-rows // ps)
            self._slot_span = self.pages_per_slot * ps
            self.num_pages = (serve_cfg.num_pages
                              if serve_cfg.num_pages is not None
                              else bsz * self.pages_per_slot)
            self.cache = init_paged_cache(cfg, self.num_pages, ps,
                                          kv_format=serve_cfg.kv_format,
                                          batch=bsz, device=self.device)
            self._decode = make_paged_decode_step(cfg)
            self._prefill = make_paged_chunked_prefill_step(cfg)
            self.alloc = PageAllocator(self.num_pages, ps, bsz,
                                       self.pages_per_slot)
        else:
            # decode reads the slot's first slot_rows rows as pages of the
            # paged engine's size (so its splits) where that size divides
            # the capacity (a multiple of 256), else of CONTIG_PAGE rows
            if cache_capacity(cfg, rows) % ps:
                ps = CONTIG_PAGE
            self.alloc = None
            self.cache = init_cache(cfg, bsz, rows, device=self.device)
            self._decode = make_decode_step(cfg, ContigView(ps, rows))
            self._prefill = make_chunked_prefill_step(cfg)
            self._slot_span = rows
            # whole-slot windows (one per slot), mapped once
            self._plain_iotlb = Iotlb()
            for i in range(bsz):
                self._plain_iotlb.program(Window(
                    name=f"slot{i}", virt_base=i * rows, size=rows,
                    phys_base=i * rows, readable=True, writable=True))
        # which leaves are page pools (axis 1 = pages; in the contiguous
        # layout, the KV caches that would be) and which per-slot state
        # (axis 1 = batch): drives swap and COW.  The two layouts list
        # their leaves in the same order
        self._pooled = [spec.pooled for spec in flat_leaves(cache_specs(
            cfg, bsz, 0, num_pages=1, page_size=ps,
            kv_format=serve_cfg.kv_format))]
        self.sched = Scheduler(bsz, serve_cfg.max_prompt)
        self.positions = np.zeros((bsz,), np.int32)
        self.last_token = np.zeros((bsz,), np.int32)
        # the sampling generator (temperature > 0), on the engine's device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(serve_cfg.seed)
        self.completed: List[Request] = []
        self.peak_active = 0        # high-water concurrency
        self.peak_pages = 0         # high-water pool pages in use
        self.n_preemptions = 0      # swap-outs
        self.n_swap_ins = 0
        self.n_swap_budget_denials = 0
        self.n_cow_copies = 0
        self.n_shared_admissions = 0
        self.n_dispatches = 0
        self.kernel_launches = 0    # CUDA kernel launches, all dispatches
        self.last_dispatch_launches = 0
        self._prefilled_since_step = False   # one prefill dispatch per tick
        self.tick_no = 0            # the serving clock (deadline ledger)
        self._closed = False        # set by drain(): no further submits
        # prefix sharing needs every cache leaf paged: recurrent state
        # cannot be inherited from a sharer
        self._can_share = serve_cfg.paged and serve_cfg.prefix_sharing \
            and all(self._pooled) and len(self._pooled) > 0
        # host bytes one swapped slot occupies, for the swap budget: every
        # pool leaf (scales included) per mapped page, every state leaf
        # per slot (axis 1 is pages resp. batch)
        self._page_nbytes = self._slot_state_nbytes = 0
        if serve_cfg.paged:
            self._page_nbytes = sum(leaf.numel() * leaf.element_size()
                                    // leaf.shape[1]
                                    for leaf in self._pool_leaves())
            self._slot_state_nbytes = sum(
                leaf.numel() * leaf.element_size() // leaf.shape[1]
                for leaf in self._state_leaves())

    # -- views ----------------------------------------------------------------
    @property
    def iotlb(self):
        return self.alloc.iotlb if self.sc.paged else self._plain_iotlb

    def pages_in_use(self) -> int:
        return self.alloc.pages_in_use() if self.sc.paged else 0

    def _pool_leaves(self) -> List[torch.Tensor]:
        """Every pool leaf in the reference's flattening order (stages in
        order, keys sorted at every level), the order of a snapshot's
        ``pool_rows``."""
        return [leaf for leaf, pooled in zip(flat_leaves(self.cache),
                                             self._pooled) if pooled]

    def _state_leaves(self) -> List[torch.Tensor]:
        """Every per-slot state leaf (layers, B, ...), in the same order:
        the order of a snapshot's ``slot_rows``."""
        return [leaf for leaf, pooled in zip(flat_leaves(self.cache),
                                             self._pooled) if not pooled]

    def pool_bytes_per_shard(self) -> int:
        """Device bytes of page-pool state one pool shard holds: every
        pool leaf, scales included (on one device, the whole pool; per-slot
        state is not pool state, as in the reference); for the contiguous
        layout, the whole cache."""
        leaves = (self._pool_leaves() if self.sc.paged
                  else flat_leaves(self.cache))
        return sum(leaf.numel() * leaf.element_size() for leaf in leaves)

    def stats(self) -> dict:
        return {"ticks": self.tick_no, "peak_active": self.peak_active,
                "peak_pages": self.peak_pages,
                "n_preemptions": self.n_preemptions,
                "n_swap_ins": self.n_swap_ins,
                "n_swap_budget_denials": self.n_swap_budget_denials,
                "n_cow_copies": self.n_cow_copies,
                "n_shared_admissions": self.n_shared_admissions,
                "n_dispatches": self.n_dispatches,
                "kernel_launches": self.kernel_launches,
                "last_dispatch_launches": self.last_dispatch_launches}

    # -- page demand --------------------------------------------------------
    def _max_pages(self, req: Request) -> int:
        """Pages covering every row the request could ever write: the
        prompt plus decode writes up to row len + max_new_tokens - 2 (the
        last sampled token is never cached)."""
        last_row = len(req.prompt) - 1
        if self.sc.max_new_tokens >= 2:
            last_row = len(req.prompt) + self.sc.max_new_tokens - 2
        return last_row // self.sc.page_size + 1

    def _claim_count(self, req: Request) -> int:
        """Pages claimed at admission: the prompt's rows plus the first
        decode write row (only when a decode tick will happen)."""
        last_row = len(req.prompt) - 1
        if self.sc.max_new_tokens >= 2:
            last_row = len(req.prompt)
        return last_row // self.sc.page_size + 1

    def _pages_dev(self) -> torch.Tensor:
        return torch.from_numpy(self.alloc.page_table).to(self.device)

    # -- admission ----------------------------------------------------------
    def _reject(self, req: Request) -> None:
        if not req.done:
            req.failed = True
            req.done = True
            self.sched.note_terminal(req)
            self.completed.append(req)

    def _fault_reject(self, req: Request, kind: str, start: int,
                      length: int) -> None:
        """Record the fault, reject the request, and raise when strict."""
        self.iotlb.faults.append(FaultRecord(kind, start, length, True))
        self._reject(req)
        if self.sc.strict_iotlb:
            raise IotlbFault(kind, f"request {req.rid}: range "
                             f"[{start}, {start + length}) write=True")

    def _admissible(self, slot: int, req: Request):
        """(verdict, share): verdict True (admit), False (rejected) or
        _DEFER (transient page shortage); ``share`` the prefix-sharing
        plan (resident slot, rows), (None, 0) when not sharing."""
        no_share = (None, 0)
        if not req.prompt:
            self._reject(req)
            return False, no_share
        if not self.sc.paged:
            span = len(req.prompt) + self.sc.max_new_tokens
            if self.iotlb.translate(slot * self._slot_span, span,
                                    write=True, strict=False) is None:
                self._reject(req)
                if self.sc.strict_iotlb:
                    f = self.iotlb.faults[-1]
                    raise IotlbFault(f.kind, f"request {req.rid}: range "
                                     f"[{f.start}, {f.start + f.length}) "
                                     f"write={f.write}")
                return False, no_share
            return True, no_share
        demand = (self._max_pages(req) if self.sc.reserve_decode_pages
                  else self._claim_count(req))
        if demand > self.num_pages:
            self._fault_reject(req, "capacity", slot * self._slot_span,
                               demand * self.sc.page_size)
            return False, no_share
        if self.sched.swapped:
            # preempted work drains first: fresh admissions would take
            # the pages the swap queue waits for
            return _DEFER, no_share
        share = (self.sched.shared_prefix(req.prompt, self.sc.page_size)
                 if self._can_share else no_share)
        demand -= share[1] // self.sc.page_size    # shared pages are free
        if demand > self.alloc.reserved_free():
            return _DEFER, no_share
        return True, share

    def _claim_pages(self, slot: int, req: Request,
                     share) -> Tuple[int, List[Tuple[int, int]]]:
        """Claim the prompt's pages plus the first decode page; whole
        shared pages are refcount-mapped from the resident slot and the
        divergent partial page is COW-copied.  Returns (prefill start
        row, page copies to apply)."""
        ps = self.sc.page_size
        needed = self._claim_count(req)
        copies: List[Tuple[int, int]] = []
        start_row, start_j = 0, 0
        src, rows = share
        if src is not None and rows > 0:
            nfull = rows // ps
            for j in range(nfull):
                self.alloc.share(slot, j, int(self.alloc.page_table[src, j]))
            start_row, start_j = rows, nfull
            if rows % ps:
                self.alloc.share(slot, nfull,
                                 int(self.alloc.page_table[src, nfull]))
                copies.append(self.alloc.privatize(slot, nfull))
                start_j = nfull + 1
            self.n_shared_admissions += 1
        for j in range(start_j, needed):
            if not self.alloc.alloc(slot, j):
                raise RuntimeError("free-page count was vetted in "
                                   "_admissible")
        if self.sc.reserve_decode_pages:
            self.alloc.growth_due[slot] = self._max_pages(req) - needed
        for j in range(needed):
            if not self.alloc.check_write(slot, j * ps, ps, strict=False):
                raise IotlbFault("miss",
                                 f"request {req.rid}: page {j} not covered")
        return start_row, copies

    def _admission_wave(self) -> int:
        """Fill free slots in the pending queue's order, then one prefill
        dispatch covering new and resumed slots.  Swapped requests
        re-enter first."""
        if self.sc.paged:
            self._swap_in_ready()
        placed: List[tuple] = []
        copies: List[Tuple[int, int]] = []
        try:
            for slot in self.sched.free_slots():
                got, share = None, (None, 0)
                while self.sched.has_pending() and got is None:
                    req = self.sched.pop_pending()
                    if req.done:
                        continue
                    verdict, share = self._admissible(slot, req)
                    if verdict is _DEFER:
                        self.sched.defer_pending(req)
                        break
                    if verdict:
                        got = req
                if got is None:
                    break
                start_row = 0
                if self.sc.paged:
                    start_row, cps = self._claim_pages(slot, got, share)
                    copies.extend(cps)
                self.sched.place(slot, got, prefill_done=start_row)
                placed.append((slot, got))
        except IotlbFault:
            # strict fault mid-wave: hand back the requests vetted so far
            # and their pages, so a caller that catches it loses nothing.
            for slot, req in reversed(placed):
                if self.sc.paged:
                    self.alloc.release_slot(slot)
                self.sched.release(slot)
                self.sched.defer_pending(req)
            raise
        if placed:
            self.peak_active = max(self.peak_active,
                                   len(self.sched.active()))
            self._apply_copies(copies)
            self._prefill_tick()
        return len(placed)

    def warmup(self) -> None:
        """Build the kernels and run each dispatch once at its serving
        shape with every slot inactive (zero lengths, positions -1), so
        no cache row is written and nothing is admitted."""
        bsz, sp = self.sc.max_batch, self.sc.max_prompt
        dev = self.device
        z_tok = torch.zeros((bsz, sp), dtype=torch.int32, device=dev)
        z_len = torch.zeros((bsz,), dtype=torch.int32, device=dev)
        one = torch.zeros((bsz, 1), dtype=torch.int32, device=dev)
        inactive = torch.full((bsz,), -1, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            if self.sc.paged:
                self._prefill(self.params, self.cache, z_tok, z_len,
                              self._pages_dev(), None)
                self._prefill(self.params, self.cache, z_tok, z_len,
                              self._pages_dev(), z_len)
                self._decode(self.params, self.cache, one, inactive,
                             self._pages_dev())
            else:
                self._prefill(self.params, self.cache, z_tok, z_len)
                self._decode(self.params, self.cache, one, inactive)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _dispatch(self, step, *args):
        """Run one prefill or decode step, counting its kernel launches."""
        self.peak_pages = max(self.peak_pages, self.pages_in_use())
        before = _kernel_launches()
        with torch.inference_mode():
            logits, self.cache = step(self.params, self.cache, *args)
        self.n_dispatches += 1
        self.last_dispatch_launches = _kernel_launches() - before
        self.kernel_launches += self.last_dispatch_launches
        return logits

    # -- resumable chunked prefill ------------------------------------------
    def _prefill_tick(self) -> None:
        """ONE chunked-prefill wave for every slot owing prompt rows:
        fresh admissions and resumed chunks dispatch separately (flash
        kernel resp. paged kernel).  Slots whose prompt completes sample
        their first token."""
        work = self.sched.prefill_plan()
        if not work:
            return
        self._prefilled_since_step = True
        for group in ([w for w in work if w[1] == 0],
                      [w for w in work if w[1] > 0]):
            if group:
                self._prefill_dispatch(group)

    def _prefill_dispatch(self, work) -> None:
        bsz, sp, ps = self.sc.max_batch, self.sc.max_prompt, self.sc.page_size
        if self.sc.paged:
            copies = []
            for slot, off, toks in work:
                # COW barrier + page-granular write coverage for the rows
                # this chunk writes (true misses fault before any cache
                # mutation)
                for j in range(off // ps, (off + len(toks) - 1) // ps + 1):
                    cp = self.alloc.privatize(slot, j)
                    if cp is not None:
                        copies.append(cp)
                    self.alloc.check_write(slot, j * ps, ps,
                                           strict=self.sc.strict_iotlb)
            self._apply_copies(copies)
        toks_np = np.zeros((bsz, sp), np.int32)
        lens_np = np.zeros((bsz,), np.int32)
        offs_np = np.zeros((bsz,), np.int32)
        for slot, off, toks in work:
            toks_np[slot, :len(toks)] = toks
            lens_np[slot] = len(toks)
            offs_np[slot] = off
        dev = self.device
        args = [torch.from_numpy(toks_np).to(dev),
                torch.from_numpy(lens_np).to(dev)]
        if self.sc.paged:
            # an all-fresh wave passes no offsets (the flash kernel); the
            # contiguous engine has fresh waves only
            args += [self._pages_dev(), (torch.from_numpy(offs_np).to(dev)
                                         if offs_np.any() else None)]
        logits = self._dispatch(self._prefill, *args)
        finishes = any(
            off + len(toks) >= len(self.sched.slots[slot].req.prompt)
            for slot, off, toks in work)
        firsts = self._sample(logits) if finishes else None
        lg_np = (logits.float().cpu().numpy() if self.sc.record_logits
                 else None)
        for slot, off, chunk_toks in work:
            meta = self.sched.slots[slot]
            meta.prefill_done = off + len(chunk_toks)
            if not meta.prefilled:
                continue            # more chunks to come; logits discarded
            req = meta.req
            first = int(firsts[slot])
            self.positions[slot] = len(req.prompt)
            self.last_token[slot] = first
            req.out_tokens.append(first)    # the post-prompt prediction
            self.sched.note_first_token(req, self.tick_no)
            if lg_np is not None:
                req.logits.append(lg_np[slot].copy())
            if first == self.sc.eos_id or \
                    len(req.out_tokens) >= self.sc.max_new_tokens:
                self._finish(slot)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """One token a row over the PADDED vocab, as the reference: at
        temperature 0 the float32 argmax (lowest index on ties), else a
        draw from softmax(logits / T) with the engine's generator (the
        reference's ``jax.random.categorical``: the same distribution,
        not the same bits)."""
        t = self.sc.temperature
        if t <= 0:
            return logits.float().argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / t, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[
            :, 0].cpu().numpy()

    def _finish(self, slot: int):
        req = self.sched.slots[slot].req
        req.done = True
        self.sched.note_terminal(req)
        self.completed.append(req)
        self.sched.release(slot)
        if self.sc.paged:
            self.alloc.release_slot(slot)   # refs return to the pool

    def _apply_copies(self, copies: List[Tuple[int, int]]) -> None:
        """Apply allocator COW copies (src phys -> dst phys) to every pool
        leaf (layers, pages, ...), in place; state leaves are per slot."""
        if not copies:
            return
        src = torch.tensor([c[0] for c in copies], device=self.device)
        dst = torch.tensor([c[1] for c in copies], device=self.device)
        for leaf in self._pool_leaves():
            leaf[:, dst] = leaf[:, src]
        self.n_cow_copies += len(copies)

    # -- device <-> host page movement --------------------------------------
    def _swap_out(self, slot: int) -> None:
        """Preempt ``slot``: copy its pages and its recurrent state rows to
        host tensors, release the pages, and park the request on the swap
        queue.  The copy to the host is synchronous, so it has landed
        before ``release_slot`` hands the pages to the next writer; a page
        the victim shares keeps its other references and bytes."""
        meta = self.sched.slots[slot]
        req = meta.req
        n_logical = self.alloc.logical_count(slot)
        phys = torch.from_numpy(
            self.alloc.page_table[slot, :n_logical].astype(np.int64)
        ).to(self.device)
        pool_rows = [leaf[:, phys].cpu() for leaf in self._pool_leaves()]
        slot_rows = [leaf[:, slot].cpu() for leaf in self._state_leaves()]
        self.sched.swapped.append(SwappedRequest(
            req=req, prefill_done=meta.prefill_done, order=meta.order,
            pos=int(self.positions[slot]),
            last_token=int(self.last_token[slot]),
            n_pages=n_logical, n_max=self._max_pages(req),
            growth_due=int(self.alloc.growth_due[slot]),
            pool_rows=pool_rows, slot_rows=slot_rows,
            nbytes=sum(t.numel() * t.element_size()
                       for t in pool_rows + slot_rows)))
        self.alloc.release_slot(slot)
        self.sched.release(slot)
        req.preempts += 1
        self.n_preemptions += 1

    def _swap_in(self, slot: int, sw: SwappedRequest) -> None:
        """Re-admit a swapped request: fresh private pages, its bytes and
        its state rows back (into the new slot), and its admission order,
        position and last token."""
        for j in range(sw.n_pages):
            if not self.alloc.alloc(slot, j):
                raise RuntimeError("swap-in pages were vetted in "
                                   "_swap_in_ready")
        phys = torch.from_numpy(
            self.alloc.page_table[slot, :sw.n_pages].astype(np.int64)
        ).to(self.device)
        for leaf, rows in zip(self._pool_leaves(), sw.pool_rows,
                              strict=True):
            leaf[:, phys] = rows.to(self.device)
        for leaf, rows in zip(self._state_leaves(), sw.slot_rows,
                              strict=True):
            leaf[:, slot] = rows.to(self.device)
        if self.sc.reserve_decode_pages:
            self.alloc.growth_due[slot] = sw.growth_due
        self.positions[slot] = sw.pos
        self.last_token[slot] = sw.last_token
        self.sched.place(slot, sw.req, prefill_done=sw.prefill_done,
                         order=sw.order)
        self.peak_active = max(self.peak_active, len(self.sched.active()))
        self.n_swap_ins += 1

    def _swap_in_ready(self) -> None:
        """Re-admit swapped requests (FIFO) while slots and pages allow:
        the mapped pages to restore, plus one growth page of headroom so
        the next decode tick makes progress instead of thrashing."""
        while self.sched.swapped and self.sched.free_slots():
            slot = self.sched.free_slots()[0]
            sw = self.sched.swapped[0]
            need = sw.n_pages + (sw.growth_due if
                                 self.sc.reserve_decode_pages
                                 else int(sw.n_pages < sw.n_max))
            if need > self.alloc.reserved_free():
                break
            self.sched.swapped.pop(0)
            self._swap_in(slot, sw)

    # -- steady-state decode tick -------------------------------------------
    def _grow_pages(self, active: List[int]) -> None:
        """Map the page covering each active slot's next write row.
        Exhaustion, reachable only under overcommit, triggers
        ``ServeConfig.preemption``: swap out the scheduler's victim and
        retry, or, with no viable victim or under "terminate", a capacity
        fault that ends the request with its partial output (strict mode
        raises)."""
        ps = self.sc.page_size
        cow: List[Tuple[int, int]] = []
        for i in active:
            meta = self.sched.slots[i]
            if meta is None:        # swapped out by an earlier iteration
                continue
            wr = int(self.positions[i])     # this tick's cache write row
            j = wr // ps
            if self.alloc.page_table[i, j] < 0:
                grown = self.alloc.alloc(i, j)
                while not grown and self.sc.preemption == "swap":
                    v = self.sched.victim(exclude=i)
                    if v is None or not self._swappable(v):
                        break
                    if self.sched.slots[v].req.priority > \
                            meta.req.priority:
                        # every other resident outranks the grower: park
                        # the grower itself, never higher-priority work;
                        # one that cannot be parked takes the capacity
                        # path
                        if not self._swap_fits_budget(i):
                            self._deny_swap_budget(i)
                        elif self._swappable(i):
                            self._swap_out(i)
                        break
                    if not self._swap_fits_budget(v):
                        self._deny_swap_budget(v)
                        break
                    self._swap_out(v)
                    grown = self.alloc.alloc(i, j)
                if self.sched.slots[i] is None:
                    continue            # the grower parked itself
                if not grown:
                    self.iotlb.faults.append(FaultRecord(
                        "capacity", i * self._slot_span + wr, 1, True))
                    req = meta.req
                    req.failed = True
                    self._finish(i)
                    if self.sc.strict_iotlb:
                        raise IotlbFault(
                            "capacity", f"request {req.rid}: page pool "
                            f"exhausted growing row {wr}")
                    continue
                self.alloc.growth_due[i] = max(
                    0, int(self.alloc.growth_due[i]) - 1)
            else:
                # COW barrier: decode never writes a page another slot
                # still references.
                cp = self.alloc.privatize(i, j)
                if cp is not None:
                    cow.append(cp)
            self.alloc.check_write(i, wr, 1, strict=self.sc.strict_iotlb)
        self._apply_copies(cow)

    def _swappable(self, slot: int) -> bool:
        """Whether a preempted ``slot`` could be re-admitted later: its
        mapped pages, plus a growth page if it is not fully grown, fit
        the pool."""
        meta = self.sched.slots[slot]
        n_logical = self.alloc.logical_count(slot)
        return n_logical + int(n_logical < self._max_pages(meta.req)) \
            <= self.num_pages

    def _swap_fits_budget(self, slot: int) -> bool:
        """Whether swapping ``slot`` keeps the swap queue within
        ``ServeConfig.swap_budget_bytes``."""
        budget = self.sc.swap_budget_bytes
        if budget is None:
            return True
        est = self.alloc.logical_count(slot) * self._page_nbytes \
            + self._slot_state_nbytes
        return self.sched.swap_bytes() + est <= budget

    def _deny_swap_budget(self, slot: int) -> None:
        """Record a swap denied by the byte budget: the grower takes the
        capacity path instead of the host holding unbounded bytes."""
        self.iotlb.faults.append(FaultRecord(
            "swap_budget", slot * self._slot_span,
            self.alloc.logical_count(slot) * self.sc.page_size, True))
        self.n_swap_budget_denials += 1

    def step(self):
        """One engine tick after admission: advance unfinished prefill by
        one chunk (unless this tick's admission wave already did), then one
        decode dispatch for every prompt-complete slot."""
        if self.sc.paged and self.sched.has_prefill_work() \
                and not self._prefilled_since_step:
            self._prefill_tick()
        self._prefilled_since_step = False
        if self.sc.paged:
            runnable = self.sched.decode_slots()
            self._grow_pages(runnable)
            runnable = set(runnable)
            active = [i for i in self.sched.decode_slots()
                      if i in runnable]     # growth may have swapped slots
        else:
            active = self.sched.decode_slots()
        if not active:
            return
        mask_np = np.zeros((self.sc.max_batch,), bool)
        mask_np[active] = True
        dev = self.device
        toks = torch.from_numpy(self.last_token[:, None].copy()).to(dev)
        pos_v = torch.from_numpy(
            np.where(mask_np, self.positions, -1).astype(np.int32)).to(dev)
        logits = self._dispatch(self._decode, toks, pos_v,
                                *([self._pages_dev()] if self.sc.paged
                                  else []))
        nxt = self._sample(logits)
        lg_np = (logits.float().cpu().numpy() if self.sc.record_logits
                 else None)
        self.last_token = np.where(mask_np, nxt,
                                   self.last_token).astype(np.int32)
        self.positions = np.where(mask_np, self.positions + 1,
                                  self.positions).astype(np.int32)
        for i in active:
            req = self.sched.slots[i].req
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            if lg_np is not None:
                req.logits.append(lg_np[i].copy())
            if tok == self.sc.eos_id or \
                    len(req.out_tokens) >= self.sc.max_new_tokens:
                self._finish(i)

    # -- session API ---------------------------------------------------------
    def submit(self, req: Request) -> RequestHandle:
        """Queue ``req`` for admission and return its handle at once.
        Raises once the engine has been drained, and on the paged engine
        for a prompt longer than ``slot_rows - max_new_tokens``: the
        reference serves those as oversized contexts from a host tier,
        which this slice does not have (ROADMAP queue 1 item 14).  The
        contiguous engine fails such a prompt at admission, as the
        reference's does (an IOTLB fault)."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed: submit() after "
                               "drain() — construct a new engine")
        limit = self.sc.slot_rows - self.sc.max_new_tokens
        if self.sc.paged and len(req.prompt) > limit:
            raise ValueError(
                f"Request.prompt of request {req.rid} has {len(req.prompt)} "
                f"tokens, more than slot_rows - max_new_tokens = {limit}; "
                "oversized contexts come with ROADMAP queue 1 item 14")
        if req.submit_tick is None:
            req.submit_tick = self.tick_no
        self.sched.submit(req)
        return RequestHandle(self, req)

    def tick(self) -> None:
        """Advance the serving clock, admit pending requests into free
        slots (at most one prefill wave), then one decode dispatch."""
        self.tick_no += 1
        self._admission_wave()
        self.step()

    def drain(self) -> List[Request]:
        """Serve every outstanding submission, then CLOSE the engine.
        Returns the requests finished during this call, in order."""
        start = len(self.completed)
        while self.sched.has_work():
            self.tick()
        self._closed = True
        return self.completed[start:]

    def run(self, requests: List[Request]) -> List[Request]:
        """Submit ``requests`` and tick until idle (the engine stays
        open).  Returns the requests finished during this call."""
        start = len(self.completed)
        for req in requests:
            self.submit(req)
        while self.sched.has_work():
            self.tick()
        return self.completed[start:]
