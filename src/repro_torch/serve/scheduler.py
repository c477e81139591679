"""Serving scheduler: pending queue, admission order, chunk budgets,
preemption victims, the swap queue, prefix matching and the deadline
ledger.

A transliteration of ``repro.serve.scheduler`` (the POLICY layer; the
allocator accounts, the engine executes), so that the port's decisions
are the reference's exactly.  Twin ledgers and the tiered pool's
coldness order are not in this slice.

  * ``pop_pending``: highest ``Request.priority`` first, FIFO within a
    class via the stamped ``submit_seq``; a transiently unadmittable head
    is ``defer_pending``ed back and blocks the wave;
  * ``prefill_plan``: the next ``chunk`` unfilled prompt tokens of every
    slot still owing prefill (resumable chunked prefill);
  * ``decode_slots``: slots whose prompt is complete;
  * ``victim``: whom overcommit preempts, the lowest-priority resident,
    youngest (largest admission ``order``) within a class; the preempted
    request waits on ``swapped`` (host bytes: ``swap_bytes``);
  * ``shared_prefix``: the resident request with the longest materialized
    common prompt prefix, at whole-page granularity.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, List, Optional, Tuple

from repro_torch.serve.config import Request


@dataclasses.dataclass
class SlotMeta:
    """Scheduler-side state of one occupied slot."""
    req: Request
    prefill_done: int           # prompt rows materialized so far
    order: int                  # admission sequence number (larger=younger)

    @property
    def prefilled(self) -> bool:
        return self.prefill_done >= len(self.req.prompt)


@dataclasses.dataclass
class SwappedRequest:
    """A preempted request parked in host memory until re-admission.
    ``pool_rows`` holds one host tensor per pool leaf, in the reference's
    leaf order (stages in order, keys sorted), each (layers, n_pages,
    page_size, ...): the request's pages byte for byte; ``slot_rows``
    one per per-slot state leaf (a mamba block's conv and SSM state), each
    (layers, ...): the slot's row.  The port has no spill tier
    (``spill_step`` stays None)."""
    req: Request
    prefill_done: int
    order: int
    pos: int                    # next cache write row (decode position)
    last_token: int
    n_pages: int                # mapped logical pages at swap-out
    n_max: int                  # worst-case pages it could ever need
    growth_due: int
    pool_rows: List[Any]
    slot_rows: List[Any]
    nbytes: int = 0             # host bytes this snapshot occupies
    spill_step: Optional[int] = None


class Scheduler:
    def __init__(self, max_batch: int, chunk: int):
        self.chunk = chunk
        self.slots: List[Optional[SlotMeta]] = [None] * max_batch
        self.swapped: List[SwappedRequest] = []
        self._order = 0
        # kept sorted by (-priority, submit_seq)
        self._pending: List[Request] = []
        self._pending_keys: List[Tuple[int, int]] = []
        self._submit_seq = 0
        self.deadline_hits = 0
        self.deadline_misses = 0

    # -- pending queue -------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue ``req``; stamps ``submit_seq`` on first submission."""
        if req.submit_seq is None:
            req.submit_seq = self._submit_seq
            self._submit_seq += 1
        self._enqueue(req)

    def _enqueue(self, req: Request) -> None:
        key = (-req.priority, req.submit_seq)
        i = bisect.bisect_left(self._pending_keys, key)
        self._pending_keys.insert(i, key)
        self._pending.insert(i, req)

    def has_pending(self) -> bool:
        return bool(self._pending)

    def pop_pending(self) -> Request:
        self._pending_keys.pop(0)
        return self._pending.pop(0)

    def defer_pending(self, req: Request) -> None:
        """Put a transiently unadmittable request back in its place."""
        self._enqueue(req)

    def has_work(self) -> bool:
        return bool(self._pending or self.swapped
                    or any(s is not None for s in self.slots))

    def state_of(self, req: Request) -> str:
        """'running' | 'swapped' | 'pending' | 'unknown' for a live
        request."""
        for meta in self.slots:
            if meta is not None and meta.req is req:
                return "running"
        for sw in self.swapped:
            if sw.req is req:
                return "swapped"
        for r in self._pending:
            if r is req:
                return "pending"
        return "unknown"

    # -- deadline ledger -----------------------------------------------------
    def note_first_token(self, req: Request, tick_no: int) -> None:
        if req.first_token_tick is not None:
            return
        req.first_token_tick = tick_no
        if req.ttft_deadline is None or req.submit_tick is None:
            return
        req.deadline_miss = \
            (tick_no - req.submit_tick) > req.ttft_deadline
        if req.deadline_miss:
            self.deadline_misses += 1
        else:
            self.deadline_hits += 1

    def note_terminal(self, req: Request) -> None:
        """A deadline-carrying request ending with no first token is a
        miss."""
        if req.ttft_deadline is None or req.submit_tick is None:
            return
        if req.first_token_tick is not None or req.deadline_miss is not None:
            return
        req.deadline_miss = True
        self.deadline_misses += 1

    # -- swap accounting -----------------------------------------------------
    def swap_bytes(self) -> int:
        """Host bytes currently parked on the swap queue."""
        return sum(sw.nbytes for sw in self.swapped)

    def next_order(self) -> int:
        """Claim the next admission-order stamp."""
        order = self._order
        self._order += 1
        return order

    # -- slot table ---------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def place(self, slot: int, req: Request, prefill_done: int = 0,
              order: Optional[int] = None) -> None:
        """Occupy ``slot``; a swapped-in request keeps its ``order``."""
        if order is None:
            order = self.next_order()
        self.slots[slot] = SlotMeta(req=req, prefill_done=prefill_done,
                                    order=order)

    def release(self, slot: int) -> None:
        self.slots[slot] = None

    # -- chunk budgeting ----------------------------------------------------
    def prefill_plan(self) -> List[Tuple[int, int, List[int]]]:
        """(slot, start_row, tokens) for every slot still owing prefill."""
        plan = []
        for i, meta in enumerate(self.slots):
            if meta is None or meta.prefilled:
                continue
            off = meta.prefill_done
            plan.append((i, off, meta.req.prompt[off:off + self.chunk]))
        return plan

    def has_prefill_work(self) -> bool:
        return any(s is not None and not s.prefilled for s in self.slots)

    def decode_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefilled]

    # -- preemption policy --------------------------------------------------
    def victim(self, exclude: int) -> Optional[int]:
        """Preemption victim other than ``exclude``: the lowest-priority
        resident, youngest within a class, or None."""
        best, best_key = None, None
        for i, meta in enumerate(self.slots):
            if meta is None or i == exclude:
                continue
            key = (meta.req.priority, -meta.order)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    # -- prefix sharing -----------------------------------------------------
    def shared_prefix(self, prompt: List[int],
                      page_size: int) -> Tuple[Optional[int], int]:
        """(resident slot, shareable rows) with the longest materialized
        common prompt prefix; (None, 0) when nothing reaches a full page.
        Rows are capped at ``len(prompt) - 1`` (the last prompt token is
        always prefilled) and at the resident's ``prefill_done``."""
        best, best_rows = None, 0
        for i, meta in enumerate(self.slots):
            if meta is None:
                continue
            lcp = 0
            for a, b in zip(prompt, meta.req.prompt):
                if a != b:
                    break
                lcp += 1
            rows = min(lcp, meta.prefill_done, len(prompt) - 1)
            if rows > best_rows:
                best, best_rows = i, rows
        if best_rows < page_size:
            return None, 0
        return best, best_rows
