"""Page allocator: refcounted page tables over a shared physical pool.

A transliteration of ``repro.serve.allocator`` (the ACCOUNTING layer) for
one unsharded pool on one card; the host tier and row rollback are not in
this slice.  It owns

  * the free list of physical pages and each slot's page table
    (``page_table[slot, j]`` = physical page of logical page ``j``,
    -1 = unmapped),
  * per-page REFCOUNTS — prefix sharing points several slots' tables at
    one physical page, which returns to the free list with its last
    reference,
  * copy-on-write (``privatize``): before a slot writes a page it
    shares, the page is remapped to a fresh one and the engine gets a
    (src, dst) copy to apply to the pools,
  * reservation accounting for worst-case decode growth
    (``growth_due``), and
  * the IOTLB: a :class:`~repro_torch.core.iotlb.PagedIotlb`, 32 resident
    LRU entries over the full page-table mapping.

Pure host-side bookkeeping: the allocator never touches device memory.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.iotlb import PagedIotlb, Window


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 pages_per_slot: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.slot_span = pages_per_slot * page_size
        self.page_table = np.full((max_batch, pages_per_slot), -1, np.int32)
        self._free: List[int] = list(range(num_pages))
        self.refcount = np.zeros((num_pages,), np.int32)
        # per-slot worst-case pages still to be grown (reservations)
        self.growth_due = np.zeros((max_batch,), np.int32)
        self.iotlb = PagedIotlb()

    # -- queries ------------------------------------------------------------
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def logical_count(self, slot: int) -> int:
        """Logical pages ``slot`` has mapped: the pages a whole-request
        swap snapshots and later restores (one tier: all on the device)."""
        return int((self.page_table[slot] >= 0).sum())

    def reserved_free(self) -> int:
        """Free pages not spoken for by outstanding growth reservations."""
        return len(self._free) - int(self.growth_due.sum())

    def _window(self, slot: int, j: int, phys: int) -> Window:
        ps = self.page_size
        return Window(name=f"slot{slot}p{j}",
                      virt_base=slot * self.slot_span + j * ps, size=ps,
                      phys_base=phys * ps, readable=True, writable=True)

    # -- allocation ---------------------------------------------------------
    def _pop_free(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None

    def alloc(self, slot: int, j: int) -> bool:
        """Map logical page ``j`` of ``slot`` to the oldest free page and
        enter its window into the IOTLB page table.  False = exhausted."""
        phys = self._pop_free()
        if phys is None:
            return False
        self.page_table[slot, j] = phys
        self.refcount[phys] = 1
        self.iotlb.map(self._window(slot, j, phys))
        return True

    def share(self, slot: int, j: int, phys: int) -> None:
        """Point (slot, j) at an already-populated physical page (prefix
        sharing): no copy, refcount up, own IOTLB window."""
        if self.refcount[phys] <= 0:
            raise RuntimeError(f"sharing unowned page {phys}")
        self.page_table[slot, j] = phys
        self.refcount[phys] += 1
        self.iotlb.map(self._window(slot, j, phys))

    def privatize(self, slot: int, j: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write barrier, called before WRITING page ``j`` of
        ``slot``: a shared page (refcount > 1) is remapped to a fresh one;
        returns (src, dst) for the engine to copy, or None when the page
        was already private."""
        phys = int(self.page_table[slot, j])
        if phys < 0 or self.refcount[phys] <= 1:
            return None
        dst = self._pop_free()
        if dst is None:
            raise RuntimeError("COW page was not accounted at admission")
        self.refcount[phys] -= 1
        self.refcount[dst] = 1
        self.page_table[slot, j] = dst
        self.iotlb.unmap(f"slot{slot}p{j}")
        self.iotlb.map(self._window(slot, j, dst))
        return (phys, dst)

    def release_slot(self, slot: int) -> None:
        """Drop every reference ``slot`` holds and its growth reservation;
        pages with no remaining sharer return to the pool."""
        for j, phys in enumerate(self.page_table[slot]):
            if phys >= 0:
                self.iotlb.unmap(f"slot{slot}p{j}")
                p = int(phys)
                self.refcount[p] -= 1
                if self.refcount[p] == 0:
                    self._free.append(p)
        self.page_table[slot] = -1
        self.growth_due[slot] = 0

    # -- access checks ------------------------------------------------------
    def check_write(self, slot: int, row: int, length: int = 1, *,
                    strict: bool) -> bool:
        """Row-granular write check through the TLB (refills counted)."""
        return self.iotlb.translate(
            slot * self.slot_span + row, length, write=True,
            strict=strict) is not None
