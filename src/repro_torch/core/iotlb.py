"""Software IOTLB: windowed, permission-checked views over shared buffers.

Shaheen's IOTLB (§III-C2) mediates every cluster access to host memory: the
host programs up to 32 entries (virtual range -> physical base + R/W perms);
out-of-window accesses raise an interrupt on the host while the IOTLB keeps
the AXI protocol alive (sinking writes, serving dummy reads) so a buggy or
malicious cluster kernel cannot corrupt host state or deadlock the bus.

The GPU runtime offers no user-programmable equivalent, so this transfers as
a *software invariant-enforcement layer*, not a security boundary: the
serving KV-cache manager routes every page write through an :class:`Iotlb`,
which either translates it or records a structured fault — mirroring the
graceful containment behaviour of the hardware block.

A pure-Python copy of ``repro.core.iotlb``: the port imports nothing from
the JAX package, so it keeps its own.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

MAX_ENTRIES = 32   # matches the silicon block


class IotlbFault(Exception):
    def __init__(self, kind: str, detail: str):
        self.kind = kind
        super().__init__(f"IOTLB fault [{kind}]: {detail}")


@dataclasses.dataclass(frozen=True)
class Window:
    name: str
    virt_base: int
    size: int
    phys_base: int
    readable: bool = True
    writable: bool = True
    shard: int = 0
    # Which physical memory the window's phys range addresses.  A
    # page-striped serving pool programs ``phys_base`` SHARD-LOCAL (the
    # page's offset within its owning shard's slice) and names the shard
    # here, mirroring how each cluster's IOTLB would be programmed
    # against its own local memory; single-memory users keep the
    # default 0.

    @property
    def virt_end(self) -> int:
        return self.virt_base + self.size

    def contains(self, start: int, length: int) -> bool:
        return self.virt_base <= start and start + length <= self.virt_end


@dataclasses.dataclass
class FaultRecord:
    kind: str
    start: int
    length: int
    write: bool


class Iotlb:
    """Host-programmed translation table with graceful fault containment."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self._max = max_entries
        self._windows: Dict[str, Window] = {}
        self.faults: List[FaultRecord] = []

    # -- host-side programming (CVA6 writing the 32 entries) ---------------
    def program(self, window: Window) -> None:
        # programming errors append to `faults` BEFORE raising, like every
        # access-path fault, so host-side fault accounting stays complete.
        if len(self._windows) >= self._max and window.name not in self._windows:
            self.faults.append(
                FaultRecord("capacity", window.virt_base, window.size, True))
            raise IotlbFault("capacity", f"more than {self._max} entries")
        for other in self._windows.values():
            if other.name == window.name:
                continue
            if (window.virt_base < other.virt_end
                    and other.virt_base < window.virt_end):
                self.faults.append(
                    FaultRecord("overlap", window.virt_base, window.size,
                                True))
                raise IotlbFault(
                    "overlap", f"{window.name} overlaps {other.name}")
        self._windows[window.name] = window

    def evict(self, name: str) -> None:
        self._windows.pop(name, None)

    # -- accelerator-side access path --------------------------------------
    def translate(self, start: int, length: int, *, write: bool,
                  strict: bool = True) -> Optional[Tuple[int, int]]:
        """Map a virtual range to (phys_start, length).

        On a miss/permission error: raises when ``strict`` (host notified),
        otherwise records the fault and returns None (transaction sunk, as
        the hardware block does to keep AXI alive).
        """
        for w in self._windows.values():
            if w.contains(start, length):
                if write and not w.writable:
                    return self._fault("wperm", start, length, write, strict)
                if not write and not w.readable:
                    return self._fault("rperm", start, length, write, strict)
                return (w.phys_base + (start - w.virt_base), length)
        return self._fault("miss", start, length, write, strict)

    def _fault(self, kind, start, length, write, strict):
        self.faults.append(FaultRecord(kind, start, length, write))
        if strict:
            raise IotlbFault(kind, f"range [{start}, {start+length}) write={write}")
        return None

    @property
    def windows(self) -> Tuple[Window, ...]:
        return tuple(self._windows.values())


@dataclasses.dataclass
class RefillRecord:
    """One TLB refill, FaultRecord-style: which backing window was walked
    in and which resident entry (if any) it displaced."""
    name: str
    start: int
    length: int
    evicted: Optional[str]


@dataclasses.dataclass
class TlbStats:
    hits: int = 0
    refills: int = 0
    evictions: int = 0


class PagedIotlb:
    """Hardware-faithful IOTLB: 32 resident entries as an LRU TLB over a
    host-memory page table.

    Shaheen's block holds only 32 entries, so a page pool larger than 32
    pages cannot map every page at once.  The host keeps the FULL mapping
    (``map``/``unmap`` — the page table, in host DRAM), and the 32 silicon
    entries cache its hottest windows: a translate that misses the
    resident set but hits the page table EVICTS the least-recently-used
    entry and REFILLS it from the table (counted in ``stats`` and logged
    FaultRecord-style in ``refill_log``); a translate that misses the
    table itself is a real fault — recorded, and raised when strict,
    exactly like :class:`Iotlb`.
    """

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self.max_entries = max_entries
        # the backing page table lives in host memory, so its capacity is
        # unbounded; programming/translation/fault semantics are Iotlb's.
        self._table = Iotlb(max_entries=1 << 62)
        self._resident: "OrderedDict[str, None]" = OrderedDict()
        self.refill_log: List[RefillRecord] = []
        self.stats = TlbStats()

    @property
    def faults(self) -> List[FaultRecord]:
        return self._table.faults

    # -- host-side page-table programming ----------------------------------
    def map(self, window: Window) -> None:
        """Enter a window into the backing page table (NOT the TLB: it
        becomes resident on first touch).  Overlaps fault like Iotlb."""
        self._table.program(window)

    def unmap(self, name: str) -> None:
        self._table.evict(name)
        self._resident.pop(name, None)

    # -- accelerator-side access path --------------------------------------
    def translate(self, start: int, length: int, *, write: bool,
                  strict: bool = True) -> Optional[Tuple[int, int]]:
        # ONE walk of the backing table (this is the per-row hot path);
        # fault recording stays Iotlb's single implementation.
        table = self._table
        w = next((x for x in table._windows.values()
                  if x.contains(start, length)), None)
        if w is None:
            return table._fault("miss", start, length, write, strict)
        # residency is accounted BEFORE the permission check, as the
        # silicon does: the walk refills the entry, then the access
        # faults on permissions against the now-resident entry.
        if w.name in self._resident:
            self._resident.move_to_end(w.name)
            self.stats.hits += 1
        else:
            evicted = None
            if len(self._resident) >= self.max_entries:
                evicted, _ = self._resident.popitem(last=False)
                self.stats.evictions += 1
            self._resident[w.name] = None
            self.stats.refills += 1
            self.refill_log.append(
                RefillRecord(w.name, start, length, evicted))
        if write and not w.writable:
            return table._fault("wperm", start, length, write, strict)
        if not write and not w.readable:
            return table._fault("rperm", start, length, write, strict)
        return (w.phys_base + (start - w.virt_base), length)

    @property
    def resident(self) -> Tuple[str, ...]:
        return tuple(self._resident)

    @property
    def windows(self) -> Tuple[Window, ...]:
        return tuple(self._table.windows)
