"""KV slot pool: the fixed [n_slots, S_max] cache managed as reusable rows.

Port copy of ``uccl_tpu/serving/slots.py`` (jax-free there too).

The device cache is allocated ONCE (the backend owns the arrays); this class
owns the host-side bookkeeping — which rows are free, which request occupies
which row, occupancy history. Freeing a slot does not touch device memory:
a stale row is dead by construction (attention stops at the slot's length,
and a new occupant prefills from position 0, re-writing every position
before any read of it — see models/inference.py `prefill_slots`).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional


class SlotPool:
    """Free-list of KV cache rows with admit/free/occupancy tracking.

    Slots exist in three states: **free** (on the heap), **occupied** (a
    live request's KV), or **parked** (a retired request's KV kept resident
    for the prefix-reuse cache — still charged against the pool, but not a
    live occupant: ``leaked()`` excludes parked slots, and only
    ``reclaim()`` — the cache's eviction — returns them to the free list).
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        # min-heap: admissions always take the LOWEST free slot id, so the
        # pool packs low rows under partial load (a deque here would hand
        # out slots in FIFO-of-frees order, not lowest-first — tested)
        self._free = list(range(n_slots))
        heapq.heapify(self._free)
        self._occupant: Dict[int, int] = {}  # slot -> rid
        self._parked: Dict[int, int] = {}  # slot -> rid of the retiree
        self.total_admits = 0
        self.total_frees = 0
        self.high_water = 0  # max concurrent occupancy observed

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def n_parked(self) -> int:
        return len(self._parked)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.n_slots

    def occupant(self, slot: int) -> Optional[int]:
        return self._occupant.get(slot)

    def active_slots(self) -> List[int]:
        return sorted(self._occupant)

    def admit(self, rid: int) -> Optional[int]:
        """Claim a free slot for ``rid``; None when the pool is full."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._occupant[slot] = rid
        self.total_admits += 1
        self.high_water = max(self.high_water, self.n_active)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._occupant:
            raise ValueError(f"slot {slot} is not occupied")
        del self._occupant[slot]
        heapq.heappush(self._free, slot)
        self.total_frees += 1

    def park(self, slot: int) -> None:
        """Retire an occupied slot into the parked (cache-resident) state:
        its KV stays readable as a prefix-reuse donor, but no request owns
        it and admissions cannot claim it until :meth:`reclaim`."""
        if slot not in self._occupant:
            raise ValueError(f"slot {slot} is not occupied")
        self._parked[slot] = self._occupant.pop(slot)

    def reclaim(self, slot: int) -> None:
        """Return a parked slot to the free list (prefix-cache eviction)."""
        if slot not in self._parked:
            raise ValueError(f"slot {slot} is not parked")
        del self._parked[slot]
        heapq.heappush(self._free, slot)
        self.total_frees += 1

    def is_parked(self, slot: int) -> bool:
        """Whether ``slot`` is in the parked (cache-resident) state — the
        tier manager's sanity check that a demotion victim really is cache
        residency and not a live request's KV."""
        return slot in self._parked

    def parked_slots(self) -> List[int]:
        return sorted(self._parked)

    def leaked(self) -> int:
        """Live-occupied slots — must be 0 after a full drain (tested).
        Parked slots are cache residency, not leaks: the prefix cache owns
        their lifecycle (LRU eviction under admission pressure)."""
        return len(self._occupant)
