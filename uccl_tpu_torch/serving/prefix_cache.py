"""Prefix-reuse KV cache: a token trie at chunk granularity over parked slots.

Port copy of ``uccl_tpu/serving/prefix_cache.py`` (host-only there too: it
never touches KV bytes, only names them). A retired request's slot is
*parked*, not freed, and its prompt enters a trie keyed by chunks of
``prefill_chunk`` tokens. A later request whose prompt shares a cached
chunk-aligned prefix copies the donor's rows into its own slot and resumes
the chunked prefill at ``prefill_pos = matched_len``. Chunk granularity
keeps every match boundary a position the chunked program resumes from,
and trie keys are a chunk's raw token bytes (no hash collisions).

A resident is an ``int`` (a parked device slot, tier 0) or an opaque tier
reference (``serving/kv_tiers.py``'s ``TierRef``, an entry demoted to the
host pool). The trie is the one index over every tier: eviction demotes
tier-0 victims through the ``demote=`` hook, and a deep-tier hit promotes
through ``TieredKVCache``. Keys are namespaced by tenant and adapter
version, so two tenants never share cached KV.

Counters: ``prefix_cache_hits_total``, ``prefix_cache_misses_total``,
``prefix_cache_evictions_total``, ``prefix_cache_tokens_reused_total``,
gauges ``prefix_cache_resident_slots`` and ``prefix_cache_resident_tokens``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from uccl_tpu_torch import obs

_HITS = obs.counter(
    "prefix_cache_hits_total",
    "admissions that resumed prefill from a cached chunk-aligned prefix",
)
_MISSES = obs.counter(
    "prefix_cache_misses_total",
    "admissions with no usable cached prefix (cold prefill from 0)",
)
_EVICTIONS = obs.counter(
    "prefix_cache_evictions_total",
    "parked donor slots reclaimed LRU-first under admission pressure",
)
_TOKENS_REUSED = obs.counter(
    "prefix_cache_tokens_reused_total",
    "prompt tokens whose prefill compute was skipped via a cached prefix",
)
_RESIDENT = obs.gauge(
    "prefix_cache_resident_slots",
    "slots currently parked as prefix-cache donors",
)
_RESIDENT_TOKENS = obs.gauge(
    "prefix_cache_resident_tokens",
    "prompt tokens held by parked prefix-cache donors (depth x chunk summed "
    "over device-tier residents) — the cache-pressure axis capacity sweeps "
    "read in tokens rather than slots",
)


class _Node:
    """One trie node: children keyed by the raw bytes of a C-token chunk;
    ``slots`` is every resident (parked slot id or tier ref) whose cached
    prompt passes through this node (i.e. whose KV holds at least this
    node's depth in chunks)."""

    __slots__ = ("children", "slots")

    def __init__(self):
        self.children: Dict[bytes, _Node] = {}
        self.slots: Set = set()


class PrefixCache:
    """Chunk-granular prefix trie over parked KV slots + demoted tier
    entries, LRU-evicted.

    The engine owns the pool and the KV copies; this class owns WHICH
    resident holds WHICH prefix and for how long. Invariant: every ``int``
    resident referenced anywhere in the trie is parked in the engine's pool
    (never a live request's slot), so eviction can only ever reclaim cache
    residency; every non-int resident is a tier ref whose bytes live in the
    attached :class:`~uccl_tpu_torch.serving.kv_tiers.TieredKVCache` — and each
    logical entry lives in EXACTLY ONE tier (a demotion moves the resident,
    never copies it).
    """

    def __init__(self, chunk: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = chunk
        self._root = _Node()
        # resident -> (depth in chunks, last-use sequence number). Depth is
        # how many full chunks of the resident's prompt are keyed in the
        # trie. Keys are slot ints (T0) or TierRefs (T1/T2).
        self._resident: Dict = {}
        # resident -> its chunk-key path, recorded at insert time so
        # removal walks only this branch (never the whole trie)
        self._paths: Dict = {}
        self._seq = 0
        self._t0_tokens = 0  # running depth*chunk sum over int residents
        self._tiers = None  # TieredKVCache once attach_tiers() is called
        # fleet listener (serving/fleet.py): mirrors residency into the
        # shared directory — on_insert(resident, path) / on_remove(resident),
        # both called on the engine step thread, both fail-soft
        self.listener = None

    # -- inspection -------------------------------------------------------
    @property
    def n_resident(self) -> int:
        """Device-tier (parked-slot) residents — the pre-tier meaning."""
        return sum(1 for r in self._resident if isinstance(r, int))

    @property
    def n_tier_refs(self) -> int:
        """Deep-tier (T1/T2) residents."""
        return len(self._resident) - self.n_resident

    def resident_slots(self) -> List[int]:
        return sorted(r for r in self._resident if isinstance(r, int))

    def tier_refs(self) -> List:
        return [r for r in self._resident if not isinstance(r, int)]

    def attach_tiers(self, tiers) -> None:
        """Bind the tier manager: ``_remove`` of a tier-ref resident then
        releases its store bytes (``tiers.release(ref)``, idempotent) so
        dropping a trie entry can never strand tier capacity."""
        self._tiers = tiers

    def _touch(self, resident) -> None:
        depth, _ = self._resident[resident]
        self._seq += 1
        self._resident[resident] = (depth, self._seq)

    def _chunks(self, prompt: np.ndarray, n: int, ns: str = ""):
        """Chunk keys of ``prompt``, namespaced: every key is
        prefixed with ``ns`` bytes, so two tenants (or two adapter
        versions of one tenant) sharing a system prompt occupy DISJOINT
        trie branches — adapter-divergent KV can never cross-hit. A
        cross-namespace lookup walks into the other namespace's branch
        root, finds nothing, and counts an ordinary miss."""
        c = self.chunk
        tag = ns.encode() + b"\x00" if ns else b""
        p = np.ascontiguousarray(np.asarray(prompt, np.int32))
        for i in range(n):
            yield tag + p[i * c:(i + 1) * c].tobytes()

    def _stamp_gauges(self) -> None:
        _RESIDENT.set(self.n_resident)
        _RESIDENT_TOKENS.set(self._t0_tokens)

    # -- lookup -----------------------------------------------------------
    def _lookup(self, prompt, ns: str = "") -> Tuple[int, Optional[object]]:
        """Side-effect-free deepest-usable-prefix walk (no counters, no
        LRU refresh) — shared by :meth:`match` and :meth:`peek_donor`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        usable = (prompt.size - 1) // self.chunk  # ≥1 token must remain
        node, best = self._root, None
        depth = 0
        for key in self._chunks(prompt, usable, ns):
            node = node.children.get(key)
            if node is None:
                break
            depth += 1
            if node.slots:
                best = (depth, node)
        if best is None:
            return 0, None
        depth, node = best
        # prefer a device-tier donor over a deep-tier ref at equal depth
        # (a slot copy beats a decode+import promotion), then the most
        # recently used among equals (keeps hot shared prompts hot)
        donor = max(node.slots,
                    key=lambda s: (isinstance(s, int),
                                   self._resident[s][1]))
        return depth * self.chunk, donor

    def match(self, prompt, ns: str = "") -> Tuple[int, Optional[object]]:
        """Deepest cached chunk-aligned prefix of ``prompt`` that is usable
        for resumption, WITHIN namespace ``ns`` (the engine passes the
        request's tenant + adapter version — a cross-tenant or
        cross-adapter-version attempt counts a miss, never a hit).
        Returns ``(matched_len, donor)`` with
        ``matched_len`` a multiple of ``chunk`` and ``donor`` a parked slot
        id (int, tier 0) or a tier ref; ``(0, None)`` on a miss.

        A match is capped at the largest chunk multiple ≤ ``len(prompt)-1``:
        at least one prompt position must remain to prefill, because the
        first generated token comes from the final position's logits — a
        fully cached prompt still recomputes its last partial/full chunk.
        Refreshes the donor's LRU stamp.

        Counting: a miss counts here; so does a device-tier (``int``
        donor) hit — its slot-to-slot copy cannot fail. A DEEP-tier
        donor's hit (+ reused tokens) is counted only by
        :meth:`commit_hit` once the promotion actually lands KV rows in
        the slot; a stale ref instead counts a :meth:`count_stale_miss`
        cold miss. The ledger never credits skipped compute that was not
        skipped, and the per-tier split of ``kv_tier_hits_total`` keeps
        summing to ``prefix_cache_hits_total``.
        """
        matched, donor = self._lookup(prompt, ns)
        if donor is None:
            _MISSES.inc()
            return 0, None
        self._touch(donor)
        if isinstance(donor, int):
            _HITS.inc()
            _TOKENS_REUSED.inc(matched)
        return matched, donor

    def commit_hit(self, matched: int) -> None:
        """Count a deep-tier hit deferred by :meth:`match` — the engine
        calls this after ``TieredKVCache.promote`` returned True, i.e.
        after the donor's rows really landed in the admitted slot."""
        _HITS.inc()
        _TOKENS_REUSED.inc(matched)

    def count_stale_miss(self) -> None:
        """Count the cold miss a stale deep-tier ref degraded to (the
        promotion found the entry gone): the admission prefills from 0,
        so it is a miss in every ledger that matters."""
        _MISSES.inc()

    def peek_donor(self, prompt, ns: str = "") -> Optional[object]:
        """The resident :meth:`match` would reuse for ``prompt``, with no
        counter or LRU side effects — the engine protects it from being
        its own admission's eviction victim."""
        return self._lookup(prompt, ns)[1]

    def covered(self, prompt, ns: str = "") -> Optional[object]:
        """If the trie already caches ``prompt``'s full-chunk prefix at
        maximal depth in namespace ``ns``, return a resident holding it
        (parking another copy would waste a slot); else None."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        k = prompt.size // self.chunk
        if k < 1:
            return None
        node = self._root
        for key in self._chunks(prompt, k, ns):
            node = node.children.get(key)
            if node is None:
                return None
        if not node.slots:
            return None
        return max(node.slots, key=lambda s: self._resident[s][1])

    # -- residency --------------------------------------------------------
    def _insert(self, resident, path: List[bytes],
                seq: Optional[int] = None) -> None:
        """Add ``resident`` along ``path`` (a list of chunk keys) and
        record the path for O(depth) removal. ``seq`` pins the LRU stamp —
        a demotion re-inserts at the victim's OLD stamp, because moving an
        entry down a tier must not refresh its recency."""
        node = self._root
        for key in path:
            node = node.children.setdefault(key, _Node())
            node.slots.add(resident)
        if seq is None:
            self._seq += 1
            seq = self._seq
        self._resident[resident] = (len(path), seq)
        self._paths[resident] = list(path)
        if isinstance(resident, int):
            self._t0_tokens += len(path) * self.chunk
        self._stamp_gauges()
        if self.listener is not None:
            self.listener.on_insert(resident, list(path))

    def park(self, pool, slot: int, prompt, ns: str = "") -> bool:
        """Try to keep a retiring request's slot resident as a donor,
        keyed in namespace ``ns`` (the retiring request's tenant +
        adapter version — its KV is only ever a donor within it).

        Returns True when the slot was parked (caller must NOT free it);
        False when caching is useless — prompt shorter than one chunk, or
        its full-chunk prefix is already cached (the existing donor's LRU
        stamp is refreshed instead) — and the caller should free the slot.

        One tier-crossing rule: when the covering resident is a DEEP-tier
        ref at exactly this prompt's full-chunk depth, the fresh slot
        supersedes it — the entry moves back to tier 0 (the slot parks,
        the ref is dropped and its store bytes released), because serving
        future hits from a device slot beats re-promoting the same bytes
        every time. A ref covering a DEEPER prefix is a different entry
        and blocks nothing.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        k = prompt.size // self.chunk
        if k < 1:
            return False
        existing = self.covered(prompt, ns)
        if existing is not None:
            if isinstance(existing, int) or self._resident[existing][0] > k:
                self._touch(existing)
                return False
            # deep-tier ref at exactly depth k: supersede it with the slot
            self._remove(existing)
        self._insert(slot, list(self._chunks(prompt, k, ns)))
        pool.park(slot)
        return True

    def _remove(self, resident) -> None:
        """Drop every trie reference to ``resident`` by walking ONLY its
        recorded chunk-key path (pruning nodes left empty, deepest-first).
        A removed tier ref also releases its store bytes through the
        attached tier manager."""
        depth, _ = self._resident.pop(resident)
        path = self._paths.pop(resident)
        nodes = [self._root]
        node = self._root
        for key in path:
            node = node.children[key]
            node.slots.discard(resident)
            nodes.append(node)
        for i in range(len(path) - 1, -1, -1):
            child = nodes[i + 1]
            if child.slots or child.children:
                break
            del nodes[i].children[path[i]]
        if isinstance(resident, int):
            self._t0_tokens -= depth * self.chunk
        elif self._tiers is not None:
            self._tiers.release(resident)
        self._stamp_gauges()
        if self.listener is not None:
            self.listener.on_remove(resident)

    def replace_ref(self, old_ref, new_ref) -> None:
        """Swap a deep-tier resident for another AT THE SAME PATH AND LRU
        STAMP (or drop it when ``new_ref`` is None) — the tier manager's
        hook for T1→T2 spills and stale-ref invalidation. The manager has
        already moved/freed the store bytes, so the embedded release is a
        no-op by idempotence."""
        _, seq = self._resident[old_ref]
        path = self._paths[old_ref]
        self._remove(old_ref)
        if new_ref is not None:
            self._insert(new_ref, path, seq=seq)

    def evict_lru(self, pool, protect: Optional[int] = None,
                  demote=None) -> Optional[int]:
        """Reclaim the least-recently-used parked slot for admission: the
        slot returns to the pool's free list and every trie entry for it is
        dropped — or, with a ``demote`` hook, MOVED: ``demote(slot,
        n_tokens)`` may export the victim's rows to a deeper tier and
        return a tier ref, which is re-inserted at the victim's exact path
        and LRU stamp (the entry keeps its identity and recency, only its
        bytes change tier). Only parked slots are candidates (live
        requests are never resident, tier refs hold no slot).
        ``protect`` exempts one resident — the donor the admission
        triggering this eviction is about to match (evicting it would
        trade the hit for the slot). Returns the evicted slot id, or None
        when no candidate remains."""
        candidates = [s for s in self._resident
                      if isinstance(s, int) and s != protect]
        if not candidates:
            return None
        slot = min(candidates, key=lambda s: self._resident[s][1])
        depth, seq = self._resident[slot]
        path = self._paths[slot]
        ref = demote(slot, depth * self.chunk) if demote is not None else None
        self._remove(slot)
        if ref is not None:
            self._insert(ref, path, seq=seq)
        pool.reclaim(slot)
        _EVICTIONS.inc()
        return slot

    def clear(self, pool) -> None:
        """Reclaim every parked slot, release every tier ref, and empty the
        trie (e.g. after compile warmup, whose synthetic prompts must not
        act as donors). Counters are untouched — benches isolate arms by
        delta."""
        for resident in list(self._resident):
            self._remove(resident)
            if isinstance(resident, int):
                pool.reclaim(resident)
        self._root = _Node()
        self._paths.clear()
        self._t0_tokens = 0
        _RESIDENT.set(0)
        _RESIDENT_TOKENS.set(0)
