"""Tiered KV cache: prefix reuse beyond the device slots, the local tiers.

Port of ``uccl_tpu/serving/kv_tiers.py``, its device and host tiers. The
prefix cache holds its entries in parked device slots (tier 0), so its
capacity is ``n_slots``. :class:`TieredKVCache` puts a bounded host-memory
pool (:class:`HostKVTier`, tier 1) behind the same
:class:`~uccl_tpu_torch.serving.prefix_cache.PrefixCache` trie:

* **Demotion is the eviction path**: a tier-0 LRU victim's rows export to
  tier 1 (``backend.export_slot_kv``) instead of being dropped; a full
  tier 1 drops its own LRU entry, counted. Demotion never blocks admission:
  an entry larger than the whole pool is dropped at once.
* **Promotion is a hit at depth**: a tier-1 donor's entry is decoded and
  imported into the admitted request's own slot, which resumes the chunked
  prefill at ``prefill_pos = matched_len``.

``wire_dtype=None`` (the default) stores raw f32 rows: a promotion gives
back the demoted rows bit for bit, so the engine's exactness extends across
demote and promote. ``"fp8"`` / ``"int8"`` store the rows block-scaled
through the port's ``ops/quant`` codec, each element within the codec's
``amax / ROUND_TRIP_DIVISOR`` round trip; their refs carry ``exact=False``
and the engine stamps ``Request.cache_hit_exact``.

The remote tier (``RemoteKVTier``, ``KvTierServer``) rides the p2p plane,
which is not ported yet: both raise ``NotImplementedError`` naming ROADMAP
queue A item 14.

Counters/gauges: ``kv_tier_hits_total{tier}``,
``kv_tier_promotions_total{tier}``, ``kv_tier_demotions_total{tier}``,
``kv_tier_drops_total{tier}``, ``kv_tier_resident_tokens{tier}``,
``kv_tier_resident_bytes{tier}``, and ``kv_tier.promote`` /
``kv_tier.demote`` trace spans.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from uccl_tpu_torch import obs
from uccl_tpu_torch.ops import quant

_TIER_HITS = obs.counter(
    "kv_tier_hits_total",
    "prefix-cache hits served by tier (t0 = parked-slot copy, t1/t2 = "
    "promotion from the host pool / a remote peer)",
)
_PROMOTIONS = obs.counter(
    "kv_tier_promotions_total",
    "tier entries imported back into a device slot to serve a hit, by "
    "source tier",
)
_DEMOTIONS = obs.counter(
    "kv_tier_demotions_total",
    "entries moved DOWN a tier under capacity pressure (t1 = device slot "
    "exported to the host pool, t2 = host entry spilled to the remote peer)",
)
_DROPS = obs.counter(
    "kv_tier_drops_total",
    "tier entries dropped instead of demoted (no deeper tier, oversize, or "
    "a stale remote ref) — the counted never-blocks-admission escape hatch",
)
_RES_TOKENS = obs.gauge(
    "kv_tier_resident_tokens",
    "prompt tokens resident per deep tier (sum of entry token counts)",
)
_RES_BYTES = obs.gauge(
    "kv_tier_resident_bytes",
    "at-rest bytes resident per deep tier (encoded blobs, scales included)",
)


class TierRef:
    """One deep-tier trie resident: names WHERE an entry's bytes live
    (``tier`` ∈ {"t1", "t2"}, store key ``key``), how many prompt-prefix
    token rows it holds (``tokens``), whether a promotion reproduces the
    donor rows bit-exactly (``exact`` — False for quantized-at-rest
    entries), and its at-rest size (``nbytes``). Hashed by identity: the
    trie treats it as an opaque non-int resident."""

    __slots__ = ("tier", "key", "tokens", "exact", "nbytes")

    def __init__(self, tier: str, key: int, tokens: int, exact: bool,
                 nbytes: int):
        self.tier = tier
        self.key = key
        self.tokens = tokens
        self.exact = exact
        self.nbytes = nbytes

    def __repr__(self):
        return (f"TierRef({self.tier}, key={self.key}, "
                f"tokens={self.tokens}, exact={self.exact})")


# -- the at-rest codec --------------------------------------------------------
#
# One entry = the victim slot's exported (k, v) rows, each [L, n, Hkv, D]
# f32. Lossless mode concatenates the raw bytes (bit-exact round trip);
# quantized mode block-scales each tensor along D through the port's
# ops/quant codec and stores payload + f32 scale sidecar. The blob is one
# flat uint8 array, the meta dict its self-description.


def encode_entry(k_rows: np.ndarray, v_rows: np.ndarray,
                 wire_dtype: Optional[str] = None,
                 block: int = 32) -> Tuple[np.ndarray, dict]:
    """Encode one entry's KV rows for at-rest storage.

    Returns ``(blob, meta)``: a flat uint8 array and the dict that decodes
    it. ``wire_dtype=None`` stores raw f32 (bit-exact); "fp8"/"int8" stores
    block-scaled payloads (+ per-block f32 scales) along the head dim.
    """
    k_rows = np.ascontiguousarray(np.asarray(k_rows, np.float32))
    v_rows = np.ascontiguousarray(np.asarray(v_rows, np.float32))
    if k_rows.shape != v_rows.shape:
        raise ValueError(
            f"k/v row shapes differ: {k_rows.shape} vs {v_rows.shape}"
        )
    shape = list(k_rows.shape)
    wire = quant.resolve_wire_dtype(wire_dtype)
    if wire is None:
        blob = np.concatenate([k_rows.reshape(-1).view(np.uint8),
                               v_rows.reshape(-1).view(np.uint8)])
        return blob, {"enc": "raw", "shape": shape}
    g = quant.adapt_block(shape[-1], block)
    parts = []
    for t in (k_rows, v_rows):
        q, scale = quant.quantize_block(torch.from_numpy(t), wire, g)
        parts.append(q.contiguous().view(torch.uint8).reshape(-1).numpy())
        parts.append(scale.to(torch.float32).reshape(-1).numpy().view(np.uint8))
    nb = shape[-1] // g  # adapt_block returns a divisor: exact block count
    return np.concatenate(parts), {
        "enc": wire, "shape": shape, "block": g, "nblocks": nb,
    }


def decode_entry(blob: np.ndarray, meta: dict
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`encode_entry`: ``(k_rows, v_rows)`` f32, each of
    ``meta["shape"]``. Raw entries are bit-exact; quantized entries carry
    the codec's documented round-trip error."""
    blob = np.asarray(blob, np.uint8)
    shape = tuple(int(s) for s in meta["shape"])
    n = int(np.prod(shape))
    if meta["enc"] == "raw":
        if blob.nbytes != 2 * n * 4:
            raise ValueError(
                f"raw entry blob {blob.nbytes}B != 2x{n} f32"
            )
        half = n * 4
        k = blob[:half].view(np.float32).reshape(shape)
        v = blob[half:].view(np.float32).reshape(shape)
        return k.copy(), v.copy()
    g = int(meta["block"])
    nb = int(meta["nblocks"])
    pdt = quant.wire_payload_dtype(meta["enc"])
    size = torch.empty((), dtype=pdt).element_size()
    scale_shape = shape[:-1] + (nb,)
    sn = int(np.prod(scale_shape))
    per = n * size + sn * 4
    if blob.nbytes != 2 * per:
        raise ValueError(
            f"{meta['enc']} entry blob {blob.nbytes}B != 2x{per}B"
        )
    out = []
    for i in range(2):
        seg = blob[i * per:(i + 1) * per]
        q = torch.from_numpy(seg[:n * size].copy()).view(pdt).reshape(shape)
        scale = torch.from_numpy(seg[n * size:].copy().view(np.float32)
                                 ).reshape(scale_shape)
        out.append(quant.dequantize_block(q, scale, g,
                                          dtype=torch.float32).numpy())
    return out[0], out[1]


# -- T1: the bounded host pool ------------------------------------------------


class HostKVTier:
    """Bounded host-memory entry store with LRU order — the T1 tier.

    Pure storage + accounting; the demote/spill/promote POLICY lives in
    :class:`TieredKVCache` (and the LRU *authority* for trie entries stays
    the trie's seq stamps — this order only breaks ties for spill victims,
    and the two agree by construction: demotions insert in eviction order
    and gets touch both)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}"
            )
        self.capacity_bytes = int(capacity_bytes)
        self.used_bytes = 0
        self.used_tokens = 0
        # key -> (blob, meta, ref); insertion/touch order = LRU order
        self._store: "OrderedDict[int, tuple]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: int) -> bool:
        return key in self._store

    def put(self, key: int, blob: np.ndarray, meta: dict, ref) -> None:
        if key in self._store:
            raise ValueError(f"t1 key {key} already stored")
        self._store[key] = (blob, meta, ref)
        self.used_bytes += int(blob.nbytes)
        self.used_tokens += int(ref.tokens)

    def get(self, key: int):
        ent = self._store.get(key)
        if ent is not None:
            self._store.move_to_end(key)
        return ent

    def pop(self, key: int):
        ent = self._store.pop(key, None)
        if ent is not None:
            self.used_bytes -= int(ent[0].nbytes)
            self.used_tokens -= int(ent[2].tokens)
        return ent

    def lru_key(self) -> Optional[int]:
        return next(iter(self._store), None)


# -- T2: the remote peer (the p2p plane, not ported yet) ----------------------


def _needs_p2p(name: str) -> str:
    return (f"{name} needs the p2p plane, which is not ported yet "
            "(ROADMAP queue A item 14)")


class KvTierServer:
    """The remote KV tier's peer: rides the p2p plane (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_needs_p2p("KvTierServer"))


class RemoteKVTier:
    """The remote KV tier's client: rides the p2p plane (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_needs_p2p("RemoteKVTier"))


# -- the tier manager ---------------------------------------------------------


class TieredKVCache:
    """Demotion/promotion policy over the host tier, attached behind one
    engine's :class:`PrefixCache`.

    The engine calls :meth:`demote` from its eviction path (via
    ``PrefixCache.evict_lru(demote=...)``) and :meth:`promote` from its
    hit path; the trie calls :meth:`release` whenever it drops a tier-ref
    resident. Invariants (tested): an entry lives in exactly one tier;
    demotion never blocks admission (a full tier 1 drops its LRU entry,
    counted); promotion writes only the admitted request's own slot, never
    evicting the donor entry it serves. ``remote`` (the tier-2 peer) needs
    the p2p plane and raises.
    """

    def __init__(self, host_bytes: int, *,
                 wire_dtype: Optional[str] = None, block: int = 32,
                 remote=None):
        if remote is not None:
            raise NotImplementedError(_needs_p2p("a remote KV tier"))
        self.wire_dtype = quant.resolve_wire_dtype(wire_dtype)
        self.block = int(block)
        self.t1 = HostKVTier(host_bytes)
        self.backend = None
        self.cache = None
        self._next_key = 0

    @property
    def exact(self) -> bool:
        """Whether at-rest entries round-trip bit-exactly (lossless f32)."""
        return self.wire_dtype is None

    def attach(self, backend, cache) -> None:
        """Bind the engine's backend (the KV byte mover) and trie (the
        index). Called by ``ServingEngine.__init__``."""
        self.backend = backend
        self.cache = cache
        cache.attach_tiers(self)

    # -- gauges ------------------------------------------------------------
    def _stamp(self) -> None:
        _RES_TOKENS.set(self.t1.used_tokens, tier="t1")
        _RES_BYTES.set(self.t1.used_bytes, tier="t1")

    def count_hit(self, tier: str) -> None:
        """Per-tier hit accounting (the engine calls this for t0 hits too,
        so the tier split sums to ``prefix_cache_hits_total``)."""
        _TIER_HITS.inc(tier=tier)

    # -- demotion (the eviction path) --------------------------------------
    def demote(self, slot: int, n_tokens: int) -> Optional[TierRef]:
        """Export a tier-0 eviction victim's rows [0, n_tokens) into tier 1
        and return the tier ref to splice into the trie, or None when the
        entry cannot be kept (empty, or larger than the whole host pool:
        counted on ``kv_tier_drops_total{tier="t1"}``). Never blocks: a
        full tier 1 drops its LRU entries first."""
        if n_tokens < 1 or self.backend is None:
            return None
        with obs.span("kv_tier.demote", track="engine", tier="t1",
                      slot=slot, tokens=n_tokens):
            k_rows, v_rows = self.backend.export_slot_kv(slot, 0, n_tokens)
            blob, meta = encode_entry(k_rows, v_rows, self.wire_dtype,
                                      self.block)
            if blob.nbytes > self.t1.capacity_bytes:
                _DROPS.inc(tier="t1")
                return None
            while (self.t1.used_bytes + blob.nbytes
                   > self.t1.capacity_bytes):
                self._spill_lru()
            key = self._next_key
            self._next_key += 1
            ref = TierRef("t1", key, n_tokens, self.exact,
                          int(blob.nbytes))
            self.t1.put(key, blob, meta, ref)
        _DEMOTIONS.inc(tier="t1")
        self._stamp()
        return ref

    def _spill_lru(self) -> None:
        """Drop tier 1's LRU entry, counted (with no deeper tier there is
        nowhere to spill it): the trie's resident goes with it."""
        key = self.t1.lru_key()
        _, _, ref = self.t1.pop(key)
        _DROPS.inc(tier="t1")
        self.cache.replace_ref(ref, None)
        self._stamp()

    # -- promotion (the hit path) ------------------------------------------
    def promote(self, ref: TierRef, slot: int, n_tokens: int) -> bool:
        """Serve a deep-tier hit: decode ``ref``'s entry and import rows
        [0, n_tokens) into the admitted request's own ``slot`` (which then
        resumes prefill at ``n_tokens``). The donor entry is read, never
        moved. Returns False on a stale ref (the caller treats the
        admission as a cold miss and drops the ref)."""
        if n_tokens > ref.tokens:
            raise ValueError(
                f"promote of {n_tokens} tokens from a {ref.tokens}-token "
                f"entry ({ref})"
            )
        with obs.span("kv_tier.promote", track="engine", tier=ref.tier,
                      slot=slot, tokens=n_tokens, exact=ref.exact):
            ent = self.t1.get(ref.key) if ref.tier == "t1" else None
            if ent is None:
                return False
            blob, meta, _ = ent
            k_rows, v_rows = decode_entry(blob, meta)
            self.backend.import_slot_kv(
                slot, k_rows[:, :n_tokens], v_rows[:, :n_tokens],
                length=n_tokens,
            )
        _PROMOTIONS.inc(tier=ref.tier)
        _TIER_HITS.inc(tier=ref.tier)
        return True

    # -- release (the trie dropped a ref) ----------------------------------
    def release(self, ref: TierRef) -> None:
        """Free a dropped trie entry's store bytes. Idempotent: the spill
        path pops the bytes BEFORE dropping the resident, so the release
        embedded in ``PrefixCache._remove`` is a no-op for it."""
        if ref.tier == "t1" and self.t1.pop(ref.key) is not None:
            self._stamp()
