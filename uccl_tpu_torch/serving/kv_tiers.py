"""Tiered KV cache: prefix reuse beyond the device slots.

Port of ``uccl_tpu/serving/kv_tiers.py``. The prefix cache holds its
entries in parked device slots (tier 0), so its capacity is ``n_slots``.
:class:`TieredKVCache` puts a bounded host-memory pool (:class:`HostKVTier`,
tier 1) and optionally a remote peer (:class:`KvTierServer` reached through
:class:`RemoteKVTier`, tier 2, over the p2p plane's windowed SACK
``Channel``) behind the same
:class:`~uccl_tpu_torch.serving.prefix_cache.PrefixCache` trie:

* **Demotion is the eviction path**: a tier-0 LRU victim's rows export to
  tier 1 (``backend.export_slot_kv``: rows on the card are staged through
  host memory) instead of being dropped; a full tier 1 spills its LRU entry
  to tier 2, or drops it, counted, when there is no remote tier (or it
  failed ``remote_fail_limit`` times in a row). Demotion never blocks
  admission: an entry larger than the whole pool is dropped at once.
* **Promotion is a hit at depth**: a tier-1/tier-2 donor's entry is fetched,
  decoded and imported into the admitted request's own slot, which resumes
  the chunked prefill at ``prefill_pos = matched_len``. A tier-2 ref the
  peer has dropped is a stale miss.

``wire_dtype=None`` (the default) stores raw f32 rows: a promotion gives
back the demoted rows bit for bit, so the engine's exactness extends across
demote and promote. ``"fp8"`` / ``"int8"`` store the rows block-scaled
through the port's ``ops/quant`` codec, each element within the codec's
``amax / ROUND_TRIP_DIVISOR`` round trip; their refs carry ``exact=False``
and the engine stamps ``Request.cache_hit_exact``.

The remote tier's wire (MAGIC + JSON control frames, one CRC-checked
windowed ``writev`` per entry) is the JAX package's, so a port client
talks to a JAX server and the reverse.

Counters/gauges: ``kv_tier_hits_total{tier}``,
``kv_tier_promotions_total{tier}``, ``kv_tier_demotions_total{tier}``,
``kv_tier_drops_total{tier}``, ``kv_tier_resident_tokens{tier}``,
``kv_tier_resident_bytes{tier}``, ``kv_tier.promote`` /
``kv_tier.demote`` trace spans and ``p2p_bytes_total{verb="kv_tier"}`` for
the remote tier's ingress bytes.
"""

from __future__ import annotations

import json
import threading
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from uccl_tpu_torch import obs
from uccl_tpu_torch.ops import quant
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("P2P")

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
# the one shared p2p byte family (p2p/endpoint.py declares it): the remote
# tier's service-level ingress verb, beside weight_push/write/read
_P2P_BYTES = obs.counter(
    "p2p_bytes_total",
    "bytes moved through p2p endpoints by verb",
)

_MAGIC = b"UKT1"


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


# -- T2: the remote peer over the SACK channel --------------------------------
#
# Control plane: MAGIC + JSON on the channel's ordered path-0 send/recv
# (the weight_push framing); data plane: one windowed writev per entry blob
# into an advertised FifoItem window, CRC-verified before accept. Ops:
#
#   put:  c -> {op:put, key, nbytes, crc, meta}   s -> {op:win, fifo}
#         c writev(blob)  c -> {op:sent}          s -> {op:ok, evicted:[..]}
#   get:  c -> {op:get, key, fifo, max}           s -> {op:miss}
#                                     | s writev(blob) -> {op:hit, nbytes,
#                                                          crc, meta}
#   del:  c -> {op:del, key}                      s -> {op:ok}
#
# The server advertises capacity_bytes and enforces it by evicting ITS LRU
# entries on put; evicted keys ride back in the put response so the client
# invalidates their (now stale) trie refs eagerly instead of discovering
# the miss at promotion time.


def _send_msg(chan, msg: dict) -> None:
    chan.send(_MAGIC + json.dumps(msg).encode())


def _recv_msg(chan, timeout_ms: int) -> dict:
    raw = chan.recv(timeout_ms=timeout_ms)
    if not raw.startswith(_MAGIC):
        raise IOError(f"kv_tier: bad control frame {raw[:8]!r}")
    return json.loads(raw[len(_MAGIC):].decode())


class KvTierServer:
    """A remote KV tier peer: advertises ``capacity_bytes`` of entry
    storage over a :class:`~uccl_tpu_torch.p2p.channel.Channel` and serves
    put/get/del requests until the channel dies (the WeightPublisher
    serve_forever pattern)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}"
            )
        self.capacity_bytes = int(capacity_bytes)
        self.used_bytes = 0
        self._lock = threading.Lock()
        # key -> (blob, meta); insertion/touch order = LRU order
        self._store: "OrderedDict[int, tuple]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    # -- storage (lock-guarded: serve loop + tests may race) ---------------
    def _reserve(self, nbytes: int):
        """Make room for an ``nbytes`` entry; returns the evicted keys."""
        evicted = []
        with self._lock:
            while (self._store
                   and self.used_bytes + nbytes > self.capacity_bytes):
                k, (blob, _m) = self._store.popitem(last=False)
                self.used_bytes -= blob.nbytes
                evicted.append(int(k))
        return evicted

    def _put(self, key: int, blob: np.ndarray, meta: dict):
        with self._lock:
            self._store[key] = (blob, meta)
            self.used_bytes += blob.nbytes

    def _get(self, key: int):
        with self._lock:
            ent = self._store.get(key)
            if ent is not None:
                self._store.move_to_end(key)
            return ent

    def _del(self, key: int):
        with self._lock:
            ent = self._store.pop(key, None)
            if ent is not None:
                self.used_bytes -= ent[0].nbytes

    # -- the serve loop ----------------------------------------------------
    def serve(self, chan, timeout_ms: int = 60000) -> str:
        """Handle ONE request on ``chan`` (blocking). Returns the op."""
        req = _recv_msg(chan, timeout_ms)
        op = req.get("op")
        if op == "put":
            nbytes = int(req["nbytes"])
            if nbytes > self.capacity_bytes:
                _send_msg(chan, {"op": "err",
                                 "msg": f"entry {nbytes}B > capacity "
                                        f"{self.capacity_bytes}B"})
                return op
            evicted = self._reserve(nbytes)
            buf = np.zeros(nbytes, np.uint8)
            ep = chan.ep
            mr = ep.reg(buf)
            try:
                _send_msg(chan, {"op": "win",
                                 "fifo": ep.advertise(mr).hex()})
                sent = _recv_msg(chan, timeout_ms)
                if sent.get("op") != "sent":
                    raise IOError(f"kv_tier: expected sent, got {sent}")
                if zlib.crc32(buf) != int(req["crc"]):
                    _send_msg(chan, {"op": "err", "msg": "CRC mismatch"})
                    return op
            finally:
                ep.dereg(mr)
            self._put(int(req["key"]), buf, req["meta"])
            _P2P_BYTES.inc(nbytes, verb="kv_tier")
            _send_msg(chan, {"op": "ok", "evicted": evicted})
            return op
        if op == "get":
            ent = self._get(int(req["key"]))
            limit = int(req.get("max", 0))
            if ent is None or (limit and ent[0].nbytes > limit):
                # unknown key, or an entry too large for this client's
                # advertised window (the writev would overrun its
                # registration): both are a miss to this client
                _send_msg(chan, {"op": "miss"})
                return op
            blob, meta = ent
            chan.writev([blob], [bytes.fromhex(req["fifo"])],
                        timeout_ms=timeout_ms)
            _send_msg(chan, {"op": "hit", "nbytes": int(blob.nbytes),
                             "crc": zlib.crc32(blob), "meta": meta})
            return op
        if op == "del":
            self._del(int(req["key"]))
            _send_msg(chan, {"op": "ok"})
            return op
        raise IOError(f"kv_tier: unknown op {req}")

    def serve_forever(self, chan, timeout_ms: int = 60000):
        """Daemon helper: serve requests on ``chan`` until it dies. A
        dying loop is never silent (the Channel CC-probe rule): the
        terminating exception is counted on
        ``kv_tier_serve_errors_total{reason}``; a timed-out idle recv is
        the one quiet exit."""

        def loop():
            while True:
                try:
                    self.serve(chan, timeout_ms)
                except TimeoutError:
                    return  # idle channel: no request within the window
                except Exception as e:
                    obs.counter(
                        "kv_tier_serve_errors_total",
                        "kv-tier serve loops terminated by an exception, "
                        "by exception class",
                    ).inc(reason=type(e).__name__)
                    _log.warning("kv_tier: serve loop terminating (%s: %s)",
                                 type(e).__name__, e)
                    return

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t


class RemoteKVTier:
    """Client side of the T2 tier: put/get/del against a
    :class:`KvTierServer` over one channel. Maintains a registered scratch
    window of ``max_entry_bytes`` for gets (one registration per client,
    not per fetch) and byte/token accounting for the t2 gauges."""

    def __init__(self, chan, max_entry_bytes: int,
                 timeout_ms: int = 60000):
        self.chan = chan
        self.timeout_ms = timeout_ms
        self.max_entry_bytes = int(max_entry_bytes)
        self._buf = np.zeros(self.max_entry_bytes, np.uint8)
        self._mr = chan.ep.reg(self._buf)
        self.used_bytes = 0
        self.used_tokens = 0

    def put(self, key: int, blob: np.ndarray, meta: dict):
        """Ship one entry; returns the server's evicted-key list (stale
        refs the caller must invalidate), or None when the entry is
        refused — larger than the server's capacity, or larger than this
        client's ``max_entry_bytes`` scratch window (stored, it could
        never be fetched back without the server writing past the
        window's registration)."""
        blob = np.ascontiguousarray(np.asarray(blob, np.uint8))
        if blob.nbytes > self.max_entry_bytes:
            return None
        _send_msg(self.chan, {"op": "put", "key": int(key),
                              "nbytes": int(blob.nbytes),
                              "crc": zlib.crc32(blob), "meta": meta})
        win = _recv_msg(self.chan, self.timeout_ms)
        if win.get("op") == "err":
            return None
        if win.get("op") != "win":
            raise IOError(f"kv_tier: expected win, got {win}")
        self.chan.writev([blob], [bytes.fromhex(win["fifo"])],
                         timeout_ms=self.timeout_ms)
        _send_msg(self.chan, {"op": "sent"})
        ok = _recv_msg(self.chan, self.timeout_ms)
        if ok.get("op") != "ok":
            raise IOError(f"kv_tier: put rejected: {ok}")
        return [int(k) for k in ok.get("evicted", [])]

    def get(self, key: int) -> Optional[Tuple[np.ndarray, dict]]:
        """Fetch one entry into the scratch window; CRC-verified. None on
        a miss (the server LRU-dropped it — a stale ref)."""
        fifo = self.chan.ep.advertise(self._mr)
        _send_msg(self.chan, {"op": "get", "key": int(key),
                              "fifo": fifo.hex(),
                              "max": self.max_entry_bytes})
        resp = _recv_msg(self.chan, self.timeout_ms)
        if resp.get("op") == "miss":
            return None
        if resp.get("op") != "hit":
            raise IOError(f"kv_tier: expected hit, got {resp}")
        nbytes = int(resp["nbytes"])
        if nbytes > self.max_entry_bytes:
            raise IOError(
                f"kv_tier: peer claims a {nbytes}B entry landed in a "
                f"{self.max_entry_bytes}B window"
            )
        blob = self._buf[:nbytes].copy()
        if zlib.crc32(blob) != int(resp["crc"]):
            raise IOError("kv_tier: get CRC mismatch (wire corruption "
                          "past the SACK layer)")
        _P2P_BYTES.inc(nbytes, verb="kv_tier")
        return blob, resp["meta"]

    def delete(self, key: int) -> None:
        _send_msg(self.chan, {"op": "del", "key": int(key)})
        ok = _recv_msg(self.chan, self.timeout_ms)
        if ok.get("op") != "ok":
            raise IOError(f"kv_tier: del rejected: {ok}")

    def close(self) -> None:
        self.chan.ep.dereg(self._mr)


# -- the tier manager ---------------------------------------------------------


class TieredKVCache:
    """Demotion/promotion policy over {T1 host pool, optional T2 remote},
    attached behind one engine's :class:`PrefixCache`.

    The engine calls :meth:`demote` from its eviction path (via
    ``PrefixCache.evict_lru(demote=...)``) and :meth:`promote` from its
    hit path; the trie calls :meth:`release` whenever it drops a tier-ref
    resident. Invariants (tested): an entry lives in exactly one tier;
    demotion never blocks admission (a full T1 spills to T2 or DROPS,
    counted); promotion writes only the admitted request's own slot, never
    evicting the donor entry it serves.
    """

    def __init__(self, host_bytes: int, *,
                 wire_dtype: Optional[str] = None, block: int = 32,
                 remote: Optional[RemoteKVTier] = None,
                 remote_fail_limit: int = 3):
        self.wire_dtype = quant.resolve_wire_dtype(wire_dtype)
        self.block = int(block)
        self.t1 = HostKVTier(host_bytes)
        self.remote = remote
        self.remote_fail_limit = int(remote_fail_limit)
        self.backend = None
        self.cache = None
        self._next_key = 0
        self._remote_failures = 0  # consecutive comms failures
        self._remote_dead = False  # latched after remote_fail_limit
        # our view of what lives on the remote peer: key -> ref (pruned on
        # eviction notices, deletes, and discovered-stale gets)
        self._t2_refs: Dict[int, TierRef] = {}

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
        if self.remote is not None:
            _RES_TOKENS.set(self.remote.used_tokens, tier="t2")
            _RES_BYTES.set(self.remote.used_bytes, tier="t2")

    def count_hit(self, tier: str) -> None:
        """Per-tier hit accounting (the engine calls this for t0 hits too,
        so the tier split sums to ``prefix_cache_hits_total``)."""
        _TIER_HITS.inc(tier=tier)

    # -- demotion (the eviction path) --------------------------------------
    def demote(self, slot: int, n_tokens: int) -> Optional[TierRef]:
        """Export a T0 eviction victim's rows [0, n_tokens) into T1 and
        return the tier ref to splice into the trie — or None when the
        entry cannot be kept (empty, or larger than the whole host pool:
        counted on ``kv_tier_drops_total{tier="t1"}``). Never blocks: a
        full T1 spills its LRU entries down (or out) first."""
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

    def _remote_failure(self, verb: str, exc: Exception) -> None:
        """Count one remote-tier comms failure. After ``remote_fail_limit``
        CONSECUTIVE failures the tier latches dead: spills drop (counted)
        and T2 hits degrade to misses without touching the channel again —
        a dying peer costs at most ``remote_fail_limit`` timeouts."""
        self._remote_failures += 1
        if self._remote_failures >= self.remote_fail_limit:
            self._remote_dead = True
        _log.warning(
            "kv_tier: t2 %s failed (%s: %s) — failure %d/%d%s", verb,
            type(exc).__name__, exc, self._remote_failures,
            self.remote_fail_limit,
            "; remote tier latched dead" if self._remote_dead else "",
        )

    def _spill_lru(self) -> None:
        """Move T1's LRU entry down to T2 (or drop it, counted) — the
        trie's resident swaps via ``replace_ref`` at the SAME path and LRU
        stamp, so the entry keeps its identity and recency. A remote-tier
        failure (channel timeout, refused put) degrades to the same
        counted drop: demotion never raises into the admission path."""
        key = self.t1.lru_key()
        blob, meta, ref = self.t1.pop(key)
        new_ref = None
        if self.remote is not None and not self._remote_dead:
            try:
                evicted = self.remote.put(key, blob, meta)
            except Exception as e:  # entry already out of T1: drop it
                evicted = None
                self._remote_failure("put", e)
            else:
                self._remote_failures = 0
            if evicted is not None:
                new_ref = TierRef("t2", key, ref.tokens, ref.exact,
                                  int(blob.nbytes))
                self._t2_refs[key] = new_ref
                self.remote.used_bytes += int(blob.nbytes)
                self.remote.used_tokens += int(ref.tokens)
                _DEMOTIONS.inc(tier="t2")
                # the peer made room by LRU-dropping: invalidate those
                # entries' refs NOW instead of missing at promotion time
                for ek in evicted:
                    self._invalidate_t2(ek)
        if new_ref is None:
            _DROPS.inc(tier="t1")
        self.cache.replace_ref(ref, new_ref)
        self._stamp()

    def _invalidate_t2(self, key: int, drop_trie: bool = True) -> None:
        """Forget a remote entry (eviction notice, discovered-stale get).
        ``drop_trie=False`` releases only this side's accounting and
        leaves the trie resident to the caller — :meth:`promote`'s miss
        path, whose contract already hands the trie drop to the engine
        (dropping here too would double-remove and KeyError)."""
        stale = self._t2_refs.pop(key, None)
        if stale is None:
            return
        self.remote.used_bytes -= stale.nbytes
        self.remote.used_tokens -= stale.tokens
        _DROPS.inc(tier="t2")
        if drop_trie and stale in self.cache._resident:
            self.cache.replace_ref(stale, None)

    # -- promotion (the hit path) ------------------------------------------
    def promote(self, ref: TierRef, slot: int, n_tokens: int) -> bool:
        """Serve a deep-tier hit: fetch ``ref``'s entry, decode, and import
        rows [0, n_tokens) into the admitted request's own ``slot`` (which
        then resumes prefill at ``n_tokens``). The donor entry is read,
        never moved — promotion cannot evict what it serves. Returns False
        on a stale ref (the caller treats the admission as a cold miss and
        drops the ref)."""
        if n_tokens > ref.tokens:
            raise ValueError(
                f"promote of {n_tokens} tokens from a {ref.tokens}-token "
                f"entry ({ref})"
            )
        with obs.span("kv_tier.promote", track="engine", tier=ref.tier,
                      slot=slot, tokens=n_tokens, exact=ref.exact):
            if ref.tier == "t1":
                ent = self.t1.get(ref.key)
                if ent is None:
                    return False
                blob, meta, _ = ent
            else:
                got = None
                if self.remote is not None and not self._remote_dead:
                    try:
                        got = self.remote.get(ref.key)
                    except Exception as e:  # degrade to a stale miss
                        self._remote_failure("get", e)
                    else:
                        self._remote_failures = 0
                if got is None:
                    # release OUR accounting only: the caller is the
                    # single owner of the trie drop on a stale ref
                    self._invalidate_t2(ref.key, drop_trie=False)
                    return False
                blob, meta = got
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
        """Free a dropped trie entry's store bytes. Idempotent — the
        spill/invalidate paths move bytes BEFORE swapping the resident, so
        the release embedded in ``PrefixCache._remove`` is a no-op for
        them."""
        if ref.tier == "t1":
            if self.t1.pop(ref.key) is not None:
                self._stamp()
            return
        if ref.key in self._t2_refs:
            del self._t2_refs[ref.key]
            self.remote.used_bytes -= ref.nbytes
            self.remote.used_tokens -= ref.tokens
            if not self._remote_dead:
                try:
                    self.remote.delete(ref.key)
                except Exception:
                    pass  # best-effort: the peer's LRU reclaims it anyway
            self._stamp()
