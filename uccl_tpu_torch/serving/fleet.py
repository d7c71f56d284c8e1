"""Fleet prefix-cache directory: N per-worker tries become one cache.

Port of ``uccl_tpu/serving/fleet.py`` (host code; the KV rows it moves are
exported from and imported into the engines' slot pools on their device).
Each worker's trie is a private cache: a system prompt computed on worker A
is recomputed on worker B. This module is the cross-worker layer, UCCL's
P2P pillar (NIXL-style initiator-target KV transfer) as architecture:

* :class:`FleetDirectory` — a **directory of resident prefixes** over the
  p2p :class:`~uccl_tpu_torch.p2p.store.StoreClient`. Each worker registers
  every chunk-aligned prefix depth of every entry its
  :class:`~uccl_tpu_torch.serving.prefix_cache.PrefixCache` parks (keyed by
  a digest of the trie's own namespaced chunk-key bytes, so the
  ``tenant|adapter@version`` isolation holds fleet-wide by construction),
  and tombstones them on eviction. SET/GET are the only store verbs used:
  a tombstone is an overwrite, a dead owner's entries are invalidated by
  any survivor, and the store server needs no new ops.

* :class:`FleetCachePublisher` — the trie listener. At park/insert time
  (on the engine's single-threaded step, while the slot still holds the
  rows) it eagerly exports + encodes the resident's KV into the worker's
  :class:`FleetKvServer` blob store and publishes the directory entries;
  at remove time it withdraws them. Eager encoding is the concurrency
  design: peer fetches are served entirely from the lock-guarded blob
  store by daemon threads — no serve thread ever touches the backend.

* :class:`FleetKvServer` / :class:`FleetCacheClient` — the wire path. The
  server is the remote KV tier's
  :class:`~uccl_tpu_torch.serving.kv_tiers.KvTierServer` behind a
  :class:`~uccl_tpu_torch.p2p.channel.ChannelAcceptor`; the client lazily
  dials owners advertised in the store and fetches over
  :class:`~uccl_tpu_torch.serving.kv_tiers.RemoteKVTier` (CRC-verified,
  counted on ``p2p_bytes_total{verb="kv_tier"}``), importing rows
  [0, matched) into the admitted request's OWN slot.

The directory, blob keys and wire frames are the JAX package's, so port
and JAX workers can share one store.

Staleness discipline (tested): the directory is a *hint*, never an
authority. A stale entry (owner evicted the blob, or died) degrades to
the cold miss the admission already counted — ``fleet_cache_stale_total``
marks it, the entry is tombstoned, and the request prefills from 0,
bit-exact. Wrong bytes are impossible: directory keys digest the exact
namespaced token bytes, blob keys are never reused, and the wire path is
CRC-checked. A fetched prefix then self-propagates: when the request
retires, its own trie parks (and re-publishes) the prefix locally.

Counters/gauges: ``fleet_cache_hits_total``, ``fleet_cache_stale_total``,
``fleet_cache_errors_total{reason}``, ``fleet_cache_tokens_imported_total``,
``fleet_dir_invalidations_total``, gauge ``fleet_dir_resident_entries``.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from uccl_tpu_torch import obs
from uccl_tpu_torch.serving.kv_tiers import (
    KvTierServer,
    RemoteKVTier,
    decode_entry,
    encode_entry,
)
from uccl_tpu_torch.serving.prefix_cache import PrefixCache
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("P2P")

_HITS = obs.counter(
    "fleet_cache_hits_total",
    "local prefix-cache misses served by a fleet peer: directory hit + "
    "remote fetch + CRC-verified import into the admitted slot",
)
_STALE = obs.counter(
    "fleet_cache_stale_total",
    "directory hits whose owner no longer held the entry at fetch time "
    "(evicted or dead) — degraded to the already-counted cold miss",
)
_ERRORS = obs.counter(
    "fleet_cache_errors_total",
    "fleet cache-plane failures by reason (publish/fetch/peer-dial) — "
    "every one degrades to a local miss, never an engine fault",
)
_TOKENS_IMPORTED = obs.counter(
    "fleet_cache_tokens_imported_total",
    "prompt tokens whose prefill compute was skipped via a cross-worker "
    "fetch (the fleet-tier analogue of prefix_cache_tokens_reused_total)",
)
_INVALIDATIONS = obs.counter(
    "fleet_dir_invalidations_total",
    "directory entries tombstoned because their owner was declared dead "
    "(chaos/heartbeat path) or discovered stale at fetch time",
)
_DIR_RESIDENT = obs.gauge(
    "fleet_dir_resident_entries",
    "directory entries this worker currently publishes (one per "
    "chunk-aligned prefix depth per resident)",
)

_DIR_PREFIX = "fdir/"
_IDX_PREFIX = "fdir_idx/"
_EP_PREFIX = "fleet_ep/"
_TOMBSTONE = b"{}"


def _digest(path: List[bytes]) -> str:
    """Directory key digest of a chunk-key path. The path bytes ARE the
    trie's namespaced chunk keys (``ns + \\x00 + token bytes``), so equal
    digests mean equal tokens in the same tenant/adapter namespace."""
    return hashlib.sha1(b"".join(path)).hexdigest()


class _ChunkShim:
    """Duck-typed ``self`` for :meth:`PrefixCache._chunks`, so directory
    lookups compute byte-identical keys to the tries they index (one
    implementation, zero drift)."""

    __slots__ = ("chunk",)

    def __init__(self, chunk: int):
        self.chunk = chunk


class FleetDirectory:
    """The shared prefix directory, per-worker view.

    Layout over the store (SET/GET only):

    * ``fdir/<sha1(path[:d])>`` -> JSON ``{"o": owner, "k": blob key,
      "t": d*chunk, "x": exact, "nb": blob bytes}`` — one entry per
      published prefix depth; ``{}`` is a tombstone.
    * ``fdir_idx/<worker>`` -> JSON list of the dir keys ``worker`` has
      ever published — the invalidation fan-out for a dead owner. Only
      its owner ever writes it (no cross-writer race).

    Publishing every depth is what makes lookup a longest-prefix-match:
    a requester probes its own usable depths deepest-first and the first
    live entry wins. Last-writer-wins on a shared shallow prefix is fine —
    the directory is a hint and the fetch path tolerates staleness.
    """

    def __init__(self, store, worker: str, chunk: int):
        self.store = store
        self.worker = worker
        self.chunk = int(chunk)
        self._shim = _ChunkShim(self.chunk)
        # dir key -> blob key we last wrote there (our local mirror; a
        # peer may have overwritten since — fetch staleness covers that)
        self._mine: Dict[str, int] = {}
        self._indexed: set = set()  # every dir key ever in our index
        self._lock = threading.Lock()

    # -- publish side ------------------------------------------------------
    def publish(self, path: List[bytes], fleet_key: int, exact: bool,
                nbytes: int) -> List[str]:
        """Register one resident at EVERY prefix depth of ``path``;
        returns the dir keys written (the withdraw handle)."""
        keys = []
        with self._lock:
            for d in range(1, len(path) + 1):
                dk = _DIR_PREFIX + _digest(path[:d])
                val = {"o": self.worker, "k": int(fleet_key),
                       "t": d * self.chunk, "x": bool(exact),
                       "nb": int(nbytes)}
                self.store.set(dk, json.dumps(val).encode())
                self._mine[dk] = int(fleet_key)
                keys.append(dk)
            new_idx = [k for k in keys if k not in self._indexed]
            if new_idx:
                self._indexed.update(new_idx)
                self.store.set(_IDX_PREFIX + self.worker,
                               json.dumps(sorted(self._indexed)).encode())
            _DIR_RESIDENT.set(len(self._mine))
        return keys

    def withdraw(self, dir_keys: List[str], fleet_key: int) -> None:
        """Tombstone the dir keys still pointing at ``fleet_key``. A key
        since re-published for a newer local resident is left alone."""
        with self._lock:
            for dk in dir_keys:
                if self._mine.get(dk) != int(fleet_key):
                    continue
                self.store.set(dk, _TOMBSTONE)
                del self._mine[dk]
            _DIR_RESIDENT.set(len(self._mine))

    # -- lookup side -------------------------------------------------------
    def _keys_of(self, prompt, ns: str) -> List[bytes]:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        usable = (int(prompt.size) - 1) // self.chunk
        if usable < 1:
            return []
        return list(PrefixCache._chunks(self._shim, prompt, usable, ns))

    def lookup(self, prompt, ns: str = "") -> Optional[dict]:
        """Deepest-first longest-prefix-match over the directory. Returns
        ``{"owner", "key", "tokens", "exact", "nbytes", "dir_key"}`` for
        the deepest live entry, or None. Capped at the requester's own
        usable depth, so ``tokens`` is always a resumable boundary."""
        path = self._keys_of(prompt, ns)
        for d in range(len(path), 0, -1):
            dk = _DIR_PREFIX + _digest(path[:d])
            raw = self.store.get(dk)
            if raw is None:
                continue
            try:
                val = json.loads(raw.decode())
            except ValueError:
                continue
            if not val.get("o"):
                continue  # tombstone
            return {"owner": val["o"], "key": int(val["k"]),
                    "tokens": int(val["t"]), "exact": bool(val.get("x", True)),
                    "nbytes": int(val.get("nb", 0)), "dir_key": dk}
        return None

    def tombstone(self, dir_key: str) -> None:
        """Kill one directory entry discovered stale at fetch time (any
        worker may do this — the owner already lost the bytes)."""
        self.store.set(dir_key, _TOMBSTONE)
        _INVALIDATIONS.inc()

    def invalidate_owner(self, dead: str) -> int:
        """Tombstone every directory entry still owned by ``dead`` (the
        chaos/heartbeat path: a survivor sweeps the dead worker's index so
        the fleet stops chasing a peer that cannot answer). Idempotent;
        returns the number of entries killed."""
        raw = self.store.get(_IDX_PREFIX + dead)
        if raw is None:
            return 0
        try:
            keys = json.loads(raw.decode())
        except ValueError:
            return 0
        killed = 0
        for dk in keys:
            cur = self.store.get(dk)
            if cur is None:
                continue
            try:
                val = json.loads(cur.decode())
            except ValueError:
                continue
            if val.get("o") == dead:
                self.store.set(dk, _TOMBSTONE)
                _INVALIDATIONS.inc()
                killed += 1
        return killed


class FleetKvServer(KvTierServer):
    """The worker's published-blob store: a remote-tier server fed
    *locally* by the publisher and served *remotely* behind a
    :class:`ChannelAcceptor` (one daemon serve loop per dialing peer,
    looping through idle timeouts — a fleet peer channel is long-lived).
    All storage ops are lock-guarded in the base class, so the publisher
    (engine thread) and the serve loops never race."""

    def __init__(self, capacity_bytes: int, ep=None,
                 idle_timeout_ms: int = 2000):
        super().__init__(capacity_bytes)
        self.idle_timeout_ms = int(idle_timeout_ms)
        self._acceptor = None
        self._closing = False
        if ep is not None:
            from uccl_tpu_torch.p2p.channel import ChannelAcceptor

            self._acceptor = ChannelAcceptor(ep, self._serve_peer)

    def _serve_peer(self, chan) -> None:
        def loop():
            while not self._closing:
                try:
                    self.serve(chan, self.idle_timeout_ms)
                except TimeoutError:
                    continue  # idle peer: keep the channel warm
                except Exception as e:
                    if not self._closing:
                        _ERRORS.inc(reason=type(e).__name__)
                    return

        threading.Thread(target=loop, daemon=True).start()

    def put_local(self, key: int, blob: np.ndarray, meta: dict) -> List[int]:
        """Publisher-side insert (no wire): reserve + store; returns the
        keys LRU-evicted to make room (their directory entries must be
        withdrawn by the caller)."""
        evicted = self._reserve(int(blob.nbytes))
        self._put(int(key), blob, meta)
        return evicted

    def drop_local(self, key: int) -> None:
        self._del(int(key))

    def close(self) -> None:
        self._closing = True
        if self._acceptor is not None:
            self._acceptor.close()


class FleetCachePublisher:
    """The :class:`PrefixCache` listener: mirrors the trie's residency
    into the blob store + directory.

    ``on_insert`` runs on the engine step thread while the parked slot
    still holds its rows — it exports + encodes ONCE (lossless ``raw``
    for device residents, the already-encoded blob for T1 refs) so serve
    threads only ever read the store. T2 refs are not published: their
    bytes already live on a remote tier peer and advertising a
    triple-hop fetch is worse than a cold prefill. Every failure is
    counted and swallowed — publishing is best-effort, admission never
    blocks on the fleet plane."""

    def __init__(self, directory: FleetDirectory, server: FleetKvServer,
                 backend, tiers=None):
        self.directory = directory
        self.server = server
        self.backend = backend
        self.tiers = tiers
        self.chunk = directory.chunk
        self._next_key = 0
        # resident -> (blob key, [dir keys]); blob key -> resident
        self._published: Dict = {}
        self._by_key: Dict[int, object] = {}

    def _encode(self, resident, path) -> Optional[Tuple]:
        if isinstance(resident, (int, np.integer)):
            n = len(path) * self.chunk
            k_rows, v_rows = self.backend.export_slot_kv(int(resident), 0, n)
            blob, meta = encode_entry(k_rows, v_rows)  # lossless raw
            return blob, meta, True
        tier = getattr(resident, "tier", None)
        if tier == "t1" and self.tiers is not None:
            ent = self.tiers.t1.get(resident.key)
            if ent is None:
                return None
            blob, meta, _ = ent  # shared array object: no byte copy
            return blob, meta, bool(getattr(resident, "exact", True))
        return None  # t2 (or unknown): bytes are not local — don't advertise

    # -- PrefixCache listener protocol ------------------------------------
    def on_insert(self, resident, path: List[bytes]) -> None:
        try:
            if resident in self._published:
                return
            enc = self._encode(resident, path)
            if enc is None:
                return
            blob, meta, exact = enc
            if blob.nbytes > self.server.capacity_bytes:
                return
            key = self._next_key
            self._next_key += 1
            for ek in self.server.put_local(key, blob, meta):
                self._withdraw_key(ek)
            dir_keys = self.directory.publish(path, key, exact,
                                              int(blob.nbytes))
            self._published[resident] = (key, dir_keys)
            self._by_key[key] = resident
        except Exception as e:
            _ERRORS.inc(reason="publish")
            _log.warning("fleet: publish failed (%s: %s)",
                         type(e).__name__, e)

    def on_remove(self, resident) -> None:
        try:
            pub = self._published.pop(resident, None)
            if pub is None:
                return
            key, dir_keys = pub
            self._by_key.pop(key, None)
            self.directory.withdraw(dir_keys, key)
            self.server.drop_local(key)
        except Exception as e:
            _ERRORS.inc(reason="withdraw")
            _log.warning("fleet: withdraw failed (%s: %s)",
                         type(e).__name__, e)

    def _withdraw_key(self, key: int) -> None:
        """A blob LRU-evicted by capacity pressure: de-publish it (the
        local trie entry is untouched — only the fleet copy is gone)."""
        resident = self._by_key.pop(key, None)
        if resident is None:
            return
        _, dir_keys = self._published.pop(resident)
        self.directory.withdraw(dir_keys, key)


class FleetCacheClient:
    """The fetch side: consult the directory on a local trie miss and
    pull the entry from the owning peer into the admitted slot.

    Peers are dialed lazily from their ``fleet_ep/<worker>`` store
    advertisement; a peer that fails ``fail_limit`` consecutive times
    latches dead (the remote tier's discipline) so a dying worker
    costs a bounded number of timeouts, after which its directory entries
    are swept via :meth:`FleetDirectory.invalidate_owner`."""

    def __init__(self, directory: FleetDirectory, worker: str, ep, store,
                 *, max_entry_bytes: int, n_paths: int = 2,
                 fail_limit: int = 3, timeout_ms: int = 10000):
        self.directory = directory
        self.worker = worker
        self.ep = ep
        self.store = store
        self.max_entry_bytes = int(max_entry_bytes)
        self.n_paths = int(n_paths)
        self.fail_limit = int(fail_limit)
        self.timeout_ms = int(timeout_ms)
        self._remotes: Dict[str, Optional[RemoteKVTier]] = {}
        self._fails: Dict[str, int] = {}

    def _remote_for(self, owner: str) -> Optional[RemoteKVTier]:
        if owner in self._remotes:
            return self._remotes[owner]
        remote = None
        raw = self.store.get(_EP_PREFIX + owner)
        if raw is not None:
            try:
                from uccl_tpu_torch.p2p.channel import Channel

                ip, port = raw.decode().rsplit(":", 1)
                chan = Channel.connect(self.ep, ip, int(port),
                                       n_paths=self.n_paths,
                                       meta=self.worker.encode())
                remote = RemoteKVTier(chan, self.max_entry_bytes,
                                      timeout_ms=self.timeout_ms)
            except Exception as e:
                _ERRORS.inc(reason="dial")
                _log.warning("fleet: dialing %s failed (%s: %s)", owner,
                             type(e).__name__, e)
                # an advertised owner that cannot be dialed is a dead
                # peer from this worker's vantage — same post-mortem
                # moment as a health-detector DEAD transition
                obs.flight_trigger(
                    "peer_dead", key=f"fleet:{owner}", peer=owner,
                    source="fleet_dial", exc=f"{type(e).__name__}: {e}",
                    directory_entries=len(getattr(
                        self.directory, "_entries", ()) or ()))
        self._remotes[owner] = remote
        return remote

    def _peer_failed(self, owner: str, exc: Exception) -> None:
        _ERRORS.inc(reason="fetch")
        n = self._fails.get(owner, 0) + 1
        self._fails[owner] = n
        dead = n >= self.fail_limit
        _log.warning("fleet: fetch from %s failed (%s: %s) — %d/%d%s",
                     owner, type(exc).__name__, exc, n, self.fail_limit,
                     "; peer latched dead" if dead else "")
        if dead:
            remote = self._remotes.get(owner)
            self._remotes[owner] = None  # latch: stop dialing/fetching
            if remote is not None:
                try:
                    remote.close()
                except Exception:
                    pass
            swept = self.directory.invalidate_owner(owner)
            obs.flight_trigger(
                "peer_dead", key=f"fleet:{owner}", peer=owner,
                source="fleet_fetch", fails=n,
                exc=f"{type(exc).__name__}: {exc}",
                entries_invalidated=swept)

    def fetch(self, prompt, ns: str, slot: int, backend) -> Tuple[int, bool]:
        """Serve a local miss from the fleet if possible. Returns
        ``(matched, exact)`` — ``(0, True)`` when the fleet has nothing
        usable (no directory hit, stale owner, dead peer), in which case
        the admission stays the cold miss it already counted."""
        hit = self.directory.lookup(prompt, ns)
        if hit is None or hit["owner"] == self.worker:
            # a self-owned hit means OUR trie just missed what we
            # published — a remove racing the lookup; it is a plain miss
            return 0, True
        owner = hit["owner"]
        remote = self._remote_for(owner)
        if remote is None:
            return 0, True
        with obs.span("fleet.fetch", track="engine", owner=owner,
                      slot=slot, tokens=hit["tokens"]):
            try:
                got = remote.get(hit["key"])
            except Exception as e:
                self._peer_failed(owner, e)
                return 0, True
            self._fails[owner] = 0
            if got is None:
                # the owner LRU-dropped the blob between our directory
                # read and the fetch: the counted cold miss, never wrong
                # bytes — and tombstone so the fleet stops chasing it
                _STALE.inc()
                self.directory.tombstone(hit["dir_key"])
                return 0, True
            blob, meta = got
            try:
                k_rows, v_rows = decode_entry(blob, meta)
            except Exception as e:
                self._peer_failed(owner, e)
                return 0, True
            n = hit["tokens"]
            if k_rows.shape[1] < n:
                _STALE.inc()
                self.directory.tombstone(hit["dir_key"])
                return 0, True
            backend.import_slot_kv(slot, k_rows[:, :n], v_rows[:, :n],
                                   length=n)
        _HITS.inc()
        _TOKENS_IMPORTED.inc(n)
        return n, hit["exact"]

    def close(self) -> None:
        for remote in self._remotes.values():
            if remote is not None:
                try:
                    remote.close()
                except Exception:
                    pass
        self._remotes.clear()


class FleetWorker:
    """One process's whole fleet plane, assembled: directory view +
    published-blob server + fetch client, advertised in the store.

    The engine binds it with :meth:`ServingEngine.attach_fleet`, which
    wires ``publisher`` onto the trie listener hook and consults
    :meth:`fetch` on local misses. ``ip`` defaults to loopback (the
    single-host bench topology); multi-host deployments pass the NIC
    address the endpoint listens on."""

    def __init__(self, name: str, store, ep, *, chunk: int,
                 capacity_bytes: int, max_entry_bytes: int,
                 backend=None, tiers=None, ip: str = "127.0.0.1",
                 n_paths: int = 2, fail_limit: int = 3,
                 timeout_ms: int = 10000):
        self.worker = name
        self.store = store
        self.ep = ep
        self.directory = FleetDirectory(store, name, chunk)
        self.server = FleetKvServer(capacity_bytes, ep)
        store.set(_EP_PREFIX + name, f"{ip}:{ep.port}".encode())
        self.publisher = FleetCachePublisher(self.directory, self.server,
                                             backend, tiers)
        self.client = FleetCacheClient(
            self.directory, name, ep, store,
            max_entry_bytes=max_entry_bytes, n_paths=n_paths,
            fail_limit=fail_limit, timeout_ms=timeout_ms,
        )

    def fetch(self, prompt, ns: str, slot: int, backend) -> Tuple[int, bool]:
        return self.client.fetch(prompt, ns, slot, backend)

    def invalidate_owner(self, dead: str) -> int:
        return self.directory.invalidate_owner(dead)

    def close(self) -> None:
        self.client.close()
        self.server.close()
