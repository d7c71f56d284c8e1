"""Multi-tenant LoRA adapter store for the serving engine.

Port of ``uccl_tpu/serving/adapters.py``. Per-tenant low-rank (A, B)
adapter pairs on the attention projections ``wq`` and ``wv``, applied in
the slot primitives as a batched per-slot fused delta: each slot carries an
adapter row id, the forward gathers its (A, B) from stacked device tables
and adds ``(x @ A) @ B`` beside the base matmul (``inference._lora_delta``,
on both stacks). Rank is zero-padded to the store's ``max_rank`` so one
table shape serves mixed-rank batches, and **row 0 is all zeros**:
adapter-free slots ride it and their delta is exactly 0.0.

Residency follows the prefix trie's LRU discipline: the device tables hold
at most ``capacity`` adapters; ``acquire`` of a resident tenant is a hit,
of a published-but-evicted tenant a miss that re-stages it (evicting the
least-recently-used row whose refcount is 0: rows pinned by live requests
are never evicted). Published host copies are the archive misses restage
from; ``max_published`` bounds it, and a request whose adapter left the
archive while it queued exits ``adapter_lost``. ``ingest`` of a weight-push
snapshot needs the p2p plane (ROADMAP queue A item 14) and raises.

Counters: ``adapter_cache_hits_total``, ``adapter_cache_misses_total``,
``adapter_cache_evictions_total``, gauge ``adapter_cache_resident``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

import torch

from uccl_tpu_torch import DeviceLike, resolve_device, obs
from uccl_tpu_torch.models.sampling import normal, split

_HITS = obs.counter(
    "adapter_cache_hits_total",
    "adapter acquisitions served from a device-resident table row",
)
_MISSES = obs.counter(
    "adapter_cache_misses_total",
    "adapter acquisitions that had to restage an evicted/new adapter",
)
_EVICTIONS = obs.counter(
    "adapter_cache_evictions_total",
    "resident adapters evicted LRU-first to restage another tenant",
)
_RESIDENT = obs.gauge(
    "adapter_cache_resident",
    "adapters currently staged in the device tables",
)

#: the two projections adapters apply to (query and value — the classic
#: LoRA target set; one fusion point in ``_forward_slots`` serves both
#: stacks, the MoE path wraps it via its ffn hook)
TARGETS = ("wq", "wv")


def make_lora(key, n_layers: int, dim: int, q_out: int, kv_out: int,
              rank: int, scale: float = 0.05):
    """A random LoRA tree for tests/benches: ``{"wq": {"a", "b"}, "wv":
    {"a", "b"}}`` with A ~ N(0, 1/sqrt(dim)) and B ~ N(0, scale), host f32
    arrays, drawn from ``key`` (``sampling.prng_key``) as the JAX
    ``make_lora`` draws them (``split(key, 4)``; each normal within a few
    ulp of JAX's). Shapes: a [L, dim, rank], b [L, rank, out]."""
    ks = split(torch.as_tensor(key).cpu(), 4)
    s_in = 1.0 / math.sqrt(dim)

    def rnd(kk, shape, s):
        return normal(kk, shape).numpy() * s

    return {
        "wq": {"a": rnd(ks[0], (n_layers, dim, rank), s_in),
               "b": rnd(ks[1], (n_layers, rank, q_out), scale)},
        "wv": {"a": rnd(ks[2], (n_layers, dim, rank), s_in),
               "b": rnd(ks[3], (n_layers, rank, kv_out), scale)},
    }


def materialize(params, tree):
    """Dense-materialize an adapter into a copy of ``params`` (a parameter
    tree of torch tensors): ``wq' = wq + A_q @ B_q``, ``wv' = wv + A_v @
    B_v``. The fused per-slot delta is held to it within a float tolerance
    (the fused form computes ``(x@A)@B``, the materialized ``x@(W +
    A@B)``)."""
    blocks = dict(params["blocks"])
    for t in TARGETS:
        w = blocks[t]
        a = torch.as_tensor(np.asarray(tree[t]["a"], np.float32), device=w.device)
        b = torch.as_tensor(np.asarray(tree[t]["b"], np.float32), device=w.device)
        blocks[t] = w + torch.einsum("lhr,lro->lho", a, b)
    out = dict(params)
    out["blocks"] = blocks
    return out


class AdapterStore:
    """Bounded, LRU-evicted, refcount-pinned store of per-tenant LoRA
    adapters with rank-padded stacked device tables.

    ``capacity`` is the number of device table rows (besides the zero
    row); published host copies are unbounded by default (they are tiny
    next to KV) but can be capped with ``max_published``. The tables live
    on ``device`` (the serving backend's).
    """

    def __init__(self, n_layers: int, dim: int, q_out: int, kv_out: int,
                 *, max_rank: int = 8, capacity: int = 4,
                 max_published: Optional[int] = None,
                 device: DeviceLike = None):
        if max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {max_rank}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        self.n_layers, self.dim = n_layers, dim
        self.q_out, self.kv_out = q_out, kv_out
        self.max_rank, self.capacity = max_rank, capacity
        self.max_published = max_published
        # published archive: tenant -> {"version", "rank", "<target>": (a, b)}
        self._published: Dict[str, dict] = {}
        self._pub_seq: Dict[str, int] = {}  # publish-LRU for max_published
        # residency: device row r in [1, capacity] holds one tenant
        self._row_tenant: List[Optional[str]] = [None] * (capacity + 1)
        self._rows: Dict[str, int] = {}  # tenant -> row
        self._refcount = [0] * (capacity + 1)
        self._lru = [0] * (capacity + 1)
        self._seq = 0
        # host staging for the stacked tables, row 0 permanently zero
        t = capacity + 1
        self._host = {
            tgt: (np.zeros((n_layers, t, dim, max_rank), np.float32),
                  np.zeros((n_layers, t, max_rank,
                            q_out if tgt == "wq" else kv_out), np.float32))
            for tgt in TARGETS
        }
        self._tables = None  # device copies, rebuilt lazily on dirty
        self._dirty = True

    # -- publishing (the weight-push consumer) ----------------------------
    def publish(self, tenant: str, tree, *,
                version: Optional[int] = None) -> int:
        """Register (or refresh) ``tenant``'s adapter from a LoRA tree.
        Returns the adapter version (auto-incremented unless pinned). A
        refresh of a RESIDENT tenant restages its table rows in place —
        live slots see the new weights on the next compiled call."""
        rank = None
        clean = {}
        for tgt in TARGETS:
            a = np.asarray(tree[tgt]["a"], np.float32)
            b = np.asarray(tree[tgt]["b"], np.float32)
            out = self.q_out if tgt == "wq" else self.kv_out
            if a.shape[:2] != (self.n_layers, self.dim) or a.ndim != 3:
                raise ValueError(
                    f"adapter {tenant!r} {tgt}.a shape {a.shape} != "
                    f"[{self.n_layers}, {self.dim}, rank]"
                )
            if b.shape != (self.n_layers, a.shape[2], out):
                raise ValueError(
                    f"adapter {tenant!r} {tgt}.b shape {b.shape} != "
                    f"[{self.n_layers}, {a.shape[2]}, {out}]"
                )
            if rank is None:
                rank = a.shape[2]
            elif a.shape[2] != rank:
                raise ValueError(
                    f"adapter {tenant!r} mixes ranks across targets "
                    f"({rank} vs {a.shape[2]})"
                )
            clean[tgt] = (a, b)
        if rank > self.max_rank:
            raise ValueError(
                f"adapter {tenant!r} rank {rank} exceeds the store's "
                f"max_rank {self.max_rank}"
            )
        prev = self._published.get(tenant)
        if version is None:
            version = prev["version"] + 1 if prev else 1
        clean["version"] = int(version)
        clean["rank"] = int(rank)
        self._published[tenant] = clean
        self._seq += 1
        self._pub_seq[tenant] = self._seq
        row = self._rows.get(tenant)
        if row is not None:  # live refresh of a resident adapter
            self._stage(row, clean)
        if (self.max_published is not None
                and len(self._published) > self.max_published):
            # drop the least-recently published NON-resident archive copy
            # (and its publish-order stamp — leaving it would leak one
            # _pub_seq entry per evicted tenant under publish/evict churn)
            victims = [t for t in self._published if t not in self._rows]
            if victims:
                victim = min(victims, key=self._pub_seq.__getitem__)
                del self._published[victim]
                del self._pub_seq[victim]
        return int(version)

    def ingest(self, snapshot) -> int:
        """Consume a weight-push snapshot: needs the p2p plane, which is
        not ported yet (ROADMAP queue A item 14); :meth:`publish` takes
        the same tree."""
        raise NotImplementedError(
            "AdapterStore.ingest needs the p2p weight-push plane, which is "
            "not ported yet (ROADMAP queue A item 14)")

    def has(self, tenant: str) -> bool:
        return tenant in self._published

    def can_acquire(self, tenant: Optional[str]) -> bool:
        """True when :meth:`acquire` would succeed without raising: no
        adapter (row 0), an already-resident row, or a published adapter
        with a free or unpinned (evictable) table row to land on.
        Non-mutating — the engine's admission gate, so a request whose
        adapter cannot be pinned right now is deferred in queue instead
        of crashing ``step()`` mid-admission."""
        if tenant is None:
            return True
        if tenant not in self._published:
            return False
        return tenant in self._rows or self.n_available_rows() > 0

    def is_resident(self, tenant: str) -> bool:
        """True when the tenant's adapter currently occupies a table row
        (an acquire would be a refcount hit, never needing a free row)."""
        return tenant in self._rows

    def n_available_rows(self, exclude=()) -> int:
        """Rows a NON-resident acquire could land on right now: free rows
        plus unpinned resident rows (eviction candidates), minus unpinned
        rows whose tenant is in ``exclude``. The engine's batch admission
        gate passes the resident adapters the batch is about to pin as
        ``exclude``, so one batch can never plan more fresh stagings than
        the table can hold once its own resident hits are pinned."""
        n = 0
        for r in range(1, self.capacity + 1):
            t = self._row_tenant[r]
            if t is None:
                n += 1
            elif self._refcount[r] == 0 and t not in exclude:
                n += 1
        return n

    def version(self, tenant: str) -> int:
        return int(self._published[tenant]["version"])

    def tenants(self) -> List[str]:
        return sorted(self._published)

    @property
    def n_resident(self) -> int:
        return len(self._rows)

    # -- residency --------------------------------------------------------
    def _stage(self, row: int, rec: dict) -> None:
        r = rec["rank"]
        for tgt in TARGETS:
            a, b = rec[tgt]
            ha, hb = self._host[tgt]
            ha[:, row] = 0.0
            hb[:, row] = 0.0
            ha[:, row, :, :r] = a
            hb[:, row, :r, :] = b
        self._dirty = True

    def acquire(self, tenant: Optional[str]) -> int:
        """Pin ``tenant``'s adapter into a device table row and return the
        row id (0 for ``tenant=None`` — the zero-rank fast path, never
        pinned). Resident → hit; published-but-evicted → miss + restage
        (LRU-evicting an unpinned row). Raises ``KeyError`` for an
        unpublished tenant and ``RuntimeError`` when every row is pinned
        by live requests."""
        if tenant is None:
            return 0
        rec = self._published.get(tenant)
        if rec is None:
            raise KeyError(f"no published adapter for tenant {tenant!r}")
        row = self._rows.get(tenant)
        self._seq += 1
        if row is not None:
            _HITS.inc()
            self._refcount[row] += 1
            self._lru[row] = self._seq
            return row
        _MISSES.inc()
        free = [r for r in range(1, self.capacity + 1)
                if self._row_tenant[r] is None]
        if free:
            row = free[0]
        else:
            victims = [r for r in range(1, self.capacity + 1)
                       if self._refcount[r] == 0]
            if not victims:
                raise RuntimeError(
                    "adapter store exhausted: every table row is pinned "
                    "by a live request"
                )
            row = min(victims, key=self._lru.__getitem__)
            del self._rows[self._row_tenant[row]]
            _EVICTIONS.inc()
        self._row_tenant[row] = tenant
        self._rows[tenant] = row
        self._refcount[row] = 1
        self._lru[row] = self._seq
        self._stage(row, rec)
        _RESIDENT.set(len(self._rows))
        return row

    def release(self, row: int) -> None:
        """Unpin one acquisition of ``row`` (row 0 is a no-op). The row
        stays resident — a refcount-0 row is evictable, not evicted."""
        if row == 0:
            return
        if self._refcount[row] <= 0:
            raise ValueError(f"release of unpinned adapter row {row}")
        self._refcount[row] -= 1

    # -- the compiled-program face ----------------------------------------
    def tables_of(self, tenant: str) -> dict:
        """Tables of the ``device_tables`` layout holding only ``tenant``'s
        published adapter, in row 1 (row 0 zero): what a request is
        replayed with alone (``serving.replay_alone``). A slot gathers the
        same rank-padded rows from it as from the engine's tables."""
        rec = self._published[tenant]
        out = {}
        for tgt in TARGETS:
            ha, hb = self._host[tgt]
            a = np.zeros((self.n_layers, 2) + ha.shape[2:], np.float32)
            b = np.zeros((self.n_layers, 2) + hb.shape[2:], np.float32)
            ra, rb = rec[tgt]
            a[:, 1, :, :rec["rank"]] = ra
            b[:, 1, :rec["rank"], :] = rb
            out[tgt] = (torch.as_tensor(a, device=self.device),
                        torch.as_tensor(b, device=self.device))
        return out

    def device_tables(self) -> dict:
        """``{"wq": (A, B), "wv": (A, B)}`` stacked tables on the store's
        device, shapes A [L, T, dim, max_rank] / B [L, T, max_rank, out]
        with T = capacity + 1 and row 0 zero. Rebuilt lazily after
        staging; the shapes never change."""
        if self._dirty or self._tables is None:
            self._tables = {
                tgt: (torch.as_tensor(ha, device=self.device).clone(),
                      torch.as_tensor(hb, device=self.device).clone())
                for tgt, (ha, hb) in self._host.items()
            }
            self._dirty = False
        return self._tables
