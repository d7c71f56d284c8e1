"""Elastic hybrid device/host buffers (pinned host memory offload).

Port of ``uccl_tpu/ep/elastic.py``. The reference's DeepEPv2 runtime backs
its EP windows with *host* memory when device memory is short or GPUDirect
is absent (ElasticBuffer,
experimental/lite/lite-ep/csrc/elastic/buffer.hpp: ``uccl_use_host_window``;
lite-ep/README.md:35 "elastic hybrid GPU/CPU buffers"). Here a tensor lives
in HBM (a CUDA tensor) or in pinned host memory (a pinned CPU tensor), moved
by ``non_blocking`` copies on the current stream, so every later use on
that stream is ordered after the copy. On a CPU run both places are the
CPU and nothing spills (``has_host`` is False), as the JAX package degrades
on a backend without a ``pinned_host`` memory space.

Two facilities:

* :class:`ElasticBuffer` — a named tensor store with an HBM budget: tensors
  placed on device while the budget holds, spilled to pinned host memory
  beyond it; ``get`` stages host-resident tensors back on demand.
* :class:`ElasticKVCache` — the serving-side application: a blockwise KV
  cache whose hot tail lives in HBM and whose cold prefix is offloaded to
  host memory, letting decode contexts grow past the HBM budget. Feeds the
  same attention contract as ``models.inference`` (see
  ``decode_step_elastic`` there).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from uccl_tpu_torch import DeviceLike, resolve_device


def _nbytes(arr) -> int:
    return int(np.prod(arr.shape)) * arr.element_size()


def _memory_places(device: DeviceLike) -> Tuple[torch.device, bool]:
    """(device, has_host) for one device: a CUDA device offloads to pinned
    host memory; the CPU has only the one place, so the elastic API keeps
    working and spills just stay where they are."""
    dev = resolve_device(device)
    return dev, dev.type == "cuda"


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class ElasticBuffer:
    """Named tensor store with an HBM budget and pinned-host spill.

    put() places a tensor in device memory while ``device_bytes`` stays
    under the budget, else in pinned host memory. get() always returns a
    device-resident tensor (host-resident entries are staged per call and
    NOT promoted — the store's placement is the durable state, a get is a
    read). pin=True forces device placement regardless of budget (the
    analog of the reference's always-device workspace).
    """

    def __init__(self, hbm_budget_bytes: int, device: DeviceLike = None):
        self.device, self.has_host = _memory_places(device)
        self.budget = int(hbm_budget_bytes)
        self._store: Dict[str, torch.Tensor] = {}
        self._on_device: Dict[str, bool] = {}

    @property
    def device_bytes(self) -> int:
        return sum(
            _nbytes(a) for n, a in self._store.items() if self._on_device[n]
        )

    @property
    def host_bytes(self) -> int:
        return sum(
            _nbytes(a) for n, a in self._store.items() if not self._on_device[n]
        )

    def put(self, name: str, arr, *, pin: bool = False) -> None:
        if name in self._store:
            self.delete(name)
        arr = torch.as_tensor(arr)
        fits = self.device_bytes + _nbytes(arr) <= self.budget
        on_dev = pin or fits or not self.has_host
        if on_dev:
            # a store entry owns its memory: never alias the caller's tensor
            t = (arr.to(self.device, non_blocking=True) if arr.device != self.device
                 else arr.clone())
        else:
            t = _to_pinned(arr)
        self._store[name] = t
        self._on_device[name] = on_dev

    def get(self, name: str) -> torch.Tensor:
        arr = self._store[name]
        if self._on_device[name]:
            return arr
        return arr.to(self.device, non_blocking=True)

    def placement(self, name: str) -> str:
        return "device" if self._on_device[name] else "host"

    def offload(self, name: str) -> None:
        """Explicitly demote an entry to host memory (frees its HBM)."""
        if self._on_device[name] and self.has_host:
            self._store[name] = _to_pinned(self._store[name])
            self._on_device[name] = False

    def delete(self, name: str) -> None:
        self._store.pop(name, None)
        self._on_device.pop(name, None)

    def names(self) -> List[str]:
        return list(self._store)


class ElasticKVCache:
    """Blockwise KV cache: hot blocks in HBM, cold blocks in host memory.

    Token layout mirrors ``models.inference.KVCache`` per block:
    k/v blocks are ``[L, B, block_tokens, Hkv, D]``. The cache holds
    ``hot_blocks`` most-recent full blocks on device; older full blocks are
    offloaded to pinned host memory as they age out. A partial "current"
    block accumulates decode-time tokens on device.

    ``kv()`` returns the full (K, V, length) context on device — cold
    blocks are staged back per call (``non_blocking`` copies, all issued
    before the concatenation), which is the streaming cost elasticity pays
    for contexts beyond HBM.
    """

    def __init__(
        self,
        n_layers: int,
        batch: int,
        n_kv_heads: int,
        head_dim: int,
        *,
        block_tokens: int = 128,
        hot_blocks: int = 4,
        dtype=torch.float32,
        device: DeviceLike = None,
    ):
        self.shape = (n_layers, batch, block_tokens, n_kv_heads, head_dim)
        self.block_tokens = block_tokens
        self.hot_blocks = max(1, int(hot_blocks))
        self.dtype = dtype
        self.device, self.has_host = _memory_places(device)
        self._cold: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._hot: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._cur_k = self._zeros()
        self._cur_v = self._zeros()
        self._cur_fill = 0

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    @property
    def length(self) -> int:
        return (
            (len(self._cold) + len(self._hot)) * self.block_tokens
            + self._cur_fill
        )

    @property
    def cold_blocks(self) -> int:
        return len(self._cold)

    def device_committed_bytes(self) -> int:
        """HBM durably held by the cache (hot ring + current block); cold
        blocks live in host memory and only transit HBM inside kv()."""
        per_block = 2 * int(np.prod(self.shape)) * self._cur_k.element_size()
        return (len(self._hot) + 1) * per_block

    def _seal_current(self) -> None:
        self._hot.append((self._cur_k, self._cur_v))
        self._cur_k = self._zeros()
        self._cur_v = self._zeros()
        self._cur_fill = 0
        while len(self._hot) > self.hot_blocks:
            k, v = self._hot.pop(0)
            if self.has_host:
                k, v = _to_pinned(k), _to_pinned(v)
            self._cold.append((k, v))

    def append_tokens(self, k_new, v_new) -> None:
        """k/v_new: [L, B, S_new, Hkv, D] — append S_new tokens (prefill
        chunks or single decode tokens)."""
        s_new = k_new.shape[2]
        off = 0
        while off < s_new:
            room = self.block_tokens - self._cur_fill
            take = min(room, s_new - off)
            lo, hi = self._cur_fill, self._cur_fill + take
            self._cur_k[:, :, lo:hi] = k_new[:, :, off:off + take].to(self.dtype)
            self._cur_v[:, :, lo:hi] = v_new[:, :, off:off + take].to(self.dtype)
            self._cur_fill += take
            off += take
            if self._cur_fill == self.block_tokens:
                self._seal_current()

    def kv(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Full context on device: (K, V, length), K/V
        [L, B, n_blocks*block_tokens, Hkv, D] (tail beyond `length` is
        zero padding from the partial block)."""
        staged_k, staged_v = [], []
        for k, v in self._cold:  # issue all stagings first: async overlap
            staged_k.append(k.to(self.device, non_blocking=True))
            staged_v.append(v.to(self.device, non_blocking=True))
        for k, v in self._hot:
            staged_k.append(k)
            staged_v.append(v)
        staged_k.append(self._cur_k)
        staged_v.append(self._cur_v)
        return (
            torch.cat(staged_k, dim=2),
            torch.cat(staged_v, dim=2),
            self.length,
        )

    @staticmethod
    def from_cache(cache, *, block_tokens=128, hot_blocks=4, device=None):
        """Blockify a ``models.inference.KVCache`` produced by prefill (the
        disaggregation hand-off: prefill ships a dense cache, the decode
        worker re-homes it elastically). ``device`` defaults to the
        cache's."""
        n_layers, batch, _, hkv, d = cache.k.shape
        length = int(cache.length)
        ekv = ElasticKVCache(
            n_layers, batch, hkv, d,
            block_tokens=block_tokens, hot_blocks=hot_blocks,
            dtype=cache.k.dtype,
            device=cache.k.device if device is None else device,
        )
        ekv.append_tokens(cache.k[:, :, :length], cache.v[:, :, :length])
        return ekv


def admit_warm_spare(buf: ElasticBuffer, weights, *, prefix: str = "",
                     pin: bool = False) -> int:
    """Warm-spare admission: import a model's weights into an elastic
    store — the spin-up path of an elastic resize (a spare joining the
    fleet mid-run stages its params here before taking traffic).

    ``weights`` is a fetched weight-push snapshot
    (:class:`uccl_tpu_torch.p2p.weight_push.WeightSnapshot` — the versioned
    fleet distribution path, whose wire bytes were already counted at
    fetch time) or a plain ``{name: tensor}`` mapping / param tree. A
    raw tree is the legacy local-copy path: its bytes land on
    ``p2p_bytes_total{verb="weight_push"}`` here so a spare admitted off
    an untracked host copy is visible on the SAME fleet byte series as a
    wire-fetched one — never silent. Returns the bytes imported; entries
    are named ``prefix + dotted-path``."""
    from uccl_tpu_torch import obs
    from uccl_tpu_torch.p2p import weight_push as _wp

    if isinstance(weights, _wp.WeightSnapshot):
        pairs = list(weights.flat().items())
        version = weights.version
    else:
        pairs = _wp.flatten_tree(weights)
        version = None
        obs.counter("p2p_bytes_total").inc(
            sum(_nbytes(a) for _, a in pairs), verb="weight_push")
    total = 0
    for key, arr in pairs:
        buf.put(prefix + key, arr, pin=pin)
        total += _nbytes(arr)
    obs.instant("warm_spare_admit", track="wire", entries=len(pairs),
                bytes=total, version=version)
    return total


def admit_warm_replica(router, prototype_backend, *, weights=None,
                       engine_kw: Optional[Dict] = None):
    """Elastic UP-scale: build a warm-spare serving replica off
    ``prototype_backend`` (sharing its parameters, and an MoE prototype's
    server — the ``serving.replicate_backend`` rule), optionally serving a
    pushed weight snapshot
    (:class:`~uccl_tpu_torch.p2p.weight_push.WeightSnapshot` — its wire
    bytes were counted at fetch), and :meth:`~uccl_tpu_torch.serving.Router.attach`
    it to the live router mid-run. The twin of ``Router.detach`` (the
    graceful down-scale): together they are the fleet-resize primitive
    the load-following control loop actuates. Returns the new
    ``ServingEngine`` (its stable replica id is on the router's
    ``attach`` instant)."""
    from uccl_tpu_torch.serving.engine import ServingEngine, replicate_backend

    backend = replicate_backend(prototype_backend, 2, weights=weights)[1]
    eng = ServingEngine(backend, **(engine_kw or {}))
    router.attach(eng)
    return eng
