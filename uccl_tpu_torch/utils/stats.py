"""Periodic stats reporting.

The analog of the reference's engine stats thread (collective/rdma
transport.cc:1797 ``stats_thread_fn`` — 2 s interval, silenced by
``UCCL_ENGINE_QUIET``): components register counter callbacks; a daemon thread
logs a snapshot every interval. Silence with ``UCCL_TPU_STATS_QUIET=1``.

The registration surface is absorbed by :data:`uccl_tpu_torch.obs.REGISTRY`:
the module-level ``registry`` here mirrors every register/unregister into the
obs registry's pull sources, so anything registered through it is also
exported via ``/metrics`` + ``/snapshot`` and the obs JSON snapshot. The
reporter thread is the log-file face of the same sources.

Port of ``uccl_tpu/utils/stats.py`` (jax-free there too), under the same
names and environment variables.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.utils.config import param
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("UTIL")

_quiet = param("stats_quiet", False, help="silence the periodic stats thread")
_interval = param("stats_interval_s", 2.0, help="stats reporting interval")


class StatsRegistry:
    """Named counter sources; snapshot() pulls every registered callback.

    When constructed with ``obs_registry``, every source is mirrored into
    that registry's pull sources (the module-level ``registry`` below
    mirrors into :data:`uccl_tpu_torch.obs.REGISTRY`). Standalone instances
    (tests) stay self-contained."""

    def __init__(self, obs_registry: Optional[_obsc.Registry] = None):
        self._sources: Dict[str, Callable[[], Dict[str, float]]] = {}
        self._lock = threading.Lock()
        self._obs = obs_registry

    def register(self, name: str, fn: Callable[[], Dict[str, float]]) -> None:
        with self._lock:
            self._sources[name] = fn
        if self._obs is not None:
            self._obs.register_source(name, fn)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)
        if self._obs is not None:
            self._obs.unregister_source(name)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            sources = dict(self._sources)
        out = {}
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception as e:  # a broken source must not kill the thread
                out[name] = {"error": repr(e)}
        return out


registry = StatsRegistry(obs_registry=_obsc.REGISTRY)


class StatsThread:
    """Daemon thread logging registry snapshots every interval."""

    def __init__(self, reg: Optional[StatsRegistry] = None):
        self._reg = reg if reg is not None else registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(float(_interval.get())):
            if _quiet.get():
                continue
            snap = self._reg.snapshot()
            if snap:
                _log.info("stats: %s", snap)
