"""Failure detection: heartbeats over the OOB store.

Port of ``uccl_tpu/parallel/health.py`` (host code, copied).

The reference's failure handling is transport-level (RTO abort after
kRTOAbortThreshold consecutive RTOs, transport_config.h:202; peer teardown via
remove_remote_endpoint, p2p/engine.h:273 — SURVEY.md §5). This adds the
job-level piece on top: every rank posts heartbeats to the rendezvous store; a
monitor thread flags peers whose heartbeats stall, so the application can
remove their endpoints / rebuild groups (elastic peer remove).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

from uccl_tpu_torch.parallel.distributed import Session
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("PARALLEL")


class HeartbeatMonitor:
    """Post own heartbeats; watch everyone else's.

    on_failure(rank) fires once per newly-suspected peer (heartbeat older
    than ``timeout_s``). Ranks that resume beating are un-suspected.
    """

    def __init__(
        self,
        sess: Session,
        interval_s: float = 1.0,
        timeout_s: float = 5.0,
        on_failure: Optional[Callable[[int], None]] = None,
        key: str = "health/hb",
    ):
        self.sess = sess
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.on_failure = on_failure
        self.key = key
        self._stop = threading.Event()
        self._suspected: set = set()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None
        # Staleness is judged LOCALLY: we record the local monotonic time at
        # which each peer's posted value last *changed*. Comparing a peer's
        # wall clock against ours would turn cross-host clock skew into
        # false suspicions (or masked failures).
        self._last_seen: Dict[int, tuple] = {}  # rank -> (value, local_mono)

    # ------------------------------------------------------------------
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

    def suspected(self) -> List[int]:
        with self._lock:
            return sorted(self._suspected)

    def beat_once(self) -> None:
        """Post one heartbeat (called by the monitor loop; callable directly
        from training loops that want heartbeats tied to step progress).

        The value is an opaque monotonically-increasing counter — peers only
        check that it CHANGES, never compare it against their own clocks."""
        self.sess.store.set(
            f"{self.key}/{self.sess.rank}",
            json.dumps(time.monotonic()).encode(),
        )

    # ------------------------------------------------------------------
    def _check_peers(self) -> None:
        now = time.monotonic()
        newly_dead = []
        for r in range(self.sess.world):
            if r == self.sess.rank:
                continue
            raw = self.sess.store.get(f"{self.key}/{r}")
            value = json.loads(raw.decode()) if raw else None
            if value is None:
                # never-seen peer gets the full timeout as a startup grace
                dead = (now - self._started_at) > self.timeout_s
            else:
                seen = self._last_seen.get(r)
                if seen is None or seen[0] != value:
                    self._last_seen[r] = (value, now)  # changed -> alive now
                dead = (now - self._last_seen[r][1]) > self.timeout_s
            last = value
            with self._lock:
                if dead and r not in self._suspected:
                    self._suspected.add(r)
                    _log.warning("peer rank %d suspected dead (last hb %s)", r, last)
                    newly_dead.append(r)
                elif not dead and r in self._suspected:
                    self._suspected.discard(r)
                    _log.info("peer rank %d recovered", r)
        # callbacks fire outside the lock: they may call suspected()/stop()
        if self.on_failure is not None:
            for r in newly_dead:
                self.on_failure(r)

    def _run(self) -> None:
        self._started_at = time.monotonic()
        self.beat_once()
        self._stop.wait(self.interval_s)
        while not self._stop.is_set():
            self.beat_once()
            self._check_peers()
            self._stop.wait(self.interval_s)
