"""Thread-safe, ring-buffered event tracer (the NPKit analog, host-side).

Port copy of ``uccl_tpu/obs/tracer.py`` (jax-free there too), on this
package's counter registry. The device timeline of the port belongs to
``torch.profiler``; the spans here are host windows (``ep.<verb>`` on the
``wire`` track, for instance).

The reference ships NPKit GPU event tracing (SURVEY.md §5): fixed-size
per-channel event buffers filled by the kernels and dumped to a
Chrome-trace post-hoc. The TPU reproduction's device timeline already
belongs to ``jax.profiler`` (utils/tracing.py); what was missing is the
HOST event spine — request lifecycles, engine steps, wire windows — with
the same properties the NPKit design proves out:

* **bounded memory**: events land in a ring buffer (``deque(maxlen=...)``);
  a long-lived server can trace forever, old events fall off the back and
  are counted in ``dropped``.
* **thread-safe**: any runtime thread may record; one lock per record,
  nothing else shared.
* **zero-cost when disabled**: the module-level helpers check one bool and
  return a cached no-op context manager — no allocation, no lock, no
  timestamp read.
* **monotonic timestamps**: ``time.perf_counter`` relative to the tracer's
  epoch, in microseconds (the Chrome-trace unit), so spans from different
  threads land on one consistent timeline.

Tracks: every event carries a ``track`` label — the Chrome-trace exporter
maps each distinct label to a tid row. ``track=None`` means "this thread's
auto track" (``thread-<n>`` in first-seen order), so concurrent writers
never interleave on one row; instrumentation that owns a logical timeline
(a request, the engine loop, the wire) passes an explicit label instead.

Event phases follow the Chrome-trace vocabulary: ``X`` (complete span with
a duration — what :func:`span`/:meth:`Tracer.complete` emit), ``B``/``E``
(open/close pairs for spans that cross call boundaries), ``i`` (instant),
and ``s``/``f`` flow start/finish pairs (:meth:`Tracer.flow`) whose shared
``fid`` binds two spans — possibly in DIFFERENT processes' traces, once
merged by ``scripts/trace_merge.py`` — into one Perfetto arrow.

Fleet clocks: each tracer records ``wall_epoch_us`` (the wall-clock time of
its monotonic ts 0) at construction, and :meth:`set_clock_offset` stores
the process's estimated wall-clock offset from the fleet's reference
process (the disagg HELLO clock exchange, obs/context.py). Both land in
the exported trace's ``otherData.clock`` so the merge tool can place N
per-process traces on one causally ordered timeline.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

from uccl_tpu_torch.obs.counters import counter as _counter

# Ring overflow as a REGISTRY counter, not only `Tracer.dropped`: the
# per-process attribute reaches the Chrome trace's otherData, but a
# fleet federator only sees what Prometheus text carries — this family
# makes trace loss visible across workers (obs/aggregate.py sums it).
_EVENTS_DROPPED = _counter(
    "obs_trace_events_dropped_total",
    "trace events evicted from the bounded ring before export — "
    "nonzero means the Chrome trace is missing its oldest history")

__all__ = [
    "Event", "Tracer", "enable", "disable", "enabled", "get_tracer",
    "span", "instant", "begin", "end", "complete",
    "flow_start", "flow_end", "set_clock_offset",
]


class Event(NamedTuple):
    """One trace event. ``ts_us`` is microseconds since the tracer's epoch;
    ``dur_us`` is only meaningful for ``ph == "X"``; ``args`` is a small
    JSON-ready dict (or None); ``fid`` is the flow-event id, set only for
    ``ph in ("s", "f")``."""

    name: str
    ph: str  # "X" | "B" | "E" | "i" | "s" | "f"
    ts_us: float
    dur_us: float
    track: str
    args: Optional[dict]
    fid: Optional[int] = None


class Tracer:
    """Ring-buffered event recorder. All methods are thread-safe."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # wall anchor first, monotonic epoch immediately after: the pair
        # relates ts 0 to the wall clock (the merge tool's per-file
        # alignment anchor); the sub-µs gap between the two reads is far
        # below the cross-process offset the anchor exists to absorb
        self.wall_epoch_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        self._threads: Dict[int, str] = {}  # ident -> auto track label
        self.dropped = 0
        # this process's estimated wall-clock offset from the fleet's
        # reference process (0 until a clock exchange sets it); clock_meta
        # carries the estimate's provenance (rtt, peer, source)
        self.clock_offset_us = 0.0
        self.clock_meta: Dict = {}

    # -- clock ---------------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since this tracer's epoch (monotonic)."""
        return (time.perf_counter() - self._t0) * 1e6

    def set_clock_offset(self, offset_us: float, **meta) -> None:
        """Record this process's estimated wall-clock offset from the
        fleet's reference process (``local_wall - reference_wall``, µs).
        The merge tool subtracts it when aligning this trace's timestamps
        (docs/OBSERVABILITY.md). ``meta`` (rtt_us, peer, ...) is exported
        verbatim in the trace's ``otherData.clock``."""
        with self._lock:
            self.clock_offset_us = float(offset_us)
            self.clock_meta = dict(meta)

    # -- recording -----------------------------------------------------------
    def _track(self, track: Optional[str]) -> str:
        if track is not None:
            return track
        ident = threading.get_ident()
        t = self._threads.get(ident)
        if t is None:
            # racy get-then-set is fine: both racers write the same mapping
            # only if they share an ident, which they cannot
            with self._lock:
                t = self._threads.setdefault(
                    ident, f"thread-{len(self._threads)}"
                )
        return t

    def _record(self, ev: Event) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
                _EVENTS_DROPPED.inc()
            self._buf.append(ev)

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        self._record(Event(name, "i", self.now_us(), 0.0,
                           self._track(track), args or None))

    def begin(self, name: str, track: Optional[str] = None, **args) -> None:
        self._record(Event(name, "B", self.now_us(), 0.0,
                           self._track(track), args or None))

    def end(self, name: str, track: Optional[str] = None) -> None:
        self._record(Event(name, "E", self.now_us(), 0.0,
                           self._track(track), None))

    def complete(self, name: str, ts_us: float, dur_us: float,
                 track: Optional[str] = None, **args) -> None:
        """Record a finished span ("X") from explicit timestamps — the form
        instrumentation uses when ONE measured window yields spans on
        several tracks (e.g. a batched prefill covering many requests)."""
        self._record(Event(name, "X", ts_us, max(0.0, dur_us),
                           self._track(track), args or None))

    def flow(self, name: str, ph: str, fid: int,
             track: Optional[str] = None,
             ts_us: Optional[float] = None) -> None:
        """Record a flow start ("s") or finish ("f") event. The s/f pair
        sharing ``fid`` (and ``name``) binds the spans enclosing their
        timestamps into one Perfetto arrow — pass ``ts_us`` INSIDE the
        span the flow should attach to (Chrome binds a flow event to the
        slice containing its timestamp on that track)."""
        if ph not in ("s", "f"):
            raise ValueError(f"flow phase must be 's' or 'f', got {ph!r}")
        self._record(Event(name, ph,
                           self.now_us() if ts_us is None else ts_us,
                           0.0, self._track(track), None, int(fid)))

    @contextlib.contextmanager
    def span(self, name: str, track: Optional[str] = None, **args):
        """Context manager: one "X" event spanning the with-block."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, self.now_us() - t0, track, **args)

    # -- readout -------------------------------------------------------------
    def events(self) -> List[Event]:
        """Snapshot of the ring (oldest first)."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


# -- module-level singleton (what instrumentation calls) ---------------------
_tracer: Optional[Tracer] = None  # None = disabled: the zero-cost check


class _NullSpan:
    """Reusable no-op context manager — the disabled-tracer fast path
    allocates nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def enable(capacity: int = 65536) -> Tracer:
    """Install (or replace) the global tracer and return it."""
    global _tracer
    _tracer = Tracer(capacity)
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def span(name: str, track: Optional[str] = None, **args):
    """Span on the global tracer; a cached no-op when tracing is off."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, track, **args)


def instant(name: str, track: Optional[str] = None, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, track, **args)


def begin(name: str, track: Optional[str] = None, **args) -> None:
    t = _tracer
    if t is not None:
        t.begin(name, track, **args)


def end(name: str, track: Optional[str] = None) -> None:
    t = _tracer
    if t is not None:
        t.end(name, track)


def complete(name: str, ts_us: float, dur_us: float,
             track: Optional[str] = None, **args) -> None:
    t = _tracer
    if t is not None:
        t.complete(name, ts_us, dur_us, track, **args)


def flow_start(name: str, fid: int, track: Optional[str] = None,
               ts_us: Optional[float] = None) -> None:
    t = _tracer
    if t is not None:
        t.flow(name, "s", fid, track, ts_us)


def flow_end(name: str, fid: int, track: Optional[str] = None,
             ts_us: Optional[float] = None) -> None:
    t = _tracer
    if t is not None:
        t.flow(name, "f", fid, track, ts_us)


def set_clock_offset(offset_us: float, **meta) -> None:
    """Record the process's clock offset on the global tracer (no-op when
    tracing is off — the estimate still lives on whoever measured it)."""
    t = _tracer
    if t is not None:
        t.set_clock_offset(offset_us, **meta)
