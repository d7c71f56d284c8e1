"""Black-box flight recorder — the active half of the obs spine.

The tracer ring and the counter registry are *passive*: traces dump at
exit, metrics are read when someone scrapes. By the time a chaos arm or
a fleet run has visibly gone wrong, the evidence of *why* has fallen off
the back of the ring. The flight recorder closes that gap: it is armed
once per process (``enable(out_dir)``), instrumentation sites across the
stack call :func:`trigger` when a pathology fires, and the recorder
atomically freezes everything a post-mortem needs into ONE self-
describing JSON bundle:

* the last N tracer ring events (what led up to the trigger),
* the full counter/gauge/histogram registry as Prometheus text (so the
  bundle is parseable by the same ``obs/aggregate.py`` parser every
  other tool uses),
* every registered state provider's snapshot — per-path SACK/CC state
  from the windowed channel, engine slot/scheduler occupancy, fleet
  directory state — captured at trigger time,
* the trigger's own context (which peer died, which path stormed, how
  far the RTO backed off).

Trigger taxonomy (``TRIGGERS``) is closed on purpose — ``doctor`` maps
each kind to a root-cause narrative, and ``check_obs --flight`` asserts
bundle/counter agreement per kind:

* ``conservation``       — the serving invariant broke
  (submitted != completed+active+queued+rejected+expired+lost)
* ``peer_dead``          — a FailureDetector HEALTHY→DEAD transition
  (or a fleet worker latching a dead cache owner)
* ``retx_storm``         — SACK retransmit count crossed the armed
  threshold inside one windowed transfer
* ``rto_backoff``        — the Jacobson RTO backed off past the armed
  ceiling (sustained loss / blackout, not isolated drops)
* ``ctrl_storm``         — disagg control-plane retries crossed the
  armed threshold (notif plane lossy or peer unresponsive)
* ``slo_burn``           — a multi-window burn-rate monitor alerted
  (obs/slo.py)
* ``step_stall``         — one engine ``step()`` exceeded the armed
  wall-clock budget
* ``uncaught_exception`` — a serve or bench entry point died; the excepthook
  dumps before the process unwinds

Discipline over volume: dumps are **deduplicated** (one bundle per
(kind, key) — a dead peer dumps once, not once per tick), **rate
limited** (``min_interval_s`` between bundles), and **capped**
(``max_dumps`` per recorder). Every written bundle counts on
``obs_flight_dumps_total{trigger=...}`` (incremented BEFORE the
registry snapshot, so a bundle always shows its own dump); every
suppressed one counts on ``obs_flight_suppressed_total{reason=...}``.
A clean run writes nothing and both counters stay zero — the chaos
bench's clean arm asserts exactly that.

Everything is a no-op (one ``is None`` check) until :func:`enable` is
called, so the hooks threaded through the hot paths cost nothing in
normal operation.

Port copy of ``uccl_tpu/obs/flight.py`` (jax-free there too).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from uccl_tpu_torch.obs import counters as _counters
from uccl_tpu_torch.obs import tracer as _tracer

SCHEMA = "uccl_tpu.flight/1"

TRIGGERS = (
    "conservation",
    "peer_dead",
    "retx_storm",
    "rto_backoff",
    "ctrl_storm",
    "slo_burn",
    "step_stall",
    "uncaught_exception",
)

_DUMPS = _counters.counter(
    "obs_flight_dumps_total",
    "flight-recorder post-mortem bundles written, by trigger kind")
_SUPPRESSED = _counters.counter(
    "obs_flight_suppressed_total",
    "flight triggers that fired but wrote no bundle, by reason "
    "(disabled excluded: an unarmed recorder is not a suppression)")


def _jsonable(obj):
    """Best-effort deep conversion to JSON-encodable values — a state
    provider returning a numpy scalar or a tuple key must degrade to a
    string, never kill the dump (the dump IS the diagnostic channel)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v) for v in obj]
    for attr in ("item", "tolist"):  # numpy scalars/arrays
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return _jsonable(fn())
            except Exception:
                break
    return repr(obj)


class FlightRecorder:
    """Bounded post-mortem bundle writer. One per process is the intended
    shape (module singleton via :func:`enable`), but the class is direct-
    constructible for tests — ``clock`` is injectable so rate-limit and
    dedup behavior are testable without sleeping."""

    def __init__(self, out_dir: str, *, last_events: int = 256,
                 max_dumps: int = 16, min_interval_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self.out_dir = out_dir
        self.last_events = int(last_events)
        self.max_dumps = int(max_dumps)
        self.min_interval_s = float(min_interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._providers: Dict[str, Callable[[], Dict]] = {}
        self._fired: set = set()     # (kind, key) dedup
        self._last_dump_t: Optional[float] = None
        self._seq = 0
        self.bundles: List[str] = []  # every path written, oldest first
        os.makedirs(out_dir, exist_ok=True)

    # -- state providers -----------------------------------------------------
    def register_provider(self, name: str, fn: Callable[[], Dict]) -> None:
        """Attach a live-state source captured into every future bundle.
        Names collide last-writer-wins (a re-created engine replaces its
        predecessor's provider rather than leaking it)."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # -- the trigger path ----------------------------------------------------
    def trigger(self, kind: str, key: Optional[str] = None,
                **context) -> Optional[str]:
        """Freeze-and-dump. Returns the bundle path, or None when the
        trigger was suppressed (dedup / rate / cap). ``key`` scopes
        dedup: pass a stable identity (peer name, transfer id) so ONE
        fault produces ONE bundle no matter how often its symptom
        re-fires; ``key=None`` skips dedup entirely."""
        if kind not in TRIGGERS:
            raise ValueError(f"unknown flight trigger {kind!r} "
                             f"(known: {TRIGGERS})")
        now = self.clock()
        with self._lock:
            if key is not None:
                dk = (kind, key)
                if dk in self._fired:
                    _SUPPRESSED.inc(reason="dedup")
                    return None
                self._fired.add(dk)
            if self._seq >= self.max_dumps:
                _SUPPRESSED.inc(reason="cap")
                return None
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < self.min_interval_s):
                _SUPPRESSED.inc(reason="rate")
                return None
            self._last_dump_t = now
            self._seq += 1
            seq = self._seq
            providers = dict(self._providers)

        # count FIRST: the bundle's own registry snapshot must show this
        # dump, so check_obs can assert bundle-count == counter value.
        _DUMPS.inc(trigger=kind)
        t = _tracer.get_tracer()
        if t is not None:
            t.instant("flight_dump", track="flight", trigger=kind,
                      **{k: v for k, v in context.items()
                         if isinstance(v, (str, int, float, bool))})
        bundle = self._collect(kind, key, context, providers, seq)
        path = os.path.join(self.out_dir,
                            f"flight_{seq:03d}_{kind}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)  # atomic: a reader never sees a torn bundle
        with self._lock:
            self.bundles.append(path)
        return path

    def _collect(self, kind, key, context, providers, seq) -> Dict:
        from uccl_tpu_torch.obs import export as _export

        t = _tracer.get_tracer()
        events: List[Dict] = []
        dropped = 0
        if t is not None:
            evs = t.events()[-self.last_events:]
            dropped = t.dropped
            for e in evs:
                d = {"name": e.name, "ph": e.ph, "ts_us": e.ts_us,
                     "track": e.track}
                if e.dur_us is not None:
                    d["dur_us"] = e.dur_us
                if e.fid is not None:
                    d["fid"] = e.fid
                if e.args:
                    d["args"] = _jsonable(e.args)
                events.append(d)
        state = {}
        for name, fn in providers.items():
            try:
                state[name] = _jsonable(fn())
            except Exception as e:  # a broken provider must not lose the dump
                state[name] = {"error": repr(e)}
        return {
            "schema": SCHEMA,
            "seq": seq,
            "trigger": {
                "kind": kind,
                "key": key,
                "t_mono_s": self.clock(),
                "t_wall_s": time.time(),
                "ts_us": t.now_us() if t is not None else None,
                "context": _jsonable(context),
            },
            "host": {"pid": os.getpid(),
                     "hostname": socket.gethostname(),
                     "argv": list(sys.argv)},
            "events": events,
            "events_dropped_from_ring": dropped,
            "state": state,
            "metrics_prom": _export.prometheus_text(),
            "registry": _counters.REGISTRY.snapshot(),
        }


# -- module singleton (mirrors tracer.enable/disable) ------------------------

_recorder: Optional[FlightRecorder] = None


def enable(out_dir: str, **kw) -> FlightRecorder:
    """Arm the process-wide recorder. Re-enabling replaces the previous
    recorder (fresh dedup/cap state) but keeps nothing from it — benches
    re-arm per fault arm to isolate attribution."""
    global _recorder
    _recorder = FlightRecorder(out_dir, **kw)
    return _recorder


def disable() -> None:
    global _recorder
    _recorder = None


def enabled() -> bool:
    return _recorder is not None


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def trigger(kind: str, key: Optional[str] = None,
            **context) -> Optional[str]:
    """The hook every instrumentation site calls. Free when unarmed."""
    if _recorder is None:
        return None
    return _recorder.trigger(kind, key=key, **context)


def register_provider(name: str, fn: Callable[[], Dict]) -> None:
    if _recorder is not None:
        _recorder.register_provider(name, fn)


def unregister_provider(name: str) -> None:
    if _recorder is not None:
        _recorder.unregister_provider(name)


def record_exception(exc: BaseException,
                     where: str = "main") -> Optional[str]:
    """Dump on an entry point's failure (callers re-raise after)."""
    tb = traceback.format_exception(type(exc), exc, exc.__traceback__)
    return trigger("uncaught_exception",
                   key=f"{where}:{type(exc).__name__}",
                   where=where, exc_type=type(exc).__name__,
                   exc=str(exc), traceback_tail="".join(tb)[-4000:])


_prev_excepthook = None


def install_excepthook(where: str = "main") -> None:
    """Chain onto ``sys.excepthook`` so an uncaught crash in a serve or
    bench entry point writes its post-mortem before the interpreter unwinds.
    Idempotent; the previous hook still runs (the traceback still
    prints)."""
    global _prev_excepthook
    if _prev_excepthook is not None:
        return
    _prev_excepthook = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            e = exc if exc is not None else exc_type()
            if e.__traceback__ is None and tb is not None:
                e = e.with_traceback(tb)
            record_exception(e, where=where)
        except Exception:
            pass  # the ORIGINAL traceback must still reach the user
        _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = hook
