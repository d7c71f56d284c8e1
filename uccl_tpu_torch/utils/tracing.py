"""Profiling / tracing hooks.

The answer to the reference's observability stack (SURVEY.md §5: STATS engine
counters, latency histograms, NPKit GPU event tracing, nsys wrappers):
``torch.profiler`` captures written as Chrome/Perfetto traces, named
annotations that show up on the same timeline (``annotate``, the obs
tracer's ``span`` plus an NVTX range on the card), and a wall-clock scope
timer feeding LatencyHistograms.

``timed_scope`` keeps its histogram contract (``scope_stats`` /
``reset_scopes``) and also lands every sample as a span on the obs tracer
(when enabled); the per-scope summaries are registered as the ``scopes`` pull
source on :data:`uccl_tpu_torch.obs.REGISTRY`, so they ride the ``/metrics``
+ ``/snapshot`` exports.

Port of ``uccl_tpu/utils/tracing.py``: its ``jax.profiler`` XPlane capture
and ``TraceAnnotation`` become a ``torch.profiler`` capture (CPU activity,
plus CUDA activity when the card is in use) and the obs span (a
``record_function`` range inside a capture); the scope timer is unchanged.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.obs import tracer as _obst
from uccl_tpu_torch.utils.latency import LatencyHistogram
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("UTIL")

# scope histograms: mutated from arbitrary runtime threads, so every access
# goes through the lock (a get-then-setdefault pair would race two threads
# into distinct histograms, silently dropping one side's samples)
_scope_hists: Dict[str, LatencyHistogram] = {}
_scope_lock = threading.Lock()

# the one capture in flight (a profiler capture is process-wide, as
# jax.profiler's is): (profile, log_dir)
_capture: Optional[tuple] = None
_capture_lock = threading.Lock()


def _scopes_source() -> Dict[str, Dict[str, float]]:
    """Per-scope summaries for the obs registry (the ``scopes`` source)."""
    with _scope_lock:
        hists = dict(_scope_hists)
    return {name: h.summary() for name, h in hists.items()}


_obsc.REGISTRY.register_source("scopes", _scopes_source)


def _on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def start_trace(log_dir: str) -> None:
    """Begin a ``torch.profiler`` capture of host ops and, when the card is
    in use, its kernels; :func:`stop_trace` writes it into ``log_dir``.
    Raises if a capture is already running."""
    global _capture
    from torch.profiler import ProfilerActivity, profile

    with _capture_lock:
        if _capture is not None:
            raise RuntimeError("a trace capture is already running")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _capture = (prof, log_dir)


def stop_trace() -> str:
    """End the capture and write it as a Chrome/Perfetto trace
    (``trace_<pid>_<ns>.json`` in the ``log_dir`` given to
    :func:`start_trace`); returns its path. Raises if no capture runs."""
    global _capture
    with _capture_lock:
        if _capture is None:
            raise RuntimeError("no trace capture is running")
        prof, log_dir = _capture
        _capture = None
    if _on_card():
        torch.cuda.synchronize()  # the capture ends after the enqueued kernels
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """:func:`uccl_tpu_torch.obs.span` ``name`` (a ``record_function`` range
    in a profiler capture, an event on the obs tracer when it is on), and
    an NVTX range while the card is in use."""
    nvtx = _on_card()
    with _obst.span(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def timed_scope(name: str, log: bool = False) -> Iterator[None]:
    """Wall-clock scope timer; samples land in a per-name LatencyHistogram
    (uccl_tpu_torch.utils.latency) retrievable via :func:`scope_stats`, and
    as a span on the obs tracer when tracing is enabled. Host time: a scope
    around work on the card ends in a sync if it is to time that work."""
    tr = _obst.get_tracer()
    ts0 = tr.now_us() if tr is not None else 0.0
    t0 = time.perf_counter()
    try:
        yield
    finally:
        us = (time.perf_counter() - t0) * 1e6
        with _scope_lock:
            hist = _scope_hists.get(name)
            if hist is None:
                hist = _scope_hists[name] = LatencyHistogram()
        hist.record(us)
        if tr is not None:
            tr.complete(name, ts0, tr.now_us() - ts0)
        if log:
            _log.info("%s: %.1f us", name, us)


def scope_stats(name: str) -> Optional[Dict[str, float]]:
    with _scope_lock:
        h = _scope_hists.get(name)
    return h.summary() if h else None


def reset_scopes() -> None:
    with _scope_lock:
        _scope_hists.clear()
