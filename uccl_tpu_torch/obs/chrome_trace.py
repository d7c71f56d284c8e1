"""Chrome-trace / Perfetto JSON export of a :class:`~uccl_tpu.obs.tracer.Tracer`.

Port copy of ``uccl_tpu/obs/chrome_trace.py`` (jax-free there too).

Emits the Trace Event Format's JSON object form (``{"traceEvents": [...]}``)
with ``B``/``E``/``X``/``i`` phase events plus ``M`` metadata naming the
process and one thread row per tracer track — so ``ui.perfetto.dev`` (or
``chrome://tracing``) opens the file directly and shows each request,
the engine loop, and the wire as its own labeled row.

Format notes (the parts tools are strict about):

* timestamps (``ts``) and durations (``dur``) are microseconds;
* ``X`` events must carry a non-negative ``dur``;
* ``i`` (instant) events carry a scope ``s`` ("t" = thread-scoped);
* every ``B`` should be closed by an ``E`` on the same pid/tid —
  :func:`to_chrome_trace` closes any still-open ``B`` at the trace's end
  timestamp rather than emitting an unbalanced file;
* flow events (``s``/``f``) carry ``cat`` + ``id`` (the s/f pair binds by
  both), and the finish end binds to its enclosing slice (``bp: "e"``).

Fleet metadata: ``otherData.clock`` records the tracer's wall-clock anchor
(``wall_epoch_us`` — wall time of monotonic ts 0) and the process's
estimated offset from the fleet reference clock (``offset_us``, set by the
disagg HELLO clock exchange). ``scripts/trace_merge.py`` reads exactly
these fields to align N per-process trace files onto one timeline.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from uccl_tpu_torch.obs.tracer import Tracer, get_tracer

__all__ = ["to_chrome_trace", "dumps", "dump"]

PID = 1  # one process: the python host runtime


def to_chrome_trace(tracer: Optional[Tracer] = None, *,
                    process_name: str = "uccl_tpu") -> dict:
    """Build the Chrome-trace JSON object for ``tracer`` (default: the
    global one). Returns ``{"traceEvents": [], ...}`` when tracing is off —
    an empty but valid trace, never an error."""
    tracer = tracer if tracer is not None else get_tracer()
    events = tracer.events() if tracer is not None else []

    tids: Dict[str, int] = {}
    out: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": PID,
        "args": {"name": process_name},
    }]

    def tid(track: str) -> int:
        t = tids.get(track)
        if t is None:
            t = tids[track] = len(tids) + 1
            out.append({
                "name": "thread_name", "ph": "M", "pid": PID, "tid": t,
                "args": {"name": track},
            })
            out.append({
                "name": "thread_sort_index", "ph": "M", "pid": PID,
                "tid": t, "args": {"sort_index": t},
            })
        return t

    # track open B stacks per tid so the emitted file is always balanced
    open_b: Dict[int, List[str]] = {}
    end_ts = 0.0
    for ev in events:
        t = tid(ev.track)
        end_ts = max(end_ts, ev.ts_us + (ev.dur_us if ev.ph == "X" else 0.0))
        rec = {"name": ev.name, "ph": ev.ph, "pid": PID, "tid": t,
               "ts": round(ev.ts_us, 3)}
        if ev.ph == "X":
            rec["dur"] = round(max(0.0, ev.dur_us), 3)
        elif ev.ph == "i":
            rec["s"] = "t"
        elif ev.ph in ("s", "f"):
            rec["cat"] = "flow"
            rec["id"] = ev.fid
            if ev.ph == "f":
                rec["bp"] = "e"  # bind to the enclosing slice
        elif ev.ph == "B":
            open_b.setdefault(t, []).append(ev.name)
        elif ev.ph == "E":
            stack = open_b.get(t)
            if not stack:
                continue  # E whose B fell off the ring: drop, stay balanced
            stack.pop()
        if ev.args:
            rec["args"] = dict(ev.args)
        out.append(rec)
    # close any B still open (e.g. a span in flight at dump time)
    for t, stack in open_b.items():
        for name in reversed(stack):
            out.append({"name": name, "ph": "E", "pid": PID, "tid": t,
                        "ts": round(end_ts, 3)})

    trace = {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "uccl_tpu.obs",
                      "process_name": process_name},
    }
    if tracer is not None:
        # per-process clock metadata — the merge tool's alignment inputs
        clock = {
            "wall_epoch_us": round(tracer.wall_epoch_us, 3),
            "offset_us": round(tracer.clock_offset_us, 3),
        }
        clock.update(tracer.clock_meta)
        trace["otherData"]["clock"] = clock
        if tracer.dropped:
            trace["otherData"]["dropped_events"] = tracer.dropped
    return trace


def dumps(tracer: Optional[Tracer] = None, **kw) -> str:
    return json.dumps(to_chrome_trace(tracer, **kw))


def dump(path: str, tracer: Optional[Tracer] = None, **kw) -> str:
    """Write the trace JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer, **kw), f)
    return path
