"""Export surfaces for the obs registry + tracer.

Port copy of ``uccl_tpu/obs/export.py`` (jax-free there too).

Three consumers, one source of truth (:data:`uccl_tpu.obs.counters.REGISTRY`
and the global tracer):

* **Prometheus text** (:func:`prometheus_text`) — counters/gauges with
  labels, histogram families as merge-safe ``_bucket``/``_sum``/``_count``
  lines (identical log-spaced edges in every process, so N workers'
  exports SUM — obs/aggregate.py federates them), the live tracer's ring
  drops as ``obs_trace_dropped_total``, plus every pull source's numeric
  leaves flattened to gauges (``<source>_<path>``), all through the shared
  sanitizer. Declared-but-empty families export an unlabeled 0 sample (or
  an all-zero histogram) so dashboards and CI can assert a series exists
  before its first event.
* **JSON snapshot** (:func:`json_snapshot`) — the registry's snapshot plus
  tracer stats, schema-versioned.
* **files / HTTP** — ``--trace-out`` / ``--metrics-out`` dump files from
  any CLI (:func:`add_cli_args` / :func:`setup_from_args` /
  :func:`dump_from_args`); :class:`MetricsServer` is the live ``/metrics``
  + ``/snapshot`` surface ``serve --server`` exposes (stdlib
  ``http.server`` on a daemon thread — no new dependencies).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

from uccl_tpu_torch.obs import chrome_trace, tracer as _tracer
from uccl_tpu_torch.obs.counters import (
    REGISTRY, Registry, escape_label_value, fmt_value, sanitize_name,
)

__all__ = [
    "SCHEMA_VERSION", "prometheus_text", "json_snapshot",
    "write_metrics", "write_trace", "MetricsServer",
    "add_cli_args", "setup_from_args", "dump_from_args",
]

# version of the exported JSON shapes (snapshot + the serve/serving_bench
# summary lines that embed it); bump on breaking renames
SCHEMA_VERSION = 1


def _flatten(prefix: str, node, out: Dict[str, float]) -> None:
    """Numeric leaves of a nested source dict → flat sanitized gauge names
    (non-numeric leaves are dropped; bools are not numbers here)."""
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}_{k}" if prefix else str(k), v, out)
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        out[sanitize_name(prefix)] = float(node)


def _label_str(labels: Dict[str, str]) -> str:
    return ",".join(
        f'{sanitize_name(k)}="{escape_label_value(str(v))}"'
        for k, v in sorted(labels.items())
    )


def _histogram_lines(fam, lines: List[str]) -> None:
    """One labeled histogram as Prometheus ``_bucket``/``_sum``/``_count``
    lines (cumulative buckets, inclusive ``le``, ``+Inf`` last). Identical
    bucket edges across processes make these lines SUMMABLE — the merge
    property obs/aggregate.py federates on."""
    name = sanitize_name(fam.name)
    samples = fam.hist_samples()
    if not samples:
        # declared-but-empty: an all-zero unlabeled histogram, so the
        # series is assertable before its first observation (the counter
        # families' rule, docs/OBSERVABILITY.md)
        samples = [({}, [0] * (len(fam.uppers) + 1), 0.0)]
    for labels, counts, total in samples:
        lbl = _label_str(labels)
        cum = 0
        for ub, c in zip(list(fam.uppers) + ["+Inf"], counts):
            cum += c
            le = ub if isinstance(ub, str) else _fmt(ub)
            sep = "," if lbl else ""
            lines.append(f'{name}_bucket{{{lbl}{sep}le="{le}"}} {cum}')
        suffix = f"{{{lbl}}}" if lbl else ""
        lines.append(f"{name}_sum{suffix} {_fmt(total)}")
        lines.append(f"{name}_count{suffix} {cum}")


def prometheus_text(registry: Registry = REGISTRY,
                    extra_lines: Optional[List[str]] = None) -> str:
    """The registry in Prometheus text exposition format."""
    lines: List[str] = []
    for fam in registry.families():
        name = sanitize_name(fam.name)
        if fam.help:
            lines.append(f"# HELP {name} {fam.help}")
        lines.append(f"# TYPE {name} {fam.kind}")
        if fam.kind == "histogram":
            _histogram_lines(fam, lines)
            continue
        samples = fam.samples()
        if not samples:
            # a declared family with no events yet still exports its series
            lines.append(f"{name} 0")
            continue
        for labels, value in samples:
            if labels:
                lines.append(
                    f"{name}{{{_label_str(labels)}}} {_fmt(value)}"
                )
            else:
                lines.append(f"{name} {_fmt(value)}")
    # the tracer's silent ring drops, surfaced as a counter: a truncated
    # trace is visible in every scrape, not just in the dump footer
    t = _tracer.get_tracer()
    lines.append("# TYPE obs_trace_dropped_total counter")
    lines.append(
        f"obs_trace_dropped_total {int(t.dropped) if t is not None else 0}"
    )
    for src, snap in sorted(registry.sources_snapshot().items()):
        flat: Dict[str, float] = {}
        _flatten(sanitize_name(src), snap, flat)
        for name, value in sorted(flat.items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(value)}")
    if extra_lines:
        lines.extend(extra_lines)
    return "\n".join(lines) + "\n"


_fmt = fmt_value  # shared with aggregate.py so the exporters cannot drift


def json_snapshot(registry: Registry = REGISTRY) -> Dict:
    snap = registry.snapshot()
    snap["schema_version"] = SCHEMA_VERSION
    t = _tracer.get_tracer()
    snap["tracer"] = {
        "enabled": t is not None,
        "events": len(t) if t is not None else 0,
        "dropped": t.dropped if t is not None else 0,
    }
    return snap


def write_metrics(path: str, registry: Registry = REGISTRY,
                  extra_lines: Optional[List[str]] = None) -> str:
    with open(path, "w") as f:
        f.write(prometheus_text(registry, extra_lines))
    return path


def write_trace(path: str, process_name: str = "uccl_tpu") -> str:
    return chrome_trace.dump(path, process_name=process_name)


class MetricsServer:
    """``/metrics`` (Prometheus text) + ``/snapshot`` (JSON) on a daemon
    thread. ``extra_lines_fn`` lets the owner append live series (the
    serving engine's percentile lines) to each /metrics scrape.

    ``port=0`` (the default) binds an EPHEMERAL port — the fleet-safe
    choice: two workers starting on one host with a fixed default port
    would race to bind and one would crash. The bound port is always on
    ``self.port`` and in the start log; a fleet aggregator
    (obs/aggregate.py) collects the per-worker ports from there."""

    def __init__(self, port: int = 0, registry: Registry = REGISTRY,
                 extra_lines_fn=None):
        import http.server

        reg = registry
        extra = extra_lines_fn

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                if self.path.rstrip("/") == "/metrics":
                    body = prometheus_text(
                        reg, extra() if extra is not None else None
                    ).encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.rstrip("/") == "/snapshot":
                    body = json.dumps(json_snapshot(reg)).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # keep scrapes off stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        from uccl_tpu_torch.utils.logging import log

        log("INFO", "metrics server listening on 127.0.0.1:%d "
            "(/metrics + /snapshot)", self.port, subsys="UTIL")

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# -- CLI wiring (every entry point shares these three calls) -----------------
def add_cli_args(ap) -> None:
    """``--trace-out`` / ``--metrics-out`` / ``--metrics-port`` on any
    argparse parser."""
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "here (enables the event tracer)")
    ap.add_argument("--metrics-out", default="",
                    help="write the Prometheus-text metrics snapshot here "
                         "at exit")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve live /metrics + /snapshot on this local "
                         "port for the run's duration (0 = off)")
    ap.add_argument("--flight-dir", default="",
                    help="arm the flight recorder: post-mortem bundles "
                         "(obs/flight.py) land in this directory on "
                         "trigger; the process's excepthook is installed "
                         "so an uncaught crash dumps too")


def setup_from_args(args, capacity: int = 65536) -> None:
    """Enable the tracer when the CLI asked for a trace, and arm the
    flight recorder when it asked for a bundle directory. Call before
    the instrumented work starts."""
    if getattr(args, "trace_out", ""):
        _tracer.enable(capacity)
    if getattr(args, "flight_dir", ""):
        from uccl_tpu_torch.obs import flight as _flight

        _flight.enable(args.flight_dir)
        _flight.install_excepthook()


_dumped_args: set = set()  # id(args) namespaces an explicit dump already ran


def dump_from_args(args, extra_lines: Optional[List[str]] = None,
                   process_name: str = "uccl_tpu") -> List[str]:
    """Write the files the CLI asked for; returns the paths written.
    ``process_name`` labels the trace's process row — per-role names
    (``uccl_tpu.prefill``/``uccl_tpu.decode``) keep merged fleet traces
    readable (scripts/trace_merge.py)."""
    written = []
    if getattr(args, "trace_out", ""):
        written.append(write_trace(args.trace_out, process_name))
    if getattr(args, "metrics_out", ""):
        written.append(write_metrics(args.metrics_out,
                                     extra_lines=extra_lines))
    _dumped_args.add(id(args))
    return written


def dump_at_exit(args) -> None:
    """Crash-safety net: dump at interpreter exit UNLESS an explicit
    :func:`dump_from_args` already ran for these args — a successful run's
    richer dump (e.g. with the serving engine's percentile lines appended)
    must not be overwritten by the bare registry state. A traced run that
    dies mid-flight still leaves its partial trace on disk, which is
    exactly when the trace is most needed."""
    import atexit

    def _fallback():
        if id(args) not in _dumped_args:
            dump_from_args(args)

    atexit.register(_fallback)
