"""Counter/gauge registry — the unified telemetry surface of the framework.

Port copy of ``uccl_tpu/obs/counters.py`` (jax-free there too), kept so the
port never imports the JAX package; the families are registered on this
package's own registry under the JAX package's names and labels.

This registry is the one place the framework's numbers live:

* **counters** — monotonic, labeled (``wire_fallback.inc(reason="budget")``):
  bytes moved per collective, pallas→lax fallback events with recorded
  reasons, admission rejections, traced-collective tallies.
* **gauges** — last-write-wins, labeled: slot-pool high-water, occupancy,
  resolved chunk-pipeline depth.
* **histograms** — bounded log-spaced buckets, labeled
  (``ttft_hist.observe(0.012)``): the MERGE-SAFE latency surface. Sample
  lists (``ServingMetrics.ttft_s``) give exact percentiles within one
  process but cannot be combined across processes by anything but raw
  concatenation; histograms with identical bucket edges SUM — N workers'
  ``_bucket`` counts add into one fleet distribution whose quantiles are
  correct to a bucket width (the Prometheus argument, PAPERS.md).
  :mod:`uccl_tpu_torch.obs.aggregate` is that summation.
* **sources** — pull callbacks (a serving engine's snapshot, for one),
  exported as gauges.

Everything is host-only, jax-free and thread-safe; reading never blocks
writers for longer than a dict copy. Export lives in
:mod:`uccl_tpu_torch.obs.export` (Prometheus text + JSON snapshot).

Label keys/values are kept verbatim here; sanitization to the Prometheus
grammar happens once at export (:func:`sanitize_name` /
:func:`escape_label_value` — shared with serving/metrics.py so the two
exporters cannot drift).
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CounterFamily", "GaugeFamily", "HistogramFamily", "Registry",
    "REGISTRY", "counter", "gauge", "histogram", "sanitize_name",
    "escape_label_value", "fmt_value", "log_buckets",
    "histogram_quantile", "bucket_width", "DEFAULT_LATENCY_BUCKETS",
]

LabelKey = Tuple[Tuple[str, str], ...]  # sorted (k, v) pairs

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Coerce to the Prometheus metric-name grammar
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (invalid chars → ``_``, digit-led names
    get a ``_`` prefix). The ONE sanitizer every exporter shares."""
    if _NAME_OK.match(name):
        return name
    name = _NAME_BAD_CHARS.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(v: str) -> str:
    """Escape a label value for the Prometheus text format."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def fmt_value(v: float) -> str:
    """Full-precision Prometheus sample value: integral floats as ints,
    everything else via repr (round-trip exact). Shared by export.py and
    aggregate.py — a %g-style shortening would silently corrupt large
    counters (1e7-scale byte totals) and break sum cross-checks."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """Shared labeled-sample storage for counters and gauges."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._samples: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def get(self, **labels) -> float:
        with self._lock:
            return self._samples.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = list(self._samples.items())
        return [(dict(k), v) for k, v in items]

    def total(self) -> float:
        with self._lock:
            return sum(self._samples.values())

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()


class CounterFamily(_Family):
    """Monotonic counter, optionally labeled."""

    kind = "counter"

    def inc(self, by: float = 1.0, **labels) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({by})")
        k = _label_key(labels)
        with self._lock:
            self._samples[k] = self._samples.get(k, 0.0) + by


class GaugeFamily(_Family):
    """Last-write-wins gauge, optionally labeled."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[_label_key(labels)] = float(value)

    def max(self, value: float, **labels) -> None:
        """Raise-only set (high-water marks)."""
        k = _label_key(labels)
        with self._lock:
            self._samples[k] = max(self._samples.get(k, value), float(value))


def log_buckets(lo: float, hi: float, per_decade: int = 4
                ) -> Tuple[float, ...]:
    """Log-spaced histogram upper bounds covering [lo, hi]: ``per_decade``
    edges per factor of 10, rounded to 6 significant digits so every
    process derives BIT-IDENTICAL edges (the merge-safety precondition —
    histograms only sum when their buckets match exactly)."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    ratio = 10.0 ** (1.0 / per_decade)
    out, v = [], float(lo)
    while v < hi * (1.0 + 1e-9):
        out.append(float(f"{v:.6g}"))
        v *= ratio
    return tuple(out)


# latency seconds, 100 µs .. ~60 s at 4 buckets/decade (24 bounded buckets
# + overflow) — wide enough for TTFT under overload, fine enough that a
# bucket-width quantile error stays under ~78% of the value (10^(1/4))
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-4, 60.0, per_decade=4)


def histogram_quantile(uppers: Sequence[float], counts: Sequence[int],
                       q: float) -> Optional[float]:
    """Quantile estimate from per-bucket counts (NOT cumulative):
    ``counts`` has ``len(uppers) + 1`` entries, the last the +Inf overflow.
    Linear interpolation inside the selected bucket (the Prometheus
    ``histogram_quantile`` shape), but the RANK convention matches
    ``serving.metrics.percentile`` (numpy's 1-based linear-interpolation
    rank ``1 + (n-1)q/100``) so histogram- and sample-derived percentiles
    of the same observations land in the same order statistic's bucket —
    the cross-check serving_bench stamps and ``check_obs --fleet`` gates
    on. The overflow bucket clamps to the top edge; None when empty."""
    n = sum(counts)
    if n == 0:
        return None
    target = 1.0 + (n - 1) * q / 100.0
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = uppers[i - 1] if i > 0 else 0.0
            if i >= len(uppers):
                return float(uppers[-1])  # overflow: clamp to the top edge
            hi = uppers[i]
            return float(lo + (hi - lo) * (target - cum) / c)
        cum += c
    return float(uppers[-1])  # pragma: no cover (target <= n always hits)


def bucket_width(uppers: Sequence[float], value: float) -> float:
    """Width of the bucket containing ``value`` — the agreement tolerance
    when cross-checking a histogram quantile against an exact sample
    percentile (check_obs --fleet)."""
    i = bisect.bisect_left(uppers, value)
    if i >= len(uppers):
        return float("inf")  # overflow bucket is unbounded
    lo = uppers[i - 1] if i > 0 else 0.0
    return float(uppers[i] - lo)


class HistogramFamily(_Family):
    """Bounded-bucket histogram, optionally labeled. Per-label-set state
    is (per-bucket counts incl. the +Inf overflow, sum of observations) —
    exactly the Prometheus ``_bucket``/``_sum``/``_count`` content, so two
    processes' exports SUM into a correct fleet distribution where
    concatenating percentile samples cannot (obs/aggregate.py)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help)
        ups = tuple(sorted(float(b) for b in
                           (buckets if buckets is not None
                            else DEFAULT_LATENCY_BUCKETS)))
        if not ups:
            raise ValueError(f"histogram {name} needs >= 1 bucket bound")
        self.uppers = ups

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        # Prometheus le is inclusive: the first upper >= v takes the count
        i = bisect.bisect_left(self.uppers, v)
        k = _label_key(labels)
        with self._lock:
            st = self._samples.get(k)
            if st is None:
                st = self._samples[k] = [[0] * (len(self.uppers) + 1), 0.0]
            st[0][i] += 1
            st[1] += v

    # _Family's float-valued surface, reinterpreted: a histogram's scalar
    # face is its observation COUNT (so snapshot()/total() stay JSON-flat)
    def get(self, **labels) -> float:
        with self._lock:
            st = self._samples.get(_label_key(labels))
            return float(sum(st[0])) if st is not None else 0.0

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = [(k, sum(st[0])) for k, st in self._samples.items()]
        return [(dict(k), float(v)) for k, v in items]

    def total(self) -> float:
        with self._lock:
            return float(sum(sum(st[0]) for st in self._samples.values()))

    def hist_samples(self) -> List[Tuple[Dict[str, str], List[int], float]]:
        """[(labels, per-bucket counts incl. overflow, sum)] — the export
        surface (obs/export.py writes it as _bucket/_sum/_count lines)."""
        with self._lock:
            items = [(k, list(st[0]), st[1])
                     for k, st in self._samples.items()]
        return [(dict(k), counts, s) for k, counts, s in items]

    def state(self) -> Dict[LabelKey, Tuple[Tuple[int, ...], float]]:
        """Immutable per-label snapshot — benches diff two states to get a
        window's own distribution out of the cumulative family."""
        with self._lock:
            return {k: (tuple(st[0]), st[1])
                    for k, st in self._samples.items()}

    def quantile(self, q: float, **labels) -> Optional[float]:
        with self._lock:
            st = self._samples.get(_label_key(labels))
            counts = list(st[0]) if st is not None else None
        if counts is None:
            return None
        return histogram_quantile(self.uppers, counts, q)


class Registry:
    """Named counter/gauge/histogram families + pull sources."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._sources: Dict[str, Callable[[], Dict]] = {}

    def counter(self, name: str, help: str = "") -> CounterFamily:
        return self._family(name, help, CounterFamily)

    def gauge(self, name: str, help: str = "") -> GaugeFamily:
        return self._family(name, help, GaugeFamily)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None
                  ) -> HistogramFamily:
        """Get-or-create a histogram. Re-registering with DIFFERENT
        buckets is an error — merge safety rests on every observer of a
        family sharing one set of edges."""
        fam = self._family(name, help, HistogramFamily, buckets=buckets)
        if buckets is not None and tuple(
                sorted(float(b) for b in buckets)) != fam.uppers:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"buckets (merge safety needs one edge set per family)"
            )
        return fam

    def _family(self, name, help, cls, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, **kw)
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            if help and not fam.help:
                fam.help = help
            return fam

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    # -- pull sources (the absorbed utils.stats surface) ---------------------
    def register_source(self, name: str,
                        fn: Callable[[], Dict]) -> None:
        with self._lock:
            self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def sources_snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            sources = dict(self._sources)
        out = {}
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception as e:  # a broken source must not kill readers
                out[name] = {"error": repr(e)}
        return out

    def snapshot(self) -> Dict:
        """JSON-ready dump: counters/gauges as {name: {"label=val,...":
        value}} (empty-label samples keyed ""), plus every source's pull."""
        metrics: Dict[str, Dict[str, float]] = {}
        for fam in self.families():
            metrics[fam.name] = {
                ",".join(f"{k}={v}" for k, v in sorted(labels.items())): val
                for labels, val in fam.samples()
            }
        return {"metrics": metrics, "sources": self.sources_snapshot()}

    def reset(self) -> None:
        """Zero every family (sources are untouched) — tests and benches
        isolating per-arm deltas."""
        for fam in self.families():
            fam.clear()


REGISTRY = Registry()


def counter(name: str, help: str = "") -> CounterFamily:
    """Get-or-create a counter on the global registry."""
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> GaugeFamily:
    """Get-or-create a gauge on the global registry."""
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Optional[Sequence[float]] = None) -> HistogramFamily:
    """Get-or-create a histogram on the global registry (default buckets:
    :data:`DEFAULT_LATENCY_BUCKETS` — log-spaced latency seconds)."""
    return REGISTRY.histogram(name, help, buckets)
