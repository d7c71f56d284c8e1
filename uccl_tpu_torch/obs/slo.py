"""Multi-window SLO burn-rate monitors over the histogram families.

The serving latency histograms (TTFT/TPOT/queue-wait/step) are
*cumulative-from-start* — correct for fleet federation, useless on their
own for "are we currently violating the objective?". This module turns
them into the ROADMAP's missing **SLO pressure signal**: a monitor
periodically snapshots each objective's histogram, and evaluation diffs
the current state against the snapshot taken one window ago, giving the
window's OWN distribution out of the cumulative family (the same
state-diff idiom the benches use).

Burn rate is the standard SRE quantity: with an objective "``target``
fraction of requests complete under ``threshold_s``", the error budget
is ``1 - target``; a window whose observed violation fraction is
``error_rate`` burns budget at ``error_rate / (1 - target)`` times the
sustainable pace. Multi-window alerting pairs a long window (sustained
pain, low burn threshold) with a short one (sudden pain, high burn
threshold) so the monitor is neither twitchy nor numb — the defaults
(1 h-equivalent policy scaled to bench time) follow the Google SRE
workbook's 14.4×/6× pairing.

Violation counting is bucket-resolved: every observation in a bucket
whose upper bound exceeds ``threshold_s`` counts as a violation. Align
``threshold_s`` with a bucket upper (the families use
``DEFAULT_LATENCY_BUCKETS``) and the count is exact; otherwise it is
conservative (the straddling bucket counts against the budget).

Alerts are *events*, not just numbers: each one lands in the tracer
(``slo_burn`` instant on the ``slo`` track), counts on
``obs_slo_burn_alerts_total{objective,window}`` (federable via
``obs/aggregate.py`` like every registry counter), and fires the flight
recorder's ``slo_burn`` trigger (deduped per objective×window×labels,
so a sustained burn produces one bundle, not one per tick).

Per-tenant objectives: set ``per="tenant"`` and the objective evaluates
each label set of the family carrying that label key independently —
one tenant burning its budget alerts with ``tenant=...`` context while
the others stay quiet.

Port copy of ``uccl_tpu/obs/slo.py`` (jax-free there too) over the port's
histogram families, tracer and flight recorder: the same observations on the
same clock give the JAX monitor's alerts, counter totals and bundles.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from uccl_tpu_torch.obs import counters as _counters
from uccl_tpu_torch.obs import flight as _flight
from uccl_tpu_torch.obs import tracer as _tracer

_ALERTS = _counters.counter(
    "obs_slo_burn_alerts_total",
    "SLO burn-rate alerts fired, by objective and evaluation window")

# (window seconds, burn-rate threshold) — short window catches sudden
# total outage fast, long window catches sustained slow burn.
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((60.0, 14.4),
                                                    (300.0, 6.0))


@dataclass(frozen=True)
class Objective:
    """'``target`` of requests observe ``metric`` <= ``threshold_s``'."""

    name: str                 # alert label, e.g. "ttft"
    metric: str               # histogram family name
    threshold_s: float
    target: float             # e.g. 0.99 -> 1% error budget
    labels: Tuple[Tuple[str, str], ...] = ()   # fixed label-set selector
    per: Optional[str] = None  # label KEY to fan out over (e.g. "tenant")

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"objective {self.name}: target must be in "
                             f"(0, 1), got {self.target}")


@dataclass
class Alert:
    objective: str
    window_s: float
    burn: float
    burn_threshold: float
    error_rate: float
    budget: float
    violations: int
    total: int
    threshold_s: float
    labels: Dict[str, str] = field(default_factory=dict)

    def as_dict(self) -> Dict:
        return {
            "objective": self.objective, "window_s": self.window_s,
            "burn": self.burn, "burn_threshold": self.burn_threshold,
            "error_rate": self.error_rate, "budget": self.budget,
            "violations": self.violations, "total": self.total,
            "threshold_s": self.threshold_s, "labels": dict(self.labels),
        }


class BurnRateMonitor:
    """Snapshot-diff burn-rate evaluator. Call :meth:`sample` on a
    cadence (each engine drain loop, each bench tick); call
    :meth:`evaluate` to get the alerts the current state justifies.
    ``tick`` does both. ``clock`` is injectable so a test drives hours
    of policy in microseconds."""

    def __init__(self, objectives: Sequence[Objective],
                 windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS,
                 *, min_count: int = 1, registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if not objectives:
            raise ValueError("BurnRateMonitor needs >= 1 objective")
        self.objectives = list(objectives)
        self.windows = [(float(w), float(b)) for w, b in windows]
        if not self.windows:
            raise ValueError("BurnRateMonitor needs >= 1 window")
        self.min_count = int(min_count)
        self.registry = registry if registry is not None \
            else _counters.REGISTRY
        self.clock = clock
        self.alerts_fired = 0
        # ring of (t, {family: state}) — retained one max-window deep
        self._samples: List[Tuple[float, Dict[str, Dict]]] = []
        self._retain_s = max(w for w, _ in self.windows) * 1.25 + 1.0

    def _families(self) -> Dict[str, _counters.HistogramFamily]:
        fams = {}
        for obj in self.objectives:
            if obj.metric in fams:
                continue
            fam = next((f for f in self.registry.families()
                        if f.name == obj.metric
                        and f.kind == "histogram"), None)
            if fam is not None:
                fams[obj.metric] = fam
        return fams

    def sample(self, now: Optional[float] = None) -> None:
        """Record one snapshot of every monitored family's state."""
        t = self.clock() if now is None else now
        snap = {name: fam.state() for name, fam in self._families().items()}
        self._samples.append((t, snap))
        cutoff = t - self._retain_s
        while len(self._samples) > 1 and self._samples[0][0] < cutoff:
            self._samples.pop(0)

    def evaluate(self, now: Optional[float] = None,
                 emit: bool = True) -> List[Alert]:
        """Diff current family state against each window-aged snapshot
        and return every (objective × window × label-set) whose burn
        crossed its threshold. ``emit=False`` suppresses the tracer/
        counter/flight side effects (doctor re-evaluating a bundle)."""
        t = self.clock() if now is None else now
        fams = self._families()
        cur = {name: fam.state() for name, fam in fams.items()}
        out: List[Alert] = []
        for win_s, burn_thresh in self.windows:
            base = self._snapshot_at(t - win_s)
            if base is None:
                continue  # not enough history to judge this window yet
            for obj in self.objectives:
                fam = fams.get(obj.metric)
                if fam is None:
                    continue
                for labels, viol, total in self._window_counts(
                        obj, fam, base.get(obj.metric, {}),
                        cur.get(obj.metric, {})):
                    if total < self.min_count:
                        continue
                    budget = 1.0 - obj.target
                    error_rate = viol / total
                    burn = error_rate / budget
                    if burn < burn_thresh:
                        continue
                    a = Alert(objective=obj.name, window_s=win_s,
                              burn=burn, burn_threshold=burn_thresh,
                              error_rate=error_rate, budget=budget,
                              violations=viol, total=total,
                              threshold_s=obj.threshold_s, labels=labels)
                    out.append(a)
                    if emit:
                        self._emit(a)
        return out

    def tick(self, now: Optional[float] = None) -> List[Alert]:
        alerts = self.evaluate(now)
        self.sample(now)
        return alerts

    # -- internals -----------------------------------------------------------
    def _snapshot_at(self, t: float) -> Optional[Dict[str, Dict]]:
        """Newest snapshot taken at or before ``t`` — the window base."""
        best = None
        for st, snap in self._samples:
            if st <= t:
                best = snap
            else:
                break
        return best

    def _window_counts(self, obj: Objective, fam, base: Dict, cur: Dict):
        """Yield (labels, violations, total) per evaluated label set.
        Counter resets (restarted worker) clamp to the current state
        rather than going negative."""
        uppers = fam.uppers
        # buckets strictly above the threshold violate; Prometheus le is
        # inclusive, so a bucket with upper == threshold is compliant.
        first_bad = bisect.bisect_right(uppers, obj.threshold_s)
        sel = dict(obj.labels)
        for key, (counts, _s) in cur.items():
            labels = dict(key)
            if any(labels.get(k) != v for k, v in sel.items()):
                continue
            if obj.per is not None and obj.per not in labels:
                continue
            if obj.per is None and obj.labels == () and labels:
                # an unlabeled objective reads the unlabeled series only
                continue
            bcounts = base.get(key, (None, 0.0))[0]
            delta = [c - (bcounts[i] if bcounts is not None else 0)
                     for i, c in enumerate(counts)]
            if any(d < 0 for d in delta):   # reset: restart mid-window
                delta = list(counts)
            total = sum(delta)
            viol = sum(delta[first_bad:])
            yield labels, viol, total

    def _emit(self, a: Alert) -> None:
        self.alerts_fired += 1
        win = f"{a.window_s:g}s"
        _ALERTS.inc(objective=a.objective, window=win, **a.labels)
        t = _tracer.get_tracer()
        if t is not None:
            t.instant("slo_burn", track="slo", objective=a.objective,
                      window=win, burn=round(a.burn, 3),
                      violations=a.violations, total=a.total, **a.labels)
        lkey = ",".join(f"{k}={v}" for k, v in sorted(a.labels.items()))
        _flight.trigger("slo_burn",
                        key=f"{a.objective}:{win}:{lkey}",
                        **a.as_dict())


def serving_objectives(*, ttft_s: float = 1.0, tpot_s: float = 0.25,
                       queue_wait_s: float = 1.0, step_s: float = 1.0,
                       target: float = 0.99) -> List[Objective]:
    """The stock objective set over the serving latency families —
    thresholds are per-deployment knobs, these defaults suit the CPU
    bench scale."""
    return [
        Objective("ttft", "serving_ttft_seconds", ttft_s, target),
        Objective("tpot", "serving_tpot_seconds", tpot_s, target),
        Objective("queue_wait", "serving_queue_wait_seconds",
                  queue_wait_s, target),
        Objective("step", "serving_step_seconds", step_s, target),
    ]
