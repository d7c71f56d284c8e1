"""Counter/gauge registry — the unified telemetry surface of the framework.

Port copy of the counter and gauge part of ``uccl_tpu/obs/counters.py``
(jax-free there too), kept so the port never imports the JAX package. The
same family names and labels are registered here (``ep_wire_fallback_total``,
``ep_bytes_total``, ``collective_plan_total``,
``collective_plan_predicted_us``, ``collective_traced_calls_total``,
``collective_traced_bytes_total``), on this package's own registry.

* **counters** — monotonic, labeled (``wire_fallback.inc(reason="budget")``).
* **gauges** — last-write-wins, labeled.

Everything is host-only and thread-safe; reading never blocks writers for
longer than a dict copy.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

__all__ = ["CounterFamily", "GaugeFamily", "Registry", "REGISTRY", "counter", "gauge"]

LabelKey = Tuple[Tuple[str, str], ...]  # sorted (k, v) pairs


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


class Registry:
    """Named counter and gauge families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def counter(self, name: str, help: str = "") -> CounterFamily:
        return self._family(name, help, CounterFamily)

    def gauge(self, name: str, help: str = "") -> GaugeFamily:
        return self._family(name, help, GaugeFamily)

    def _family(self, name, help, cls):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help)
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

    def snapshot(self) -> Dict:
        """JSON-ready dump: {name: {"label=val,...": value}} (empty-label
        samples keyed "")."""
        return {
            fam.name: {
                ",".join(f"{k}={v}" for k, v in sorted(labels.items())): val
                for labels, val in fam.samples()
            }
            for fam in self.families()
        }

    def reset(self) -> None:
        """Zero every family — tests and benches isolating per-arm deltas."""
        for fam in self.families():
            fam.clear()


REGISTRY = Registry()


def counter(name: str, help: str = "") -> CounterFamily:
    """Get-or-create a counter on the global registry."""
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> GaugeFamily:
    """Get-or-create a gauge on the global registry."""
    return REGISTRY.gauge(name, help)
