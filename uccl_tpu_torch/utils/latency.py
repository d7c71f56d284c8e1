"""Percentile latency histograms.

Equivalent of the reference's ``include/util/latency.h`` (log-bucketed
percentile histograms used by every engine stats thread). Pure numpy, so it is
usable from host runtime threads.

Port copy of ``uccl_tpu/utils/latency.py`` (numpy only there too), kept so the
port never imports the JAX package.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Sequence

import numpy as np


class LatencyHistogram:
    """Log-scale bucketed histogram over microsecond samples.

    Buckets are exponential: bucket i covers [base**i, base**(i+1)) microseconds,
    giving ~5% resolution with base=1.05 across ns..minutes like the reference's
    fixed 1..2^k bucket ladder but with finer grain.
    """

    def __init__(self, base: float = 1.05, max_us: float = 60e6):
        self._base = base
        self._log_base = math.log(base)
        self._nbuckets = int(math.log(max_us) / self._log_base) + 2
        self._counts = np.zeros(self._nbuckets, dtype=np.int64)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = 0.0
        self._lock = threading.Lock()

    def _bucket(self, us: float) -> int:
        if us < 1.0:
            return 0
        idx = int(math.log(us) / self._log_base) + 1
        return min(idx, self._nbuckets - 1)

    def record(self, us: float) -> None:
        with self._lock:
            self._counts[self._bucket(us)] += 1
            self._count += 1
            self._sum += us
            self._min = min(self._min, us)
            self._max = max(self._max, us)

    def record_many(self, samples: Sequence[float]) -> None:
        for s in samples:
            self.record(s)

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; returns the bucket upper-bound latency in us."""
        with self._lock:
            if self._count == 0:
                return 0.0
            target = max(1, math.ceil(self._count * p / 100.0))
            cum = np.cumsum(self._counts)
            idx = int(np.searchsorted(cum, target))
            upper = self._base ** idx
            return min(max(upper, self._min), self._max)

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean_us": self.mean,
            "min_us": 0.0 if self._count == 0 else self._min,
            "p50_us": self.percentile(50),
            "p90_us": self.percentile(90),
            "p99_us": self.percentile(99),
            "max_us": self._max,
        }

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        s = self.summary()
        return (
            f"n={s['count']:.0f} mean={s['mean_us']:.1f}us p50={s['p50_us']:.1f}us "
            f"p90={s['p90_us']:.1f}us p99={s['p99_us']:.1f}us max={s['max_us']:.1f}us"
        )
