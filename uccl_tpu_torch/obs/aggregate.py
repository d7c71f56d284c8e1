"""Pull-based fleet metrics federation: N worker `/metrics` → one snapshot.

``ServingMetrics.merged`` concatenates raw sample lists — exact, but only
possible for engines living in ONE process. A fleet's workers export
Prometheus text (live ``/metrics`` via :class:`~uccl_tpu_torch.obs.export.
MetricsServer`, or ``--metrics-out`` files); this module scrapes N such
targets and builds one fleet snapshot the way Prometheus federation does:

* every scraped series is re-emitted with a ``replica="<label>"`` label,
  so per-worker views survive in the aggregate;
* **counters and histograms additionally SUM across replicas** into
  unlabeled fleet series — histogram ``_bucket``/``_sum``/``_count``
  lines with identical bucket edges add into one correct fleet
  distribution (the merge-safety property sample concatenation lacks
  across processes), and :func:`fleet_quantile` reads p50/p95 off the
  summed buckets;
* gauges (and untyped lines like the serving percentile extras) stay
  per-replica only — summing last-write-wins values is meaningless.

Targets are files or ``http://`` URLs, optionally labeled
(``label=target``); scraping is stdlib ``urllib`` — no new dependencies.

CLI::

    python -m uccl_tpu_torch.obs.aggregate --out fleet.prom \\
        prefill=prefill.prom decode=http://127.0.0.1:9100/metrics

Port copy of ``uccl_tpu/obs/aggregate.py`` (jax-free there too). Both
packages print the same exposition format, so one fleet may mix workers of
either package, and both federators give the same fleet text.
"""

from __future__ import annotations

import argparse
import re
import sys
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from uccl_tpu_torch.obs.counters import (
    escape_label_value, fmt_value, histogram_quantile, sanitize_name,
)

__all__ = [
    "parse_prometheus", "scrape", "aggregate", "fleet_text",
    "fleet_quantile", "counter_resets", "main",
]

# one sample line: name{labels} value (labels optional; the value is
# validated by float() below, so scientific notation / inf / nan all pass)
_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$'
)
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

LabelKey = Tuple[Tuple[str, str], ...]


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def parse_prometheus(text: str) -> Tuple[Dict[str, str],
                                         Dict[str, Dict[LabelKey, float]]]:
    """Prometheus text → (``{series name: type}``, ``{series name:
    {sorted-label-tuple: value}}``). Histogram component series
    (``x_bucket``/``x_sum``/``x_count``) keep their full names; the type
    map holds the FAMILY name (``x``) as ``histogram``."""
    types: Dict[str, str] = {}
    samples: Dict[str, Dict[LabelKey, float]] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        if ln.startswith("#"):
            parts = ln.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            continue
        m = _SAMPLE.match(ln)
        if not m:
            continue  # tolerate foreign lines — a scrape must not die
        name, lbl, val = m.group(1), m.group(2), m.group(3)
        try:
            v = float(val)
        except ValueError:
            continue
        labels = tuple(sorted(
            (k, _unescape(raw)) for k, raw in _LABEL.findall(lbl or "")
        ))
        samples.setdefault(name, {})[labels] = v
    return types, samples


def _series_kind(name: str, types: Dict[str, str]) -> str:
    """Summability class of a series: its declared type, or its histogram
    family's when the name is a ``_bucket``/``_sum``/``_count`` leaf."""
    t = types.get(name)
    if t is not None:
        return t
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) == "histogram":
                return "histogram"
    return "untyped"


def scrape(target: str, timeout_s: float = 5.0) -> str:
    """One target's Prometheus text: ``http(s)://`` URLs are fetched
    (append ``/metrics`` when the URL has no path), anything else is read
    as a file."""
    if target.startswith(("http://", "https://")):
        url = target
        if url.rstrip("/").count("/") < 3:  # scheme://host:port only
            url = url.rstrip("/") + "/metrics"
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return r.read().decode()
    with open(target) as f:
        return f.read()


def _le_sort_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def _check_bucket_bounds(
        types: Dict[str, str],
        per_replica: Dict[str, Dict[LabelKey, Dict[str, float]]]) -> None:
    """Hard-fail when two replicas export the same histogram family with
    DIFFERENT bucket bounds — summing mismatched ``le`` grids yields a
    silently wrong fleet distribution (each replica's counts land in a
    grid the other never observed into), which is worse than no answer."""
    for name, by_label in per_replica.items():
        if (not name.endswith("_bucket")
                or _series_kind(name, types) != "histogram"):
            continue
        # non-le label set -> replica -> its set of le bounds
        groups: Dict[LabelKey, Dict[str, set]] = {}
        for labels, by_rep in by_label.items():
            d = dict(labels)
            le = d.pop("le", None)
            if le is None:
                continue
            key = tuple(sorted(d.items()))
            for rep in by_rep:
                groups.setdefault(key, {}).setdefault(rep, set()).add(le)
        for key, reps in groups.items():
            bounds = {rep: tuple(sorted(les, key=_le_sort_key))
                      for rep, les in reps.items()}
            if len(set(bounds.values())) > 1:
                detail = "; ".join(
                    f"{rep}: [{', '.join(b)}]"
                    for rep, b in sorted(bounds.items())
                )
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                raise ValueError(
                    f"histogram {name!r}"
                    + (f" {{{lbl}}}" if lbl else "")
                    + f" has mismatched bucket bounds across replicas — "
                      f"summing them would be silently wrong ({detail})"
                )


def counter_resets(prev: Dict, cur: Dict) -> List[Tuple]:
    """Restarted-worker detection between two :func:`aggregate`
    snapshots of the SAME targets: a cumulative series (counter or
    histogram component) can only grow within one process lifetime, so a
    per-replica DECREASE means that replica restarted and its counters
    reset to zero — naive deltas (``cur - prev``) go negative and any
    rate computed over the pair is garbage. Returns
    ``[(replica, series, labels, prev_value, cur_value), ...]``,
    empty when every cumulative series grew monotonically."""
    resets: List[Tuple] = []
    for name, by_label in cur["per_replica"].items():
        if _series_kind(name, cur["types"]) not in ("counter",
                                                    "histogram"):
            continue
        prev_by_label = prev["per_replica"].get(name, {})
        for labels, by_rep in by_label.items():
            prev_reps = prev_by_label.get(labels, {})
            for rep, v in by_rep.items():
                pv = prev_reps.get(rep)
                if pv is not None and v < pv:
                    resets.append((rep, name, labels, pv, v))
    return resets


def aggregate(scrapes: Sequence[Tuple[str, str]]) -> Dict:
    """Federate ``[(replica label, prometheus text), ...]`` into one
    snapshot dict: ``types``, ``per_replica`` (name → label-tuple →
    replica → value) and ``fleet`` (name → label-tuple → summed value,
    counters + histogram components only)."""
    types: Dict[str, str] = {}
    per_replica: Dict[str, Dict[LabelKey, Dict[str, float]]] = {}
    fleet: Dict[str, Dict[LabelKey, float]] = {}
    replicas: List[str] = []
    for label, text in scrapes:
        replicas.append(label)
        t, samples = parse_prometheus(text)
        for name, kind in t.items():
            prev = types.setdefault(name, kind)
            if prev != kind:
                raise ValueError(
                    f"series {name!r} is {prev} on one replica and "
                    f"{kind} on another — the fleet cannot sum it"
                )
        for name, by_label in samples.items():
            slot = per_replica.setdefault(name, {})
            for labels, v in by_label.items():
                slot.setdefault(labels, {})[label] = v
    _check_bucket_bounds(types, per_replica)
    for name, by_label in per_replica.items():
        if _series_kind(name, types) not in ("counter", "histogram"):
            continue
        fleet[name] = {
            labels: sum(by_rep.values())
            for labels, by_rep in by_label.items()
        }
    return {"replicas": replicas, "types": types,
            "per_replica": per_replica, "fleet": fleet}


def _line(name: str, labels: LabelKey, value: float,
          extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(labels) + ([extra] if extra else [])
    if pairs:
        lbl = ",".join(
            f'{sanitize_name(k)}="{escape_label_value(str(v))}"'
            for k, v in sorted(pairs)
        )
        return f"{name}{{{lbl}}} {fmt_value(value)}"
    return f"{name} {fmt_value(value)}"


def fleet_text(agg: Dict) -> str:
    """The aggregate as Prometheus text: fleet-summed series first
    (unlabeled-replica), then every per-replica series relabeled with
    ``replica="<label>"``."""
    lines: List[str] = []
    for name, kind in sorted(agg["types"].items()):
        lines.append(f"# TYPE {name} {kind}")
    for name in sorted(agg["fleet"]):
        for labels, v in sorted(agg["fleet"][name].items()):
            lines.append(_line(name, labels, v))
    for name in sorted(agg["per_replica"]):
        for labels, by_rep in sorted(agg["per_replica"][name].items()):
            for rep, v in sorted(by_rep.items()):
                lines.append(_line(name, labels, v, ("replica", rep)))
    return "\n".join(lines) + "\n"


def fleet_quantile(agg: Dict, family: str, q: float,
                   replica: Optional[str] = None) -> Optional[float]:
    """Quantile estimate off a histogram family's bucket counts —
    fleet-summed by default, one replica's when ``replica`` is given.
    None when the family is absent or empty."""
    name = f"{family}_bucket"
    if replica is None:
        by_label = agg["fleet"].get(name, {})
        flat = {labels: v for labels, v in by_label.items()}
    else:
        flat = {labels: by_rep.get(replica)
                for labels, by_rep in agg["per_replica"].get(name,
                                                             {}).items()
                if by_rep.get(replica) is not None}
    buckets: List[Tuple[float, float]] = []  # (upper, cumulative count)
    for labels, v in flat.items():
        le = dict(labels).get("le")
        if le is None:
            continue
        upper = float("inf") if le == "+Inf" else float(le)
        buckets.append((upper, v))
    if not buckets:
        return None
    buckets.sort()
    uppers = [u for u, _ in buckets if u != float("inf")]
    cum = [c for _, c in buckets]
    counts = [cum[0]] + [cum[i] - cum[i - 1] for i in range(1, len(cum))]
    return histogram_quantile(uppers, counts, q)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m uccl_tpu_torch.obs.aggregate",
        description="Federate N worker /metrics scrapes (URLs or files) "
                    "into one fleet Prometheus snapshot.",
    )
    ap.add_argument("targets", nargs="+",
                    help="label=target pairs (target: a .prom file or an "
                         "http://host:port[/metrics] URL); a bare target "
                         "gets the label r<index>")
    ap.add_argument("--out", default="",
                    help="write the fleet snapshot here (default: stdout)")
    ap.add_argument("--timeout", type=float, default=5.0,
                    help="per-target scrape timeout, seconds")
    args = ap.parse_args(argv)

    scrapes = []
    for i, spec in enumerate(args.targets):
        # label=target, but never split inside a URL scheme
        if "=" in spec and not spec.startswith(("http://", "https://")):
            label, target = spec.split("=", 1)
        else:
            label, target = f"r{i}", spec
        scrapes.append((label, scrape(target, args.timeout)))
    agg = aggregate(scrapes)
    text = fleet_text(agg)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"aggregate: {len(scrapes)} replica(s), "
              f"{sum(len(v) for v in agg['per_replica'].values())} series "
              f"-> {args.out}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
