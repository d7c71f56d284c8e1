"""``python -m uccl_tpu_torch.doctor`` — forensic reader for flight bundles.

The flight recorder (obs/flight.py) freezes evidence; this CLI turns it
back into a story. For each bundle it cross-links the trigger with the
preceding ring events, the frozen transport/engine/fleet state, and the
registry counters, then prints a root-cause narrative::

    == flight_001_retx_storm.json · t=4.21s · trigger=retx_storm ==
    root cause: path_loss
    SACK retransmit storm on path 2: 14 fast + 3 RTO retx over 38
    chunks (44.7%); rto backed off to 812.0 ms; path scores
    [1.00, 1.00, 0.31, 0.98] ...

Each trigger kind maps to a stable machine-readable ``root_cause`` tag
(``--json`` emits the verdicts as JSON), so a fault-injection run can
assert that the verdict names the fault it injected:

    peer_dead          -> replica_failure
    retx_storm         -> path_loss
    rto_backoff        -> path_blackout
    ctrl_storm         -> control_plane_loss
    conservation       -> accounting_leak
    slo_burn           -> slo_violation
    step_stall         -> engine_stall
    uncaught_exception -> driver_crash

Inputs are bundle paths or directories (scanned for
``flight_*.json``); ``--trace merged.json`` optionally cross-links a
clock-aligned merged trace (scripts/trace_merge.py) so the narrative
can cite fleet-wide events around the trigger instant.

Port copy of ``uccl_tpu/doctor.py`` (jax-free there too). Both packages'
flight recorders write the same bundle schema (``uccl_tpu.flight/1``), and
either package's doctor reads either package's bundles to the same verdicts
and the same ``--json`` output.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

ROOT_CAUSE = {
    "peer_dead": "replica_failure",
    "retx_storm": "path_loss",
    "rto_backoff": "path_blackout",
    "ctrl_storm": "control_plane_loss",
    "conservation": "accounting_leak",
    "slo_burn": "slo_violation",
    "step_stall": "engine_stall",
    "uncaught_exception": "driver_crash",
}

# ring-event names worth citing as precursors, by trigger kind
_PRECURSORS = {
    "peer_dead": ("peer_suspect", "peer_dead", "heartbeat"),
    "retx_storm": ("p2p_transfer_failed", "flight_dump"),
    "rto_backoff": ("p2p_transfer_failed",),
    "ctrl_storm": ("grant", "begin", "final"),
    "conservation": ("submit", "reject", "expired", "recovered"),
    "slo_burn": ("first_token", "submit", "preempt"),
    "step_stall": ("engine.step", "preempt", "resume"),
    "uncaught_exception": (),
}


def load_bundle(path: str) -> Dict:
    with open(path) as f:
        b = json.load(f)
    if b.get("schema") != "uccl_tpu.flight/1":
        raise ValueError(f"{path}: not a flight bundle "
                         f"(schema={b.get('schema')!r})")
    b["_path"] = path
    return b


def _expand(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "flight_*.json"))))
        else:
            out.append(p)
    return out


def _counters(bundle: Dict) -> Dict[str, float]:
    """Flatten the bundle's Prometheus text to {series-line-key: value}
    using the same parser the federator uses."""
    from uccl_tpu_torch.obs.aggregate import parse_prometheus

    _types, samples = parse_prometheus(bundle.get("metrics_prom", ""))
    out: Dict[str, float] = {}
    for name, series in samples.items():
        for labels, v in series.items():
            lbl = ",".join(f'{k}="{val}"' for k, val in labels)
            out[f"{name}{'{' + lbl + '}' if lbl else ''}"] = v
    return out


def _sum_counter(counters: Dict[str, float], prefix: str) -> float:
    return sum(v for k, v in counters.items()
               if k == prefix or k.startswith(prefix + "{"))


def _preceding(bundle: Dict, kind: str, n: int = 8) -> List[Dict]:
    names = _PRECURSORS.get(kind, ())
    evs = [e for e in bundle.get("events", [])
           if not names or e.get("name") in names
           or any(e.get("name", "").startswith(p) for p in names)]
    return evs[-n:]


def _transport_state(bundle: Dict) -> Optional[Dict]:
    ctx = bundle["trigger"].get("context") or {}
    state = bundle.get("state")
    sources = [ctx] + (list(state.values())
                       if isinstance(state, dict) else [])
    for src in sources:
        if isinstance(src, dict) and ("retx_fast" in src
                                      or "path_scores" in src):
            return src
    return None


def _conservation_terms(counters: Dict[str, float]) -> Dict[str, float]:
    terms = {}
    for t in ("submitted", "completed", "active", "queued", "rejected",
              "expired", "lost"):
        terms[t] = _sum_counter(counters, f"uccl_serving_{t}")
    return terms


def diagnose(bundle: Dict) -> Dict:
    """One bundle -> verdict dict with a stable root_cause tag and a
    human narrative. Never raises on a well-formed bundle — a sparse
    bundle degrades to a sparser narrative."""
    trig = bundle["trigger"]
    kind = trig["kind"]
    ctx = trig.get("context") or {}
    counters = _counters(bundle)
    lines: List[str] = []
    details: Dict = {}

    if kind == "peer_dead":
        peer = ctx.get("peer") or ctx.get("owner") or trig.get("key")
        src = ctx.get("source", "health")
        suspects = [e for e in bundle.get("events", [])
                    if e.get("name") == "peer_suspect"]
        lines.append(
            f"replica {peer!r} declared DEAD (detected via {src})"
            + (f" after {len(suspects)} SUSPECT transition(s) in the ring"
               if suspects else " with no SUSPECT precursor in the ring"))
        recovered = _sum_counter(counters, "serving_recovered_total")
        if recovered:
            lines.append(f"{int(recovered)} request(s) already re-placed "
                         f"on survivors at dump time")
        details.update(peer=peer, source=src)
    elif kind in ("retx_storm", "rto_backoff"):
        st = _transport_state(bundle) or {}
        fast = int(st.get("retx_fast", ctx.get("retx_fast", 0)) or 0)
        rto = int(st.get("retx_rto", ctx.get("retx_rto", 0)) or 0)
        chunks = int(st.get("chunks", ctx.get("chunks", 0)) or 0)
        rto_ms = st.get("rto_ms", ctx.get("rto_ms"))
        scores = st.get("path_scores", ctx.get("path_scores"))
        frac = (f" ({100.0 * (fast + rto) / chunks:.1f}% of {chunks} "
                f"chunks)") if chunks else ""
        if kind == "retx_storm":
            lines.append(f"SACK retransmit storm: {fast} fast + {rto} RTO "
                         f"retransmits{frac}")
        else:
            lines.append(f"RTO backed off past the armed ceiling"
                         + (f" to {float(rto_ms):.1f} ms"
                            if rto_ms is not None else "")
                         + f" — sustained loss or path blackout"
                         + (f"; {fast} fast + {rto} RTO retx{frac}"
                            if fast + rto else ""))
        if scores:
            worst = min(range(len(scores)), key=lambda i: scores[i])
            lines.append(
                f"path quality {['%.2f' % s for s in scores]} — "
                f"path {worst} is the casualty ({scores[worst]:.2f})")
            details["worst_path"] = worst
        if rto_ms is not None and kind == "retx_storm":
            lines.append(f"smoothed RTO at dump: {float(rto_ms):.1f} ms")
        details.update(retx_fast=fast, retx_rto=rto, chunks=chunks)
    elif kind == "ctrl_storm":
        retries = ctx.get("retries",
                          _sum_counter(counters, "disagg_ctrl_retries_total"))
        dropped = _sum_counter(counters, "disagg_ctrl_dropped_total")
        lines.append(f"disagg control-plane storm: {int(retries)} notif "
                     f"retransmission(s)"
                     + (f", {int(dropped)} injected drop(s) counted"
                        if dropped else "")
                     + " — notif plane lossy or the peer is unresponsive")
        details.update(retries=int(retries), dropped=int(dropped))
    elif kind == "conservation":
        terms = ctx.get("terms") or _conservation_terms(counters)
        rhs = sum(v for k, v in terms.items() if k != "submitted")
        lines.append(
            f"serving conservation broke: submitted "
            f"{terms.get('submitted')} != "
            f"completed+active+queued+rejected+expired+lost = {rhs} "
            f"({ {k: int(v) for k, v in terms.items()} })")
        details["terms"] = terms
    elif kind == "slo_burn":
        obj = ctx.get("objective", "?")
        win = ctx.get("window_s", "?")
        lines.append(
            f"SLO burn alert: objective {obj!r} burned at "
            f"{float(ctx.get('burn', 0)):.1f}x budget over the {win}s "
            f"window — {int(ctx.get('violations', 0))} of "
            f"{int(ctx.get('total', 0))} request(s) past the "
            f"{float(ctx.get('threshold_s', 0)) * 1e3:.0f} ms objective")
        if ctx.get("labels"):
            lines.append(f"scope: {ctx['labels']}")
        details.update(objective=obj, burn=ctx.get("burn"),
                       labels=ctx.get("labels"))
    elif kind == "step_stall":
        dur = float(ctx.get("dur_s", 0.0))
        budget = ctx.get("budget_s")
        occ = ctx.get("occupancy")
        lines.append(f"engine step stalled: one step() took {dur * 1e3:.1f}"
                     f" ms"
                     + (f" against a {float(budget) * 1e3:.0f} ms budget"
                        if budget is not None else "")
                     + (f" at occupancy {occ}" if occ is not None else ""))
        details.update(dur_s=dur, budget_s=budget)
    elif kind == "uncaught_exception":
        lines.append(f"driver crashed in {ctx.get('where', '?')}: "
                     f"{ctx.get('exc_type', '?')}: {ctx.get('exc', '')}")
        tail = (ctx.get("traceback_tail") or "").strip().splitlines()
        if tail:
            lines.append("traceback tail: " + tail[-1].strip())
        details.update(exc_type=ctx.get("exc_type"))
    else:
        lines.append(f"unknown trigger kind {kind!r}")

    pre = _preceding(bundle, kind)
    if pre:
        tail = ", ".join(f"{e['name']}@{e['ts_us'] / 1e6:.3f}s"
                         for e in pre[-4:])
        lines.append(f"preceding ring events: {tail}")
    burns = _sum_counter(counters, "obs_slo_burn_alerts_total")
    if burns and kind != "slo_burn":
        lines.append(f"{int(burns)} SLO burn alert(s) already counted at "
                     f"dump time — user-visible impact likely")
    dumps = _sum_counter(counters, "obs_flight_dumps_total")
    details["dumps_counted"] = dumps

    return {
        "bundle": bundle["_path"],
        "seq": bundle.get("seq"),
        "trigger": kind,
        "t_wall_s": trig.get("t_wall_s"),
        "root_cause": ROOT_CAUSE.get(kind, "unknown"),
        "narrative": lines,
        "details": details,
    }


def _trace_context(trace_path: str, bundle: Dict,
                   window_us: float = 2e5) -> List[str]:
    """Cite merged-trace instants near the trigger instant (both sides
    are wall-anchored: trace_merge rebases onto wall epochs, the bundle
    carries t_wall_s)."""
    with open(trace_path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    base = ((doc.get("otherData") or {}).get("merged_wall_epoch_us")
            if isinstance(doc, dict) else None)
    if base is None or bundle["trigger"].get("t_wall_s") is None:
        return []
    t_us = bundle["trigger"]["t_wall_s"] * 1e6 - float(base)
    near = [e for e in evs
            if isinstance(e, dict) and e.get("ph") == "i"
            and abs(float(e.get("ts", 0)) - t_us) <= window_us]
    return [f"merged-trace instants within {window_us / 1e3:.0f} ms of the "
            f"trigger: "
            + ", ".join(sorted({e.get('name', '?') for e in near}))] \
        if near else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m uccl_tpu_torch.doctor",
        description="root-cause narratives from flight-recorder bundles")
    ap.add_argument("bundles", nargs="+",
                    help="bundle files or directories of flight_*.json")
    ap.add_argument("--trace", default="",
                    help="merged Chrome trace (scripts/trace_merge.py) to "
                         "cross-link around each trigger")
    ap.add_argument("--json", action="store_true",
                    help="emit verdicts as a JSON array instead of prose")
    args = ap.parse_args(argv)

    paths = _expand(args.bundles)
    if not paths:
        print("doctor: no flight bundles found", file=sys.stderr)
        return 1
    verdicts = []
    for p in paths:
        try:
            b = load_bundle(p)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"doctor: {e}", file=sys.stderr)
            return 1
        v = diagnose(b)
        if args.trace:
            try:
                v["narrative"].extend(_trace_context(args.trace, b))
            except (OSError, json.JSONDecodeError) as e:
                v["narrative"].append(f"(merged trace unreadable: {e})")
        verdicts.append(v)
    verdicts.sort(key=lambda v: (v["t_wall_s"] or 0.0, v["bundle"]))

    if args.json:
        json.dump(verdicts, sys.stdout, indent=1)
        print()
        return 0
    t0 = next((v["t_wall_s"] for v in verdicts
               if v["t_wall_s"] is not None), None)
    for v in verdicts:
        t = v["t_wall_s"]
        head = (f"== {os.path.basename(v['bundle'])}"
                + (f" · t=+{t - t0:.2f}s" if t is not None else "")
                + f" · trigger={v['trigger']} ==")
        print(head)
        print(f"root cause: {v['root_cause']}")
        for ln in v["narrative"]:
            print(f"  {ln}")
        print()
    print(f"doctor: {len(verdicts)} bundle(s) examined")
    return 0


if __name__ == "__main__":
    sys.exit(main())
