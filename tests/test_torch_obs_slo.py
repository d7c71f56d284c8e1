"""The port's SLO burn-rate monitors (uccl_tpu_torch/obs/slo.py) against the
JAX package's.

Each case feeds the same observations, on the same fake clock, to a JAX
monitor over a JAX registry and a port monitor over a port registry: the
alerts (``Alert.as_dict()``), the ``obs_slo_burn_alerts_total`` deltas by
label, the tracer's ``slo_burn`` instants and the flight bundles' names must
be equal. No tolerance: the arithmetic is the same Python on the same
integers.
"""

import os

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

from uccl_tpu.obs import counters as jcounters
from uccl_tpu.obs import flight as jflight
from uccl_tpu.obs import slo as jslo
from uccl_tpu.obs import tracer as jtracer
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.obs import counters as tcounters
from uccl_tpu_torch.obs import flight as tflight
from uccl_tpu_torch.obs import slo as tslo
from uccl_tpu_torch.obs import tracer as ttracer

BUCKETS = [0.01, 0.1, 1.0]
PKGS = {"jax": (jcounters, jflight, jslo, jtracer), "port": (tcounters, tflight, tslo, ttracer)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for _, flight, _, tracer in PKGS.values():
        flight.disable()
        tracer.disable()


def _monitor(pkg, objectives, windows, min_count=1):
    counters, _, slo, _ = PKGS[pkg]
    reg = counters.Registry()
    fams = {m: reg.histogram(m, buckets=BUCKETS) for m in {o[1] for o in objectives}}
    clk = [0.0]
    mon = slo.BurnRateMonitor([slo.Objective(*o[:4], **o[4]) for o in objectives],
                              windows=windows, registry=reg, clock=lambda: clk[0],
                              min_count=min_count)
    return fams, clk, mon


def _alert_counts(slo):
    return {tuple(sorted(labels.items())): v for labels, v in slo._ALERTS.samples()}


def _drive(pkg, objectives, windows, script, tmp_path, min_count=1):
    """Run ``script`` — a list of (t, [(metric, value, labels), ...],
    action) with action "sample", "evaluate", "tick", "replay" (evaluate
    without side effects) or "restart" (clear the histograms first) — on
    one package.
    Returns every evaluation's alerts, the alert counter's deltas, the
    tracer's slo_burn instants and the bundle names."""
    _, flight, slo, tracer = PKGS[pkg]
    rec = flight.enable(str(tmp_path / pkg), min_interval_s=0.0)
    tr = tracer.enable()
    before = _alert_counts(slo)
    fams, clk, mon = _monitor(pkg, objectives, windows, min_count)
    evaluations = []
    for t, obs, action in script:
        clk[0] = t
        if action == "restart":  # a restarted worker: its histograms start over
            for fam in fams.values():
                fam.clear()
        for metric, value, labels in obs:
            fams[metric].observe(value, **labels)
        if action == "sample":
            mon.sample()
        elif action == "evaluate":
            evaluations.append([a.as_dict() for a in mon.evaluate()])
        elif action == "tick":
            evaluations.append([a.as_dict() for a in mon.tick()])
        elif action == "replay":
            evaluations.append([a.as_dict() for a in mon.evaluate(emit=False)])
    after = _alert_counts(slo)
    deltas = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    instants = [(e.track, dict(e.args)) for e in tr.events() if e.name == "slo_burn"]
    return dict(evaluations=evaluations, deltas=deltas, instants=instants,
                bundles=[os.path.basename(p) for p in rec.bundles], fired=mon.alerts_fired)


def _both(*args, **kw):
    got = [_drive(pkg, *args, **kw) for pkg in ("jax", "port")]
    assert got[0] == got[1]
    return got[1]


TTFT = ("ttft", "unit_ttft_seconds", 0.1, 0.99, {})


def test_burn_alert_counter_instant_and_bundle_match(tmp_path):
    bad = [("unit_ttft_seconds", 0.5, {})] * 5
    out = _both([TTFT], ((60.0, 1.0),),
                [(0.0, [], "sample"), (10.0, bad, None), (61.0, [], "evaluate"),
                 (61.0, [], "replay")], tmp_path)
    [[alert], [replayed]] = out["evaluations"]
    assert alert == replayed
    assert alert["violations"] == 5 and alert["total"] == 5 and alert["burn"] == pytest.approx(100.0)
    assert out["bundles"] == ["flight_001_slo_burn.json"] and out["fired"] == 1
    assert list(out["deltas"].values()) == [1] and len(out["instants"]) == 1


def test_clean_window_and_counter_reset_match(tmp_path):
    ok = [("unit_ttft_seconds", 0.05, {})] * 5
    out = _both([TTFT], ((60.0, 1.0),),
                [(0.0, ok, "sample"), (61.0, ok, "evaluate")], tmp_path)
    assert out["evaluations"] == [[]] and out["bundles"] == []
    bad = [("unit_ttft_seconds", 0.5, {})]
    out = _both([TTFT], ((60.0, 1.0),),
                [(0.0, bad * 10, "sample"), (30.0, bad * 2, "restart"), (61.0, [], "replay")],
                tmp_path)
    [[alert]] = out["evaluations"]
    assert alert["total"] == 2 and alert["violations"] == 2 and out["bundles"] == []


def test_multi_window_per_tenant_ticks_match(tmp_path):
    """Two windows, a per-tenant objective and an unlabeled one, ticks over
    simulated minutes: one tenant burns, the other stays inside its budget;
    dedup keeps one bundle per objective x window x labels."""
    objs = [TTFT, ("tenant_tpot", "unit_tpot_seconds", 0.1, 0.9, {"per": "tenant"})]
    windows = ((60.0, 14.4), (300.0, 6.0))
    script = []
    for minute in range(12):
        t = 30.0 * minute
        obs = [("unit_tpot_seconds", 0.5 if i % 4 else 0.05, {"tenant": "a"}) for i in range(4)]
        obs += [("unit_tpot_seconds", 0.05, {"tenant": "b"})] * 4
        obs += [("unit_ttft_seconds", 2.0 if minute > 6 else 0.02, {})] * 3
        script.append((t, obs, "tick"))
    out = _both(objs, windows, script, tmp_path, min_count=2)
    fired = [a for ev in out["evaluations"] for a in ev]
    assert {a["objective"] for a in fired} == {"ttft", "tenant_tpot"}
    assert all(a["labels"] in ({}, {"tenant": "a"}) for a in fired)
    assert len(out["bundles"]) == len({(a["objective"], a["window_s"], tuple(a["labels"].items()))
                                       for a in fired})


def test_objectives_and_validation_match():
    for kw in ({}, dict(ttft_s=0.5, tpot_s=0.05, target=0.9)):
        assert [o.__dict__ for o in tslo.serving_objectives(**kw)] == \
            [o.__dict__ for o in jslo.serving_objectives(**kw)]
    for target in (0.0, 1.0):
        with pytest.raises(ValueError):
            tslo.Objective(name="x", metric="m", threshold_s=1.0, target=target)
    with pytest.raises(ValueError):
        tslo.BurnRateMonitor([])
    assert tslo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS
    assert tobs.BurnRateMonitor is tslo.BurnRateMonitor and tobs.Alert is tslo.Alert
