"""The port's ``doctor`` (uccl_tpu_torch/doctor.py) against the JAX package's.

Both packages' flight recorders write one bundle per trigger kind of
``TRIGGERS`` (a slo_burn bundle from each package's burn-rate monitor,
an uncaught_exception one from ``record_exception``), over a tracer ring
holding precursor events. For every bundle, from either recorder, both
doctors must give the same verdict dict (root-cause tag, narrative, details),
and the same ``--json`` and prose output, with and without a merged
``--trace``; ``python -m uccl_tpu_torch.doctor`` must print what the
in-process CLI prints. No tolerance: the same Python over the same JSON.
"""

import json
import os
import subprocess
import sys

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

from uccl_tpu import doctor as jdoctor
from uccl_tpu.obs import counters as jcounters
from uccl_tpu.obs import flight as jflight
from uccl_tpu.obs import slo as jslo
from uccl_tpu.obs import tracer as jtracer
from uccl_tpu_torch import doctor as tdoctor
from uccl_tpu_torch.obs import counters as tcounters
from uccl_tpu_torch.obs import flight as tflight
from uccl_tpu_torch.obs import slo as tslo
from uccl_tpu_torch.obs import tracer as ttracer

PKGS = {"jax": (jflight, jtracer, jslo, jcounters), "port": (tflight, ttracer, tslo, tcounters)}
CONTEXT = {
    "peer_dead": dict(peer="r0", source="health"),
    "retx_storm": dict(retx_fast=14, retx_rto=3, chunks=38, rto_ms=812.0,
                       path_scores=[1.0, 1.0, 0.31, 0.98]),
    "rto_backoff": dict(rto_ms=2048.0, retx_fast=1, retx_rto=5, chunks=9),
    "ctrl_storm": dict(retries=4),
    "conservation": dict(terms={"submitted": 10, "completed": 7, "active": 1, "queued": 0,
                                "rejected": 1, "expired": 0, "lost": 0}),
    "step_stall": dict(dur_s=0.4321, budget_s=0.1, occupancy=0.75),
}
PRECURSORS = ("peer_suspect", "heartbeat", "submit", "first_token", "preempt", "grant",
              "engine.step", "p2p_transfer_failed")


@pytest.fixture(autouse=True)
def _clean():
    yield
    for flight, tracer, *_ in PKGS.values():
        flight.disable()
        tracer.disable()


def _trigger(path):
    with open(path) as f:
        return json.load(f)["trigger"]


def _bundles(pkg, out_dir):
    """One bundle per trigger kind, written by ``pkg``'s recorder."""
    flight, tracer, slo, counters = PKGS[pkg]
    tr = tracer.enable()
    for name in PRECURSORS:
        tr.instant(name, track="unit")
    rec = flight.enable(str(out_dir), min_interval_s=0.0)
    for kind in flight.TRIGGERS:
        if kind == "slo_burn":  # the monitor fires it
            reg = counters.Registry()
            fam = reg.histogram("unit_step_seconds", buckets=[0.01, 0.1, 1.0])
            mon = slo.BurnRateMonitor([slo.Objective("step", "unit_step_seconds", 0.1, 0.99)],
                                      windows=((60.0, 1.0),), registry=reg)
            mon.sample(now=0.0)
            for _ in range(3):
                fam.observe(0.5)
            assert len(mon.evaluate(now=61.0)) == 1
        elif kind == "uncaught_exception":
            try:
                raise KeyError("gone")
            except KeyError as e:
                flight.record_exception(e, where="unit")
        else:
            assert rec.trigger(kind, key=kind, **CONTEXT[kind]) is not None
    assert [_trigger(p)["kind"] for p in rec.bundles] == list(flight.TRIGGERS)
    flight.disable()
    tracer.disable()
    return rec.bundles


@pytest.fixture
def bundles(tmp_path):
    return {pkg: _bundles(pkg, tmp_path / pkg) for pkg in PKGS}


def test_taxonomy_matches():
    assert tflight.TRIGGERS == jflight.TRIGGERS
    assert tdoctor.ROOT_CAUSE == jdoctor.ROOT_CAUSE
    assert set(tdoctor.ROOT_CAUSE) == set(tflight.TRIGGERS)


def test_every_trigger_gets_equal_verdicts_from_both_doctors(bundles):
    first_lines = {}
    for pkg, paths in bundles.items():
        for path in paths:
            got = tdoctor.diagnose(tdoctor.load_bundle(path))
            assert got == jdoctor.diagnose(jdoctor.load_bundle(path))
            assert got["root_cause"] == tdoctor.ROOT_CAUSE[got["trigger"]]
            assert any(line.startswith("preceding ring events") for line in got["narrative"]) \
                or got["trigger"] == "uncaught_exception"
            first_lines.setdefault(got["trigger"], set()).add(got["narrative"][0])
    # either package's bundle of one fault reads the same
    assert all(len(lines) == 1 for lines in first_lines.values())


def test_cli_json_prose_and_trace_match(bundles, tmp_path, capsys):
    dirs = [os.path.dirname(paths[0]) for paths in bundles.values()]
    t_wall = _trigger(bundles["port"][0])["t_wall_s"]
    trace = tmp_path / "merged.json"
    trace.write_text(json.dumps({
        "otherData": {"merged_wall_epoch_us": 0.0},
        "traceEvents": [{"name": "kv_slab", "ph": "i", "ts": t_wall * 1e6 + 5e4},
                        {"name": "far_away", "ph": "i", "ts": t_wall * 1e6 + 5e6}]}))
    for argv in ([*dirs, "--json"], dirs, [*dirs, "--json", "--trace", str(trace)],
                 [*dirs, "--trace", str(trace)]):
        outs = []
        for mod in (jdoctor, tdoctor):
            assert mod.main(argv) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
    assert "merged-trace instants within 200 ms of the trigger: kv_slab" in outs[1]
    assert f"{2 * len(tflight.TRIGGERS)} bundle(s) examined" in outs[1]
    proc = subprocess.run([sys.executable, "-m", "uccl_tpu_torch.doctor", *dirs, "--json"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert tdoctor.main([*dirs, "--json"]) == 0
    assert proc.stdout == capsys.readouterr().out
    assert {v["root_cause"] for v in json.loads(proc.stdout)} == set(tdoctor.ROOT_CAUSE.values())


def test_non_bundles_rejected_alike(tmp_path, capsys):
    p = tmp_path / "flight_001_bogus.json"
    p.write_text(json.dumps({"schema": "nope"}))
    (tmp_path / "empty").mkdir()
    for mod in (jdoctor, tdoctor):
        with pytest.raises(ValueError, match="not a flight bundle"):
            mod.load_bundle(str(p))
        assert mod.main([str(p)]) == 1
        assert mod.main([str(tmp_path / "empty")]) == 1
    err = capsys.readouterr().err
    assert err.count("not a flight bundle") == 2 and err.count("no flight bundles found") == 2
