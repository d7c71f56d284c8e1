"""The port's fleet federation (uccl_tpu_torch/obs/aggregate.py) against the
JAX package's, on a fleet that mixes JAX and port workers.

Both packages print the same Prometheus exposition, so each federator reads
either package's scrapes: the parsed series, the aggregate, ``fleet_text``,
``fleet_quantile``, ``counter_resets`` and both CLIs' outputs must be equal,
byte for byte (the same Python over the same text; no tolerance).
"""

import subprocess
import sys

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

from uccl_tpu.obs import aggregate as jagg
from uccl_tpu.obs import counters as jcounters
from uccl_tpu.obs import export as jexport
from uccl_tpu_torch.obs import aggregate as tagg
from uccl_tpu_torch.obs import counters as tcounters
from uccl_tpu_torch.obs import export as texport

BUCKETS = [0.001, 0.01, 0.1, 1.0]
PKGS = {"jax": (jcounters, jexport), "port": (tcounters, texport)}


def _worker(pkg, ttft, requests, occupancy=0.5, route="a"):
    """One worker's registry, in either package, as Prometheus text."""
    counters, export = PKGS[pkg]
    reg = counters.Registry()
    h = reg.histogram("serving_ttft_seconds", "time to first token", buckets=BUCKETS)
    for v in ttft:
        h.observe(v)
    reg.counter("requests_total", "requests").inc(requests, route=route)
    reg.counter("requests_total").inc(1, route='b"q')  # a label value to escape
    reg.gauge("occupancy").set(occupancy)
    return export.prometheus_text(reg)


def test_both_packages_print_the_same_exposition():
    args = ([0.0005, 0.02, 0.3, 2.0], 4)
    assert _worker("jax", *args) == _worker("port", *args)


@pytest.fixture
def fleet():
    return [("prefill", _worker("jax", [0.0005, 0.02], 2)),
            ("decode", _worker("port", [0.3, 0.04, 2.0], 3, occupancy=0.75)),
            ("decode2", _worker("port", [0.002], 1, route="c"))]


def test_parse_aggregate_text_and_quantiles_match(fleet):
    for _, text in fleet:
        assert tagg.parse_prometheus(text) == jagg.parse_prometheus(text)
    got, want = tagg.aggregate(fleet), jagg.aggregate(fleet)
    assert got == want
    assert tagg.fleet_text(got) == jagg.fleet_text(want)
    assert "requests_total" in got["fleet"] and "occupancy" not in got["fleet"]
    for q in (50, 95, 99):
        assert tagg.fleet_quantile(got, "serving_ttft_seconds", q) == \
            jagg.fleet_quantile(want, "serving_ttft_seconds", q)
        for rep, _ in fleet:
            assert tagg.fleet_quantile(got, "serving_ttft_seconds", q, replica=rep) == \
                jagg.fleet_quantile(want, "serving_ttft_seconds", q, replica=rep)
    assert tagg.fleet_quantile(got, "absent", 50) is None
    counts = got["fleet"]["serving_ttft_seconds_count"]
    assert sum(counts.values()) == 6  # the histogram counts sum over the fleet


def test_counter_resets_match(fleet):
    later = [(rep, text) for rep, text in fleet]
    later[1] = ("decode", _worker("jax", [0.3], 1))  # restarted: its counters fell
    prev, cur = tagg.aggregate(fleet), tagg.aggregate(later)
    got = tagg.counter_resets(prev, cur)
    assert got == jagg.counter_resets(jagg.aggregate(fleet), jagg.aggregate(later))
    assert got and all(rep == "decode" for rep, *_ in got)


def test_mismatched_buckets_and_types_rejected_alike():
    a = _worker("port", [0.01], 1)
    b = a.replace('le="0.001"', 'le="0.002"')
    c = "# TYPE requests_total gauge\nrequests_total 1\n"
    for bad in ([("a", a), ("b", b)], [("a", a), ("c", c)]):
        errs = []
        for mod in (jagg, tagg):
            with pytest.raises(ValueError) as e:
                mod.aggregate(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_http_pull_of_mixed_workers_matches(fleet):
    """Each package's MetricsServer, scraped by both federators."""
    regs = {}
    for pkg in PKGS:
        counters, export = PKGS[pkg]
        reg = counters.Registry()
        reg.counter("pulled_total").inc(2 if pkg == "jax" else 5)
        regs[pkg] = (reg, export.MetricsServer(0, registry=reg))
    try:
        urls = [(pkg, f"http://127.0.0.1:{srv.port}") for pkg, (_, srv) in regs.items()]
        texts = [[(pkg, mod.scrape(url)) for pkg, url in urls] for mod in (jagg, tagg)]
        assert texts[0] == texts[1]
        fleet_text = tagg.fleet_text(tagg.aggregate(texts[1]))
        assert fleet_text == jagg.fleet_text(jagg.aggregate(texts[0]))
        assert fleet_text.splitlines().count("pulled_total 7") == 1
    finally:
        for _, srv in regs.values():
            srv.close()


def test_clis_write_the_same_fleet(fleet, tmp_path, capsys):
    paths = []
    for rep, text in fleet:
        p = tmp_path / f"{rep}.prom"
        p.write_text(text)
        paths.append(f"{rep}={p}")
    paths.append(str(p))  # a bare target: labeled r<index>
    outs = []
    for mod, name in ((jagg, "jax"), (tagg, "port")):
        out = tmp_path / f"fleet_{name}.prom"
        assert mod.main([*paths, "--out", str(out)]) == 0
        said = capsys.readouterr().out
        assert mod.main(paths) == 0
        outs.append((out.read_text(), said.replace(str(out), "OUT"), capsys.readouterr().out))
    assert outs[0] == outs[1]
    proc = subprocess.run([sys.executable, "-m", "uccl_tpu_torch.obs.aggregate", *paths],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == outs[1][2]
