"""The harness on the CPU: the contract of ``BENCHMARK.json``, a cell, a
configuration and a metric added as new files only, the import guard, and
the check failing under each planted fault and under the control.

A tiny float32 cell stands in for the card's: its limits come from CPU
readings of the program (at most 2.3e-7 loss, 4.6e-7 grad, 2.9e-6 change
over 8 seeds) and of its control, the reference in TF32 (at least 1.4e-5,
1.4e-4, 3.8e-4 over 4 seeds).
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import check
import faults
import run
import traffic
import weights

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 3_000_000_019

TINY_CONFIG = {
    "family": "flagship", "source": "a test's cell",
    "model": {"vocab": 256, "dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 16, "moe_experts": 4, "moe_topk": 2, "moe_ffn": 96,
              "capacity_factor": 1.25, "rope_theta": 10000.0, "norm_eps": 1e-6,
              "aux_loss_weight": 0.01, "z_loss_weight": 0.001, "remat": "full",
              "dtype": "float32"},
    "optimizer": {"name": "adamw", "learning_rate": 3e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
                  "weight_decay": 0.01, "state_dtype": "float32"},
}
TINY_LIMITS = {"loss": 2e-6, "grad": 1e-5, "change": 3e-5}
NEW_METRIC = '''"""traced_steps: how many steps the profiler saw."""


def read(run):
    return float(run.trace_steps)
'''


@pytest.fixture
def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout's benchmark with a configuration, a traffic mix, a cell and
    a per-layer metric added as new files; the files already there are
    copied unchanged."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    data = tmp_path / "portbench"
    (data / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (data / "traffic" / "b4-s32.json").write_text(json.dumps(
        {"batch": 4, "seq": 32, "pool": 4}))
    (data / "workloads" / "tiny.b4-s32.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    (data / "metrics" / "traced_steps.py").write_text(NEW_METRIC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test", "reduced": [], "why": "test",
                             "file": "portbench/configs/tiny.json"})
    bench["workloads"].append({"name": "tiny.b4-s32", "config": "tiny", "traffic": "b4-s32",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "traced_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "step_ms", "workloads": ["tiny.b4-s32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for f in BENCH.rglob("*"):
        if f.is_file() and "tests" not in f.parts and "__pycache__" not in f.parts:
            assert (data / f.relative_to(BENCH)).read_bytes() == f.read_bytes()
    return tmp_path


def _run_in_process(root, wrap=None, trace=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "tiny.b4-s32", "--seed", str(SEED), "--seconds", "0.3",
                       "--trace", str(trace)], device="cpu", root=root, wrap=wrap)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


REHEARSAL = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
rc = run.main({argv!r}, device="cpu")
print(json.dumps({{"rc": rc, "forbidden": run.forbidden_modules(),
                   "program": "uccl_tpu_torch" in sys.modules}}))
"""


def _rehearse(root: Path, argv, program_root=ROOT):
    code = REHEARSAL.format(bench=str(root / "portbench"), root=str(program_root), argv=argv)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, env=env, timeout=600)


def test_benchmark_json_keeps_the_contract(bench_json):
    b = bench_json
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and set(c["reduced"]) <= set(cfg["model"])
        assert not any(k.endswith(("_dim", "_rank", "_ffn")) or k in ("dim", "moe_topk")
                       for k in c["reduced"])
        names.add(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        traffic.check(json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()))
        limits = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())["limits"]
        assert limits and set(limits) <= set(check.NAMES)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["workloads"] and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    everything = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    assert all(NAME.match(x["name"]) for x in everything)
    assert len({x["name"] for x in b["end_to_end"] + b["per_layer"]}) == len(
        b["end_to_end"]) + len(b["per_layer"])
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in b["end_to_end"] + b["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_added_as_new_files_run_on_the_cpu(tiny_root):
    argv = ["--workload", "tiny.b4-s32", "--seed", str(SEED), "--seconds", "0.3"]
    for trace in ("0", "1"):
        proc = _rehearse(tiny_root, argv + ["--trace", trace])
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = proc.stdout.strip().splitlines()
        result, after = json.loads(lines[-2]), json.loads(lines[-1])
        assert after == {"rc": 0, "forbidden": [], "program": True}
        assert result["correct"] is True and result["failed"] == 0
        assert list(result)[-1] == "checks"
        if trace == "0":
            assert set(result["metrics"]) == {"step_ms", "peak_gib", "setup_s"}
        else:  # the CPU has no device kernels: only the new metric reads
            assert result["metrics"] == {"traced_steps": {"value": 3.0, "unit": "steps"}}
            assert "breakdown" in result
        tail = proc.stderr.strip().splitlines()[-3:]
        assert tail == ["check failed_steps 0 limit 0", "check state_dtype 0 limit 0",
                        "check tf32_matmul 0 limit 0"]


def test_without_the_program_there_is_no_result(tiny_root, tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copytree(tiny_root / "portbench", bare / "portbench")
    shutil.copy(tiny_root / "BENCHMARK.json", bare)
    proc = _rehearse(bare, ["--workload", "tiny.b4-s32", "--seed", "1", "--seconds", "0.3",
                            "--trace", "0"], program_root=bare)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout


def test_without_a_card_there_is_no_result(bench_json):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           bench_json["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no card" in proc.stderr


def test_a_sound_run_is_correct(tiny_root):
    assert _run_in_process(tiny_root)["correct"] is True


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_planted_fault_fails_the_check(tiny_root, fault):
    result = _run_in_process(tiny_root, wrap=faults.FAULTS[fault])
    assert result["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in result["checks"].values())


def test_the_control_fails_the_check(tiny_root):
    cell = run.load_cell(tiny_root, "tiny.b4-s32")
    ref = run.load_module(BENCH / "reference" / "flagship.py", "portbench_test_reference")
    layout = run.load_module(BENCH / "families" / "flagship.py",
                             "portbench_test_family").layout(cell.model)
    for seed in (SEED, SEED + 7919, SEED + 2 * 7919):
        batches = traffic.pool(cell.mix, cell.model["vocab"], seed, "cpu")
        want = run.reference_record(ref, cell, layout, batches, seed, "cpu")
        got = run.reference_record(ref, cell, layout, batches, seed, "cpu", control="products")
        correct, _, _ = check.judge(check.gaps(got, want), cell.limits)
        assert not correct, seed


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "uccl_tpu_torch_lookalike", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "uccl_tpu.ops", types.ModuleType("uccl_tpu.ops"))
    assert run.forbidden_modules() == ["jax", "uccl_tpu"]


def test_weights_and_batches_follow_the_seed():
    layout = [(("a",), (3, 4), 0.5), (("b", "c"), (2,), None)]
    one, two = weights.tree(layout, 2**31 + 5, "cpu"), weights.tree(layout, 2**31 + 5, "cpu")
    assert torch.equal(one["a"], two["a"]) and torch.equal(one["b"]["c"], torch.ones(2))
    assert not torch.equal(one["a"], weights.tree(layout, 2**31 + 6, "cpu")["a"])
    mix = {"batch": 2, "seq": 8, "pool": 3}
    a, b = traffic.pool(mix, 50, 11, "cpu"), traffic.pool(mix, 50, 11, "cpu")
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))
    assert torch.equal(a[0][0][:, 1:], a[0][1][:, :-1])  # targets are the next token


def test_a_mix_with_other_keys_is_refused():
    with pytest.raises(ValueError):
        traffic.check({"batch": 1, "seq": 8, "pool": 2, "zipf_exponent": 1.0})


def test_float32_departures_are_counted(tiny_root, monkeypatch):
    cell = run.load_cell(tiny_root, "tiny.b4-s32")
    params = {"a": torch.zeros(3), "b": {"c": torch.zeros(2)}}
    state = {"count": 1, "mu": {"a": torch.zeros(3)}, "nu": {"a": torch.zeros(3)}}
    assert run.float32_departures(cell, params, state) == {"state_dtype": 0, "tf32_matmul": 0}
    state["mu"]["a"] = torch.zeros(3, dtype=torch.bfloat16)
    params["b"]["c"] = torch.zeros(2, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert run.float32_departures(cell, params, state) == {"state_dtype": 2, "tf32_matmul": 1}
