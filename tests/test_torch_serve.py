"""``python -m uccl_tpu_torch.serve`` on the CPU: the continuous-batching
server with ``--check-oracle`` on both stacks (every request equal, token
for token, to its run alone on the engine's slot programs; no slot leaked), the one-shot batch mode,
the observability files, and the flags of later slices refused by name.
No tolerance: the checks are exact."""

import json
import os
import subprocess
import sys

import pytest
import torch

from uccl_tpu_torch import serve

from torch_one_thread import one_torch_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--requests", "8", "--prompt-len", "12", "--new-tokens", "5",
         "--arrival-rate", "0"]


def _last_json(out: str) -> dict:
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


@pytest.mark.parametrize("stack,extra", [
    ("moe", ["--dp", "4", "--slots", "8"]),
    ("moe", ["--dp", "2", "--slots", "4", "--temperature", "0.8", "--top-p", "0.9",
             "--top-k", "20"]),
    ("dense", ["--slots", "3", "--temperature", "0.7", "--priority-classes"]),
    ("dense", ["--slots", "2", "--tenants", "2"]),
])
def test_server_check_oracle(capsys, stack, extra):
    summary, reqs = serve.main(["--server", "--check-oracle", "--stack", stack, *SMALL, *extra])
    out = capsys.readouterr().out
    assert summary["oracle_match"] and summary["leaked_slots"] == 0 and summary["conservation"]
    assert summary["completed"] == len(reqs) == 8 and summary["mismatches"] == []
    assert "token-exact" in out and _last_json(out)["oracle_match"] is True


def test_server_observability_files(tmp_path, capsys):
    metrics, trace = tmp_path / "m.prom", tmp_path / "t.json"
    serve.main(["--server", "--dp", "2", "--slots", "2", *SMALL, "--metrics-out", str(metrics),
                "--trace-out", str(trace)])
    text = metrics.read_text()
    for family in ("serving_ttft_seconds_bucket", "serving_slot_high_water",
                   "uccl_serving_completed 8", "ep_bytes_total"):
        assert family in text
    events = json.loads(trace.read_text())["traceEvents"]
    assert {"engine.step", "wire.decode", "first_token"} <= {e.get("name") for e in events}
    from uccl_tpu_torch import obs

    obs.disable_tracing()


def test_oneshot_batch_mode(capsys):
    summary = serve.main(["--device", "cpu", "--dp", "2", "--batch", "4", "--prompt-len", "6",
                          "--new-tokens", "4", "--timing-reps", "1"])
    assert summary["world"] == 2 and summary["impl"] == "ll"
    assert summary["tokens_per_sec"] > 0 and "ttft_ms" in summary
    assert capsys.readouterr().out.startswith("first sequence:")


@pytest.mark.parametrize("flags,item", [
    (["--ckpt-dir", "/nonexistent"], "item 6"),
    (["--server", "--prefill-chunk", "4"], "item 10g"),
    (["--server", "--step-tokens", "8"], "item 10g"),
    (["--server", "--spec-k", "2"], "item 10a"),
    (["--server", "--adapter-rank", "4", "--tenants", "2"], "item 10c"),
    (["--server", "--replicas", "2"], "item 10d"),
])
def test_flags_of_later_slices_are_refused_by_name(flags, item):
    """Every flag of these items is ported now. ``--ckpt-dir`` (item 6)
    serves a trainer checkpoint (tests/test_torch_serve_ckpt.py), so a
    directory without one is refused for that reason; the serving flags of
    items 10g, 10a, 10c and 10d reach the engine's knobs."""
    if item == "item 6":
        with pytest.raises(SystemExit, match="no step_N checkpoints in /nonexistent"):
            serve.main(["--device", "cpu", *flags])
        return
    args = serve.parser().parse_args(["--device", "cpu", *flags])
    kw = serve.engine_kwargs(args)
    assert {"item 10g": kw["prefill_chunk"] == 4 or args.step_tokens == 8,
            "item 10a": kw["spec_k"] == 2,
            "item 10c": args.adapter_rank == 4 and kw["tenant_fair"],
            "item 10d": args.replicas == 2}[item]


def test_bad_world_and_slots_are_refused():
    with pytest.raises(SystemExit, match="divide"):
        serve.main(["--server", "--dp", "4", "--slots", "6", *SMALL])
    with pytest.raises(SystemExit, match="exceeds"):
        serve.main(["--server", "--devices", "2", "--dp", "4", *SMALL])


def test_default_device_is_cuda_and_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--server", "--requests", "1", "--arrival-rate", "0"])


def test_module_entry_point_runs_in_a_fresh_interpreter():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "uccl_tpu_torch.serve", "--server", "--check-oracle", "--dp",
         "2", "--slots", "2", *SMALL], cwd=REPO, env=env, text=True, capture_output=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _last_json(proc.stdout)["oracle_match"] is True


@pytest.mark.parametrize("stack,extra", [
    ("moe", ["--dp", "4", "--slots", "4", "--prefill-chunk", "4", "--step-tokens", "16",
             "--spec-k", "2", "--priority-classes", "--temperature", "0.8", "--top-k", "20"]),
    ("dense", ["--slots", "2", "--tenants", "2", "--adapter-rank", "4", "--prefill-chunk", "4"]),
    ("moe", ["--dp", "2", "--slots", "4", "--replicas", "2", "--prefill-chunk", "4",
             "--spec-k", "2"]),
])
def test_server_engine_flags_check_oracle(capsys, stack, extra):
    """The engine knobs of the serving slice through the CLI: every request
    equal to its replay (with its engine's drafter and adapters, on the
    replica that ran it), no slot leaked."""
    summary, reqs = serve.main(["--server", "--check-oracle", "--stack", stack, *SMALL, *extra])
    assert summary["oracle_match"] and summary["leaked_slots"] == 0 and summary["conservation"]
    assert summary["completed"] == len(reqs) == 8 and summary["mismatches"] == []
    if "--replicas" in extra:
        assert summary["replicas"] == 2 and {r.replica for r in reqs} == {0, 1}
    if "--adapter-rank" in extra:
        assert {r.adapter for r in reqs} == {"t0", "t1"}
    assert all(r.prefill_chunk == 4 for r in reqs)


def test_bad_engine_flags_are_refused():
    for flags, msg in ((["--step-tokens", "8"], "needs --prefill-chunk"),
                       (["--prefill-chunk", "8", "--step-tokens", "4"], "must be >="),
                       (["--adapter-rank", "4"], "needs --tenants"),
                       (["--replicas", "0"], "--replicas must be")):
        with pytest.raises(SystemExit, match=msg):
            serve.main(["--server", *SMALL, *flags])


def test_feature_workloads_draw_like_the_originals():
    import numpy as np

    from uccl_tpu.serving import loadgen as jload
    from uccl_tpu_torch.serving import loadgen as tload

    for name, args in (("synth_shared_workload", (9, 32, 100, 8.0, 0.5, 12)),
                       ("synth_multi_prefix_workload", (7, 32, 100, 4.0, 3, 12)),
                       ("synth_repeat_workload", (8, 24, 100, 0.0))):
        tp, tl, ta = getattr(tload, name)(np.random.default_rng(5), *args)
        jp, jl, ja = getattr(jload, name)(np.random.default_rng(5), *args)
        assert [p.tolist() for p in tp] == [p.tolist() for p in jp]
        assert np.array_equal(tl, jl) and np.array_equal(ta, ja)
