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
    with pytest.raises(SystemExit, match=item):
        serve.main(["--device", "cpu", *flags])


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
