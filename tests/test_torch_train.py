"""The port's trainer entry point and the port's import boundary: no module of
uccl_tpu_torch, and not chip_smoke.py, imports jax or the JAX package."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from uccl_tpu.train import _batch_for_step as jax_batch_for_step
from uccl_tpu_torch import train as ttrain

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "uccl_tpu_torch"


def _run(args, timeout=240):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, text=True,
                          capture_output=True, timeout=timeout)


def test_trainer_runs_on_cpu_with_finite_losses():
    proc = _run(["-m", "uccl_tpu_torch.train", "--device", "cpu", "--steps", "2",
                 "--log-every", "1", "--batch", "2", "--seq", "16", "--vocab", "64",
                 "--dim", "32", "--layers", "1", "--heads", "2", "--kv-heads", "1",
                 "--ffn", "48", "--experts", "4"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    losses = [float(line.split()[3]) for line in lines if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    summary = json.loads(lines[-1])
    assert summary["steps"] == 2 and summary["device"] == "cpu"
    assert summary["dtype"] == "float32" and np.isfinite(summary["final_loss"])


@pytest.mark.parametrize("flag", [["--mesh", "dp=2", "--batch", "3"]])
def test_trainer_refuses_unported_flags(flag, capsys):
    """Every flag of the JAX trainer is ported (--mesh in
    tests/test_torch_train_mesh.py); a mesh the data does not divide over is
    refused before anything is built, with the JAX trainer's message."""
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--device", "cpu", "--steps", "1", *flag])
    err = capsys.readouterr().err
    assert exc.value.code == 2 and "--batch 3 must divide by dp=2" in err


def test_batch_stream_matches_jax_trainer():
    for step in (0, 7):
        for a, b in zip(ttrain._batch_for_step(step, 3, 5, 100),
                        jax_batch_for_step(step, 3, 5, 100)):
            np.testing.assert_array_equal(a, b)


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter (this one has jax loaded by conftest.py)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    # the last modules ported: importing them pulls in no jax either
    assert {"uccl_tpu_torch.version", "uccl_tpu_torch.doctor", "uccl_tpu_torch.models.resnet",
            "uccl_tpu_torch.obs.aggregate", "uccl_tpu_torch.obs.slo",
            "uccl_tpu_torch.utils.latency", "uccl_tpu_torch.utils.stats",
            "uccl_tpu_torch.utils.timing", "uccl_tpu_torch.utils.tracing"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'uccl_tpu' or m.startswith('uccl_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_jax_module_has_a_port_counterpart():
    """Every module of the JAX package has one of the same path in the
    port, but the jax version bridge and the two Pallas kernel files (their
    kernels are the port's csrc/)."""
    def modules(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}

    missing = modules(REPO / "uccl_tpu") - modules(PORT)
    assert missing == {"utils/jaxcompat.py", "ops/pallas_attention.py",
                       "collective/pallas_ccl.py"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_source_imports_jax_or_the_jax_package():
    files = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(files) > 8
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "uccl_tpu"), f"{path}: {name}"
