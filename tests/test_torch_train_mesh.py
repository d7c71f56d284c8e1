"""``python -m uccl_tpu_torch.train --mesh`` (every member on the CPU) against
``python -m uccl_tpu.train --mesh`` on the conftest's 8 virtual devices, run
in this process at the same flags: each step's loss (the JAX trainer prints
six decimals) within 2e-6 of the printed value. The port's own checkpoints
at a mesh resume bit for bit.
"""

import re

import numpy as np
import pytest
import torch

from uccl_tpu import train as jtrain
from uccl_tpu_torch import train as ttrain

SIZE = ["--vocab", "64", "--dim", "32", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--ffn", "32", "--experts", "4", "--batch", "4", "--seq", "16", "--log-every", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: in the parallel
    test run every worker's torch would otherwise start a thread per core
    and the workers' threads contend; and with one there is no fresh
    worker thread whose first exp/log can be off by ~1e-4 (ROADMAP C8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_losses(argv, capsys):
    capsys.readouterr()
    jtrain.main(argv)
    out = capsys.readouterr().out
    return [float(m.group(1)) for m in re.finditer(r"^step +\d+ loss ([-\d.]+)", out, re.M)]


@pytest.mark.parametrize("flags", [
    ["--mesh", "pp=2,cp=2,tp=2", "--microbatches", "2"],
    ["--model", "dense", "--mesh", "pp=2,dp=2,tp=2", "--microbatches", "2"],
], ids=["pp2_cp2_tp2", "dense_pp2_dp2_tp2"])
def test_mesh_run_matches_the_jax_trainer(flags, capsys):
    argv = [*SIZE, *flags, "--steps", "2"]
    want = _jax_losses(argv, capsys)
    run = ttrain.main(["--device", "cpu", *argv])
    mesh = dict(pp=1, dp=1, cp=1, tp=1)
    mesh.update({k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", flags[flags.index("--mesh") + 1])})
    assert run.summary["mesh"] == mesh
    assert len(want) == 2
    np.testing.assert_allclose([m["loss"] for m in run.metrics], want, rtol=0, atol=2e-6)


def test_mesh_resume_is_bit_exact(tmp_path):
    """4 steps with a checkpoint every 2 at pp=2, cp=2, tp=2 (GPipe), then a
    resume from step 2: the same parameters, moments and losses, bit for
    bit (the checkpoint holds the global trees)."""
    base = ["--device", "cpu", *SIZE, "--mesh", "pp=2,cp=2,tp=2", "--microbatches", "2",
            "--steps", "4"]
    full = ttrain.main([*base, "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "2"])
    ttrain.main([*base[:-1], "2", "--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "2"])
    resumed = ttrain.main([*base, "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert resumed.summary["steps"] == 2
    for a, b in zip(ttrain.flagship.tree_leaves(full.params),
                    ttrain.flagship.tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for a, b in zip(ttrain.flagship.tree_leaves(full.opt_state["mu"]),
                    ttrain.flagship.tree_leaves(resumed.opt_state["mu"])):
        assert torch.equal(a, b)
    assert [m["loss"] for m in full.metrics[2:]] == [m["loss"] for m in resumed.metrics]
