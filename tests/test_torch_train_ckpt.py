"""uccl_tpu_torch.train's --data stream, checkpoints and --resume against the
JAX trainer (uccl_tpu/train.py), on the CPU at tiny widths.

The --data batches must equal the JAX trainer's bit for bit, and its
refusals carry the JAX messages. A save must round-trip every tensor
exactly and leave no step behind when it fails; a resumed run must equal
the uninterrupted one bit for bit (the CPU's arithmetic is deterministic);
config.json must hold the keys the JAX trainer writes.
"""

import ast
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from uccl_tpu import train as jtrain
from uccl_tpu_torch import train as ttrain

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = ["--vocab", "64", "--dim", "32", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--ffn", "48", "--experts", "4", "--batch", "2", "--seq", "16", "--log-every", "0"]


@pytest.fixture
def corpus_path(tmp_path):
    path = tmp_path / "corpus.npy"
    np.save(path, np.random.default_rng(0).integers(0, 64, 4096).astype(np.int32))
    return str(path)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_same_state(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for name, x in la.items():
        y = lb[name]
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x.detach().cpu(), y.detach().cpu()), name
        else:
            assert x == y, name


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint16])
def test_data_stream_matches_jax_trainer(dtype, corpus_path):
    corpus = np.load(corpus_path).astype(dtype)
    for step in (0, 3, 11):
        got = ttrain._batch_for_step(step, 4, 16, 64, corpus)
        want = jtrain._batch_for_step(step, 4, 16, 64, corpus)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        # next-token targets
        np.testing.assert_array_equal(got[0][:, 1:], got[1][:, :-1])


@pytest.mark.parametrize("bad", ["2d", "float", "short", "high", "negative"])
def test_open_corpus_refusals_carry_the_jax_messages(bad, tmp_path):
    arr = {"2d": np.zeros((4, 40), np.int32), "float": np.zeros(100, np.float32),
           "short": np.zeros(17, np.int32), "high": np.full(100, 64, np.int32),
           "negative": np.full(100, -1, np.int64)}[bad]
    path = str(tmp_path / "bad.npy")
    np.save(path, arr)
    with pytest.raises(SystemExit) as want:
        jtrain._open_corpus(path, 64, 16)
    with pytest.raises(SystemExit) as got:
        ttrain._open_corpus(path, 64, 16)
    assert str(got.value) == str(want.value)


def test_save_load_round_trips_every_tensor_exactly(tmp_path):
    run = ttrain.main(["--device", "cpu", "--steps", "1", *SIZE])
    ttrain._save(str(tmp_path), 1, run.params, run.opt_state)
    state = ttrain.load_state(str(tmp_path), 1)
    _assert_same_state(state, {"params": run.params, "opt": run.opt_state})
    assert state["opt"]["count"] == 1
    # restore into fresh trees: the live tensors are written in place
    fresh = ttrain.main(["--device", "cpu", "--steps", "0", "--seed", "1", *SIZE])
    p, o = ttrain._restore(str(tmp_path), 1, fresh.params, fresh.opt_state)
    assert p["embed"] is fresh.params["embed"]
    _assert_same_state({"params": p, "opt": o}, {"params": run.params, "opt": run.opt_state})


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves no step_N: only a hidden temporary."""
    run = ttrain.main(["--device", "cpu", "--steps", "0", *SIZE])

    def dies(obj, path):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError):
        ttrain._save(str(tmp_path), 2, run.params, run.opt_state)
    assert ttrain._latest_step(str(tmp_path)) is None
    assert not any(n.startswith("step_") for n in os.listdir(tmp_path))
    monkeypatch.undo()
    ttrain._save(str(tmp_path), 2, run.params, run.opt_state)  # a retry succeeds
    assert ttrain._latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("model", ["flagship", "dense"])
def test_resume_equals_the_uninterrupted_run(model, tmp_path, corpus_path):
    flags = ["--device", "cpu", "--model", model, "--data", corpus_path, *SIZE]
    straight = ttrain.main([*flags, "--steps", "4"])
    first = str(tmp_path / "a")
    ttrain.main([*flags, "--steps", "2", "--ckpt-dir", first, "--ckpt-every", "2"])
    resumed = ttrain.main([*flags, "--steps", "4", "--ckpt-dir", first, "--ckpt-every", "2",
                           "--resume"])
    assert resumed.summary["steps"] == 2
    assert resumed.metrics == straight.metrics[2:]
    _assert_same_state({"params": resumed.params, "opt": resumed.opt_state},
                       {"params": straight.params, "opt": straight.opt_state})
    assert ttrain._latest_step(first) == 4


def _jax_config_keys():
    """The keys of the model_cfg dict the JAX trainer passes to _save."""
    tree = ast.parse((REPO / "uccl_tpu" / "train.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "model_cfg" \
                and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys]
    raise AssertionError("no model_cfg dict in uccl_tpu/train.py")


def test_config_json_has_the_jax_trainers_keys(tmp_path):
    ckpt = str(tmp_path / "c")
    ttrain.main(["--device", "cpu", "--steps", "1", "--ckpt-dir", ckpt, "--ckpt-every", "1",
                 *SIZE])
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = json.load(f)
    assert list(cfg) == _jax_config_keys()
    assert cfg == {"model": "flagship", "vocab": 64, "dim": 32, "layers": 2, "heads": 4,
                   "kv_heads": 2, "ffn": 48, "experts": 4}
    assert sorted(os.listdir(ckpt)) == ["config.json", "step_1"]
    assert os.listdir(os.path.join(ckpt, "step_1")) == [ttrain.STATE_FILE]


def test_resume_rules_and_messages(tmp_path):
    ckpt = str(tmp_path / "c")
    with pytest.raises(SystemExit, match="--resume needs an existing --ckpt-dir"):
        ttrain.main(["--device", "cpu", "--steps", "1", "--resume", *SIZE])
    os.makedirs(ckpt)
    with pytest.raises(SystemExit, match="no step_N checkpoints in"):
        ttrain.main(["--device", "cpu", "--steps", "1", "--resume", "--ckpt-dir", ckpt, *SIZE])
    ttrain.main(["--device", "cpu", "--steps", "1", "--ckpt-dir", ckpt, "--ckpt-every", "1",
                 *SIZE])
    with pytest.raises(SystemExit, match="already holds checkpoints; pass --resume"):
        ttrain.main(["--device", "cpu", "--steps", "2", "--ckpt-dir", ckpt, *SIZE])
    # a checkpoint of other widths is refused by name, not loaded
    with pytest.raises(SystemExit, match="pass the training run's size flags"):
        ttrain.main(["--device", "cpu", "--steps", "2", "--ckpt-dir", ckpt, "--resume",
                     *SIZE, "--dim", "64"])
    shutil.rmtree(ckpt)
