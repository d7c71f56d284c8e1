"""``python -m uccl_tpu_torch.serve --ckpt-dir``: the port serves what the
port's trainer saved, token for token as the JAX package's engine serves
the same weights (CPU, tiny widths).

A one-step checkpoint of each family is written by uccl_tpu_torch.train;
its params go to the JAX servers through numpy. The MoE stack runs at EP
world 1 (the sorted decode path) and 2 (the packed LL path), the dense
stack at world 1; greedy tokens must be identical. The size checks and the
config.json check refuse with the JAX package's messages.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uccl_tpu import serve as jserve
from uccl_tpu.models import inference as jinf
from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.models.dense import DenseConfig as JDenseConfig
from uccl_tpu_torch import serve as tserve
from uccl_tpu_torch import train as ttrain
from uccl_tpu_torch.models import moe_inference as tmoe

SIZE = ["--vocab", "64", "--dim", "32", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--ffn", "48", "--experts", "4"]
WIDTHS = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8)
ONESHOT = ["--device", "cpu", "--batch", "4", "--prompt-len", "6", "--new-tokens", "4",
           "--timing-reps", "1"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for model in ("flagship", "dense"):
        d = str(root / model)
        ttrain.main(["--device", "cpu", "--model", model, "--steps", "1", "--batch", "2",
                     "--seq", "8", "--log-every", "0", "--ckpt-dir", d, "--ckpt-every", "1",
                     *SIZE])
        out[model] = (d, jax.tree.map(np.asarray, ttrain.load_state(d, 1)["params"],
                                      is_leaf=torch.is_tensor))
    return out


def _first_sequence(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("first sequence:"))
    return json.loads(line.split(":", 1)[1])


@pytest.mark.parametrize("world", [1, 2])
def test_moe_checkpoint_serves_the_jax_engines_tokens(world, ckpts, devices, capsys):
    d, params = ckpts["flagship"]
    summary = tserve.main([*ONESHOT, "--ckpt-dir", d, "--dp", str(world)])
    assert summary["ckpt_step"] == 1 and summary["world"] == world
    got = _first_sequence(capsys.readouterr().out)
    cfg = jmoe.MoEServeConfig(**WIDTHS, moe_experts=4, moe_ffn=48)
    server = jmoe.MoEServer(cfg, Mesh(np.array(devices[:world]), ("dp",)))
    prompt = np.random.default_rng(0).integers(0, 64, (world, 4 // world, 6)).astype(np.int32)
    impl = "sort" if world == 1 else "ll"
    want = np.asarray(server.generate(server.shard_params(jax.tree.map(jnp.asarray, params)),
                                      jnp.asarray(prompt), 4, 10, impl=impl))
    assert got == want[0, 0].tolist()
    # every sequence, through the port's own server on the loaded params
    tcfg = tmoe.MoEServeConfig(**WIDTHS, moe_experts=4, moe_ffn=48)
    args = tserve.parser().parse_args([*ONESHOT, "--ckpt-dir", d, *SIZE])
    tp, step = tserve.stack_params(args, tcfg, tmoe.init_params, torch.device("cpu"))
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    tsrv = tmoe.MoEServer(tcfg, make_mesh(MeshConfig(dp=world), "cpu", world))
    out = tsrv.generate(tsrv.shard_params(tp), prompt, 4, 10, impl=impl)
    assert step == 1 and out.numpy().tolist() == want.tolist()


def test_dense_checkpoint_serves_the_jax_tokens(ckpts, capsys):
    d, params = ckpts["dense"]
    summary = tserve.main([*ONESHOT, "--ckpt-dir", d])
    assert summary["impl"] == "dense" and summary["ckpt_step"] == 1
    got = _first_sequence(capsys.readouterr().out)
    prompt = np.random.default_rng(0).integers(0, 64, (4, 6)).astype(np.int32)
    want = jinf.generate(jax.tree.map(jnp.asarray, params), jnp.asarray(prompt),
                         JDenseConfig(**WIDTHS, ffn=48), max_new_tokens=4, max_seq=10)
    assert got == np.asarray(want)[0].tolist()
    # the server engine picks the dense stack from config.json and passes its oracle
    summary, reqs = tserve.main(["--device", "cpu", "--server", "--ckpt-dir", d, "--slots", "2",
                                 "--requests", "3", "--prompt-len", "6", "--new-tokens", "3",
                                 "--arrival-rate", "0", "--check-oracle"])
    assert summary["stack"] == "dense" and summary["oracle_match"] and len(reqs) == 3


def _shrunk(params, leaf, axis):
    p = jax.tree.map(lambda a: a, params)
    node = p
    for part in leaf[:-1]:
        node = node[part]
    node[leaf[-1]] = np.delete(node[leaf[-1]], 0, axis=axis)
    return p


@pytest.mark.parametrize("leaf,axis", [(("embed",), 0), (("blocks", "we_gate"), 3),
                                       (("blocks", "wq"), 2), (("blocks", "we_gate"), 1)])
def test_size_mismatches_use_the_jax_messages(leaf, axis, ckpts):
    _, params = ckpts["flagship"]
    bad = _shrunk(params, leaf, axis)
    with pytest.raises(SystemExit) as want:
        jserve._check_sizes(bad, jmoe.MoEServeConfig(**WIDTHS, moe_experts=4, moe_ffn=48))
    with pytest.raises(SystemExit) as got:
        tserve._check_sizes(jax.tree.map(torch.tensor, bad),
                            tmoe.MoEServeConfig(**WIDTHS, moe_experts=4, moe_ffn=48))
    assert str(got.value) == str(want.value)


def test_family_and_config_refusals(ckpts, tmp_path):
    d, dense_params = ckpts["dense"]
    cfg = jmoe.MoEServeConfig(**WIDTHS, moe_experts=4, moe_ffn=48)
    with pytest.raises(SystemExit) as want:
        jserve._check_sizes(dense_params, cfg)
    with pytest.raises(SystemExit) as got:
        tserve._check_sizes(jax.tree.map(torch.tensor, dense_params),
                            tmoe.MoEServeConfig(**WIDTHS, moe_experts=4, moe_ffn=48))
    assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit, match=r"--dim 48 != checkpoint config 32"):
        tserve.main([*ONESHOT, "--ckpt-dir", d, "--dim", "48"])
    with pytest.raises(SystemExit, match="no step_N checkpoints in"):
        tserve.main([*ONESHOT, "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no such checkpoint"):
        tserve.main([*ONESHOT, "--ckpt-dir", d, "--step", "7"])
    assert not os.path.exists(os.path.join(str(tmp_path), "config.json"))
