"""uccl_tpu_torch.parallel.pipeline.interleaved_1f1b (stage-stacked tensors,
chunk parameters [P, V, ...]) against uccl_tpu.parallel.pipeline's under
shard_map on a pp mesh and against sequential autodiff, as
tests/test_pipeline.py::TestInterleaved holds the JAX function: the loss at
rtol 1e-5, gradients at rtol 1e-4 / atol 1e-5, and the schedule tables of
_simulate_interleaved equal to the JAX package's entry for entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from uccl_tpu.parallel import pipeline as jpipe
from uccl_tpu.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.parallel import pipeline as tpipe

# (P, V, M) of TestInterleaved's cases: its parity grid, the bf16 case, the
# ramp sweep and the stash bound
CASES = [(2, 2, 4), (4, 2, 4), (2, 3, 5), (2, 1, 4), (2, 2, 2),
         (4, 1, 8), (4, 2, 8), (4, 4, 8), (4, 2, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors (see
    tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stages(a, p):
    """A replicated array as the stage-stacked tensor [P, ...]."""
    return torch.tensor(np.broadcast_to(a, (p,) + a.shape).copy())


def _to_device_chunks(arr, p, v):
    """[L, ...] stage-major -> [P, V, ...] (chunk c on stage s holds global
    stage c*p + s)."""
    return np.moveaxis(arr.reshape((v, p) + arr.shape[1:]), 1, 0)


def _setup(rng, n_stages, m, b=2, h=8):
    ws = (rng.standard_normal((n_stages, h, h)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((n_stages, h)) * 0.1).astype(np.float32)
    xmb = rng.standard_normal((m, b, h)).astype(np.float32)
    return ws, bs, xmb


def _t_stage(prm, x):
    w, bias = prm
    return torch.tanh(x @ w + bias[:, None])


def _t_loss(y):
    return (y * y).sum(dim=tuple(range(1, y.dim())))


@pytest.mark.parametrize("p,v,m", CASES)
@pytest.mark.parametrize("policy", ["greedy", "strict", "best"])
def test_schedule_tables_equal_jax(p, v, m, policy):
    got = tpipe._simulate_interleaved(m, p, v, policy)
    want = jpipe._simulate_interleaved(m, p, v, policy)
    assert (got is None) == (want is None)
    if want is None:
        return
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("p,v,m", [(2, 2, 4), (4, 2, 4), (2, 3, 5), (2, 1, 4)])
def test_matches_jax_and_sequential_autodiff(devices, p, v, m):
    """TestInterleaved's parity grid through both packages: loss and
    gradients against the JAX interleaved_1f1b and against autograd of the
    sequential model."""
    rng = np.random.default_rng(p * 100 + v * 10 + m)
    L = p * v
    ws, bs, xmb = _setup(rng, L, m)
    wd, bd = _to_device_chunks(ws, p, v), _to_device_chunks(bs, p, v)
    mesh = make_mesh(MeshConfig(pp=p), devices[:p])

    def f(w, b, x):
        loss, (dw, db) = jpipe.interleaved_1f1b(
            lambda prm, xx: jnp.tanh(xx @ prm[0] + prm[1]), lambda y: jnp.sum(y * y),
            (w[0], b[0]), x, n_chunks=v, axis="pp")
        return loss, dw[None], db[None]

    want = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("pp"), P("pp"), P(None)),
                                 out_specs=(P(), P("pp"), P("pp")),
                                 check_vma=False))(wd, bd, xmb)

    loss, (dw, db) = tpipe.interleaved_1f1b(
        _t_stage, _t_loss, (torch.tensor(wd), torch.tensor(bd)), _stages(xmb, p), n_chunks=v)

    w_seq = torch.tensor(ws, requires_grad=True)
    b_seq = torch.tensor(bs, requires_grad=True)
    total = 0.0
    for k in range(m):
        x = torch.tensor(xmb[k])
        for i in range(L):
            x = torch.tanh(x @ w_seq[i] + b_seq[i])
        total = total + (x * x).sum()
    g_w, g_b = torch.autograd.grad(total, [w_seq, b_seq])

    for s in range(p):
        np.testing.assert_allclose(loss[s].item(), float(want[0]), rtol=1e-5)
        np.testing.assert_allclose(loss[s].item(), total.item(), rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), _to_device_chunks(g_w.numpy(), p, v),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), _to_device_chunks(g_b.numpy(), p, v),
                               rtol=1e-4, atol=1e-5)


def test_bf16_loss_dtype():
    """A bf16 loss (mixed precision) runs, stays finite, and the gradients
    keep the parameters' dtype."""
    p, v, m = 2, 2, 2
    rng = np.random.default_rng(7)
    ws, bs, xmb = _setup(rng, p * v, m)
    wd = torch.tensor(_to_device_chunks(ws, p, v)).to(torch.bfloat16)
    bd = torch.tensor(_to_device_chunks(bs, p, v)).to(torch.bfloat16)
    loss, (dw, _db) = tpipe.interleaved_1f1b(
        _t_stage, _t_loss, (wd, bd), _stages(xmb, p).to(torch.bfloat16), n_chunks=v)
    assert torch.isfinite(loss).all()
    assert loss.dtype == torch.float32
    assert dw.dtype == torch.bfloat16


def test_ramp_shrinks_with_chunks():
    """In wall-clock units (a slot runs 1/V of a stage's layers) the
    interleaved span T/V beats non-interleaved 1F1B's and shrinks with V."""
    m, p = 8, 4
    spans = {v: tpipe._simulate_interleaved(m, p, v)["do_f"].shape[0] / v
             for v in (1, 2, 4)}
    assert spans[2] < spans[1], spans
    assert spans[4] < spans[2], spans
    sched = tpipe._simulate_interleaved(m, p, 2)
    assert sched["do_f"].sum() == 2 * m * p
    assert sched["do_b"].sum() == 2 * m * p


def test_stash_bound():
    m, p, v = 16, 4, 2
    sched = tpipe._simulate_interleaved(m, p, v)
    cap = sum(min(m, (v - 1 - c) * p + p) for c in range(v))
    assert sched["n_stash"] <= cap
    assert sched["n_stash"] < m


def test_leading_dims_checked():
    xmb = torch.zeros(2, 4, 2, 8)
    with pytest.raises(ValueError, match="stack 2 stages x 2 chunks"):
        tpipe.interleaved_1f1b(_t_stage, _t_loss, (torch.zeros(2, 3, 8, 8), torch.zeros(2, 3, 8)),
                               xmb, n_chunks=2)
    with pytest.raises(ValueError, match="need >=1"):
        tpipe.interleaved_1f1b(_t_stage, _t_loss, (torch.zeros(2, 0, 8, 8),), xmb, n_chunks=0)
