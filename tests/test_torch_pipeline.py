"""uccl_tpu_torch.parallel.pipeline (tensors stacked over the pipeline stage)
against uccl_tpu.parallel.pipeline under shard_map on a pp mesh: GPipe's
outputs, aux and gradients, the manual 1F1B step with boundary gradients
(pipeline_train) and its thin adapter (one_f_one_b), and the 1F1B schedule
tables, as tests/test_pipeline.py holds the JAX functions: outputs at rtol
1e-5 / atol 1e-6, gradients at 1e-4 / 1e-5, the tables equal.
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


def _stages(a, p):
    """A replicated array as the stage-stacked tensor [P, ...]."""
    return torch.tensor(np.broadcast_to(a, (p,) + a.shape).copy())


@pytest.mark.parametrize("m", [1, 3])
def test_gpipe_matches_jax(devices, m):
    """4 stages of y = tanh(x @ w_s), aux = sum(x): outputs, aux and the
    gradient of sum(out^2) against the JAX GPipe under shard_map."""
    p, b, h = 4, 2, 8
    rng = np.random.default_rng(m)
    xmb = rng.standard_normal((m, b, h)).astype(np.float32)
    ws = (rng.standard_normal((p, h, h)) * 0.5).astype(np.float32)
    mesh = make_mesh(MeshConfig(pp=p, dp=2), devices)

    def f(w_local, x):
        out, aux = jpipe.gpipe_spmd(lambda xm: (jnp.tanh(xm @ w_local[0]), jnp.sum(xm)), x, "pp")
        return out, aux, jnp.sum(out * out)

    mapped = jax.shard_map(f, mesh=mesh, in_specs=(P("pp"), P()), out_specs=(P(), P(), P()),
                           check_vma=False)
    want_out, want_aux, _ = jax.jit(mapped)(ws, xmb)
    want_g = jax.jit(jax.grad(lambda w: mapped(w, xmb)[2]))(ws)

    w = torch.tensor(ws, requires_grad=True)
    out, aux = tpipe.gpipe_spmd(
        lambda x: (torch.tanh(x @ w), x.sum(dim=(1, 2))), _stages(xmb, p))
    for s in range(p):  # every stage holds the last stage's outputs and the sum
        np.testing.assert_allclose(out[s].detach().numpy(), np.asarray(want_out),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aux[s].item(), float(want_aux), rtol=1e-5)
    (g,) = torch.autograd.grad((out[0] * out[0]).sum(), w)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m,p", [(2, 2), (4, 2), (4, 4), (6, 4), (2, 4), (12, 4), (3, 1)])
def test_simulate_1f1b_tables_equal_jax(m, p):
    for got, want in zip(tpipe._simulate_1f1b(m, p), jpipe._simulate_1f1b(m, p)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,m", [(2, 4), (4, 6)])
@pytest.mark.parametrize("uniform", [False, True])
def test_pipeline_train_matches_jax(devices, p, m, uniform):
    """tests/test_pipeline.py's whole model (embedding -> stages with an aux
    loss -> a head with per-microbatch targets) through both packages'
    pipeline_train: total, loss, stage, head and embedding gradients."""
    b, h, vocab, aux_w = 2, 8, 12, 0.05
    rng = np.random.default_rng(p * 10 + m)
    emb = (rng.standard_normal((vocab, h)) * 0.5).astype(np.float32)
    ws = (rng.standard_normal((p, h, h)) * 0.3).astype(np.float32)
    head = (rng.standard_normal((h, vocab)) * 0.5).astype(np.float32)
    toks = rng.integers(0, vocab, (m, b)).astype(np.int32)
    tgts = rng.standard_normal((m, b, vocab)).astype(np.float32)
    mesh = make_mesh(MeshConfig(pp=p), devices[:p])

    def per_shard(emb_, ws_, head_, toks_, tgts_):
        xmb = jnp.take(emb_, toks_, axis=0)
        total, ce, dws, dhead, dxmb = jpipe.pipeline_train(
            lambda w, x: (jnp.tanh(x @ w[0]), 1e-3 * jnp.sum(x * x)),
            lambda hp, y, tgt: jnp.sum((y @ hp - tgt) ** 2),
            (ws_[0],), head_, xmb, tgts_, "pp", aux_weight=aux_w, uniform=uniform)
        demb = jnp.zeros_like(emb_).at[toks_.reshape(-1)].add(dxmb.reshape(-1, h))
        return total, ce, dws[0][None], dhead, demb

    want = jax.jit(jax.shard_map(
        per_shard, mesh=mesh, in_specs=(P(), P("pp"), P(), P(), P()),
        out_specs=(P(), P(), P("pp"), P(), P()), check_vma=False))(emb, ws, head, toks, tgts)

    x = torch.tensor(emb)[torch.tensor(toks).long()]  # [M, B, H]
    total, ce, (dws,), dhead, dxmb = tpipe.pipeline_train(
        lambda w, x: (torch.tanh(x @ w[0]), 1e-3 * (x * x).sum(dim=(1, 2))),
        lambda hp, y, tgt: ((y @ hp - tgt) ** 2).sum(dim=(1, 2)),
        (torch.tensor(ws),), _stages(head, p), _stages(x.numpy(), p), _stages(tgts, p),
        "pp", aux_weight=aux_w, uniform=uniform)
    demb = torch.zeros_like(torch.tensor(emb)).index_add_(
        0, torch.tensor(toks).reshape(-1).long(), dxmb[0].reshape(-1, h))
    for s in range(p):  # replicated over the stages
        np.testing.assert_allclose(total[s].item(), float(want[0]), rtol=1e-5)
        np.testing.assert_allclose(ce[s].item(), float(want[1]), rtol=1e-5)
    for name, got, w in (("dws", dws, want[2]), ("dhead", dhead[0], want[3]),
                         ("demb", demb, want[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("p,m", [(2, 4), (4, 2)])
def test_one_f_one_b_matches_jax(devices, p, m):
    b, h = 2, 8
    rng = np.random.default_rng(p + m)
    ws = (rng.standard_normal((p, h, h)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((p, h)) * 0.1).astype(np.float32)
    xmb = rng.standard_normal((m, b, h)).astype(np.float32)
    mesh = make_mesh(MeshConfig(pp=p), devices[:p])

    def f(w, bias, x):
        loss, (dw, db) = jpipe.one_f_one_b(
            lambda prm, xx: jnp.tanh(xx @ prm[0] + prm[1]), lambda y: jnp.sum(y * y),
            (w[0], bias[0]), x, "pp")
        return loss, dw[None], db[None]

    want = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("pp"), P("pp"), P()),
                                 out_specs=(P(), P("pp"), P("pp")),
                                 check_vma=False))(ws, bs, xmb)
    loss, (dw, db) = tpipe.one_f_one_b(
        lambda prm, xx: torch.tanh(xx @ prm[0] + prm[1][:, None]),
        lambda y: (y * y).sum(dim=(1, 2)),
        (torch.tensor(ws), torch.tensor(bs)), _stages(xmb, p))
    np.testing.assert_allclose(loss[0].item(), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-5)
