"""uccl_tpu_torch.ep.cross_pod against the JAX package's:
``tests/test_ep.py::TestCrossPod`` and ``TestCrossPodTraining`` case for case,
and ``tests/test_a2a_sched.py::TestCrossPodScheduled`` (slow-marked there,
cheap here), on two pods of threads over real loopback ``DcnGroup``s.

Tolerances, each the JAX test's own: forward within rtol 2e-4 / atol 2e-5
of the dense oracle; gradients (``torch.autograd`` on the saved received
buffers, where the JAX package runs ``jax.vjp``) within rtol 2e-3 / atol
2e-4 of ``jax.grad`` of the single-process oracle; the pipelined forward
(``n_chunks=2``) within rtol 1e-5 / atol 1e-6 of the serial one; the
scheduled DCN order bit-equal to the fixed one. The port's forward also
runs the SwiGLU expert GEMMs of ``ep.ops`` (what the card runs) against
the same oracle.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uccl_tpu_torch.collective.hierarchical import DcnGroup
from uccl_tpu_torch.ep import ops as ep_ops
from uccl_tpu_torch.ep.cross_pod import CrossPodMoE
from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
from uccl_tpu_torch.parallel.distributed import Session
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

from torch_one_thread import one_torch_thread  # noqa: F401


P_PODS, E, T, H, F_, K = 2, 8, 24, 16, 32, 2
EPP = E // P_PODS


def relu_fn(buf, w):
    # buf: [epp, cap, H] — per-expert ReLU MLP
    hmid = torch.relu(torch.einsum("ech,ehf->ecf", buf, w["wg"]))
    return torch.einsum("ecf,efh->ech", hmid, w["wd"])


def swiglu_fn(buf, w):
    return ep_ops._expert_gemms(buf, w["wg"], w["wu"], w["wd"])


def _inputs(rng):
    wg = (rng.standard_normal((E, H, F_)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((E, F_, H)) * 0.2).astype(np.float32)
    x = rng.standard_normal((P_PODS, T, H)).astype(np.float32)
    logits = rng.standard_normal((P_PODS, T, E)).astype(np.float32)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ti = np.argsort(-gates, axis=-1)[..., :K].astype(np.int32)
    tv = np.take_along_axis(gates, ti, -1)
    tv = (tv / tv.sum(-1, keepdims=True)).astype(np.float32)
    return x, ti, tv, wg, wd


def _run_pods(body, tag):
    server = StoreServer()
    results, errors = {}, []

    def pod_main(p):
        try:
            client = StoreClient("127.0.0.1", server.port)
            dcn = DcnGroup(Session(rank=p, world=P_PODS, store=client), n_paths=2, tag=tag)
            results[p] = body(dcn, p, make_mesh(MeshConfig(dp=4), "cpu", 4))
            dcn.close()
            client.close()
        except Exception:  # pragma: no cover
            import traceback

            errors.append((p, traceback.format_exc()))

    ts = [threading.Thread(target=pod_main, args=(p,)) for p in range(P_PODS)]
    [t.start() for t in ts]
    [t.join(timeout=180) for t in ts]
    server.close()
    assert not errors, errors[0][1]
    return results


def _local(w, p):
    return torch.from_numpy(np.ascontiguousarray(w[p * EPP:(p + 1) * EPP]))


class TestCrossPod:
    @pytest.mark.parametrize("expert", ["relu", "swiglu"])
    def test_two_pods_match_dense_oracle(self, expert, rng):
        x, ti, tv, wg, wd = _inputs(rng)
        wu = (rng.standard_normal((E, H, F_)) * 0.2).astype(np.float32)

        def body(dcn, p, mesh):
            moe = CrossPodMoE(dcn, mesh, num_global_experts=E, num_selected=K,
                              capacity_factor=float(E))  # ample: no drops
            w = {"fn": relu_fn if expert == "relu" else swiglu_fn,
                 "wg": _local(wg, p), "wd": _local(wd, p), "wu": _local(wu, p)}
            return moe.forward(x[p], ti[p], tv[p], w)

        results = _run_pods(body, f"xpod_{expert}")
        # dense oracle: every token through its topk experts
        for p in range(P_PODS):
            want = np.zeros((T, H), np.float32)
            for t in range(T):
                for j in range(K):
                    e = ti[p, t, j]
                    if expert == "relu":
                        hmid = np.maximum(x[p, t] @ wg[e], 0.0)
                    else:
                        g = torch.from_numpy(x[p, t] @ wg[e])
                        hmid = (F.silu(g).numpy() * (x[p, t] @ wu[e]))
                    want[t] += tv[p, t, j] * (hmid @ wd[e])
            np.testing.assert_allclose(results[p], want, rtol=2e-4, atol=2e-5)

    def test_two_pods_tight_capacity_runs(self, rng):
        """Tight per-pod buckets drop excess (token,pod) pairs; output stays
        finite and the exchange completes."""
        e_, h_, f_ = 4, 8, 16
        wg = (rng.standard_normal((e_, h_, f_)) * 0.2).astype(np.float32)
        wd = (rng.standard_normal((e_, f_, h_)) * 0.2).astype(np.float32)
        xs = rng.standard_normal((P_PODS, 16, h_)).astype(np.float32)
        tis = rng.integers(0, e_, (P_PODS, 16, K)).astype(np.int32)
        tvs = np.full((P_PODS, 16, K), 0.5, np.float32)

        def body(dcn, p, mesh):
            moe = CrossPodMoE(dcn, mesh, num_global_experts=e_, num_selected=K,
                              capacity_factor=0.5)  # forces drops
            return moe.forward(xs[p], tis[p], tvs[p], {
                "fn": relu_fn,
                "wg": torch.from_numpy(wg[p * 2:(p + 1) * 2]),
                "wd": torch.from_numpy(wd[p * 2:(p + 1) * 2])})

        results = _run_pods(body, "xpod_tight")
        for p in range(P_PODS):
            assert np.isfinite(results[p]).all()

    def test_rejects_mismatched_k_and_unknown_schedule(self, rng):
        def body(dcn, p, mesh):
            with pytest.raises(ValueError, match="a2a_sched"):
                CrossPodMoE(dcn, mesh, num_global_experts=E, a2a_sched="maybe")
            moe = CrossPodMoE(dcn, mesh, num_global_experts=E, num_selected=K)
            with pytest.raises(ValueError, match="num_selected"):
                moe.forward(np.zeros((4, H), np.float32), np.zeros((4, 3), np.int32),
                            np.zeros((4, 3), np.float32), {"fn": relu_fn})
            with pytest.raises(RuntimeError, match="saved forward"):
                moe.backward(np.zeros((4, H), np.float32))
            return True

        assert _run_pods(body, "xpod_err") == {0: True, 1: True}


class TestCrossPodTraining:
    """Backward runs the same DCN exchanges and the gradients match a
    single-process oracle."""

    def _run(self, rng, n_chunks, mode="off", traffic=None):
        x, ti, tv, wg, wd = _inputs(rng)

        def body(dcn, p, mesh):
            moe = CrossPodMoE(dcn, mesh, num_global_experts=E, num_selected=K,
                              capacity_factor=float(E), n_chunks=n_chunks,
                              a2a_sched=mode, a2a_traffic=traffic)
            out = moe.forward(x[p], ti[p], tv[p],
                              {"fn": relu_fn, "wg": _local(wg, p), "wd": _local(wd, p)})
            # loss = sum(out^2) per pod -> dout = 2*out
            dx, dw, dwarr = moe.backward(2.0 * out)
            return out, dx, dw, {k: v.numpy() for k, v in dwarr.items()}

        results = _run_pods(body, f"xpodtr{n_chunks}{mode}")
        return results, (x, ti, tv, wg, wd)

    @pytest.mark.parametrize("n_chunks", [1, 2], ids=["serial", "overlap"])
    def test_grads_match_oracle(self, rng, n_chunks):
        results, (x, ti, tv, wg, wd) = self._run(rng, n_chunks)

        # oracle: global loss = sum over pods of sum(out_p^2); autodiff
        def oracle_loss(xg, tvg, wgg, wdg):
            total = 0.0
            for p in range(P_PODS):
                out = jnp.zeros((T, H), jnp.float32)
                for j in range(K):
                    e = ti[p, :, j]
                    hmid = jnp.maximum(jnp.einsum("th,thf->tf", xg[p], wgg[e]), 0.0)
                    y = jnp.einsum("tf,tfh->th", hmid, wdg[e])
                    out = out + tvg[p, :, j][:, None] * y
                total = total + jnp.sum(out**2)
            return total

        g_x, g_tv, g_wg, g_wd = jax.grad(oracle_loss, argnums=(0, 1, 2, 3))(
            jnp.asarray(x), jnp.asarray(tv), jnp.asarray(wg), jnp.asarray(wd)
        )
        for p in range(P_PODS):
            out, dx, dw, dwarr = results[p]
            np.testing.assert_allclose(dx, np.asarray(g_x[p]), rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(dw, np.asarray(g_tv[p]), rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(dwarr["wg"], np.asarray(g_wg[p * EPP:(p + 1) * EPP]),
                                       rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(dwarr["wd"], np.asarray(g_wd[p * EPP:(p + 1) * EPP]),
                                       rtol=2e-3, atol=2e-4)

    def test_overlap_matches_serial_forward(self, rng):
        """n_chunks=2 (pipelined exchanges) is numerically identical to the
        serial schedule."""
        r1, _ = self._run(rng, 1)
        r2, _ = self._run(np.random.default_rng(0), 2)
        for p in r1:
            np.testing.assert_allclose(r1[p][0], r2[p][0], rtol=1e-5, atol=1e-6)


class TestCrossPodScheduled:
    def test_two_pods_sched_matches_off(self, rng):
        """The contention-aware DCN order (a skewed traffic matrix) moves
        the same bytes as the fixed order: outputs and gradients bit for
        bit."""
        skewed = np.array([[0.0, 5.0], [1.0, 0.0]])
        off, _ = self._pair(rng, "off", None)
        on, _ = self._pair(np.random.default_rng(0), "on", skewed)
        for p in range(P_PODS):
            for a, b in zip(on[p][:3], off[p][:3]):
                np.testing.assert_array_equal(a, b)

    def _pair(self, rng, mode, traffic):
        return TestCrossPodTraining._run(None, rng, 1, mode, traffic)
