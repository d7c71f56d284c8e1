"""uccl_tpu_torch ring and Ulysses attention (member-stacked over the cp axis,
CPU: the flash impl runs the kernels' plain versions) against the JAX
package's per-shard functions under shard_map on a cp=4 mesh, forward and
gradients, as tests/test_attention.py holds them: outputs at rtol 2e-4 /
atol 2e-5, gradients at 3e-4 / 3e-5. The JAX flash ring runs in interpret
mode at S_local = 8 only; gradients are held against JAX's plain ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from uccl_tpu.ops import attention as jattn
from uccl_tpu.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.ops import attention as tattn
from uccl_tpu_torch.ops import flash_attention as fa

N_CP = 4
SPEC = P(None, "cp", None, None)


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


@pytest.fixture(scope="module")
def cp_mesh(devices):
    return make_mesh(MeshConfig(cp=N_CP, dp=2), devices)


def _qkv(seed, b=2, s=32, h=4, hkv=None, d=16):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))


def _stacked(a):
    """[B, S, H, D] -> member-stacked [n, B, S/n, H, D] (chunk r on member r)."""
    b, s, h, d = a.shape
    return torch.tensor(a.reshape(b, N_CP, s // N_CP, h, d).transpose(1, 0, 2, 3, 4).copy())


def _global(t):
    n, b, sl, h, d = t.shape
    return t.detach().numpy().transpose(1, 0, 2, 3, 4).reshape(b, n * sl, h, d)


_JAX_RUNS = {}


def _jax(mesh, kind, causal, q, k, v, cot):
    """JAX's plain ring or Ulysses (``kind``) under shard_map: (out, dq, dk,
    dv) of sum(out * cot), computed once per case for both port impls."""
    key = (kind, causal, k.shape)
    if key not in _JAX_RUNS:
        fn = jattn.ring_attention if kind == "ring" else jattn.ulysses_attention
        mapped = jax.shard_map(lambda a, b, c: fn(a, b, c, "cp", causal=causal), mesh=mesh,
                               in_specs=(SPEC,) * 3, out_specs=SPEC, check_vma=False)
        out = np.asarray(jax.jit(mapped)(q, k, v))
        grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(mapped(a, b, c) * cot),
                                 argnums=(0, 1, 2)))(q, k, v)
        _JAX_RUNS[key] = (out,) + tuple(np.asarray(g) for g in grads)
    return _JAX_RUNS[key]


def _port(fn, q, k, v, cot):
    ts = [_stacked(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad((out * _stacked(cot)).sum(), ts)
    return (_global(out),) + tuple(_global(g) for g in grads)


def _close(got, want, rtol, atol):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal,hkv", [(True, 4), (False, 4), (True, 2)],
                         ids=["causal", "noncausal", "gqa"])
def test_ring_matches_jax(cp_mesh, impl, causal, hkv):
    q, k, v, cot = _qkv(0, hkv=hkv)
    want = _jax(cp_mesh, "ring", causal, q, k, v, cot)
    got = _port(lambda a, b, c: tattn.ring_attention(a, b, c, "cp", causal=causal, impl=impl),
                q, k, v, cot)
    _close(got[:1], want[:1], 2e-4, 2e-5)
    _close(got[1:], want[1:], 3e-4, 3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ring_forward_matches_jax_flash(cp_mesh, causal):
    """Against the Pallas flash ring itself (interpret mode, S_local = 8)."""
    q, k, v, _ = _qkv(1, hkv=2)
    mapped = jax.shard_map(
        lambda a, b, c: jattn.ring_attention(a, b, c, "cp", causal=causal, impl="flash"),
        mesh=cp_mesh, in_specs=(SPEC,) * 3, out_specs=SPEC, check_vma=False)
    want = np.asarray(jax.jit(mapped)(q, k, v))
    got = tattn.ring_attention(*map(_stacked, (q, k, v)), "cp", causal=causal, impl="flash")
    np.testing.assert_allclose(_global(got), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal,hkv", [(True, 4), (False, 4), (True, 2)],
                         ids=["causal", "noncausal", "gqa_repeated"])
def test_ulysses_matches_jax(cp_mesh, impl, causal, hkv):
    """hkv = 2 does not divide the axis: the KV heads are repeated first."""
    q, k, v, cot = _qkv(2, hkv=hkv)
    want = _jax(cp_mesh, "ulysses", causal, q, k, v, cot)
    got = _port(lambda a, b, c: tattn.ulysses_attention(a, b, c, "cp", causal=causal,
                                                        impl=impl), q, k, v, cot)
    _close(got[:1], want[:1], 2e-4, 2e-5)
    _close(got[1:], want[1:], 3e-4, 3e-5)


def test_ulysses_indivisible_heads_raises():
    q, k, v, _ = _qkv(3, h=3, hkv=3)
    with pytest.raises(ValueError, match="divisible"):
        tattn.ulysses_attention(*map(_stacked, (q, k, v)), "cp")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ring_one_launch_per_step(monkeypatch, causal):
    """n launches a call; at step t >= 1 the causal ring's launch holds the
    members r >= t only (the JAX lax.cond skip), every member otherwise."""
    seen = []
    real = fa.flash_attention_lse

    def spy(q, k, v, is_causal, *a):
        seen.append((q.shape[0], is_causal))
        return real(q, k, v, is_causal, *a)

    monkeypatch.setattr(fa, "flash_attention_lse", spy)
    q, k, v, _ = _qkv(4)
    tattn.ring_attention(*map(_stacked, (q, k, v)), "cp", causal=causal, impl="flash")
    b = q.shape[0]
    want = [(N_CP * b, causal)] + [((N_CP - t if causal else N_CP) * b, False)
                                   for t in range(1, N_CP)]
    assert seen == want


def test_skipped_members_merge_is_exact():
    """Merging a masked block (lse = -1e30, o = 0) leaves the accumulators'
    bits and passes their cotangents through unchanged: what leaving the
    skipped members out of a ring step does."""
    rng = np.random.default_rng(5)
    o = torch.tensor(rng.standard_normal((2, 8, 4, 16)).astype(np.float32), requires_grad=True)
    lse = torch.tensor(rng.standard_normal((2, 4, 8)).astype(np.float32), requires_grad=True)
    om, lm = tattn._merge_blocks(o, lse, torch.zeros_like(o),
                                 torch.full_like(lse, tattn._NEG_INF))
    assert torch.equal(om, o) and torch.equal(lm, lse)
    go, gl = torch.randn_like(o), torch.randn_like(lse)
    do, dl = torch.autograd.grad((om * go).sum() + (lm * gl).sum(), (o, lse))
    assert torch.equal(do, go) and torch.equal(dl, gl)
