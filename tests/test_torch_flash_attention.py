"""uccl_tpu_torch flash attention (its plain path, on the CPU) against the JAX
package's Pallas flash attention (interpret mode, as
tests/test_pallas_attention.py runs it) and attention_reference.

Tolerances are those of tests/test_pallas_attention.py: out and lse at
rtol 2e-4 / atol 2e-5 in f32, gradients at 1e-3 / 1e-4, bf16 at 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.ops.attention import attention_reference as j_attention_reference
from uccl_tpu.ops.pallas_attention import flash_attention_lse as j_flash_attention_lse
from uccl_tpu_torch.ops import attention as tattn
from uccl_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _order_independent():
    """Every case here, the first included, sees the same process state
    whatever file ran before it on the same worker: torch's default dtype
    and JAX's x64 and matmul-precision flags are pinned for the module (and
    restored after it), the JAX interpreter compiles and runs the forward
    once before the first case, so no case is a process's first call of
    it, and torch's exp and log run once on every intra-op thread (a fresh
    OpenMP worker thread's first one can be off by ~1e-4, ROADMAP C8)."""
    saved = (torch.get_default_dtype(), jax.config.jax_enable_x64,
             jax.config.jax_default_matmul_precision)
    torch.set_default_dtype(torch.float32)
    jax.config.update("jax_enable_x64", False)
    jax.config.update("jax_default_matmul_precision", None)
    x = torch.rand(torch.get_num_threads() * 65536) + 0.5
    torch.exp(x), torch.log(x)
    q, k, v = _qkv(np.random.default_rng(0))
    for causal in (True, False):
        jax.block_until_ready(j_flash_attention_lse(*map(jnp.asarray, (q, k, v)), causal, 32, 32))
    yield
    torch.set_default_dtype(saved[0])
    jax.config.update("jax_enable_x64", saved[1])
    jax.config.update("jax_default_matmul_precision", saved[2])


def _qkv(rng, b=1, s=64, h=4, hkv=None, d=32, dtype=np.float32):
    hkv = hkv or h
    return (
        rng.standard_normal((b, s, h, d)).astype(dtype),
        rng.standard_normal((b, s, hkv, d)).astype(dtype),
        rng.standard_normal((b, s, hkv, d)).astype(dtype),
    )


CASES = [(True, 1), (True, 2), (True, 4), (False, 1), (False, 2), (False, 4)]


@pytest.mark.parametrize("causal,n_rep", CASES)
def test_forward_and_lse_match_pallas(rng, causal, n_rep):
    q, k, v = _qkv(rng, h=4, hkv=4 // n_rep)
    jo, jl = j_flash_attention_lse(*map(jnp.asarray, (q, k, v)), causal, 32, 32)
    to, tl = fa.flash_attention_lse(*map(torch.tensor, (q, k, v)), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal,n_rep", CASES)
def test_grads_with_lse_cotangent_match_pallas(rng, causal, n_rep):
    q, k, v = _qkv(rng, s=64, h=4, hkv=4 // n_rep, d=16)
    g_out = rng.standard_normal(q.shape).astype(np.float32)
    g_lse = rng.standard_normal((1, 4, 64)).astype(np.float32)

    _, vjp = jax.vjp(lambda a, b, c: j_flash_attention_lse(a, b, c, causal, 32, 32),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))

    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out, lse = fa.flash_attention_lse(*leaves, causal)
    got = torch.autograd.grad((out, lse), leaves, (torch.tensor(g_out), torch.tensor(g_lse)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_attention_reference(rng, causal):
    q, k, v = _qkv(rng, s=48, h=4, hkv=2)
    want = np.asarray(j_attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal))
    ref = tattn.attention_reference(*map(torch.tensor, (q, k, v)), causal=causal)
    got = fa.flash_attention(*map(torch.tensor, (q, k, v)), causal)
    np.testing.assert_allclose(ref.numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_attention_reference_offsets(rng):
    q, k, v = _qkv(rng, s=16, h=2)
    args = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(j_attention_reference(*args, causal=True, q_offset=16, kv_offset=4))
    got = tattn.attention_reference(*map(torch.tensor, (q, k, v)), causal=True,
                                    q_offset=16, kv_offset=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_bf16(rng):
    q, k, v = _qkv(rng, s=64, h=4, hkv=2)
    want = np.asarray(j_attention_reference(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True)).astype(np.float32)
    got = fa.flash_attention(*(torch.tensor(x, dtype=torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_plain_kernels_match_autograd_of_plain_forward(rng):
    """The plain dQ / dK/dV functions are the gradient of the plain forward
    (autograd through flash_fwd_plain), g_lse included."""
    q, k, v = (torch.tensor(x, dtype=torch.float64) for x in _qkv(rng, s=32, h=4, hkv=2, d=8))
    g_out = torch.tensor(rng.standard_normal(q.shape))
    g_lse = torch.tensor(rng.standard_normal((1, 4, 32)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_fwd_plain(*leaves, True)
    want = torch.autograd.grad((out, lse.double()), leaves, (g_out, g_lse))
    delta = fa.flash_delta(out.detach(), g_out, g_lse)
    got = (fa.flash_bwd_dq_plain(q, k, v, g_out, lse.detach(), delta, True),
           *fa.flash_bwd_dkv_plain(q, k, v, g_out, lse.detach(), delta, True))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_kernel_error_takes_bf16_rounding_and_rejects_a_missing_lse_term(rng):
    """The rule the CUDA kernels are held to: the plain f32 result rounded to
    bf16 passes; dq computed without the lse cotangent does not."""
    q, k, v = (torch.tensor(x) for x in _qkv(rng, s=128, h=4, hkv=2, d=64))
    g_out = torch.tensor(rng.standard_normal(q.shape), dtype=torch.float32)
    g_lse = torch.tensor(rng.standard_normal((1, 4, 128)), dtype=torch.float32) * 0.5
    out, lse = fa.flash_fwd_plain(q, k, v, True)
    dq = fa.flash_bwd_dq_plain(q, k, v, g_out, lse, fa.flash_delta(out, g_out, g_lse))
    assert fa.kernel_error(dq, dq)["worst"] == 0
    assert fa.kernel_error(dq.to(torch.bfloat16), dq)["worst"] <= 1
    dq_no_glse = fa.flash_bwd_dq_plain(q, k, v, g_out, lse, fa.flash_delta(out, g_out))
    assert fa.kernel_error(dq_no_glse, dq)["worst"] > 10


def test_cpu_path_needs_no_cuda_and_counts_no_launch(rng, monkeypatch):
    """On CPU tensors the wrappers run the plain versions: no build, no
    launch counted (the kernel build is lazy, at the first CUDA call)."""
    from uccl_tpu_torch.utils import build

    def no_nvcc():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    fa.reset_launch_counts()
    leaves = [torch.tensor(x, requires_grad=True) for x in _qkv(rng, s=16, h=2)]
    out, lse = fa.flash_attention_lse(*leaves)
    torch.autograd.grad(out.sum() + lse.sum(), leaves)
    assert fa.launch_counts == {k: 0 for k in fa.KERNELS}


def test_other_devices_and_mixed_devices_raise():
    meta = torch.empty((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError):
        fa.flash_fwd(meta, meta, meta)
    cpu = torch.zeros((1, 64, 2, 64))
    with pytest.raises(ValueError):
        fa.flash_fwd(cpu, meta, meta)


def test_auto_block_and_tile_knobs(monkeypatch):
    from uccl_tpu_torch.utils import config

    assert tattn.auto_block(1024) == 64 and tattn.auto_block(96) == 0
    monkeypatch.setenv("UCCL_TPU_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("UCCL_TPU_FLASH_BLOCK_K", "64")
    for name in ("flash_block_q", "flash_block_k"):
        config.param(name, 0).reset()
    try:
        assert fa._default_blocks() == (128, 64)
    finally:
        monkeypatch.undo()
        for name in ("flash_block_q", "flash_block_k"):
            config.param(name, 0).reset()
    assert fa._default_blocks() == (0, 0)
