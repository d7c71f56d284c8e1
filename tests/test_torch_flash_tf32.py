"""The f32 flash kernels' arithmetic (3xTF32) on the CPU.

The CUDA kernels of B1, B2 and B3 in float32 compute each f32 product on the
tensor cores as three TF32 products: x = hi + lo with hi = tf32(x) and lo =
tf32(x - hi), both rounded as ``cvt.rna.tf32.f32`` rounds, and a b = lo hi +
hi lo + hi hi, accumulated in f32 per k-step of 8. ``ops/flash_attention``
emulates that in torch (``tf32_rna``, ``mm_3xtf32``, ``flash_fwd_3xtf32``,
``flash_bwd_*_3xtf32``);
the main path never calls the emulation. Here it is held to the rule the
kernels are held to on the card (``fa.kernel_error``'s f32 rule, unchanged),
against the plain versions with a nonzero lse cotangent; a single TF32 pass
and a dropped cross term must fail that rule; and it is held to the JAX
package's backward and forward at a tiny shape, as
tests/test_torch_flash_attention.py runs them (gradients at rtol 1e-3, atol
1e-4; out and lse at rtol 2e-4, atol 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.ops.pallas_attention import flash_attention_lse as j_flash_attention_lse
from uccl_tpu_torch.ops import flash_attention as fa


def _inputs(rng, s, h=4, hkv=2, d=64):
    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    q, k, v, dout = t(1, s, h, d), t(1, s, hkv, d), t(1, s, hkv, d), t(1, s, h, d)
    return q, k, v, dout, t(1, h, s) * 0.5


def _plain_and_emulated(rng, s, causal, terms):
    q, k, v, dout, g_lse = _inputs(rng, s)
    out, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.flash_delta(out, dout, g_lse)
    x = (q, k, v, dout, lse, delta, causal)
    want = (fa.flash_bwd_dq_plain(*x), *fa.flash_bwd_dkv_plain(*x))
    got = (fa.flash_bwd_dq_3xtf32(*x, terms), *fa.flash_bwd_dkv_3xtf32(*x, terms))
    return {name: fa.kernel_error(g, w)["worst"]
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def test_tf32_rna_rounds_as_cvt_rna():
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2), 1 + 1.5 * ulp,
                      3.0, 0.0, 2.0 ** -130], dtype=torch.float32)
    got = fa.tf32_rna(x)
    want = [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0, 0.0, 2.0 ** -130]
    assert got.tolist() == want
    rng = np.random.default_rng(1)
    y = torch.tensor(rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
                     dtype=torch.float32)
    r = fa.tf32_rna(y)
    assert not (r.view(torch.int32) & 0x1FFF).any()  # 10 explicit mantissa bits left
    assert ((r - y).abs() <= y.abs() * 2.0 ** -11).all()  # within half a TF32 ulp
    hi, lo = r, fa.tf32_rna(y - r)
    assert ((hi.double() + lo.double() - y.double()).abs() <= y.abs().double() * 2.0 ** -21).all()


@pytest.mark.parametrize("s,causal", [(256, True), (256, False), (77, True), (77, False)])
def test_3xtf32_keeps_the_f32_rule(rng, s, causal):
    worst = _plain_and_emulated(rng, s, causal, terms=3)
    assert max(worst.values()) <= 1, worst


@pytest.mark.parametrize("terms,what", [(1, "a single TF32 pass"), (2, "one cross term dropped")])
@pytest.mark.parametrize("causal", [True, False])
def test_fewer_terms_fail_the_f32_rule(rng, terms, what, causal):
    worst = _plain_and_emulated(rng, 256, causal, terms=terms)
    assert min(worst.values()) > 1, (what, worst)


def test_3xtf32_matches_the_jax_backward(rng):
    """The emulated dq/dk/dv against jax.vjp of the JAX package's Pallas
    flash attention (interpret mode), lse cotangent included."""
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
    g_out = rng.standard_normal(q.shape).astype(np.float32)
    g_lse = rng.standard_normal((1, 4, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: j_flash_attention_lse(a, b, c, True, 32, 32),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))

    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g_out))
    out, lse = fa.flash_fwd_plain(tq, tk, tv, True)
    delta = fa.flash_delta(out, tg, torch.tensor(g_lse))
    x = (tq, tk, tv, tg, lse, delta, True)
    got = (fa.flash_bwd_dq_3xtf32(*x), *fa.flash_bwd_dkv_3xtf32(*x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)


# The forward (B1 in f32): S and each 64-key tile's P V in 3xTF32, the
# tile's P V into a fresh accumulator added after the rescale.


def _fwd_plain_and_emulated(rng, s, causal, terms):
    q, k, v, _, _ = _inputs(rng, s)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    out, lse = fa.flash_fwd_3xtf32(q, k, v, causal, terms)
    return fa.kernel_error(out, out_p)["worst"], (lse - lse_p).abs().max().item()


@pytest.mark.parametrize("s,causal", [(256, True), (256, False), (77, True), (77, False)])
def test_fwd_3xtf32_keeps_the_f32_rule(rng, s, causal):
    worst, lse_err = _fwd_plain_and_emulated(rng, s, causal, terms=3)
    assert worst <= 1 and lse_err <= fa.F32_LSE_ATOL, (worst, lse_err)


@pytest.mark.parametrize("terms,what", [(1, "a single TF32 pass"), (2, "one cross term dropped")])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_fewer_terms_fail_the_f32_rule(rng, terms, what, causal):
    worst, _ = _fwd_plain_and_emulated(rng, 256, causal, terms=terms)
    assert worst > 1, (what, worst)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_3xtf32_matches_the_jax_forward(rng, causal):
    """The emulated out and lse against the JAX package's Pallas forward
    (interpret mode) at the forward test's tolerance."""
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
    jo, jl = j_flash_attention_lse(*map(jnp.asarray, (q, k, v)), causal, 32, 32)
    to, tl = fa.flash_fwd_3xtf32(*map(torch.tensor, (q, k, v)), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-5)

