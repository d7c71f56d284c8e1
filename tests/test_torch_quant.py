"""The port's block codec (uccl_tpu_torch/ops/quant.py) against the JAX
package's (uccl_tpu/ops/quant.py).

The same seeded numpy inputs go through both on the CPU. The JAX codec runs
compiled (``jax.jit``), as it does inside the Pallas kernels and every jitted
caller: XLA then computes a block's scale as ``amax * (1 / QMAX)``, which is
the port's rule. Tolerance, per test: payload bytes and scales EQUAL
(``assert_array_equal``) wherever the two substrates do the same arithmetic —
int8 everywhere, fp8 on seeded data. Three places where they do not, each
with its reason and its own bound in the test: the JAX codec run op by op
outside ``jit`` (it divides: scales within one ulp), denormal inputs (XLA:CPU
flushes them to zero, torch keeps them) and a cast that lands on a rounding
tie (a substrate that rounds f32→f16→e4m3 may step the other way; torch
rounds once); the last two are held to the documented ``round_trip_bound``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.collective import dma as jdma
from uccl_tpu.ops import quant as jq
from uccl_tpu_torch.collective import dma as tdma
from uccl_tpu_torch.ops import quant as tq

jquantize = jax.jit(jq.quantize_block, static_argnums=(1, 2))

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _both(x, dtype="f32"):
    return jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])


def _payload_bytes(q):
    if torch.is_tensor(q):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _seeded(shape, seed):
    """Rows whose magnitudes span 1e-3..1e3, so the scales differ per block."""
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), shape[:-1] + (1,)))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


@pytest.mark.parametrize("wd", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block,d", [(128, 512), (32, 512), (128, 300), (32, 70)])
def test_quantize_matches_jax_bit_for_bit(wd, dtype, block, d):
    """Payload bytes and scales equal, dividing and non-dividing last dims."""
    xj, xt = _both(_seeded((16, d), seed=d + block), dtype)
    qj, sj = jquantize(xj, wd, block)
    qt, st = tq.quantize_block(xt, wd, block)
    assert qt.dtype == tq.wire_payload_dtype(wd) and st.dtype == torch.float32
    assert tuple(qt.shape) == qj.shape and tuple(st.shape) == sj.shape
    np.testing.assert_array_equal(_payload_bytes(qt), _payload_bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_jax_codec_outside_jit_divides_and_is_one_ulp_away(wd):
    """Run op by op, the JAX codec computes amax / QMAX, not the compiled
    amax * (1 / QMAX): its scales are within one ulp of the port's (and of
    its own compiled ones), not equal. The port follows the compiled rule."""
    x = _seeded((64, 128), seed=2)
    _, s_eager = jq.quantize_block(jnp.asarray(x), wd, 128)
    _, s_jit = jquantize(jnp.asarray(x), wd, 128)
    _, st = tq.quantize_block(torch.tensor(x), wd, 128)
    s_eager, s_jit = np.asarray(s_eager), np.asarray(s_jit)
    np.testing.assert_array_equal(st.numpy(), s_jit)
    assert (np.abs(st.numpy() - s_eager) <= np.spacing(s_eager)).all()
    assert (st.numpy() != s_eager).any()
    amax = np.abs(x).max(-1, keepdims=True)
    np.testing.assert_array_equal(s_eager, amax / np.float32(tq.wire_qmax(wd)))
    np.testing.assert_array_equal(st.numpy(),
                                  amax * (np.float32(1) / np.float32(tq.wire_qmax(wd))))


@pytest.mark.parametrize("wd", ["fp8", "int8"])
@pytest.mark.parametrize("out", ["f32", "bf16", "f16"])
def test_dequantize_matches_jax_bit_for_bit(wd, out):
    xj, xt = _both(_seeded((8, 300), seed=3))
    qj, sj = jquantize(xj, wd, 128)
    qt, st = tq.quantize_block(xt, wd, 128)
    back_j = np.asarray(jq.dequantize_block(qj, sj, 128, JDT[out])).astype(np.float32)
    back_t = tq.dequantize_block(qt, st, 128, TDT[out])
    assert back_t.dtype == TDT[out]
    np.testing.assert_array_equal(back_t.float().numpy(), back_j)


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_round_trip_within_the_documented_bound(wd):
    x = _seeded((32, 256), seed=5)
    q, s = tq.quantize_block(torch.tensor(x), wd, 128)
    back = tq.dequantize_block(q, s, 128, torch.float32).numpy()
    amax = np.abs(x.reshape(32, 2, 128)).max(-1, keepdims=True)
    bound = amax / tq.ROUND_TRIP_DIVISOR[wd]
    assert (np.abs(back - x).reshape(32, 2, 128) <= bound).all()
    assert tq.round_trip_bound(3.0, wd) == jq.round_trip_bound(3.0, wd)


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_zero_block_takes_scale_one_and_round_trips_exact(wd):
    x = _seeded((4, 256), seed=6)
    x[1, :128] = 0.0
    x[3] = 0.0
    qj, sj = jquantize(jnp.asarray(x), wd, 128)
    qt, st = tq.quantize_block(torch.tensor(x), wd, 128)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[1, 0] == 1.0 and (st[3] == 1.0).all()
    back = tq.dequantize_block(qt, st, 128, torch.float32)
    assert (back[1, :128] == 0).all() and (back[3] == 0).all()
    np.testing.assert_array_equal(_payload_bytes(qt), _payload_bytes(qj))


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_denormal_amax_stays_finite(wd):
    """Not equal to JAX by construction: XLA:CPU flushes the denormal
    inputs to zero (scale 1.0, zeros out), torch keeps them and floors the
    scale at the smallest normal f32. Both must stay finite and within the
    round-trip bound of the input, which is the JAX test's own demand."""
    x = np.full((1, 128), 1e-42, np.float32)
    q, s = tq.quantize_block(torch.tensor(x), wd, 128)
    assert float(s[0, 0]) == float(np.finfo(np.float32).tiny)
    back = tq.dequantize_block(q, s, 128, torch.float32).numpy()
    back_j = np.asarray(jq.dequantize_block(*jquantize(jnp.asarray(x), wd, 128), 128,
                                            jnp.float32))
    bound = tq.round_trip_bound(1e-42, wd) + float(np.finfo(np.float32).tiny)
    for got in (back, back_j):
        assert np.isfinite(got).all() and (np.abs(got - x) <= bound).all()


@pytest.mark.parametrize("wd", ["fp8", "int8"])
@pytest.mark.parametrize("val", [np.inf, -np.inf, np.nan])
def test_nonfinite_block_gets_scale_inf_and_stays_loud(wd, val):
    x = _seeded((2, 256), seed=7)
    x[0, 5] = val
    qj, sj = jquantize(jnp.asarray(x), wd, 128)
    qt, st = tq.quantize_block(torch.tensor(x), wd, 128)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert torch.isposinf(st[0, 0]) and torch.isfinite(st[0, 1]) and torch.isfinite(st[1]).all()
    back = tq.dequantize_block(qt, st, 128, torch.float32)
    back_j = np.asarray(jq.dequantize_block(qj, sj, 128, jnp.float32))
    assert not torch.isfinite(back[0, :128]).any()  # the WHOLE block
    assert torch.isfinite(back[0, 128:]).all() and torch.isfinite(back[1]).all()
    np.testing.assert_array_equal(np.isfinite(back.numpy()), np.isfinite(back_j))
    # the finite blocks' payload and values agree with JAX bit for bit
    np.testing.assert_array_equal(_payload_bytes(qt)[:, 128:], _payload_bytes(qj)[:, 128:])
    np.testing.assert_array_equal(back.numpy()[:, 128:], back_j[:, 128:])


@pytest.mark.parametrize("bad", [0.0, -1.0, np.nan, 1e-42])
def test_dequantize_guards_garbage_scales(bad):
    q = torch.ones((4, 128)).to(tq.FP8_DTYPE)
    scale = torch.full((4, 1), bad, dtype=torch.float32)
    assert (tq.dequantize_block(q, scale, 128, torch.float32) == 0).all()
    want = np.asarray(jq.dequantize_block(jnp.ones((4, 128), jq.FP8_DTYPE),
                                          jnp.full((4, 1), bad, jnp.float32), 128, jnp.float32))
    assert (want == 0).all()


def test_dequantize_lets_an_inf_scale_through():
    q = torch.ones((2, 128)).to(tq.FP8_DTYPE)
    back = tq.dequantize_block(q, torch.full((2, 1), np.inf), 128, torch.float32)
    assert not torch.isfinite(back).any()


def test_crafted_rounding_ties_hold_the_round_trip_bound():
    """Values whose quotient by the scale sits exactly on the midpoint of
    two e4m3 codes (or within half an f16 ulp of it): a substrate that
    casts f32→f16→e4m3 may round such a value the other way than torch,
    which rounds once, so payloads may differ by one step here. Held, on
    both sides, to round_trip_bound (amax / 27.7, whose slack over the
    single-rounding amax / 28 is exactly this), not to equality."""
    codes = np.array([16, 18, 20, 22, 24, 26, 28, 30, 208, 224, 240, 256, 288, 320, 352, 384],
                     np.float32)
    mids = (codes[:-1] + codes[1:]) / 2
    x = np.zeros((1, 128), np.float32)
    x[0, 0] = 448.0  # scale exactly 1.0
    x[0, 1:1 + len(mids)] = mids
    x[0, 20:20 + len(mids)] = np.nextafter(mids, np.float32(1e9))  # inside the f16 tie window
    x[0, 40:40 + len(mids)] = -np.nextafter(mids, np.float32(0))
    bound = tq.round_trip_bound(448.0, "fp8")
    qt, st = tq.quantize_block(torch.tensor(x), "fp8", 128)
    qj, sj = jquantize(jnp.asarray(x), "fp8", 128)
    assert float(st[0, 0]) == 1.0 == float(sj[0, 0])
    back_t = tq.dequantize_block(qt, st, 128, torch.float32).numpy()
    back_j = np.asarray(jq.dequantize_block(qj, sj, 128, jnp.float32))
    assert np.abs(back_t - x).max() <= bound and np.abs(back_j - x).max() <= bound
    # torch rounds once: an exact midpoint goes to the even code, a value
    # just past it to the nearer one
    want = np.asarray(torch.tensor(x).to(torch.float8_e4m3fn).float())
    np.testing.assert_array_equal(back_t, want)
    # and where the two payloads differ, it is by one e4m3 step at a tie
    differ = _payload_bytes(qt) != _payload_bytes(qj)
    assert np.abs(back_t - back_j)[differ].max(initial=0.0) <= 32.0


@pytest.mark.parametrize("shape,dtype", [((4, 256), "f32"), ((4, 256), "bf16"), ((7, 100), "f32"),
                                         ((3, 5), "bf16"), ((1000,), "f32"), ((), "f32"),
                                         ((2, 4), "i32")])
@pytest.mark.parametrize("wd", [None, "fp8", "int8"])
def test_wire_bytes_of_equals_jax(shape, dtype, wd):
    jdt = {**JDT, "i32": jnp.int32}[dtype]
    tdt = {**TDT, "i32": torch.int32}[dtype]
    for group in (128, 32):
        assert tq.wire_bytes_of(shape, tdt, wd, group) == jq.wire_bytes_of(shape, jdt, wd, group)


def test_knob_helpers_equal_jax():
    for d in (1, 7, 64, 100, 128, 300, 4096):
        for block in (8, 32, 128):
            assert tq.adapt_block(d, block) == jq.adapt_block(d, block)
            assert tq.paying_block(d, block) == jq.paying_block(d, block)
    for wd in ("fp8", "int8"):
        assert tq.wire_qmax(wd) == jq.wire_qmax(wd)
        assert tq.ROUND_TRIP_DIVISOR[wd] == jq.ROUND_TRIP_DIVISOR[wd]
        assert tq.wire_payload_dtype(wd).itemsize == jnp.dtype(jq.wire_payload_dtype(wd)).itemsize
    assert (tq.FP8_MAX, tq.INT8_MAX) == (jq.FP8_MAX, jq.INT8_MAX)
    assert tq._SCALE_TINY == jq._SCALE_TINY
    for ok in (None, "", "none"):
        assert tq.resolve_wire_dtype(ok) is None is jq.resolve_wire_dtype(ok)
    assert tq.resolve_wire_dtype("fp8") == "fp8" and tq.resolve_wire_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        tq.resolve_wire_dtype("fp4")
    assert not hasattr(tdma, "resolve_wire_dtype")  # one validation: the codec's
    with pytest.raises(ValueError):
        tq.quantize_block(torch.zeros(2, 128), None)


def test_legacy_fp8_surface_matches_jax():
    xj, xt = _both(_seeded((4, 16, 256), seed=8))
    qj, sj = jax.jit(jq.quantize_fp8, static_argnums=1)(xj, 128)
    qt, st = tq.quantize_fp8(xt, 128)
    assert qt.dtype == torch.float8_e4m3fn and tuple(st.shape) == (4, 16, 2)
    np.testing.assert_array_equal(_payload_bytes(qt), _payload_bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back_j = np.asarray(jq.dequantize_fp8(qj, sj, 128)).astype(np.float32)
    np.testing.assert_array_equal(tq.dequantize_fp8(qt, st, 128).float().numpy(), back_j)
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize_fp8(torch.zeros(2, 100), 128)


@pytest.mark.parametrize("rows", [1, 8, 127, 128, 129, 1000])
def test_scale_sidecar_layout_equals_jax(rows):
    """One f32 scale per payload row, 128 per sidecar row, zero tail."""
    assert tdma.scale_rows(rows) == jdma.scale_rows(rows)
    srows = tdma.scale_rows(rows)
    s = np.random.default_rng(rows).uniform(0.1, 2.0, (3, rows)).astype(np.float32)
    pj = np.asarray(jdma.pack_row_scales(jnp.asarray(s), srows))
    pt = tdma.pack_row_scales(torch.tensor(s), srows)
    assert tuple(pt.shape) == (3, srows, tdma.LANES)
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert (pt.reshape(3, -1)[:, rows:] == 0).all()
    np.testing.assert_array_equal(tdma.unpack_row_scales(pt, rows).numpy(), s)
    assert tdma.CID_SCALE_OFFSET == jdma.CID_SCALE_OFFSET
