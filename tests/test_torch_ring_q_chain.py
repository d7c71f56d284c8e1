"""B6's and B8's contracts in the port: ``ring_ccl.rs_q_chain_plain`` and
``ring_ccl.ar_q_chain_plain``, the quantized reduce-scatter and all-reduce
as one pass over the unpadded payload, each link of the ring's chain one
quantize -> dequantize round trip of the partial sum.

The card's B6 and B8 kernels are held to these functions bit for bit
(tests/test_torch_cuda_ccl.py, chip_smoke.py). Here the functions
themselves are held, exactly (``assert_array_equal``, a nan equal to a
nan), to the ring's hop schedules on padded slots (``rs_q_plain``,
``ar_q_plain``), which the CPU wrappers run: worlds 2, 3, 4, 5 and 8, both
directions, one and two streams, fp8 and int8, f32 and bf16, slots and
chunks whose length is a multiple of neither 128 nor 4 (so a slot's last
row is short, and rows start off 16 bytes), rows holding an inf, a nan,
only zeros or denormals, and the bidir pair's halves at an odd split.

Then, on a handful of cases, to the JAX package's Pallas kernels
(``pallas_ccl.ring_reduce_scatter`` and ``ring_all_reduce`` with a
``wire_dtype``), run as tests/test_torch_quant_wire.py runs them: the TPU
interpreter on a 1-axis mesh of the virtual CPU devices, with that file's
tolerances. bf16 bit for bit; f32 within a few ulps of the largest partial
sum per hop, because XLA:CPU contracts the reference's f32 ``q * scale``
and add into one fma and the port rounds twice (``_close_f32_sum``); and
each result within tests/test_quant_wire.py's round-trip budget of the
exact sum. Payloads are a few KiB: the interpreter is most of this file's
time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.collective import pallas_ccl
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.collective import dma, ring_ccl

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_quant_wire.py's per-round-trip divisors
QERR = {"fp8": 448.0 / 16.125, "int8": 254.0}


def _inputs(shape, dtype, seed):
    """The same values in both frameworks (bf16 rounded from f32 by both),
    each 128-element block scaled by e^(3z), so that a row's scale matters."""
    rng = np.random.default_rng(seed)
    mag = np.exp(3 * rng.standard_normal((shape[0], shape[1] // 128 + 1)))
    x = (rng.standard_normal(shape) * np.repeat(mag, 128, axis=1)[:, : shape[1]])
    x = x.astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _rs_hops(x, direction, wd):
    """rs_q_plain on the padded slots, cut back to the payload's."""
    n = x.shape[0]
    chunks, per, m = dma.pad_chunks(x, n)
    return ring_ccl.rs_q_plain(chunks.reshape(n, n, m), direction, wd)[:, :per]


def _ar_hops(x, dirs, wd):
    """ar_q_plain on the padded slot-major layout, cut back to the payload."""
    view, k, _ = ring_ccl._ar_layout(x, len(dirs))
    return ring_ccl._ar_unlayout(ring_ccl.ar_q_plain(view, dirs, wd), k, x)


# (n, per, direction, wire, dtype): every world meets both directions, both
# wires and both dtypes across the cases; no per is a multiple of 4 or 128
CASES = [(2, 301, 1, "fp8", "f32"), (2, 259, -1, "int8", "bf16"), (3, 197, -1, "fp8", "bf16"),
         (3, 411, 1, "int8", "f32"), (4, 333, 1, "int8", "bf16"), (4, 141, -1, "fp8", "f32"),
         (5, 263, 1, "fp8", "f32"), (5, 151, -1, "int8", "bf16"), (8, 135, -1, "fp8", "bf16"),
         (8, 299, 1, "int8", "f32")]


@pytest.mark.parametrize("n,per,direction,wd,dtype", CASES)
def test_rs_chain_equals_the_hop_schedule(n, per, direction, wd, dtype):
    _, xt = _inputs((n, n * per), dtype, seed=n * per)
    got = ring_ccl.rs_q_chain_plain(xt, direction, wd)
    assert got.shape == (n, per) and got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(_rs_hops(xt, direction, wd)))


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("n,per,direction,wd,dtype", CASES)
def test_ar_chain_equals_the_hop_schedule(n, per, direction, wd, dtype, streams):
    """Rows of n·per - 1 elements: the last chunk is short, and with two
    streams no chunk length is a multiple of 4."""
    _, xt = _inputs((n, n * per - 1), dtype, seed=n * per + streams)
    dirs = (1, -1) if streams == 2 else (direction,)
    got = ring_ccl.ar_q_chain_plain(xt, dirs, wd)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(_ar_hops(xt, dirs, wd)))
    assert (got == got[0]).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_nonfinite_zero_and_denormal_rows(wd, dtype):
    """An inf and a nan in slot 0 (rows 0 and 2, the short one) poison the
    rows whose scale they set (+inf), an all-zero row stays exactly zero, a
    denormal row stays finite: the same bits as the hop schedule, B6 and B8
    in both directions. B6's chain adds the owner's own term, member 0's
    inf among it, after its last round trip: that inf stays a lone inf."""
    n, per = 4, 333
    _, xt = _inputs((n, n * per), dtype, seed=80)
    xt[0, 5], xt[1, 300] = float("inf"), float("nan")
    xt[:, 128:256] = 0.0
    xt[2, per + 10: per + 60] = 1e-42 if dtype == "f32" else 1e-39
    for d in (1, -1):
        rs = ring_ccl.rs_q_chain_plain(xt, d, wd)
        np.testing.assert_array_equal(_np(rs), _np(_rs_hops(xt, d, wd)))
        assert rs[0, 256:].isnan().all() and torch.isinf(rs[0, 5]) and rs[0, :5].isfinite().all()
        assert (rs[0, 128:256] == 0).all() and rs[1:].isfinite().all()
        for dirs in ((d,), (1, -1)):
            ar = ring_ccl.ar_q_chain_plain(xt, dirs, wd)
            np.testing.assert_array_equal(_np(ar), _np(_ar_hops(xt, dirs, wd)))
    # one stream: chunk 0 is slot 0, round-tripped once more, inf row and all
    ar = ring_ccl.ar_q_chain_plain(xt, (1,), wd)
    assert ar[:, :128].isnan().all() and ar[:, 256:per].isnan().all()
    assert (ar[:, 128:256] == 0).all() and ar[:, per:].isfinite().all()


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_bidir_halves_at_an_odd_split(wd):
    """The bidir pair runs B8 on each half in its direction, into one
    output: the two contracts side by side are what the CPU wrapper (the
    hop schedules on each half's padded layout) gives."""
    n, size = 3, 2 * 211  # halves of 211 elements
    _, xt = _inputs((n, size), "f32", seed=81)
    half = size // 2
    got = torch.cat([ring_ccl.ar_q_chain_plain(xt[:, :half], (1,), wd),
                     ring_ccl.ar_q_chain_plain(xt[:, half:], (-1,), wd)], 1)
    np.testing.assert_array_equal(_np(got), _np(ring_ccl.bidir_all_reduce(xt, wire_dtype=wd)))


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_b8_is_b6_and_one_more_round_trip(wd):
    """With one stream and W | size, B8's chunk o is B6's slot o round-
    tripped once more: the owner's reduced slot, quantized once and
    dequantized by every member."""
    n, per = 5, 263
    _, xt = _inputs((n, n * per), "bf16", seed=82)
    rs = ring_ccl.rs_q_chain_plain(xt, -1, wd)
    ar = ring_ccl.ar_q_chain_plain(xt, (-1,), wd)
    want = ring_ccl._round_trip(rs, wd).reshape(-1)
    assert all(torch.equal(ar[r], want) for r in range(n))


def _jax_run(devices, n, fn, x):
    mesh = Mesh(np.array(devices[:n]), ("dp",))
    mapped = shard_map(fn, mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"),
                       check_vma=False)
    return np.asarray(jax.jit(mapped)(x)).astype(np.float32)


def _same_sum(got, want, xs, trips, dtype):
    """bf16 bit for bit; f32 within 4 ulps of the largest partial sum per
    hop (tests/test_torch_quant_wire.py's _close_f32_sum)."""
    if dtype == "f32":
        atol = trips * 4 * 2.0 ** -23 * np.abs(xs).sum(0).max()
        np.testing.assert_allclose(_np(got).reshape(want.shape), want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(_np(got).reshape(want.shape), want)


def _budget(xs, trips, wd, dtype):
    """tests/test_quant_wire.py's budget: trips round trips of
    sum|x| / QERR (x 1.05), plus its bf16 allowance."""
    b = trips * np.abs(xs).sum(axis=0).max() / QERR[wd] * 1.05
    return b + (0.1 * np.abs(xs.sum(0)).max() if dtype == "bf16" else 0.0)


@pytest.mark.parametrize("n,per,direction,wd,dtype", [CASES[1], CASES[3], CASES[5], CASES[7]])
def test_rs_chain_matches_pallas(devices, n, per, direction, wd, dtype):
    xj, xt = _inputs((n, n * per), dtype, seed=200 + n * per)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_reduce_scatter(
        v.reshape(-1), "dp", direction=direction, interpret=True, wire_dtype=wd), xj)
    got = ring_ccl.rs_q_chain_plain(xt, direction, wd)
    _same_sum(got, want.reshape(n, per), _np(xt), n - 1, dtype)
    xs = _np(xt)
    assert np.abs(_np(got) - xs.sum(0).reshape(n, per)).max() <= _budget(xs, n - 1, wd, dtype)


@pytest.mark.parametrize("n,per,direction,wd,dtype,streams",
                         [(*CASES[0], 2), (*CASES[2], 1), (*CASES[4], 2), (*CASES[6], 1)])
def test_ar_chain_matches_pallas(devices, n, per, direction, wd, dtype, streams):
    xj, xt = _inputs((n, n * per - 1), dtype, seed=300 + n * per)
    kw = dict(bidirectional=streams == 2, direction=direction)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_reduce(
        v, "dp", interpret=True, wire_dtype=wd, **kw), xj)
    got = ring_ccl.ar_q_chain_plain(xt, (1, -1) if streams == 2 else (direction,), wd)
    _same_sum(got, want, _np(xt), n, dtype)
    xs = _np(xt)
    assert np.abs(_np(got) - xs.sum(0)).max() <= _budget(xs, n, wd, dtype)
    assert (got == got[0]).all()
