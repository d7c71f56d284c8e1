"""The port's quantized-wire ring collectives (uccl_tpu_torch/collective/
ring_ccl.py, ``wire_dtype=``) against the JAX package's Pallas kernels
(uccl_tpu/collective/pallas_ccl.py).

The same seeded numpy inputs go through both. The JAX side runs as
tests/test_quant_wire.py runs it: Pallas interpret mode under ``shard_map``
on a 1-axis mesh of the virtual CPU devices. The port's side runs on CPU
tensors, so its wrappers take the plain versions of B6 and B8
(``rs_q_plain``, ``ar_q_plain``: the same hop schedule, the same codec call
per hop, the same add in the input dtype).

Tolerance, stated per test. Where the arithmetic is the same the results
must be EQUAL bit for bit (``_eq``): every all-gather and broadcast, and
every sum in bf16, int8 and fp8 alike on these seeded inputs (the two
substrates' f32→e4m3 casts can differ only on an exact rounding tie, which
tests/test_torch_quant.py crafts and bounds). One place where it is not the
same: an f32 sum. The reference's hop is ``deq = (q * scale).astype(dtype)``
then ``buf + deq``, two roundings, which the port's plain version and its
CUDA kernel (``__fmul_rn`` then ``__fadd_rn``) keep; compiled for the CPU,
XLA contracts that multiply and add into one fma when the dtype is f32 (no
cast sits between them), one rounding. Those results are held to a few ulps
of the largest partial sum per hop (``_close_f32_sum``), not to equality. On
top of that each result is held to the error budget of
tests/test_quant_wire.py, never a looser one: n round trips of
``amax / QERR`` for an all-reduce (``_allreduce_bound``), n-1 for a
reduce-scatter, one for an all-gather or a broadcast. Payloads are a few
KiB, under the interpreter's ceiling, sized so that chunks need padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.collective import dma as jdma
from uccl_tpu.collective import pallas_ccl
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.collective import dma, plan, ring_ccl
from uccl_tpu_torch.ops import quant

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_quant_wire.py's per-round-trip divisors
QERR = {"fp8": 448.0 / 16.125, "int8": 254.0}


def _jax_run(devices, n, fn, x):
    mesh = Mesh(np.array(devices[:n]), ("dp",))
    mapped = shard_map(fn, mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"),
                       check_vma=False)
    return np.asarray(jax.jit(mapped)(x)).astype(np.float32)


def _inputs(shape, dtype, seed):
    """The same values in both frameworks (bf16 rounded from f32 by both)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    xt = torch.tensor(x).to(tdt)
    return jnp.asarray(x, jdt), xt, xt.float().numpy()


def _eq(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.float().numpy().reshape(want.shape), want)


def _close_f32_sum(got: torch.Tensor, want: np.ndarray, xs: np.ndarray, trips: int):
    """An f32 sum against the compiled JAX kernel: each hop's fma differs
    from multiply-then-add by at most one ulp of the partial sum, and a
    row's amax off by an ulp moves its scale, and so the row's dequantized
    values, by another: 4 * 2^-23 * max sum|x| per hop."""
    atol = trips * 4 * 2.0 ** -23 * np.abs(xs).sum(0).max()
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=0, atol=atol)


def _same_sum(got, want, xs, trips, dtype):
    """Bit-identical in bf16; in f32 within the fma's ulps (module docstring)."""
    if dtype == "f32":
        _close_f32_sum(got, want, xs, trips)
    else:
        _eq(got, want)


def _allreduce_bound(xs, n, wd, dtype="f32"):
    """tests/test_quant_wire.py:85, plus its bf16 allowance (:218)."""
    b = n * np.abs(xs).sum(axis=0).max() / QERR[wd] * 1.05
    return b + (0.1 * np.abs(xs.sum(0)).max() if dtype == "bf16" else 0.0)


def _one_trip_bound(xs, wd, dtype):
    """One round trip from the input (tests/test_quant_wire.py:184); a bf16
    result adds its own rounding, half an ulp of the value (2^-9 relative)."""
    b = np.abs(xs).max() / QERR[wd] * 1.05
    return b + (2.0 ** -9 * np.abs(xs).max() if dtype == "bf16" else 0.0)


def _fb(what, reason):
    return dma.WIRE_FALLBACK.get(what=what, reason=reason)


def _bytes(**labels):
    return ring_ccl._WIRE_BYTES.get(**labels)


def _jbytes(**labels):
    return pallas_ccl._WIRE_BYTES.get(**labels)


# (n, wire, dtype, streams, direction): worlds 2, 4 and 5 (odd world = the pad
# path), both wires, both dtypes, one and two streams, both directions
AR_CASES = [(2, "fp8", "f32", 1, 1), (2, "int8", "bf16", 2, 1), (4, "fp8", "f32", 2, 1),
            (4, "int8", "f32", 1, -1), (4, "fp8", "bf16", 1, -1), (5, "int8", "f32", 2, 1),
            (5, "fp8", "bf16", 2, 1), (4, "int8", "bf16", 2, 1)]


@pytest.mark.parametrize("n,wd,dtype,streams,direction", AR_CASES)
def test_all_reduce_matches_pallas(devices, n, wd, dtype, streams, direction):
    """Equal to the JAX kernel (bf16 bit for bit, f32 within the fma's
    ulps); within test_quant_wire's n-trip budget of the exact sum; every
    member's copy the same."""
    xj, xt, xs = _inputs((n, 3, 100), dtype, seed=n + streams)
    kw = dict(bidirectional=streams == 2, direction=direction)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_reduce(
        v, "dp", interpret=True, wire_dtype=wd, **kw), xj)
    got = ring_ccl.ring_all_reduce(xt, wire_dtype=wd, **kw)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    _same_sum(got, want, xs, n, dtype)
    assert np.abs(got.float().numpy() - xs.sum(0)).max() <= _allreduce_bound(xs, n, wd, dtype)
    assert (got == got[0]).all()


@pytest.mark.parametrize("n,wd,dtype,direction", [(2, "int8", "f32", -1), (4, "fp8", "f32", 1),
                                                  (4, "int8", "bf16", -1), (5, "fp8", "bf16", 1),
                                                  (5, "int8", "f32", 1)])
def test_reduce_scatter_matches_pallas(devices, n, wd, dtype, direction):
    """Equal to the JAX kernel (bf16 bit for bit, f32 within the fma's
    ulps); within (n-1) * sum|x| / QERR * 1.05 (test_quant_wire:201)."""
    xj, xt, xs = _inputs((n, n * 70), dtype, seed=10 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_reduce_scatter(
        v.reshape(-1), "dp", direction=direction, interpret=True, wire_dtype=wd), xj)
    got = ring_ccl.ring_reduce_scatter(xt, direction=direction, wire_dtype=wd)
    assert got.shape == (n, 70)
    _same_sum(got, want, xs, n - 1, dtype)
    bound = (n - 1) * np.abs(xs).sum(0).max() / QERR[wd] * 1.05
    bound += 0.1 * np.abs(xs.sum(0)).max() if dtype == "bf16" else 0.0
    assert np.abs(got.float().numpy() - xs.sum(0).reshape(n, 70)).max() <= bound


@pytest.mark.parametrize("n,wd,dtype,direction", [(4, "fp8", "f32", 1), (4, "int8", "bf16", 1),
                                                  (5, "int8", "f32", -1), (2, "fp8", "bf16", -1)])
def test_all_gather_matches_pallas(devices, n, wd, dtype, direction):
    """Bit-identical; one round trip from the input (test_quant_wire:184);
    all members identical."""
    xj, xt, xs = _inputs((n * 3, 50), dtype, seed=20 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_gather(
        v, "dp", direction=direction, interpret=True, wire_dtype=wd), xj)
    got = ring_ccl.ring_all_gather(xt.reshape(n, 3, 50), direction=direction, wire_dtype=wd)
    assert got.shape == (n, n * 3, 50) and got.dtype == xt.dtype
    _eq(got, want)
    assert np.abs(got[0].float().numpy() - xs).max() <= _one_trip_bound(xs, wd, dtype)
    assert (got == got[0]).all()


@pytest.mark.parametrize("n,wd,dtype", [(4, "fp8", "f32"), (3, "int8", "bf16"), (5, "int8", "f32")])
def test_bidir_all_reduce_matches_pallas(devices, n, wd, dtype):
    xj, xt, xs = _inputs((n, 301), dtype, seed=30 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.bidir_all_reduce(
        v, "dp", interpret=True, wire_dtype=wd), xj)
    got = ring_ccl.bidir_all_reduce(xt, wire_dtype=wd)
    _same_sum(got, want, xs, n, dtype)
    assert np.abs(got.float().numpy() - xs.sum(0)).max() <= _allreduce_bound(xs, n, wd, dtype)
    assert (got == got[0]).all()


@pytest.mark.parametrize("n,wd,dtype", [(4, "int8", "f32"), (3, "fp8", "bf16")])
def test_bidir_all_gather_matches_pallas(devices, n, wd, dtype):
    xj, xt, xs = _inputs((n * 2, 33), dtype, seed=40 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.bidir_all_gather(
        v, "dp", interpret=True, wire_dtype=wd), xj)
    got = ring_ccl.bidir_all_gather(xt.reshape(n, 2, 33), wire_dtype=wd)
    _eq(got, want)
    assert np.abs(got[0].float().numpy() - xs).max() <= _one_trip_bound(xs, wd, dtype)
    assert (got == got[0]).all()


@pytest.mark.parametrize("n,root,wd,dtype", [(4, 1, "fp8", "f32"), (3, 2, "int8", "bf16"),
                                             (5, 0, "fp8", "f32")])
def test_scatter_ag_broadcast_matches_pallas(devices, n, root, wd, dtype):
    xj, xt, xs = _inputs((n, 257), dtype, seed=50 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.scatter_ag_broadcast(
        v, "dp", root, interpret=True, wire_dtype=wd), xj)
    got = ring_ccl.scatter_ag_broadcast(xt, root, wire_dtype=wd)
    _eq(got, want)
    assert np.abs(got.float().numpy() - xs[root]).max() <= _one_trip_bound(xs[root], wd, dtype)
    assert (got == got[0]).all()


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_zero_in_exact_zero_out(wd):
    x = torch.zeros(4, 3, 64)
    for out in (ring_ccl.ring_all_reduce(x, wire_dtype=wd),
                ring_ccl.bidir_all_reduce(x, wire_dtype=wd),
                ring_ccl.ring_all_gather(x, wire_dtype=wd),
                ring_ccl.ring_reduce_scatter(x.reshape(4, 192), wire_dtype=wd),
                ring_ccl.scatter_ag_broadcast(x, 1, wire_dtype=wd)):
        assert (out == 0).all()


def test_outlier_stays_in_its_block(devices):
    """test_quant_wire's outlier case: a 1e4 value saturates its own
    128-lane block's scale and degrades no other block. Equal to the JAX
    kernel within the f32 fma's ulps."""
    n = 4
    xs = np.random.default_rng(60).standard_normal((n, n * 2 * 2 * 128)).astype(np.float32)
    xs[0, 0] = 1e4
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_reduce(
        v, "dp", interpret=True, wire_dtype="fp8"), jnp.asarray(xs))
    got = ring_ccl.ring_all_reduce(torch.tensor(xs), wire_dtype="fp8")
    _close_f32_sum(got, want, xs, n)
    got, exact = got.numpy(), xs.sum(0)
    assert abs(got[0, 0] - exact[0]) <= _allreduce_bound(xs, n, "fp8")
    clean = xs.copy()
    clean[0, 0] = 0.0
    assert np.abs(got[:, 128:] - exact[128:]).max() <= _allreduce_bound(clean, n, "fp8")


def test_nonfinite_input_stays_loud():
    """A nan in one member's payload poisons its 128-lane block on every
    member (the full-precision wire would deliver the divergence too) and
    nothing else."""
    x = torch.randn(4, 4 * 1024, generator=torch.Generator().manual_seed(61))
    x[2, 5] = float("nan")
    for wd in ("fp8", "int8"):
        out = ring_ccl.ring_all_reduce(x, bidirectional=False, wire_dtype=wd)
        assert out[:, :128].isnan().all() and out[:, 128:].isfinite().all()


def test_int_payload_downgrades_counted_and_ships_exact(devices):
    """A non-float payload under a wire_dtype rides the full-precision wire
    (exact), counted on ep_wire_fallback_total{reason=quant_dtype}, as in
    the JAX package (test_quant_wire.py:248)."""
    n = 4
    xs = np.arange(n * 32, dtype=np.int32).reshape(n, 32)
    jb = jdma.WIRE_FALLBACK.get(what="all_reduce", reason="quant_dtype")
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_reduce(
        v, "dp", interpret=True, wire_dtype="fp8"), jnp.asarray(xs))
    assert jdma.WIRE_FALLBACK.get(what="all_reduce", reason="quant_dtype") == jb + 1
    for fn, what in ((ring_ccl.ring_all_reduce, "all_reduce"),
                     (ring_ccl.bidir_all_reduce, "all_reduce_bidir"),
                     (ring_ccl.ring_all_gather, "all_gather"),
                     (ring_ccl.scatter_ag_broadcast, "broadcast")):
        before = _fb(what, "quant_dtype")
        got = fn(torch.tensor(xs), wire_dtype="fp8")
        assert _fb(what, "quant_dtype") == before + 1, what
        if what.startswith("all_reduce"):
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    before = _fb("reduce_scatter", "quant_dtype")
    rs = ring_ccl.ring_reduce_scatter(torch.tensor(xs), wire_dtype="int8")
    assert _fb("reduce_scatter", "quant_dtype") == before + 1
    np.testing.assert_array_equal(rs.numpy(), xs.sum(0).reshape(n, 8))


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_wire_bytes_counted_equal_jax(devices, wd):
    """ep_bytes_total carries the quantized arithmetic (1 byte per element +
    the f32 scale sidecar) under the wire_dtype label; the deltas of one
    call equal the JAX package's for the same request, verb by verb."""
    n = 4
    xj, xt, _ = _inputs((n, 3000), "f32", seed=70)
    calls = [
        ("ring_all_reduce", lambda v: pallas_ccl.ring_all_reduce(
            v, "dp", interpret=True, wire_dtype=wd),
         lambda: ring_ccl.ring_all_reduce(xt, wire_dtype=wd)),
        ("ring_reduce_scatter", lambda v: pallas_ccl.ring_reduce_scatter(
            v.reshape(-1), "dp", interpret=True, wire_dtype=wd).reshape(1, -1),
         lambda: ring_ccl.ring_reduce_scatter(xt, wire_dtype=wd)),
        ("ring_all_gather", lambda v: pallas_ccl.bidir_all_gather(
            v, "dp", interpret=True, wire_dtype=wd),
         lambda: ring_ccl.bidir_all_gather(xt, wire_dtype=wd)),
        ("bcast", lambda v: pallas_ccl.scatter_ag_broadcast(
            v, "dp", 1, interpret=True, wire_dtype=wd),
         lambda: ring_ccl.scatter_ag_broadcast(xt, 1, wire_dtype=wd)),
    ]
    for verb, jfn, tfn in calls:
        labels = dict(verb=verb, wire="pallas", wire_dtype=wd)
        full = dict(verb=verb, wire="pallas", wire_dtype="none")
        jb, tb, tf = _jbytes(**labels), _bytes(**labels), _bytes(**full)
        _jax_run(devices, n, jfn, xj)
        tfn()
        moved = _bytes(**labels) - tb
        assert moved == _jbytes(**labels) - jb and moved > 0, verb
        assert _bytes(**full) == tf, verb  # nothing lands on the full-precision series


def test_wire_byte_reductions():
    """The counters' own reductions at world 8 on a 64 KiB f32 payload,
    where a hop is one 1024-element chunk and its sidecar one 128-scale
    row: 4096 B against 1024 + 512. The quantized all-reduce moves 2.67x
    fewer bytes than the full-precision one (3.88x on chunks of 128 rows
    and more, whose sidecar rows are full); the scatter-allgather
    broadcast, whose scatter leg stays full precision, 2.2x fewer."""
    x = torch.randn(8, 16384, generator=torch.Generator().manual_seed(71))

    def moved(fn, verb, wd):
        labels = dict(verb=verb, wire="pallas", wire_dtype=wd or "none")
        before = _bytes(**labels)
        fn(x, wire_dtype=wd)
        return _bytes(**labels) - before

    ar = [moved(ring_ccl.ring_all_reduce, "ring_all_reduce", wd) for wd in (None, "fp8", "int8")]
    assert ar[0] / ar[1] == pytest.approx(4096 / 1536) and ar[1] == ar[2]
    m = 1 << 20
    assert m * 4 / ring_ccl._hop_wire_bytes(m, 4, "fp8") == pytest.approx(3.88, abs=0.01)
    bc = [moved(ring_ccl.scatter_ag_broadcast, "bcast", wd) for wd in (None, "fp8")]
    assert bc[0] / bc[1] >= 2.0


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_budget_fallback_is_counted_and_changes_no_number(wd):
    """Past the arena budget a CPU tensor takes the quantized schedule's
    mirror (the JAX package's pure-lax mirror; test_quant_wire.py:223 pins
    kernel == mirror): the same numbers bit for bit, counted on
    ep_wire_fallback_total, wire bytes under wire="lax", and for the pairs
    collective_plan_total{outcome="fallback"} with the wire_dtype label."""
    x = torch.randn(4, 4, 60, generator=torch.Generator().manual_seed(72))
    entries = [
        (lambda: ring_ccl.ring_all_reduce(x, wire_dtype=wd), "all_reduce", "ring_all_reduce"),
        (lambda: ring_ccl.ring_reduce_scatter(x, wire_dtype=wd),
         "reduce_scatter", "ring_reduce_scatter"),
        (lambda: ring_ccl.ring_all_gather(x, wire_dtype=wd), "all_gather", "ring_all_gather"),
        (lambda: ring_ccl.bidir_all_reduce(x, wire_dtype=wd), "all_reduce_bidir",
         "ring_all_reduce_bidir"),
        (lambda: ring_ccl.bidir_all_gather(x, wire_dtype=wd), "all_gather_bidir",
         "ring_all_gather"),
        (lambda: ring_ccl.scatter_ag_broadcast(x, 2, wire_dtype=wd), "broadcast", "bcast"),
    ]
    in_budget = [fn() for fn, _, _ in entries]
    pair = dict(algo="bidir", chunks=2, wire_dtype=wd, outcome="fallback")
    pairs0 = plan.PLAN_TOTAL.get(**pair)
    dma.MAX_ARENA_BYTES.set(64)
    try:
        for (fn, what, verb), want in zip(entries, in_budget):
            fb, lax = _fb(what, "arena_budget"), _bytes(verb=verb, wire="lax", wire_dtype=wd)
            got = fn()
            assert torch.equal(got, want), what
            assert _fb(what, "arena_budget") == fb + 1, what
            assert _bytes(verb=verb, wire="lax", wire_dtype=wd) > lax, what
    finally:
        dma.MAX_ARENA_BYTES.set(None)
    assert plan.PLAN_TOTAL.get(**pair) == pairs0 + 1


def test_charges_match_the_jax_gates():
    """The gates' charges under a wire_dtype equal the JAX package's
    (its non-interpreter arithmetic: a pair's halves add)."""
    for wd in ("fp8", "int8"):
        for nelems, itemsize, n in [(1, 4, 2), (1000, 2, 3), (4097, 4, 8), (10 ** 6, 4, 4),
                                    (300_000, 2, 5)]:
            for port, ref in ((ring_ccl.rs_charge, pallas_ccl.rs_charge),
                              (ring_ccl.ag_charge, pallas_ccl.ag_charge),
                              (ring_ccl.bidir_pair_charge, pallas_ccl.bidir_pair_charge),
                              (ring_ccl.ag_pair_charge, pallas_ccl.ag_pair_charge),
                              (ring_ccl.bcast_pair_charge, pallas_ccl.bcast_pair_charge)):
                assert port(nelems, itemsize, n, wd) == ref(nelems, itemsize, n, wd, False)
            m = dma.padded_chunk_elems(-(-nelems // n))
            assert ring_ccl._hop_wire_bytes(m, itemsize, wd) == \
                pallas_ccl._hop_wire_bytes(m, itemsize, wd)
            assert ring_ccl._bcast_wire_bytes(n, m, itemsize, wd) == \
                pallas_ccl._bcast_wire_bytes(n, m, itemsize, wd)


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_plain_versions_are_what_the_cpu_wrappers_run(wd):
    """The wrappers on CPU tensors are the plain versions on the padded
    layout, and no kernel launch is counted."""
    ring_ccl.reset_launch_counts()
    x = torch.randn(4, 1000, generator=torch.Generator().manual_seed(73))
    chunks, per, m = dma.pad_chunks(x, 4)
    want = ring_ccl.rs_q_plain(chunks.reshape(4, 4, m), -1, wd)[:, :per]
    assert torch.equal(ring_ccl.ring_reduce_scatter(x, direction=-1, wire_dtype=wd), want)
    view, k, _ = ring_ccl._ar_layout(x, 2)
    want = ring_ccl._ar_unlayout(ring_ccl.ar_q_plain(view, (1, -1), wd), k, x)
    assert torch.equal(ring_ccl.ring_all_reduce(x, wire_dtype=wd), want)
    # B8's reduced slot before its quantize-once pass is B6's result
    one = ring_ccl.ar_q_plain(ring_ccl._ar_layout(x, 1)[0], (1,), wd)[:, :, 0]
    rs = ring_ccl.rs_q_plain(chunks.reshape(4, 4, m), 1, wd)
    q, sc = quant.quantize_block(rs.reshape(4, -1, 128), wd, 128)
    assert torch.equal(one[0], quant.dequantize_block(q, sc, 128, x.dtype).reshape(4, m))
    assert ring_ccl.launch_counts == dict.fromkeys(ring_ccl.KERNELS, 0)


def test_unknown_wire_dtype_raises_value_error():
    x = torch.randn(4, 8)
    for fn in (ring_ccl.ring_all_reduce, ring_ccl.ring_all_gather, ring_ccl.ring_reduce_scatter,
               ring_ccl.bidir_all_reduce, ring_ccl.bidir_all_gather,
               ring_ccl.scatter_ag_broadcast):
        with pytest.raises(ValueError, match="unknown wire_dtype"):
            fn(x, wire_dtype="fp4")
