"""The port's ring collectives (uccl_tpu_torch/collective/ring_ccl.py) against
the JAX package's Pallas kernels (uccl_tpu/collective/pallas_ccl.py).

The same seeded numpy inputs go through both. The JAX side runs as
tests/test_pallas_ccl.py runs it: the faithful TPU interpreter on a 1-axis
mesh of the virtual CPU devices. The port's side runs on CPU tensors, so its
wrappers take each kernel's plain version (the same hop schedule on the
member-stacked tensor, the same per-hop add in the input dtype): the results
must be bit-identical, for f32 and bf16, n in {2, 3, 4, 8} and both ring
directions. This file is the full-precision wire; the quantized one is
tests/test_torch_quant_wire.py. Payloads are a few KiB, under the interpreter's 64 KiB ceiling,
and sized so each member's chunks need padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.collective import pallas_ccl
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.collective import ring_ccl

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_run(devices, n, fn, x):
    mesh = Mesh(np.array(devices[:n]), ("dp",))
    mapped = shard_map(fn, mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"),
                       check_vma=False)
    return np.asarray(jax.jit(mapped)(x)).astype(np.float32)


def _inputs(shape, dtype, seed):
    """The same values in both frameworks (bf16 rounded from f32 by both)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _eq(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.float().numpy().reshape(want.shape), want)


# (n, direction, dtype): every world meets both directions and both dtypes
# across the kernels without running every combination in the interpreter
CASES = [(2, 1, "f32"), (3, -1, "bf16"), (4, 1, "bf16"), (8, -1, "f32")]
CASES_FLIPPED = [(n, -d, "bf16" if t == "f32" else "f32") for n, d, t in CASES]


@pytest.mark.parametrize("n,direction,dtype", CASES + [(3, 1, "f32")])
def test_all_gather_matches_pallas(devices, n, direction, dtype):
    xj, xt = _inputs((n * 3, 40), dtype, seed=n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_gather(
        v, "dp", direction=direction, interpret=True), xj)
    got = ring_ccl.ring_all_gather(xt.reshape(n, 3, 40), direction=direction)
    assert got.shape == (n, n * 3, 40) and got.dtype == xt.dtype
    _eq(got, want)


@pytest.mark.parametrize("n,direction,dtype", CASES_FLIPPED)
def test_reduce_scatter_matches_pallas(devices, n, direction, dtype):
    xj, xt = _inputs((n, n * 70), dtype, seed=10 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_reduce_scatter(
        v.reshape(-1), "dp", direction=direction, interpret=True), xj)
    got = ring_ccl.ring_reduce_scatter(xt, direction=direction)
    assert got.shape == (n, 70)
    _eq(got, want)


@pytest.mark.parametrize("n,direction,dtype", [(3, -1, "bf16"), (4, 1, "f32"),
                                               (2, -1, "f32")])
def test_all_reduce_one_stream_matches_pallas(devices, n, direction, dtype):
    xj, xt = _inputs((n, 300), dtype, seed=20 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_reduce(
        v, "dp", bidirectional=False, direction=direction, interpret=True), xj)
    _eq(ring_ccl.ring_all_reduce(xt, bidirectional=False, direction=direction), want)


@pytest.mark.parametrize("n,dtype", [(2, "bf16"), (3, "f32"), (8, "bf16")])
def test_all_reduce_two_streams_matches_pallas(devices, n, dtype):
    xj, xt = _inputs((n, 300), dtype, seed=30 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_reduce(
        v, "dp", bidirectional=True, interpret=True), xj)
    _eq(ring_ccl.ring_all_reduce(xt, bidirectional=True), want)


@pytest.mark.parametrize("n,dtype", [(4, "f32"), (3, "bf16")])
def test_bidir_all_reduce_matches_pallas(devices, n, dtype):
    xj, xt = _inputs((n, 41), dtype, seed=40 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.bidir_all_reduce(
        v, "dp", interpret=True), xj)
    _eq(ring_ccl.bidir_all_reduce(xt), want)


@pytest.mark.parametrize("n,dtype", [(4, "bf16"), (3, "f32")])
def test_bidir_all_gather_matches_pallas(devices, n, dtype):
    xj, xt = _inputs((n * 2, 33), dtype, seed=50 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.bidir_all_gather(
        v, "dp", interpret=True), xj)
    _eq(ring_ccl.bidir_all_gather(xt.reshape(n, 2, 33)), want)


@pytest.mark.parametrize("n,root,dtype", [(4, 1, "f32"), (3, 2, "bf16")])
def test_scatter_ag_broadcast_matches_pallas(devices, n, root, dtype):
    xj, xt = _inputs((n, 57), dtype, seed=60 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.scatter_ag_broadcast(
        v, "dp", root, interpret=True), xj)
    got = ring_ccl.scatter_ag_broadcast(xt, root)
    _eq(got, want)
    assert torch.equal(got, xt[root].expand_as(xt))


@pytest.mark.parametrize("n", [3, 4])
def test_scatter_gather_broadcast_lax_matches(devices, n):
    xj, xt = _inputs((n, 50), "f32", seed=70 + n)
    want = _jax_run(devices, n, lambda v: pallas_ccl.scatter_gather_broadcast_lax(v, "dp", 0),
                    xj)
    _eq(ring_ccl.scatter_gather_broadcast_lax(xt, 0), want)


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    ring_ccl.reset_launch_counts()
    x = torch.randn(4, 2, 64)
    assert torch.equal(ring_ccl.ring_all_gather(x)[1], x.reshape(8, 64))
    assert torch.equal(ring_ccl.ring_reduce_scatter(x.reshape(4, 128)),
                       ring_ccl.rs_plain(ring_ccl._dma.pad_chunks(
                           x.reshape(4, 128), 4)[0].reshape(4, 4, -1))[:, :32])
    ring_ccl.ring_all_reduce(x)
    assert ring_ccl.launch_counts == dict.fromkeys(ring_ccl.KERNELS, 0)


def test_int32_all_gather_and_all_reduce_plain():
    x = torch.arange(3 * 5 * 7, dtype=torch.int32).reshape(3, 5, 7)
    assert torch.equal(ring_ccl.ring_all_gather(x)[2], x.reshape(15, 7))
    assert torch.equal(ring_ccl.ring_all_reduce(x), x.sum(0, dtype=torch.int32).expand_as(x))


def test_quantized_wire_is_the_next_slice():
    """That slice has landed: every entry takes a wire_dtype (held against
    the JAX kernels in tests/test_torch_quant_wire.py), None and "none" are
    the full-precision wire, and an unknown value raises ValueError."""
    x = torch.randn(4, 8)
    for fn in (ring_ccl.ring_all_reduce, ring_ccl.ring_all_gather,
               ring_ccl.ring_reduce_scatter, ring_ccl.bidir_all_reduce):
        full = fn(x)
        assert torch.equal(fn(x, wire_dtype="none"), full)
        for wd in ("fp8", "int8"):
            got = fn(x, wire_dtype=wd)
            assert got.shape == full.shape and torch.allclose(got, full, atol=0.5)
        with pytest.raises(ValueError, match="unknown wire_dtype"):
            fn(x, wire_dtype="fp16")


def test_indivisible_reduce_scatter_raises():
    with pytest.raises(ValueError, match="not divisible"):
        ring_ccl.ring_reduce_scatter(torch.ones(4, 9))


def test_charges_match_the_jax_gates():
    for nelems, itemsize, n in [(1, 4, 2), (1000, 2, 3), (4097, 4, 8), (10 ** 6, 4, 4)]:
        assert ring_ccl.rs_charge(nelems, itemsize, n) == pallas_ccl.rs_charge(
            nelems, itemsize, n, None, False)
        assert ring_ccl.ag_charge(nelems, itemsize, n) == pallas_ccl.ag_charge(
            nelems, itemsize, n, None, False)
        for port, ref in ((ring_ccl.bidir_pair_charge, pallas_ccl.bidir_pair_charge),
                          (ring_ccl.ag_pair_charge, pallas_ccl.ag_pair_charge),
                          (ring_ccl.bcast_pair_charge, pallas_ccl.bcast_pair_charge)):
            assert port(nelems, itemsize, n) == ref(nelems, itemsize, n, None, False)
