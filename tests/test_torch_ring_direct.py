"""The one-pass contracts of B4 and B7 in the port: ``ring_ccl.ag_rows_plain``
(the all-gather on unpadded rows) and ``ring_ccl.ar_chain_plain`` (the
all-reduce as one chain sum per chunk of the unpadded payload, written to
every member).

The card's B4 and B7 kernels are held to these functions bit for bit
(tests/test_torch_cuda_ccl.py, chip_smoke.py). Here the functions
themselves are held, exactly (``assert_array_equal``), to the ring's hop
schedules on padded slots (``ag_plain``, ``ar_plain``) and to the JAX
package's Pallas kernels (``pallas_ccl.ring_all_gather``,
``pallas_ccl.ring_all_reduce``), run as tests/test_torch_ring_ccl.py runs
them: the TPU interpreter on a 1-axis mesh of the virtual CPU devices.
Worlds 2, 3, 4 and 8, both directions, one stream and two, f32, bf16 and
int32; chunks whose length is no multiple of 4 elements (so their starts are
off 16 bytes), sizes that W·S does not divide (a short tail chunk), and
sizes below W·S (empty chunks). Payloads are a few KiB: the interpreter is
most of this file's time.
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

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (jnp.int32, torch.int32)}


def _inputs(shape, dtype, seed):
    """The same values in both frameworks (bf16 rounded from f32 by both;
    int32 from scaled normals, whose sums do not wrap)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "i32":
        x = (x * 1000).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy() if t.dtype == torch.int32 else t.float().numpy()


def _jax_run(devices, n, fn, xj, dtype):
    mesh = Mesh(np.array(devices[:n]), ("dp",))
    mapped = shard_map(fn, mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"), check_vma=False)
    out = np.asarray(jax.jit(mapped)(xj))
    return out if dtype == "i32" else out.astype(np.float32)


# ---------------------------------------------------------------------------
# B4: the gather on unpadded rows

# (n, per, direction, dtype): every world meets both directions, and the
# dtypes spread across them; no per is a multiple of 4
AG_CASES = [(2, 33, 1, "f32"), (2, 5, -1, "i32"), (3, 21, -1, "bf16"), (3, 1, 1, "i32"),
            (4, 37, 1, "bf16"), (4, 19, -1, "f32"), (8, 13, -1, "f32"), (8, 3, 1, "bf16"),
            (8, 9, -1, "i32")]


@pytest.mark.parametrize("n,per,direction,dtype", AG_CASES)
def test_gather_rows_equal_the_hop_schedule(n, per, direction, dtype):
    _, xt = _inputs((n, per), dtype, seed=n * per)
    got = ring_ccl.ag_rows_plain(xt)
    assert got.shape == (n, n, per) and got.dtype == xt.dtype
    chunk, _, m = dma.pad_chunks(xt, 1)
    want = ring_ccl.ag_plain(chunk.reshape(n, m), direction)[:, :, :per]
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("n,per,direction,dtype", AG_CASES)
def test_gather_rows_equal_pallas(devices, n, per, direction, dtype):
    xj, xt = _inputs((n, per), dtype, seed=100 + n * per)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_gather(
        v, "dp", direction=direction, interpret=True), xj, dtype)
    np.testing.assert_array_equal(_np(ring_ccl.ag_rows_plain(xt)), want.reshape(n, n, per))


# ---------------------------------------------------------------------------
# B7: one chain sum per chunk, on every member

# (n, size, dirs, dtype): every world meets +1, -1 and the two streams; the
# chunk k = ceil(size / (n·S)) is no multiple of 4 elements, and the tail
# chunk is short (sizes below n·S leave chunks empty: (3, 7), (4, 3),
# (8, 11), and (8, 135), whose last chunk is empty)
AR_CASES = [(2, 45, (1,), "f32"), (2, 30, (-1,), "i32"), (2, 21, (1, -1), "bf16"),
            (3, 26, (1,), "f32"), (3, 61, (-1,), "bf16"), (3, 50, (1, -1), "i32"),
            (3, 7, (1, -1), "f32"), (4, 3, (1,), "bf16"), (4, 90, (-1,), "i32"),
            (4, 37, (1, -1), "f32"), (8, 21, (1,), "bf16"), (8, 70, (-1,), "f32"),
            (8, 11, (1, -1), "bf16"), (8, 135, (1, -1), "i32")]


def _ar_hops(xt, dirs):
    """ar_plain on the padded slot-major layout, cut back to the payload."""
    view, k, _ = ring_ccl._ar_layout(xt, len(dirs))
    return ring_ccl._ar_unlayout(ring_ccl.ar_plain(view, dirs), k, xt)


@pytest.mark.parametrize("n,size,dirs,dtype", AR_CASES)
def test_chain_all_reduce_equals_the_hop_schedule(n, size, dirs, dtype):
    _, xt = _inputs((n, size), dtype, seed=n * size)
    got = ring_ccl.ar_chain_plain(xt, dirs)
    assert got.shape == (n, size) and got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(_ar_hops(xt, dirs)))
    assert all(torch.equal(got[r], got[0]) for r in range(1, n))


@pytest.mark.parametrize("n,size,dirs,dtype", AR_CASES)
def test_chain_all_reduce_equals_pallas(devices, n, size, dirs, dtype):
    xj, xt = _inputs((n, size), dtype, seed=200 + n * size)
    want = _jax_run(devices, n, lambda v: pallas_ccl.ring_all_reduce(
        v, "dp", bidirectional=len(dirs) == 2, direction=dirs[0], interpret=True), xj, dtype)
    np.testing.assert_array_equal(_np(ring_ccl.ar_chain_plain(xt, dirs)), want)


def test_chain_all_reduce_of_bidir_halves_equals_pallas(devices):
    """The bidir pair's two one-stream launches write the halves of one
    output: ar_chain_plain on each half, directions +1 and -1, is the JAX
    package's bidir_all_reduce."""
    n, size = 4, 41
    xj, xt = _inputs((n, size), "bf16", seed=5)
    want = _jax_run(devices, n, lambda v: pallas_ccl.bidir_all_reduce(v, "dp", interpret=True),
                    xj, "bf16")
    half = size // 2
    got = torch.cat([ring_ccl.ar_chain_plain(xt[:, :half], (1,)),
                     ring_ccl.ar_chain_plain(xt[:, half:], (-1,))], dim=1)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dirs", [(1,), (1, -1)])
def test_ascending_member_order_is_a_different_sum(dirs):
    """A planted fault: every chunk's members summed in ascending order,
    each add rounded in bf16, differ from the chain (which starts at member
    owner + d and ends at the owner), and so do the sums of stream 1 taken
    in direction +1. The ring's order is part of the contract."""
    n, size = 4, 4096
    _, xt = _inputs((n, size), "bf16", seed=7)
    ascending = xt[0]
    for j in range(1, n):
        ascending = ascending + xt[j]
    chain = ring_ccl.ar_chain_plain(xt, dirs)
    assert not torch.equal(ascending.expand(n, -1), chain)
    if len(dirs) == 2:
        assert not torch.equal(ring_ccl.ar_chain_plain(xt, (1, 1)), chain)
    assert torch.equal(chain, _ar_hops(xt, dirs))


def test_entries_on_the_cpu_keep_the_hop_schedules():
    """On CPU tensors the AG and AR verbs (and the bidir pairs and the
    broadcast) run the hop schedules on padded slots, launch nothing, and
    equal the one-pass contracts, on sizes whose chunks are off 16 bytes."""
    n = 4
    _, xt = _inputs((n, 37), "f32", seed=3)
    ring_ccl.reset_launch_counts()
    assert torch.equal(ring_ccl.ring_all_gather(xt.unsqueeze(1)).reshape(n, n, -1),
                       ring_ccl.ag_rows_plain(xt))
    assert torch.equal(ring_ccl.bidir_all_gather(xt.unsqueeze(1)).reshape(n, n, -1),
                       ring_ccl.ag_rows_plain(xt))
    assert torch.equal(ring_ccl.ring_all_reduce(xt), ring_ccl.ar_chain_plain(xt, (1, -1)))
    assert torch.equal(ring_ccl.ring_all_reduce(xt, bidirectional=False, direction=-1),
                       ring_ccl.ar_chain_plain(xt, (-1,)))
    assert torch.equal(ring_ccl.bidir_all_reduce(xt), torch.cat(
        [ring_ccl.ar_chain_plain(xt[:, :18], (1,)), ring_ccl.ar_chain_plain(xt[:, 18:], (-1,))],
        dim=1))
    assert torch.equal(ring_ccl.scatter_ag_broadcast(xt, 3), xt[3].expand(n, -1))
    assert ring_ccl.launch_counts == dict.fromkeys(ring_ccl.KERNELS, 0)
