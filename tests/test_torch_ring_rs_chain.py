"""B5's contract in the port: ``ring_ccl.rs_chain_plain``, the reduce-scatter
as one pass over the unpadded payload, summing each slot along the chain
the ring's hops make.

The card's B5 kernel is held to this function bit for bit
(tests/test_torch_cuda_ccl.py, chip_smoke.py). Here the function itself is
held, exactly (``assert_array_equal``), to the ring's hop schedule on padded
slots (``rs_plain``) and to the JAX package's Pallas kernel
(``pallas_ccl.ring_reduce_scatter``, run as tests/test_pallas_ccl.py runs it:
the TPU interpreter on a 1-axis mesh of the virtual CPU devices). Worlds 2,
3, 4 and 8, both directions, f32, bf16 and int32, slots whose length is no
multiple of 4 (so their starts are off 16 bytes, as B5 must take them).
Payloads are a few KiB: the interpreter is most of this file's time.
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


def _inputs(n, per, dtype, seed):
    """[n, n*per] in both frameworks, the same values (bf16 rounded from f32
    by both; int32 from scaled normals, whose sums do not wrap)."""
    x = np.random.default_rng(seed).standard_normal((n, n * per)).astype(np.float32)
    if dtype == "i32":
        x = (x * 1000).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy() if t.dtype == torch.int32 else t.float().numpy()


def _hops(xt: torch.Tensor, direction: int) -> torch.Tensor:
    """rs_plain on the padded slots, cut back to the payload's."""
    n = xt.shape[0]
    chunks, per, m = dma.pad_chunks(xt, n)
    return ring_ccl.rs_plain(chunks.reshape(n, n, m), direction)[:, :per]


# (n, per, direction, dtype): every world meets both directions and every
# dtype across the cases; no per is a multiple of 4
CASES = [(2, 33, 1, "f32"), (2, 45, -1, "i32"), (3, 21, -1, "bf16"), (3, 27, 1, "i32"),
         (4, 37, 1, "bf16"), (4, 19, -1, "f32"), (8, 13, -1, "f32"), (8, 11, 1, "bf16"),
         (8, 9, -1, "i32")]


@pytest.mark.parametrize("n,per,direction,dtype", CASES)
def test_chain_equals_the_hop_schedule(n, per, direction, dtype):
    _, xt = _inputs(n, per, dtype, seed=n * per)
    got = ring_ccl.rs_chain_plain(xt, direction)
    assert got.shape == (n, per) and got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(_hops(xt, direction)))


@pytest.mark.parametrize("n,per,direction,dtype", CASES)
def test_chain_equals_pallas(devices, n, per, direction, dtype):
    xj, xt = _inputs(n, per, dtype, seed=100 + n * per)
    mesh = Mesh(np.array(devices[:n]), ("dp",))
    mapped = shard_map(lambda v: pallas_ccl.ring_reduce_scatter(
        v.reshape(-1), "dp", direction=direction, interpret=True),
        mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"), check_vma=False)
    want = np.asarray(jax.jit(mapped)(xj)).reshape(n, per)
    got = ring_ccl.rs_chain_plain(xt, direction)
    np.testing.assert_array_equal(_np(got), want if dtype == "i32" else want.astype(np.float32))


@pytest.mark.parametrize("direction", [1, -1])
def test_ascending_member_order_is_a_different_sum(direction):
    """A planted fault: the members summed in ascending order, each add
    rounded in bf16, differ from the chain (which starts at member k+d and
    ends at member k). The ring's order is part of the contract."""
    n, per = 4, 512
    _, xt = _inputs(n, per, "bf16", seed=7)
    slots = xt.reshape(n, n, per)
    k = torch.arange(n)
    ascending = slots[0, k]
    for j in range(1, n):
        ascending = ascending + slots[j, k]
    chain = ring_ccl.rs_chain_plain(xt, direction)
    assert not torch.equal(ascending, chain)
    assert torch.equal(chain, _hops(xt, direction))


def test_reduce_scatter_entry_on_the_cpu_keeps_the_hop_schedule():
    """On CPU tensors the RS verb runs the hop schedule on padded slots
    (what the tests against JAX hold), launches nothing, and equals the
    chain, for a payload whose slots are off 16 bytes."""
    _, xt = _inputs(4, 37, "f32", seed=3)
    ring_ccl.reset_launch_counts()
    got = ring_ccl.ring_reduce_scatter(xt)
    assert torch.equal(got, ring_ccl.rs_chain_plain(xt))
    assert ring_ccl.launch_counts == dict.fromkeys(ring_ccl.KERNELS, 0)
