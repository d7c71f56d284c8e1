"""The port's CUDA ring kernels (B4-B8 in uccl_tpu_torch/csrc/ring_ccl.cu)
against their plain versions, on the card.

Every test here needs an NVIDIA Hopper GPU and ``nvcc``; without a GPU each
skips. This file imports neither jax nor the JAX package, so it runs alone,
past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ccl.py

Tolerance: none. Each kernel runs the plain version's hop schedule with one
correctly rounded add per hop in the input dtype, so the results must be
bit-identical (``torch.equal``). The quantized kernels B6 and B8 carry the
block codec's arithmetic in their bodies (the scale as amax * (1 / QMAX), an
IEEE division by it, the dequantized value rounded to the input dtype before
the add), so they too must equal their plain versions bit for bit, a nan
counting as equal to a nan (a block poisoned by a non-finite input).
"""

import ctypes

import numpy as np
import pytest
import torch

from uccl_tpu_torch.collective import Communicator, dma, lanes, ring_ccl
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _x(dev, shape, dtype, seed):
    x = torch.tensor(np.random.default_rng(seed).standard_normal(shape), dtype=torch.float32)
    if dtype == torch.int32:
        x = (x * 1000).to(torch.int32)
    return x.to(dtype).to(dev)


def _counts():
    """The kernels launched since the last reset."""
    return {k: v for k, v in ring_ccl.launch_counts.items() if v}


def _same(a, b):
    """Bit-identical, a nan equal to a nan."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


CASES = [  # (n, per-member elements, dtype, direction)
    (2, 1000, torch.float32, 1),
    (3, 5000, torch.bfloat16, -1),
    (4, 300_000, torch.float32, -1),
    (4, 4096, torch.float16, 1),
    (8, 70_001, torch.bfloat16, 1),
    (3, 2_000_000, torch.int32, 1),
    (16, 333, torch.float32, -1),
]


@pytest.mark.parametrize("n,size,dtype,d", CASES, ids=lambda v: str(v))
def test_kernels_equal_plain(dev, n, size, dtype, d):
    x = _x(dev, (n, size), dtype, seed=n)
    ring_ccl.reset_launch_counts()
    # B4
    chunk, _, m = dma.pad_chunks(x, 1)
    chunk = chunk.reshape(n, m)
    _, got = ring_ccl._ag_kernel(chunk, d, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_ccl.ag_plain(chunk, d))
    # B5
    chunks, _, m = dma.pad_chunks(x, n)
    chunks = chunks.reshape(n, n, m)
    _, got = ring_ccl._rs_kernel(chunks, d, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_ccl.rs_plain(chunks, d))
    # B7, one stream in direction d and two counter-rotating streams
    for dirs in ((d,), (1, -1)):
        view, _, _ = ring_ccl._ar_layout(x, len(dirs))
        lane, got = ring_ccl._ar_kernel(view, dirs, 0)
        lane.check("test")
        assert torch.equal(got, ring_ccl.ar_plain(view, dirs))
    assert _counts() == {"ring_all_gather": 1, "ring_reduce_scatter": 1, "ring_all_reduce": 2}


def test_entry_points_against_plain_and_sum(dev):
    """The public wrappers on CUDA tensors (kernels) against the same calls
    on the CPU (plain versions), and the f32 sum against float64."""
    n = 4
    x = _x(dev, (n, 3, 10_007), torch.float32, seed=1)
    xc = x.cpu()
    for name, fn in [("ag", lambda t: ring_ccl.ring_all_gather(t, direction=-1)),
                     ("rs", lambda t: ring_ccl.ring_reduce_scatter(t.reshape(n, -1)[:, :30_020])),
                     ("ar", lambda t: ring_ccl.ring_all_reduce(t)),
                     ("ar1", lambda t: ring_ccl.ring_all_reduce(t, bidirectional=False)),
                     ("bidir_ar", ring_ccl.bidir_all_reduce),
                     ("bidir_ag", ring_ccl.bidir_all_gather),
                     ("bcast", lambda t: ring_ccl.scatter_ag_broadcast(t, 2))]:
        got = fn(x)
        assert got.is_cuda and torch.equal(got.cpu(), fn(xc)), name
    exact = x.double().sum(0)
    bound = (n - 1) * 2.0 ** -24 * x.double().abs().sum(0)
    err = (ring_ccl.ring_all_reduce(x).double() - exact).abs()
    assert (err <= bound).all()


def test_repeated_calls_on_one_flag_region(dev):
    """Epochs: many launches on the same collective id, alternating sizes
    and directions, stay right (a stale flag would let a wait through)."""
    for i in range(24):
        n = 3 + i % 2
        x = _x(dev, (n, 2048 * (1 + i % 3)), torch.float32, seed=i)
        d = 1 if i % 2 else -1
        got = ring_ccl.ring_all_reduce(x, bidirectional=False, direction=d)
        view, k, _ = ring_ccl._ar_layout(x, 1)
        want = ring_ccl._ar_unlayout(ring_ccl.ar_plain(view, (d,)), k, x)
        assert torch.equal(got, want), i


def _launch_all_but_last(name, x, buf, stage, out, streams, dirs, cid, slot_bytes, *,
                         wire_dtype=None, sstage=None, qbuf=None, sbuf=None):
    """``ring_ccl._launch`` with the last member left out of the grid: the
    C entry launches members [0, n-1) only."""
    n, t = x.shape[0], lanes.table
    lane = ring_ccl._lane(x.device, cid)
    rc = ring_ccl._lib().uccl_ring_launch(
        ring_ccl._KERNEL_ID[name], ring_ccl._ADD_DTYPES.get(x.dtype, 0),
        ring_ccl._WIRE_ID.get(wire_dtype, 0), n, n - 1, streams, dirs[0], dirs[-1], slot_bytes,
        t(x, n), t(buf, n), t(stage, n), t(out, n), t(sstage, n), t(qbuf, n), t(sbuf, n),
        t(lane.flags, n), ctypes.c_void_p(lane.err.data_ptr()), cid, lane.next_epoch(),
        lanes.SPIN_TIMEOUT_MS.get() * 1_000_000,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    assert rc == 0
    return lane


def test_missing_member_raises_instead_of_hanging(dev):
    """Launch all but the last member: its neighbors' waits time out, the
    kernel writes its error word and returns, and the check raises, for all
    five kernels. The flag region works again afterwards."""
    n, m = 4, 4096
    x = _x(dev, (n, n, m), torch.float32, seed=2)
    e = torch.empty_like
    slot = m * 4
    view = x.reshape(n, n, 1, m)
    qstage, sstage = ring_ccl._wire_buffers(x, n, 2)
    _, *ar_q = ring_ccl._ar_operands(view, "fp8")
    lanes.SPIN_TIMEOUT_MS.set(200)
    try:
        for args, kw in (
                (("ring_reduce_scatter", x, e(x), x.new_empty((n, 2, m)), x.new_empty((n, m)),
                  1, (1,), 5, slot), {}),
                (("ring_all_gather", x[:, 0].contiguous(), e(x), None, None, 1, (1,), 5, slot),
                 {}),
                (("ring_all_reduce", view, e(view), x.new_empty((n, 1, 2, m)), None, 1, (1,), 5,
                  slot), {}),
                (("ring_reduce_scatter_q", x, e(x), qstage, x.new_empty((n, m)), 1, (1,), 5,
                  slot), dict(wire_dtype="int8", sstage=sstage)),
                (("ring_all_reduce_q", view, e(view), ar_q[0], None, 1, (1,), 5, slot),
                 dict(wire_dtype="fp8", sstage=ar_q[1], qbuf=ar_q[2], sbuf=ar_q[3]))):
            lane = _launch_all_but_last(*args, **kw)
            with pytest.raises(RuntimeError, match="timed out"):
                lane.check("test")
    finally:
        lanes.SPIN_TIMEOUT_MS.set(None)
    lane, got = ring_ccl._rs_kernel(x, 1, 5)
    lane.check("test")
    assert torch.equal(got, ring_ccl.rs_plain(x, 1))


def test_cuda_tensors_ignore_the_arena_budget(dev):
    """The arena budget gates CPU tensors only: on the card every kernel
    algo launches its kernel at any size, and nothing falls back."""
    comm = Communicator(make_mesh(MeshConfig(dp=4)), "dp")
    x = _x(dev, (4, 3000), torch.float32, seed=6)
    dma.MAX_ARENA_BYTES.set(64)
    try:
        fb = dma.WIRE_FALLBACK.total()
        ring_ccl.reset_launch_counts()
        for algo in ("pallas", "bidir"):
            got = comm.all_reduce(x, algo=algo)
            assert torch.allclose(got, x.sum(0).expand_as(x), atol=1e-4), algo
        for algo in ("ring", "bidir"):
            assert torch.equal(comm.all_gather(x, algo=algo), x)
        assert torch.equal(comm.broadcast(x, 1, algo="scatter_ag"), x[1].expand_as(x))
        comm.reduce_scatter(x, algo="ring")
        assert dma.WIRE_FALLBACK.total() == fb
        assert _counts() == {"ring_all_gather": 5, "ring_reduce_scatter": 1,
                             "ring_all_reduce": 3}
    finally:
        dma.MAX_ARENA_BYTES.set(None)


def test_two_bidir_launches_in_flight(dev):
    """bidir all-reduce and all-gather: two launches on two streams,
    distinct collective ids, joined before returning; repeated while other
    work is queued on the current stream."""
    n = 4
    x = _x(dev, (n, 1 << 20), torch.bfloat16, seed=3)
    ring_ccl.reset_launch_counts()
    for _ in range(3):
        y = x * 1  # work queued on the current stream before the pair
        got = ring_ccl.bidir_all_reduce(y)
        assert torch.equal(got.cpu(), ring_ccl.bidir_all_reduce(y.cpu()))
        got = ring_ccl.bidir_all_gather(y.reshape(n, 1, -1))
        assert torch.equal(got.cpu(), ring_ccl.bidir_all_gather(y.cpu().reshape(n, 1, -1)))
    assert ring_ccl.launch_counts["ring_all_reduce"] == 6
    assert ring_ccl.launch_counts["ring_all_gather"] == 6


def test_communicator_on_the_card(dev):
    comm = Communicator(make_mesh(MeshConfig(dp=4)), "dp")
    assert comm.device.type == "cuda"
    x = _x(dev, (4, 257, 3), torch.float32, seed=4)
    for algo in ("pallas", "bidir", "ring", "hd", "xla", "auto"):
        got = comm.all_reduce(x, algo=algo)
        assert got.is_cuda and torch.allclose(got, x.sum(0).expand_as(x), atol=1e-4), algo
    for algo in ("ring", "bidir", "xla"):
        assert torch.equal(comm.all_gather(x, algo=algo), x)
    assert torch.equal(comm.broadcast(x, 3, algo="scatter_ag"), x[3].expand_as(x))
    y = _x(dev, (4, 1028), torch.float32, seed=5)
    rs = comm.reduce_scatter(y, algo="ring")
    assert torch.allclose(rs, y.sum(0).reshape(4, 257), atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        ring_ccl.ring_all_reduce(torch.ones(4, 100, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        ring_ccl.ring_all_reduce(torch.ones(17, 100, device=dev))
    with pytest.raises(ValueError):
        ring_ccl._ag_kernel(torch.ones(4, 8, 1024, device=dev)[:, 0], 1, 0)
    # B4 moves bytes of any dtype
    x = torch.arange(4 * 3000, dtype=torch.int64, device=dev).reshape(4, 3000)
    assert torch.equal(ring_ccl.ring_all_gather(x.unsqueeze(1))[3], x)


# ---------------------------------------------------------------------------
# The quantized wire: B6 and B8


def _xq(dev, shape, dtype, seed):
    """Payloads whose 128-element blocks span magnitudes of e^±3."""
    rng = np.random.default_rng(seed)
    mag = np.exp(3 * rng.standard_normal((shape[0], shape[1] // 128 + 1)))
    x = rng.standard_normal(shape) * np.repeat(mag, 128, axis=1)[:, : shape[1]]
    return torch.tensor(x, dtype=torch.float32).to(dtype).to(dev)


QUANT_CASES = [  # (n, per-member elements, dtype, direction)
    (2, 5000, torch.float32, 1),
    (3, 70_001, torch.bfloat16, -1),
    (4, 1_000_003, torch.float32, -1),
    (4, 4096, torch.float16, 1),
    (8, 300_001, torch.bfloat16, 1),
    (16, 333, torch.float32, -1),
]


@pytest.mark.parametrize("wd", ["fp8", "int8"])
@pytest.mark.parametrize("n,size,dtype,d", QUANT_CASES, ids=lambda v: str(v))
def test_quantized_kernels_equal_plain(dev, n, size, dtype, d, wd):
    x = _xq(dev, (n, size), dtype, seed=n)
    ring_ccl.reset_launch_counts()
    chunks = dma.pad_chunks(x[:, : size - size % n], n)[0].reshape(n, n, -1)
    lane, got = ring_ccl._rs_kernel(chunks, d, 0, wd)
    lane.check("test")
    assert _same(got, ring_ccl.rs_q_plain(chunks, d, wd))
    for dirs in ((d,), (1, -1)):
        view, _, _ = ring_ccl._ar_layout(x, len(dirs))
        lane, got = ring_ccl._ar_kernel(view, dirs, 0, wd)
        lane.check("test")
        assert _same(got, ring_ccl.ar_q_plain(view, dirs, wd))
        assert all(_same(got[i], got[0]) for i in range(1, n))
    assert _counts() == {"ring_reduce_scatter_q": 1, "ring_all_reduce_q": 2}


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_quantized_kernels_keep_nonfinite_loud_and_zeros_exact(dev, wd):
    """An inf and a nan each poison their own 128-lane block on every
    member (the row's scale becomes +inf: fmaxf alone would drop the nan),
    an all-zero block comes out exactly zero, a denormal block stays
    finite; all of it equal to the plain version."""
    x = _xq(dev, (4, 8192), torch.float32, seed=7)
    x[0, 5], x[1, 300] = float("inf"), float("nan")
    x[:, 1024:1152], x[3, 2048:2176] = 0.0, 1e-42
    view, k, _ = ring_ccl._ar_layout(x, 1)
    lane, got = ring_ccl._ar_kernel(view, (1,), 0, wd)
    lane.check("test")
    assert _same(got, ring_ccl.ar_q_plain(view, (1,), wd))
    out = ring_ccl._ar_unlayout(got, k, x)
    assert out[:, :128].isnan().all() and out[:, 256:384].isnan().all()
    assert out[:, 128:256].isfinite().all() and out[:, 384:].isfinite().all()
    assert (out[:, 1024:1152] == 0).all()


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_quantized_entry_points_against_plain(dev, wd):
    """The public wrappers with a wire_dtype on CUDA tensors (B6, B8, B4 on
    payload and scales, the codec's torch ops on the card) against the same
    calls on the CPU (plain versions), bit for bit."""
    n = 4
    x = _xq(dev, (n, 30_021), torch.float32, seed=8).reshape(n, 3, 10_007)
    xc = x.cpu()
    ring_ccl.reset_launch_counts()
    for name, fn in [("ag", lambda t: ring_ccl.ring_all_gather(t, direction=-1, wire_dtype=wd)),
                     ("rs", lambda t: ring_ccl.ring_reduce_scatter(
                         t.reshape(n, -1)[:, :30_020], wire_dtype=wd)),
                     ("ar", lambda t: ring_ccl.ring_all_reduce(t, wire_dtype=wd)),
                     ("ar1", lambda t: ring_ccl.ring_all_reduce(t, bidirectional=False,
                                                                wire_dtype=wd)),
                     ("bidir_ar", lambda t: ring_ccl.bidir_all_reduce(t, wire_dtype=wd)),
                     ("bidir_ag", lambda t: ring_ccl.bidir_all_gather(t, wire_dtype=wd)),
                     ("bcast", lambda t: ring_ccl.scatter_ag_broadcast(t, 2, wire_dtype=wd))]:
        got = fn(x)
        assert got.is_cuda and torch.equal(got.cpu(), fn(xc)), name
    assert _counts() == {"ring_all_gather": 2 + 4 + 4, "ring_reduce_scatter_q": 1,
                         "ring_all_reduce_q": 1 + 1 + 2}


def test_quantized_communicator_on_the_card(dev):
    """Every verb's wire_dtype through the kernels, equal to the same verb
    on the CPU (plain versions), with the arena budget forced tiny: CUDA
    tensors launch at every size and nothing falls back."""
    comm = Communicator(make_mesh(MeshConfig(dp=4)), "dp")
    cpu = Communicator(make_mesh(MeshConfig(dp=4), device="cpu"), "dp")
    x = _xq(dev, (4, 3000), torch.float32, seed=9)
    xc = x.cpu()
    want = {}
    verbs = [("all_reduce", dict(algo="pallas")), ("all_reduce", dict(algo="bidir")),
             ("all_gather", dict(algo="ring")), ("all_gather", dict(algo="bidir")),
             ("broadcast", dict(root=1, algo="scatter_ag")),
             ("reduce_scatter", dict(algo="ring"))]
    for wd in ("fp8", "int8"):
        for i, (verb, kw) in enumerate(verbs):
            want[wd, i] = getattr(cpu, verb)(xc, wire_dtype=wd, **kw)
    dma.MAX_ARENA_BYTES.set(64)
    try:
        fb = dma.WIRE_FALLBACK.total()
        ring_ccl.reset_launch_counts()
        for wd in ("fp8", "int8"):
            for i, (verb, kw) in enumerate(verbs):
                got = getattr(comm, verb)(x, wire_dtype=wd, **kw)
                assert got.is_cuda and torch.equal(got.cpu(), want[wd, i]), (verb, kw, wd)
        assert dma.WIRE_FALLBACK.total() == fb
        assert _counts() == {"ring_all_gather": 2 * (2 + 4 + 4), "ring_reduce_scatter_q": 2,
                             "ring_all_reduce_q": 2 * 3}
    finally:
        dma.MAX_ARENA_BYTES.set(None)


def test_quantized_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        ring_ccl.ring_all_reduce(torch.ones(4, 100, dtype=torch.float64, device=dev),
                                 wire_dtype="fp8")
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        ring_ccl.ring_all_reduce(torch.ones(4, 100, device=dev), wire_dtype="e5m2")
    # an int payload ships full precision through B7, counted
    fb = dma.WIRE_FALLBACK.get(what="all_reduce", reason="quant_dtype")
    xi = torch.arange(4 * 300, dtype=torch.int32, device=dev).reshape(4, 300)
    assert torch.equal(ring_ccl.ring_all_reduce(xi, wire_dtype="int8"),
                       xi.sum(0, dtype=torch.int32).expand_as(xi))
    assert dma.WIRE_FALLBACK.get(what="all_reduce", reason="quant_dtype") == fb + 1
