"""The port's CUDA ring kernels (B4-B8 in uccl_tpu_torch/csrc/ring_ccl.cu)
against their plain versions, on the card.

Every test here needs an NVIDIA Hopper GPU and ``nvcc``; without a GPU each
skips. This file imports neither jax nor the JAX package, so it runs alone,
past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ccl.py

Tolerance: none. Each kernel runs the plain version's hop schedule with one
correctly rounded add per hop in the input dtype, so the results must be
bit-identical (``torch.equal``). B4, B5 and B7 are one pass each, not a
ring, and add in the chain order the ring's hops make: each must equal both
its contract on the unpadded payload (``ag_rows_plain``,
``rs_chain_plain``, ``ar_chain_plain``) and its hop schedule on the padded
slots (``ag_plain``, ``rs_plain``, ``ar_plain``). The quantized kernels B6
and B8 are the same one pass with the block codec's round trip at every
link of the chain (the scale as amax * (1 / QMAX), an IEEE division by it,
the dequantized value rounded to the input dtype before the add), so they
too must equal their contracts (``rs_q_chain_plain``, ``ar_q_chain_plain``)
and their hop schedules (``rs_q_plain``, ``ar_q_plain``) bit for bit, a nan
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


def _ag_hops(x, d):
    """ag_plain on the padded slots, cut back to the payload."""
    n, size = x.shape
    chunk, _, m = dma.pad_chunks(x, 1)
    return ring_ccl.ag_plain(chunk.reshape(n, m), d)[:, :, :size]


def _ar_hops(x, dirs):
    """ar_plain on the padded slot-major layout, cut back to the payload."""
    view, k, _ = ring_ccl._ar_layout(x, len(dirs))
    return ring_ccl._ar_unlayout(ring_ccl.ar_plain(view, dirs), k, x)


@pytest.mark.parametrize("n,size,dtype,d", CASES, ids=lambda v: str(v))
def test_kernels_equal_plain(dev, n, size, dtype, d):
    x = _x(dev, (n, size), dtype, seed=n)
    ring_ccl.reset_launch_counts()
    # B4 on the unpadded rows
    _, got = ring_ccl._ag_kernel(x, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_ccl.ag_rows_plain(x))
    assert torch.equal(got, _ag_hops(x, d))
    # B5 on the unpadded rows (strided when n does not divide size)
    xs = x[:, : size - size % n]
    _, got = ring_ccl._rs_kernel(xs, d, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_ccl.rs_chain_plain(xs, d))
    chunks, per, m = dma.pad_chunks(xs, n)
    assert torch.equal(got, ring_ccl.rs_plain(chunks.reshape(n, n, m), d)[:, :per])
    # B7 on the unpadded rows, one stream in direction d and two
    # counter-rotating streams
    for dirs in ((d,), (1, -1)):
        lane, got = ring_ccl._ar_kernel(x, dirs, 0)
        lane.check("test")
        assert torch.equal(got, ring_ccl.ar_chain_plain(x, dirs))
        assert torch.equal(got, _ar_hops(x, dirs))
    assert _counts() == {"ring_all_gather": 1, "ring_reduce_scatter": 1, "ring_all_reduce": 2}


RS_RAGGED = [  # (n, elements per slot, dtype, direction): slot starts off 16 bytes
    (2, 1001, torch.bfloat16, 1),
    (3, 4097, torch.float32, -1),
    (4, 100_003, torch.float32, 1),
    (4, 77_777, torch.int32, -1),
    (5, 12_345, torch.float16, 1),
    (8, 30_001, torch.bfloat16, -1),
    (8, 3, torch.float32, 1),
    (6, 50_001, torch.int32, 1),
    (7, 9_999, torch.float16, -1),
]


@pytest.mark.parametrize("n,per,dtype,d", RS_RAGGED, ids=lambda v: str(v))
def test_reduce_scatter_on_ragged_slots(dev, n, per, dtype, d):
    """B5 where slot k starts k*per elements into each row, no multiple of
    16 bytes: on the contiguous payload (vectors between a ragged head and
    tail), on rows at a stride one element longer (every term offset
    differently: funnel-shifted vectors) and on a payload starting one element
    in. Each equal to rs_chain_plain and to rs_plain on padded slots."""
    x = _x(dev, (n, n * per + 1), dtype, seed=per)
    ring_ccl.reset_launch_counts()
    for name, xs in (("contiguous", x[:, 1:].contiguous()), ("strided rows", x[:, 1:]),
                     ("offset start", x.reshape(-1)[1: 1 + n * n * per].view(n, n * per))):
        lane, got = ring_ccl._rs_kernel(xs, d, 0)
        lane.check("test")
        assert torch.equal(got, ring_ccl.rs_chain_plain(xs, d)), name
        chunks, _, m = dma.pad_chunks(xs, n)
        assert torch.equal(got, ring_ccl.rs_plain(chunks.reshape(n, n, m), d)[:, :per]), name
    assert _counts() == {"ring_reduce_scatter": 3}


DIRECT_RAGGED = [  # (n, elements per member, dtype, direction): chunks off 16 bytes
    (2, 1001, torch.bfloat16, 1),
    (3, 4097, torch.float32, -1),
    (4, 100_003, torch.float32, 1),
    (4, 77_777, torch.int32, -1),
    (5, 12_345, torch.float16, 1),
    (8, 30_001, torch.bfloat16, -1),
    (8, 11, torch.float32, 1),
    (6, 50_001, torch.int32, 1),
    (7, 9_999, torch.float16, -1),
    (16, 333, torch.bfloat16, 1),
]


@pytest.mark.parametrize("n,size,dtype,d", DIRECT_RAGGED, ids=lambda v: str(v))
def test_all_gather_and_all_reduce_on_ragged_rows(dev, n, size, dtype, d):
    """B4 and B7 where chunks start off 16 bytes: on the contiguous
    payload, on rows at a stride one element longer (terms and outputs
    offset differently mod 16) and on a payload starting one element in;
    B7 with one stream and two. Then both pairs' halves written into one
    output (B4's filled with 0xFF bytes first). Each equal to its one-pass
    contract and to its hop schedule."""
    x = _x(dev, (n, size + 1), dtype, seed=size)
    ring_ccl.reset_launch_counts()
    for name, xs in (("contiguous", x[:, 1:].contiguous()), ("strided rows", x[:, 1:]),
                     ("offset start", x.reshape(-1)[1: 1 + n * size].view(n, size))):
        lane, got = ring_ccl._ag_kernel(xs, 0)
        lane.check("test")
        assert torch.equal(got, ring_ccl.ag_rows_plain(xs)), name
        assert torch.equal(got, _ag_hops(xs, d)), name
        for dirs in ((d,), (1, -1)):
            lane, got = ring_ccl._ar_kernel(xs, dirs, 0)
            lane.check("test")
            assert torch.equal(got, ring_ccl.ar_chain_plain(xs, dirs)), (name, dirs)
            assert torch.equal(got, _ar_hops(xs, dirs)), (name, dirs)
    xs, half = x[:, 1:], size // 2
    ar, ag = xs.new_empty((n, size)), xs.new_empty((n, n, size))
    ag.view(torch.uint8).fill_(0xFF)
    lanes_ = [ring_ccl.launch_ar(xs[:, :half], ar[:, :half], (1,), 0),
              ring_ccl.launch_ar(xs[:, half:], ar[:, half:], (-1,), 1),
              ring_ccl.launch_ag(xs[:, :half], ag[:, :, :half], 2),
              ring_ccl.launch_ag(xs[:, half:], ag[:, :, half:], 3)]
    for lane in lanes_:
        lane.check("test")
    assert torch.equal(ar, torch.cat([ring_ccl.ar_chain_plain(xs[:, :half], (1,)),
                                      ring_ccl.ar_chain_plain(xs[:, half:], (-1,))], 1))
    assert torch.equal(ag, ring_ccl.ag_rows_plain(xs))
    assert _counts() == {"ring_all_gather": 5, "ring_all_reduce": 8}


@pytest.mark.parametrize("verb", ["all_reduce", "all_reduce_1", "bidir_all_reduce",
                                  "all_gather", "bidir_all_gather", "broadcast"])
def test_all_gather_and_all_reduce_allocate_no_scratch(dev, verb):
    """The AR and AG verbs and the broadcast hand B4 and B7 the payload as
    it is: one call allocates its result and nothing else (no padded
    layout, no staging, no halves to concatenate)."""
    n, size = 4, 1 << 20
    x = _x(dev, (n, size), torch.float32, seed=13)
    fn = {"all_reduce": ring_ccl.ring_all_reduce,
          "all_reduce_1": lambda t: ring_ccl.ring_all_reduce(t, bidirectional=False),
          "bidir_all_reduce": ring_ccl.bidir_all_reduce,
          "all_gather": lambda t: ring_ccl.ring_all_gather(t.unsqueeze(1)),
          "bidir_all_gather": lambda t: ring_ccl.bidir_all_gather(t.unsqueeze(1)),
          "broadcast": lambda t: ring_ccl.scatter_ag_broadcast(t, 1)}[verb]
    fn(x)  # the flag regions exist from here on
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ring_ccl.reset_launch_counts()
    got = fn(x)
    torch.cuda.synchronize()
    # a pair's two error words, stacked for one read, take one 512-byte block
    assert torch.cuda.max_memory_allocated(dev) - base <= got.nbytes + 512
    launches = 2 if verb.startswith(("bidir", "broadcast")) else 1
    kernel = "ring_all_reduce" if "reduce" in verb else "ring_all_gather"
    assert _counts() == {kernel: launches}
    want = {"all_reduce": lambda: ring_ccl.ar_chain_plain(x, (1, -1)),
            "all_reduce_1": lambda: ring_ccl.ar_chain_plain(x, (1,)),
            "bidir_all_reduce": lambda: torch.cat(
                [ring_ccl.ar_chain_plain(x[:, :size // 2], (1,)),
                 ring_ccl.ar_chain_plain(x[:, size // 2:], (-1,))], 1),
            "all_gather": lambda: ring_ccl.ag_rows_plain(x).reshape(n, -1),
            "bidir_all_gather": lambda: ring_ccl.ag_rows_plain(x).reshape(n, -1),
            "broadcast": lambda: x[1].expand(n, -1)}[verb]()
    assert torch.equal(got.reshape(want.shape), want)


def test_reduce_scatter_allocates_no_scratch(dev):
    """The RS verb hands B5 the payload as it is: one call allocates its
    [n, per] output and nothing of the [n, n, m] padded layout or the
    ring's scratch."""
    n, per = 4, 1 << 20
    x = _x(dev, (n, n * per), torch.float32, seed=12)
    ring_ccl.ring_reduce_scatter(x)  # the flag region exists from here on
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ring_ccl.reset_launch_counts()
    got = ring_ccl.ring_reduce_scatter(x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base <= got.nbytes
    assert _counts() == {"ring_reduce_scatter": 1}
    assert torch.equal(got, ring_ccl.rs_chain_plain(x))


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


def _launch_all_but_last(name, x, out, streams, dirs, cid, slot_bytes, *, wire_dtype=None,
                         row_elems=0, slot_stride=0, extent=0):
    """``ring_ccl._enqueue`` with the last member left out of the grid: the
    C entry launches members [0, n-1) only."""
    n, t = x.shape[0], lanes.table
    lane = ring_ccl._lane(x.device, cid)
    rc = ring_ccl._lib().uccl_ring_launch(
        ring_ccl._KERNEL_ID[name], ring_ccl._ADD_DTYPES.get(x.dtype, 0),
        ring_ccl._WIRE_ID.get(wire_dtype, 0), n, n - 1, streams, dirs[0], dirs[-1], slot_bytes,
        row_elems, slot_stride, extent, t(x, n), t(out, n), t(lane.flags, n),
        ctypes.c_void_p(lane.err.data_ptr()), cid, lane.next_epoch(),
        lanes.SPIN_TIMEOUT_MS.get() * 1_000_000,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    assert rc == 0
    return lane


def test_missing_member_raises_instead_of_hanging(dev):
    """Launch all but the last member: its peers' waits time out, the
    kernel writes its error word and returns, and the check raises, for all
    five kernels (every member waits on every peer, at entry and at exit,
    so all of them time out; B7 and B8 on both streams). The flag region
    works again afterwards."""
    n, m = 4, 4096
    x = _x(dev, (n, n, m), torch.float32, seed=2)
    rows = x.reshape(n, n * m)
    e = torch.empty_like
    slot = m * 4
    lanes.SPIN_TIMEOUT_MS.set(200)
    try:
        for args, kw in (
                (("ring_reduce_scatter", rows, x.new_empty((n, m)), 1, (1,), 5, slot),
                 dict(row_elems=n * m)),
                (("ring_all_gather", x[:, 0], e(x), 1, (1,), 5, slot),
                 dict(slot_stride=slot, extent=n * slot)),
                (("ring_all_reduce", rows, e(rows), 1, (1,), 5, slot),
                 dict(row_elems=n * m)),
                (("ring_all_reduce", rows, e(rows), 2, (1, -1), 5, slot // 2),
                 dict(row_elems=n * m)),
                (("ring_reduce_scatter_q", rows, x.new_empty((n, m)), 1, (1,), 5, slot),
                 dict(wire_dtype="int8", row_elems=n * m)),
                (("ring_all_reduce_q", rows, e(rows), 1, (1,), 5, slot),
                 dict(wire_dtype="fp8", row_elems=n * m)),
                (("ring_all_reduce_q", rows, e(rows), 2, (1, -1), 5, slot // 2),
                 dict(wire_dtype="int8", row_elems=n * m))):
            lane = _launch_all_but_last(*args, **kw)
            with pytest.raises(RuntimeError, match="timed out"):
                lane.check("test")
    finally:
        lanes.SPIN_TIMEOUT_MS.set(None)
    lane, got = ring_ccl._rs_kernel(rows, 1, 5)
    lane.check("test")
    assert torch.equal(got, ring_ccl.rs_plain(x, 1))
    lane, got = ring_ccl._ar_kernel(rows, (1, -1), 5)
    lane.check("test")
    assert torch.equal(got, ring_ccl.ar_chain_plain(rows, (1, -1)))
    lane, got = ring_ccl._ag_kernel(x[:, 0], 5)
    lane.check("test")
    assert torch.equal(got, ring_ccl.ag_rows_plain(x[:, 0]))
    lane, got = ring_ccl._ar_kernel(rows, (1, -1), 5, "fp8")
    lane.check("test")
    assert _same(got, ring_ccl.ar_q_chain_plain(rows, (1, -1), "fp8"))


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
    # B4 takes rows at any stride, but each row's elements contiguous, and
    # an output of [n, n, per]
    with pytest.raises(ValueError, match="contiguous rows"):
        ring_ccl._ag_kernel(torch.ones(4, 8, 1024, device=dev)[:, :, 0], 0)
    with pytest.raises(ValueError, match="is not"):
        ring_ccl.launch_ag(torch.ones(4, 8, device=dev), torch.empty(4, 4, 9, device=dev), 0)
    # B4 moves bytes of any dtype
    x = torch.arange(4 * 3000, dtype=torch.int64, device=dev).reshape(4, 3000)
    assert torch.equal(ring_ccl.ring_all_gather(x.unsqueeze(1))[3], x)
    # B5 and B6 take the unpadded rows and no scratch: the C entry refuses
    # rows of other than W * per elements and a slot of no whole number of
    # elements, B6 an int32 payload too; B7 and B8 a chunk other than
    # ceil(size / (W * S)) elements. The wrapper refuses an output that
    # does not split the rows.
    xs = torch.ones(4, 4 * 1000, device=dev)
    out = xs.new_empty((4, 1000))
    for name, wd in (("ring_reduce_scatter", None), ("ring_reduce_scatter_q", "fp8")):
        for kw in (dict(row_elems=4 * 1000 + 1), dict(slot_bytes=999 * 4),
                   dict(slot_bytes=3998)):
            args = dict(slot_bytes=1000 * 4, row_elems=4 * 1000) | kw
            with pytest.raises(RuntimeError, match="code -1"):
                ring_ccl._enqueue(name, xs, out, 1, (1,), 0, args["slot_bytes"],
                                  row_elems=args["row_elems"], wire_dtype=wd)
        with pytest.raises(ValueError, match="not 4 slots"):
            ring_ccl.launch_rs(xs, xs.new_empty((4, 999)), 1, 0, wd)
        with pytest.raises(ValueError, match="contiguous rows"):
            ring_ccl.launch_rs(xs[:, ::2], out[:, :500], 1, 0, wd)
    xi = torch.ones(4, 4 * 1000, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="code -1"):
        ring_ccl._enqueue("ring_reduce_scatter_q", xi, xi[:, :1000], 1, (1,), 0, 4000,
                          row_elems=4000, wire_dtype="int8")
    for name, wd in (("ring_all_reduce", None), ("ring_all_reduce_q", "int8")):
        for streams, slot in ((1, 1001 * 4), (2, 1000 * 4)):
            with pytest.raises(RuntimeError, match="code -1"):
                ring_ccl._enqueue(name, xs, torch.empty_like(xs), streams, (1, -1)[:streams], 0,
                                  slot, row_elems=4 * 1000, wire_dtype=wd)


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


def _rs_q_hops(x, d, wd):
    """rs_q_plain on the padded slots, cut back to the payload's."""
    n = x.shape[0]
    chunks, per, m = dma.pad_chunks(x, n)
    return ring_ccl.rs_q_plain(chunks.reshape(n, n, m), d, wd)[:, :per]


def _ar_q_hops(x, dirs, wd):
    """ar_q_plain on the padded slot-major layout, cut back to the payload."""
    view, k, _ = ring_ccl._ar_layout(x, len(dirs))
    return ring_ccl._ar_unlayout(ring_ccl.ar_q_plain(view, dirs, wd), k, x)


@pytest.mark.parametrize("wd", ["fp8", "int8"])
@pytest.mark.parametrize("n,size,dtype,d", QUANT_CASES, ids=lambda v: str(v))
def test_quantized_kernels_equal_plain(dev, n, size, dtype, d, wd):
    """B6 and B8 on the unpadded rows, equal to their contracts and to their
    hop schedules on padded slots; B8's members identical."""
    x = _xq(dev, (n, size), dtype, seed=n)
    ring_ccl.reset_launch_counts()
    xs = x[:, : size - size % n]
    lane, got = ring_ccl._rs_kernel(xs, d, 0, wd)
    lane.check("test")
    assert _same(got, ring_ccl.rs_q_chain_plain(xs, d, wd))
    assert _same(got, _rs_q_hops(xs, d, wd))
    for dirs in ((d,), (1, -1)):
        lane, got = ring_ccl._ar_kernel(x, dirs, 0, wd)
        lane.check("test")
        assert _same(got, ring_ccl.ar_q_chain_plain(x, dirs, wd))
        assert _same(got, _ar_q_hops(x, dirs, wd))
        assert all(_same(got[i], got[0]) for i in range(1, n))
    assert _counts() == {"ring_reduce_scatter_q": 1, "ring_all_reduce_q": 2}


QUANT_RAGGED = [  # (n, elements per slot, dtype, direction): rows off 16 bytes
    (2, 1001, torch.bfloat16, 1),
    (3, 4097, torch.float32, -1),
    (4, 100_003, torch.float32, 1),
    (5, 12_345, torch.float16, 1),
    (8, 30_001, torch.bfloat16, -1),
    (8, 3, torch.float32, 1),
    (7, 9_999, torch.float16, -1),
]


@pytest.mark.parametrize("wd", ["fp8", "int8"])
@pytest.mark.parametrize("n,per,dtype,d", QUANT_RAGGED, ids=lambda v: str(v))
def test_quantized_kernels_on_ragged_rows(dev, n, per, dtype, d, wd):
    """B6 and B8 where slots, chunks and rows start off 16 bytes: on the
    contiguous payload, on rows at a stride one element longer (terms and
    outputs at different offsets) and on a payload starting one element
    in; B8 with one stream and two, and on the halves of one output as the
    bidir pair writes them. Each equal to its contract and its hop
    schedule."""
    x = _xq(dev, (n, n * per + 1), dtype, seed=per)
    size = n * per
    ring_ccl.reset_launch_counts()
    for name, xs in (("contiguous", x[:, 1:].contiguous()), ("strided rows", x[:, 1:]),
                     ("offset start", x.reshape(-1)[1: 1 + n * size].view(n, size))):
        lane, got = ring_ccl._rs_kernel(xs, d, 0, wd)
        lane.check("test")
        assert _same(got, ring_ccl.rs_q_chain_plain(xs, d, wd)), name
        assert _same(got, _rs_q_hops(xs, d, wd)), name
        for dirs in ((d,), (1, -1)):
            lane, got = ring_ccl._ar_kernel(xs, dirs, 0, wd)
            lane.check("test")
            assert _same(got, ring_ccl.ar_q_chain_plain(xs, dirs, wd)), (name, dirs)
            assert _same(got, _ar_q_hops(xs, dirs, wd)), (name, dirs)
    xs, half = x[:, 1:], (size - 1) // 2  # an odd split of the rows
    ar = xs.new_empty((n, size))
    lanes_ = [ring_ccl.launch_ar(xs[:, :half], ar[:, :half], (1,), 0, wd),
              ring_ccl.launch_ar(xs[:, half:], ar[:, half:], (-1,), 1, wd)]
    for lane in lanes_:
        lane.check("test")
    assert _same(ar, torch.cat([ring_ccl.ar_q_chain_plain(xs[:, :half], (1,), wd),
                                ring_ccl.ar_q_chain_plain(xs[:, half:], (-1,), wd)], 1))
    assert _counts() == {"ring_reduce_scatter_q": 3, "ring_all_reduce_q": 8}


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_quantized_kernels_keep_nonfinite_loud_and_zeros_exact(dev, wd):
    """An inf and a nan each poison their own 128-lane block on every
    member (the row's scale becomes +inf: fmaxf alone would drop the nan),
    an all-zero block comes out exactly zero, a denormal block stays
    finite; all of it equal to the contract and the hop schedule, for B8
    and B6."""
    x = _xq(dev, (4, 8192), torch.float32, seed=7)
    x[0, 5], x[1, 300] = float("inf"), float("nan")
    x[:, 1024:1152], x[3, 2048:2176] = 0.0, 1e-42
    lane, out = ring_ccl._ar_kernel(x, (1,), 0, wd)
    lane.check("test")
    assert _same(out, ring_ccl.ar_q_chain_plain(x, (1,), wd))
    assert _same(out, _ar_q_hops(x, (1,), wd))
    assert out[:, :128].isnan().all() and out[:, 256:384].isnan().all()
    assert out[:, 128:256].isfinite().all() and out[:, 384:].isfinite().all()
    assert (out[:, 1024:1152] == 0).all()
    lane, out = ring_ccl._rs_kernel(x, -1, 0, wd)
    lane.check("test")
    assert _same(out, ring_ccl.rs_q_chain_plain(x, -1, wd))
    assert _same(out, _rs_q_hops(x, -1, wd))
    # the owner's own term, member 0's inf among it, is added after the
    # chain's last round trip: the nan row is poisoned, the inf stays put
    assert out[0, 256:384].isnan().all() and torch.isinf(out[0, 5])
    assert (out[0, 1024:1152] == 0).all() and out[1:].isfinite().all()


@pytest.mark.parametrize("verb", ["all_reduce", "all_reduce_1", "bidir_all_reduce",
                                  "reduce_scatter"])
def test_quantized_verbs_allocate_no_scratch(dev, verb):
    """The quantized AR and RS verbs hand B8 and B6 the payload as it is:
    one call allocates its result and nothing else (no padded layout, no
    staging, no gather buffers, no halves to concatenate), and launches as
    many kernels as before."""
    n, size = 4, 1 << 20
    x = _xq(dev, (n, size), torch.float32, seed=14)
    fn = {"all_reduce": lambda t: ring_ccl.ring_all_reduce(t, wire_dtype="fp8"),
          "all_reduce_1": lambda t: ring_ccl.ring_all_reduce(t, bidirectional=False,
                                                             wire_dtype="int8"),
          "bidir_all_reduce": lambda t: ring_ccl.bidir_all_reduce(t, wire_dtype="fp8"),
          "reduce_scatter": lambda t: ring_ccl.ring_reduce_scatter(t, wire_dtype="int8")}[verb]
    fn(x)  # the flag regions exist from here on
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ring_ccl.reset_launch_counts()
    got = fn(x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base <= got.nbytes + 512
    kernel = "ring_reduce_scatter_q" if verb == "reduce_scatter" else "ring_all_reduce_q"
    assert _counts() == {kernel: 2 if verb.startswith("bidir") else 1}
    want = {"all_reduce": lambda: ring_ccl.ar_q_chain_plain(x, (1, -1), "fp8"),
            "all_reduce_1": lambda: ring_ccl.ar_q_chain_plain(x, (1,), "int8"),
            "bidir_all_reduce": lambda: torch.cat(
                [ring_ccl.ar_q_chain_plain(x[:, :size // 2], (1,), "fp8"),
                 ring_ccl.ar_q_chain_plain(x[:, size // 2:], (-1,), "fp8")], 1),
            "reduce_scatter": lambda: ring_ccl.rs_q_chain_plain(x, 1, "int8")}[verb]()
    assert _same(got, want)


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
