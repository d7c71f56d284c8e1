"""The port's CUDA EP all-to-all kernels (B9 and B10 in
uccl_tpu_torch/csrc/ep_a2a.cu) against their plain versions, on the card.

Every test here needs an NVIDIA Hopper GPU and ``nvcc``; without a GPU each
skips. This file imports neither jax nor the JAX package, so it runs alone,
past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ep.py

Tolerance: none. Both kernels copy bytes, so each must equal its plain
version and ``x.transpose(0, 1)`` bit for bit (``torch.equal`` on the
bytes), for every payload dtype: bf16, f32, int32, and the quantized wire's
1-byte payloads and f32 scales.
"""

import ctypes

import numpy as np
import pytest
import torch

from uccl_tpu_torch.collective import dma, lanes
from uccl_tpu_torch.ep import Buffer, a2a_sched, ops, pallas_a2a
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _x(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype in (torch.uint8, torch.int32):
        return torch.randint(-(2 ** 30) if dtype == torch.int32 else 0,
                             2 ** 30 if dtype == torch.int32 else 256, shape, generator=g,
                             device=dev, dtype=dtype)
    x = torch.randn(shape, generator=g, device=dev)
    return x.to(dtype)


def _bytes_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


CASES = [  # (n, per-member trailing shape, dtype)
    (2, (3, 1000), torch.float32),
    (3, (5, 777), torch.bfloat16),
    (4, (2, 2560, 64), torch.bfloat16),
    (5, (7, 333), torch.int32),
    (8, (1, 4096), torch.float8_e4m3fn),
    (8, (4, 100), torch.int8),
    (16, (3, 129), torch.float32),
]


@pytest.mark.parametrize("n,shape,dtype", CASES, ids=lambda v: str(v))
def test_kernels_equal_plain_and_transpose(dev, n, shape, dtype):
    x = _x(dev, (n, n) + shape, torch.float32 if dtype.itemsize == 1 else dtype, seed=n)
    if dtype.itemsize == 1:
        x = (x * 40).to(dtype)
    want = x.transpose(0, 1)
    xb, _ = pallas_a2a._as_bytes(x)
    view, _, _ = pallas_a2a._view(xb)
    pallas_a2a.reset_launch_counts()
    # B9
    out = torch.empty_like(view)
    pallas_a2a.launch_a2a(view, out, 6).check("test")
    assert torch.equal(out, pallas_a2a.a2a_plain(view))
    assert _bytes_equal(pallas_a2a.all_to_all(x), want)
    # B10, every round of a uniform and a skewed schedule, into one
    # sentinel-filled receive buffer: after each round it equals the plain
    # round on the same buffer, so each pair is written in its designated
    # round only, and a shadow duplicate leaves its slot alone
    sentinel = torch.full_like(view, 0x5A)
    for mat in (np.ones((n, n)), a2a_sched.traffic_from_topk(
            a2a_sched.zipf_topk(np.random.default_rng(n), n, 64, 2, 2 * n, 1.2), 2 * n, 9, n)):
        rounds, k_mat = a2a_sched.wire_schedule(mat, n)
        perms = [r.perm for r in rounds]
        got, plain = sentinel.clone(), sentinel.clone()
        for k, pi in enumerate(perms):
            send, local = pallas_a2a.round_bits(perms, k_mat, k)
            pallas_a2a.launch_sched_round(view, got, pi, send, local, 22).check("test")
            pallas_a2a.sched_round_plain(view, plain, pi, send, local)
            assert torch.equal(got, plain), k
        assert torch.equal(got, view.transpose(0, 1).contiguous())
        assert _bytes_equal(pallas_a2a.scheduled_all_to_all(x, (rounds, k_mat)), want)
    assert pallas_a2a.launch_counts["a2a"] == 2


def test_round_with_a_wrong_send_bit_is_caught(dev):
    """A round launched with one due pair's send bit cleared leaves that
    slot as the sentinel, and one with a shadow duplicate's bit set writes a
    slot the plain round leaves alone: both differ from the plain round."""
    n = 4
    view = _x(dev, (n, n, 8, 128), torch.float32, seed=5)
    idx = a2a_sched.zipf_topk(np.random.default_rng(4), n, 64, 2, 2 * n, 1.2)
    rounds, k_mat = a2a_sched.wire_schedule(a2a_sched.traffic_from_topk(idx, 2 * n, 12, n), n)
    perms = [r.perm for r in rounds]
    fill = torch.full_like(view, float("nan"))
    checked = 0
    for k, pi in enumerate(perms):
        send, local = pallas_a2a.round_bits(perms, k_mat, k)
        plain = pallas_a2a.sched_round_plain(view, fill.clone(), pi, send, local)
        for r in range(n):
            if pi[r] == r:
                continue
            wrong = tuple(due != (m == r) for m, due in enumerate(send))
            got = fill.clone()
            pallas_a2a.launch_sched_round(view, got, pi, wrong, local, 23).check("test")
            assert not _bytes_equal(got, plain), (k, r, send[r])
            checked += 1
    assert checked >= 8


@pytest.mark.parametrize("n_chunks", [2, 3, 8])
def test_chunked_and_scheduled_chunked_equal_transpose(dev, n_chunks):
    n = 4
    x = _x(dev, (n, n, 2, 37, 96), torch.bfloat16, seed=n_chunks)
    pallas_a2a.reset_launch_counts()
    assert torch.equal(pallas_a2a.all_to_all(x, n_chunks=n_chunks, chunk_axis=2),
                       x.transpose(0, 1))
    sched = a2a_sched.wire_schedule(np.ones((n, n)), n)
    assert torch.equal(pallas_a2a.scheduled_all_to_all(x, sched, n_chunks=n_chunks,
                                                       chunk_axis=2), x.transpose(0, 1))
    assert pallas_a2a.launch_counts == {"a2a": n_chunks,
                                        "sched_round": n_chunks * len(sched[0])}


def test_repeated_calls_on_one_flag_region(dev):
    """Epochs: many launches on one collective id, alternating worlds and
    sizes, stay right (a stale flag would let a wait through)."""
    for i in range(24):
        n = 3 + i % 3
        x = _x(dev, (n, n, 1 + i % 4, 2048), torch.float32, seed=i)
        assert torch.equal(pallas_a2a.all_to_all(x, collective_id=6), x.transpose(0, 1)), i


def test_buffer_verbs_on_the_card_equal_the_cpu(dev):
    """The Buffer verbs on CUDA tensors (the kernels) against the same
    calls on CPU tensors (the plain versions): dispatch bit for bit on every
    wire, combine within the reordered sum's tolerance."""
    rng = np.random.default_rng(0)
    w, t, h, e, k = 4, 64, 256, 8, 2
    x = torch.tensor(rng.standard_normal((w, t, h)), dtype=torch.bfloat16)
    idx = torch.tensor(np.argsort(rng.random((w, t, e)), -1)[..., :k].astype(np.int32))
    outs = {}
    for device in ("cpu", "cuda"):
        buf = Buffer(make_mesh(MeshConfig(dp=w), device=device), "dp", num_experts=e,
                     wire="pallas", n_chunks=2, a2a_sched="on",
                     a2a_traffic=a2a_sched.traffic_from_topk(idx.numpy(), e, 16, w))
        recv, handle = buf.dispatch(x, idx, wire_dtype="fp8")
        outs[device] = (recv.cpu(), buf.combine(recv, handle).cpu(), handle.recv_counts.cpu())
        r_x, counts, llh = buf.low_latency_dispatch(x, idx, t, wire="pallas")
        outs[device] += (r_x.cpu(), counts.cpu())
    a, b = outs["cpu"], outs["cuda"]
    for i in (0, 2, 3, 4):
        assert torch.equal(a[i], b[i]), i
    torch.testing.assert_close(a[1].float(), b[1].float(), rtol=1e-2, atol=1e-2)


def test_async_finish_leaves_the_check_to_the_event(dev):
    """With ``async_finish`` a verb does not wait for its error words: its
    EventOverlap carries the read, and ``synchronize()`` resolves it. The
    results equal the waiting verbs' bit for bit."""
    rng = np.random.default_rng(1)
    w, t, h, e, k = 4, 64, 256, 8, 2
    x = torch.tensor(rng.standard_normal((w, t, h)), dtype=torch.bfloat16, device=dev)
    idx = torch.tensor(np.argsort(rng.random((w, t, e)), -1)[..., :k].astype(np.int32),
                       device=dev)
    buf = Buffer(make_mesh(MeshConfig(dp=w), device="cuda"), "dp", num_experts=e,
                 wire="pallas", n_chunks=2)
    recv, handle = buf.dispatch(x, idx)
    want = buf.combine(recv, handle)
    recv2, handle2, ev = buf.dispatch(x, idx, async_finish=True)
    assert ev.pending is not None
    ev.current_stream_wait()
    out, ev2 = buf.combine(recv2, handle2, previous_event=ev, async_finish=True)
    ev2.synchronize()
    ev.synchronize()
    assert not lanes._pending
    assert torch.equal(recv2, recv) and torch.equal(out, want)


def test_cuda_tensors_ignore_the_budget(dev):
    x = _x(dev, (4, 4, 3, 3000), torch.float32, seed=6)
    dma.MAX_ARENA_BYTES.set(64)
    try:
        fb = dma.WIRE_FALLBACK.total()
        pallas_a2a.reset_launch_counts()
        assert torch.equal(pallas_a2a.all_to_all(x, n_chunks=3, chunk_axis=1),
                           x.transpose(0, 1))
        assert torch.equal(pallas_a2a.scheduled_all_to_all(
            x, a2a_sched.wire_schedule(np.ones((4, 4)), 4)), x.transpose(0, 1))
        assert ops.resolve_chunks(0, "pallas", 4, 2560, 2, 1024, 2, device=dev) == 8
        assert dma.WIRE_FALLBACK.total() == fb
        assert pallas_a2a.launch_counts == {"a2a": 3, "sched_round": 3}
    finally:
        dma.MAX_ARENA_BYTES.set(None)


def _launch_all_but_last(kernel, view, out, pi, cid):
    """``pallas_a2a._launch`` with the last member left out of the grid: the
    C entry launches members [0, n-1) only (B10 as round 0 with every pair
    due)."""
    if kernel == 0:
        return pallas_a2a._launch("a2a", view, out, cid, live=view.shape[0] - 1)
    return pallas_a2a._launch("sched_round", view, out, cid, pi=pi,
                              send=[d != r for r, d in enumerate(pi)], local=True,
                              live=view.shape[0] - 1)


def test_missing_member_raises_instead_of_hanging(dev):
    """Launch all but the last member: the others' entry barriers time out,
    the kernel writes its error word and returns, and the check raises, for
    both kernels. The flag region works again afterwards."""
    n = 4
    x = _x(dev, (n, n, 4096), torch.float32, seed=2)
    view = x.reshape(n, n, 32, 128)
    lanes.SPIN_TIMEOUT_MS.set(200)
    try:
        lane = _launch_all_but_last(0, view, torch.empty_like(view), None, 7)
        with pytest.raises(RuntimeError, match="timed out"):
            lane.check("test")
        lane = _launch_all_but_last(1, view, torch.empty_like(view), (1, 2, 3, 0), 7)
        with pytest.raises(RuntimeError, match="timed out"):
            lane.check("test")
    finally:
        lanes.SPIN_TIMEOUT_MS.set(None)
    assert torch.equal(pallas_a2a.all_to_all(x, collective_id=7), x.transpose(0, 1))


def test_missing_member_raises_at_the_scope_end(dev):
    """Inside ``lanes.one_check`` a timed-out launch raises when the scope
    closes, after the launches that follow it; without a wait
    (``blocking=False``) its ``Pending`` raises on ``resolve()``, and an
    unresolved one raises at the next blocking check."""
    n = 4
    x = _x(dev, (n, n, 4096), torch.float32, seed=4)
    view = x.reshape(n, n, 32, 128)
    lanes.SPIN_TIMEOUT_MS.set(200)
    try:
        with pytest.raises(RuntimeError, match="timed out"):
            with lanes.one_check():
                _launch_all_but_last(0, view, torch.empty_like(view), None, 11).check("test")
                assert torch.equal(pallas_a2a.all_to_all(x, collective_id=12),
                                   x.transpose(0, 1))
        with lanes.one_check(blocking=False) as scope:
            _launch_all_but_last(0, view, torch.empty_like(view), None, 11).check("test")
        with pytest.raises(RuntimeError, match="timed out"):
            scope.pending.resolve()
        with lanes.one_check(blocking=False) as scope:
            _launch_all_but_last(1, view, torch.empty_like(view), (1, 2, 3, 0),
                                 11).check("test")
        assert scope.pending is not None
        with pytest.raises(RuntimeError, match="timed out"):
            pallas_a2a.all_to_all(x, collective_id=12)  # a blocking check resolves it
    finally:
        lanes.SPIN_TIMEOUT_MS.set(None)
    assert torch.equal(pallas_a2a.all_to_all(x, collective_id=11), x.transpose(0, 1))


def test_bad_arguments_are_refused(dev):
    lib = pallas_a2a._lib()
    n = 4
    view = _x(dev, (n, n, 8, 128), torch.float32, seed=3)
    lane = pallas_a2a._lane(view.device, 9)
    tab = lanes.table
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(kernel, nn, slot_bytes, pi, send=0, drop=-1):
        perm = None if pi is None else (ctypes.c_int * nn)(*pi)
        return lib.uccl_a2a_launch(kernel, nn, nn, slot_bytes, tab(view, n),
                                   tab(torch.empty_like(view), n), tab(lane.flags, n),
                                   ctypes.c_void_p(lane.err.data_ptr()), perm, send, 0, drop, 9,
                                   1, 10 ** 9, stream)

    assert call(0, 1, 4096, None) == -1  # world 1
    assert call(0, 17, 4096, None) == -1  # past kMaxMembers
    assert call(0, 4, 4100, None) == -1  # not whole 16-byte vectors
    assert call(1, 4, 4096, None) == -1  # a round with no permutation
    assert call(1, 4, 4096, (0, 0, 1, 2)) == -1  # not a permutation
    assert call(1, 4, 4096, (1, 0, 2, 3), send=0b0100) == -1  # a self-loop sent
    assert call(1, 4, 4096, (1, 0, 3, 2), send=0b10000) == -1  # a send bit past the world
    assert call(0, 4, 4096, None, drop=5) == -1  # B9 cannot drop the diagonal pair (1, 1)
    assert call(0, 4, 4096, None, drop=16) == -1  # a pair past the world
    assert call(1, 4, 4096, (1, 0, 3, 2), drop=1) == -1  # only B9 drops an arrival
    out = (ctypes.c_int * 3)()
    assert lib.uccl_a2a_grid(1, 4096, 0, out) == -1
    assert lib.uccl_a2a_grid(4, 4100, 0, out) == -1
    with pytest.raises(ValueError):
        pallas_a2a.launch_a2a(view, torch.empty_like(view).float().double(), 9)


# ---------------------------------------------------------------------------
# B9's pair grid

SERVING_SHAPES = {  # the serving drives' f32 exchanges, member-stacked
    "decode": (4, 4, 4, 1024),
    "verify": (4, 4, 2, 6, 1024),
    "chunk prefill": (4, 4, 2, 128, 1024),
}


@pytest.mark.parametrize("kind", list(SERVING_SHAPES))
def test_b9_at_the_serving_shapes(dev, kind):
    x = _x(dev, SERVING_SHAPES[kind], torch.float32, seed=len(kind))
    view, _, _ = pallas_a2a._view(x)
    out = torch.full_like(view, float("nan"))
    pallas_a2a.launch_a2a(view, out, 6).check("test")
    assert torch.equal(out, pallas_a2a.a2a_plain(view))
    assert torch.equal(out, view.transpose(0, 1).contiguous())
    assert torch.equal(pallas_a2a.all_to_all(x), x.transpose(0, 1))


# slots in 16-byte vectors: one vector, a few, around one least piece, odd
# counts that cross the split into pieces and blocks
SLOT_VECS = (1, 3, 511, 513, 4097, 33_333)


@pytest.mark.parametrize("n", list(range(2, 17)))
def test_b9_worlds_and_slot_sizes(dev, n):
    grid_p = set()
    for vecs in SLOT_VECS:
        view = _x(dev, (n, n, vecs, 4), torch.int32, seed=n * vecs)
        out = torch.full_like(view, -1)
        pallas_a2a.launch_a2a(view, out, 6).check("test")
        assert torch.equal(out, pallas_a2a.a2a_plain(view)), vecs
        assert torch.equal(out, view.transpose(0, 1).contiguous()), vecs
        p, x, blocks = pallas_a2a.kernel_grid(n, vecs * 16)
        assert (p, x) == pallas_a2a.pair_grid(n, vecs * 16, blocks)
        assert torch.equal(out, pallas_a2a.a2a_plain(view, pieces=p))
        grid_p.add(p)
    if blocks // (2 * n) // n > 1:  # half the card holds 2 pieces of every pair
        assert max(grid_p) > 1  # some slot crossed the split into pieces


def test_b9_grid_matches_its_mirror(dev):
    """The built kernel's grid equals pallas_a2a.pair_grid on cards of any
    size; on this one, the launch takes at most half of it."""
    for n in (2, 3, 4, 8, 13, 16):
        for slot_bytes in (16, 4096, 16384, 49152, 1 << 20, 10_485_760):
            for blocks in (1, 7, 100, 264, 528, 1056, 2112):
                p, x, b = pallas_a2a.kernel_grid(n, slot_bytes, blocks)
                assert b == blocks and (p, x) == pallas_a2a.pair_grid(n, slot_bytes, blocks)
            p, x, b = pallas_a2a.kernel_grid(n, slot_bytes)
            assert x * n <= max(n, b // 2) and 1 <= p <= x <= lanes.MAX_CHANNELS


def test_b9_repeated_calls_across_epochs_and_grids(dev):
    """One flag region, many launches whose grids differ (pieces 1 to 16,
    worlds 2 to 16): a word left by an earlier launch never lets a wait of
    a later one through."""
    for i in range(40):
        n = (2, 4, 16, 3, 4)[i % 5]
        vecs = (1, 1024, 3000, 65_536, 77)[i % 5 if n != 16 else 0] + i
        view = _x(dev, (n, n, vecs, 4), torch.int32, seed=i)
        out = torch.full_like(view, -1)
        pallas_a2a.launch_a2a(view, out, 14).check("test")
        assert torch.equal(out, view.transpose(0, 1).contiguous()), i


def test_b9_parity_twins_in_flight_on_two_streams(dev):
    """Two chunk launches on collective-id parity twins, on two streams at
    once (each takes at most half the card, so both are resident), each
    bit-identical, many times over."""
    n = 4
    views = [_x(dev, (n, n, 2, 1280, 1024), torch.bfloat16, seed=c) for c in (0, 1)]
    outs = [torch.empty_like(v) for v in views]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize(dev)
    got = []
    for _ in range(8):
        for c in (0, 1):
            with torch.cuda.stream(streams[c]):
                got.append(pallas_a2a.launch_a2a(views[c], outs[c],
                                                 dma.chunk_collective_id(dma.CID_EP_DISPATCH, c)))
    torch.cuda.synchronize(dev)
    for lane in got:
        lane.check("test")
    for v, o in zip(views, outs):
        assert torch.equal(o, v.transpose(0, 1).contiguous())


def test_b9_missing_arrival_times_out(dev):
    """A planted fault of the new protocol: pair (1, 3)'s piece 0 is copied
    but its arrival word is never raised. Member 3's exit wait on that piece
    times out through the error word (the receive wait, member 3, waiting on
    member 1), the launch returns, and the region works again afterwards."""
    n = 4
    x = _x(dev, (n, n, 2, 1024), torch.float32, seed=8)
    view = x.reshape(n, n, 16, 128)
    lanes.SPIN_TIMEOUT_MS.set(200)
    try:
        lane = pallas_a2a._launch("a2a", view, torch.empty_like(view), 15, drop=(1, 3))
        with pytest.raises(RuntimeError, match=r"receive wait \(member 3, .* member 1,"):
            lane.check("test")
    finally:
        lanes.SPIN_TIMEOUT_MS.set(None)
    assert torch.equal(pallas_a2a.all_to_all(x, collective_id=15), x.transpose(0, 1))
