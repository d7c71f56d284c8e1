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
    n, t = view.shape[0], lanes.table
    lane = pallas_a2a._lane(view.device, cid)
    perm = None if pi is None else (ctypes.c_int * n)(*pi)
    send = 0 if pi is None else sum(1 << r for r, d in enumerate(pi) if d != r)
    rc = pallas_a2a._lib().uccl_a2a_launch(
        kernel, n, n - 1, view[0, 0].numel() * view.element_size(), t(view, n), t(out, n),
        t(lane.flags, n), ctypes.c_void_p(lane.err.data_ptr()), perm, send, 1, cid,
        lane.next_epoch(),
        lanes.SPIN_TIMEOUT_MS.get() * 1_000_000,
        ctypes.c_void_p(torch.cuda.current_stream(view.device).cuda_stream))
    assert rc == 0
    return lane


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

    def call(kernel, nn, slot_bytes, pi, send=0):
        perm = None if pi is None else (ctypes.c_int * nn)(*pi)
        return lib.uccl_a2a_launch(kernel, nn, nn, slot_bytes, tab(view, n),
                                   tab(torch.empty_like(view), n), tab(lane.flags, n),
                                   ctypes.c_void_p(lane.err.data_ptr()), perm, send, 0, 9, 1,
                                   10 ** 9, stream)

    assert call(0, 1, 4096, None) == -1  # world 1
    assert call(0, 17, 4096, None) == -1  # past kMaxMembers
    assert call(0, 4, 4100, None) == -1  # not whole 16-byte vectors
    assert call(1, 4, 4096, None) == -1  # a round with no permutation
    assert call(1, 4, 4096, (0, 0, 1, 2)) == -1  # not a permutation
    assert call(1, 4, 4096, (1, 0, 2, 3), send=0b0100) == -1  # a self-loop sent
    assert call(1, 4, 4096, (1, 0, 3, 2), send=0b10000) == -1  # a send bit past the world
    with pytest.raises(ValueError):
        pallas_a2a.launch_a2a(view, torch.empty_like(view).float().double(), 9)
