"""Device-level ring collectives: hand-written CUDA kernels on member-stacked tensors.

Port of ``uccl_tpu/collective/pallas_ccl.py``, full-precision wire. Its
Pallas remote-DMA kernels become three CUDA kernels in
``csrc/ring_ccl.cu``, built with ``nvcc`` for ``sm_90a`` at first use and
called through ctypes:

* ``ring_all_gather`` (B4, replaces ``_ag_ring``): write-once ring
  all-gather; backs :func:`ring_all_gather`, :func:`bidir_all_gather` and
  :func:`scatter_ag_broadcast`.
* ``ring_reduce_scatter`` (B5): partial sums circulate through 2-slot
  staging; member r keeps slot r summed.
* ``ring_all_reduce`` (B7): RS phase, phase barrier, AG phase in one
  launch, on one or two counter-rotating streams; backs
  :func:`ring_all_reduce` and, as a pair of directed launches on two CUDA
  streams, :func:`bidir_all_reduce`.

Buffer model: where a JAX function takes one shard's ``x`` inside
``shard_map``, its port takes the member-stacked tensor ``[world, ...]``
whose row r is member r's shard, and returns the members' results stacked
the same way. One launch runs all members (see the CUDA source for the
address table, flags and epochs). On one card a hop is an HBM-to-HBM store.

Beside each kernel is its plain version (``*_plain``): the same hop schedule
on the member-stacked tensor — the same slot order, the same per-hop add in
the input dtype — so it is bit-identical to the kernel and to the JAX
kernels. A wrapper runs it for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises, and raises if a kernel reports a spin-wait
timeout. ``launch_counts`` counts kernel launches.

On a CPU tensor over the arena budget (``dma.MAX_ARENA_BYTES``), a wrapper
falls back to the plan lowering (``plan.py``), counted on
``ep_wire_fallback_total`` and logged, as in the JAX package; on a CUDA
tensor it launches its kernel at every size. Wire bytes per member land on
``ep_bytes_total{verb, wire, wire_dtype}`` per call. A ``wire_dtype``
other than None raises ``NotImplementedError``: the quantized kernels B6
and B8 are the next slice.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.utils.config import param

LANES = _dma.LANES

KERNELS = ("ring_all_gather", "ring_reduce_scatter", "ring_all_reduce")
launch_counts = {name: 0 for name in KERNELS}
_KERNEL_ID = {"ring_all_gather": 0, "ring_reduce_scatter": 1, "ring_all_reduce": 2}
# dtypes the reducing kernels (B5, B7) add in; B4 moves bytes of any dtype
_ADD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}
MAX_MEMBERS = 16  # kMaxMembers in the source
_MAX_CHANNELS = 64  # kMaxChannels
_FLAG_WORDS = 4  # kFlagWords
_WAITS = ("entry barrier", "credit", "receive", "phase barrier")

SPIN_TIMEOUT_MS = param(
    "RING_SPIN_TIMEOUT_MS", 10000, int,
    "bound on any one spin-wait of the ring kernels; a wait past it writes "
    "the kernel's error word and the wrapper raises",
)

_WIRE_BYTES = _obsc.counter(
    "ep_bytes_total",
    "actual wire bytes moved by EP verbs and ring collectives (quantized "
    "payload + f32 scale sidecar when a wire_dtype applies, raw element "
    "bytes otherwise), by verb, wire, and wire_dtype",
)


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _count_wire_bytes(verb: str, wire: str, wire_dtype, nbytes: int) -> None:
    """Tally one call's per-member wire bytes."""
    _WIRE_BYTES.inc(nbytes, verb=verb, wire=wire, wire_dtype=wire_dtype or "none")


def _is_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"ring collectives: tensor on {x.device} (want cpu or cuda)")


def _over_budget(x: torch.Tensor, charge: int, what: str) -> bool:
    """True when a CPU payload's charge exceeds the arena budget (the gate
    counts and logs it): the wrapper then takes the plan lowering, as the
    JAX package does past its VMEM ceiling. A CUDA tensor never falls back:
    the kernels' buffers are allocated per call and their slot sizes are
    64-bit, so they take every size."""
    return _is_cpu(x) and not _dma.check_budget(charge, what)


# ---------------------------------------------------------------------------
# Charges: what one kernel holds in each member's arena, the arithmetic of
# the JAX package's gates (pallas_ccl.py:929-975) on the full-precision
# wire. Shared by the wrappers' gates and the planner's quiet probes.


def rs_charge(nelems: int, itemsize: int, n: int) -> int:
    """Charge of ONE reduce-scatter kernel on a flat ``nelems`` payload."""
    del n  # full precision: the accumulator alone
    return nelems * itemsize


def ag_charge(nelems: int, itemsize: int, n: int) -> int:
    """Charge of ONE all-gather kernel on a contributed ``nelems`` payload:
    the gathered buffer."""
    return n * nelems * itemsize


def bidir_pair_charge(nelems: int, itemsize: int, n: int) -> int:
    """Charge of the bidir all-reduce pair: both kernels fly at once, so
    their halves' charges add."""
    half = nelems // 2
    return sum(h * itemsize for h in (half, nelems - half))


def ag_pair_charge(nelems: int, itemsize: int, n: int) -> int:
    """Charge of the counter-rotating all-gather pair: the halves' sum."""
    half = nelems // 2
    halves = (half, nelems - half) if half else (nelems,)
    return sum(ag_charge(h, itemsize, n) for h in halves)


def bcast_pair_charge(nelems: int, itemsize: int, n: int) -> int:
    """Charge of the scatter-allgather broadcast: the AG pair over ONE
    padded S/n chunk."""
    m = _dma.padded_chunk_elems(-(-nelems // n))
    return ag_pair_charge(m, itemsize, n)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' hop schedules on member-stacked tensors


def ag_plain(chunk: torch.Tensor, direction: int = 1) -> torch.Tensor:
    """B4's function. ``chunk`` ``[n, m]`` (member r's contribution in row
    r) → ``[n, n, m]``: each member's gathered slots. Step s: member r
    sends slot (r - d*s) mod n into the same slot of its right neighbor."""
    n = chunk.shape[0]
    r = torch.arange(n, device=chunk.device)
    buf = chunk.new_zeros((n,) + tuple(chunk.shape))
    buf[r, r] = chunk
    _ag_hops(buf, direction)
    return buf


def _rs_hops(buf: torch.Tensor, direction: int) -> None:
    """The RS phase in place on ``buf`` ``[n, n, m]``: step s, member r
    sends slot (r - d(s+1)) mod n, and its right neighbor adds it into the
    same slot index, (right - d(s+2)) mod n, in the input dtype."""
    n = buf.shape[0]
    r = torch.arange(n, device=buf.device)
    right = (r + direction) % n
    for s in range(n - 1):
        send = (r - direction * (s + 1)) % n
        arrived = buf[r, send].clone()
        buf[right, send] = buf[right, send] + arrived


def _ag_hops(buf: torch.Tensor, direction: int) -> None:
    """The AG phase in place on ``buf`` ``[n, n, m]`` (member r owns slot r)."""
    n = buf.shape[0]
    r = torch.arange(n, device=buf.device)
    right = (r + direction) % n
    for s in range(n - 1):
        send = (r - direction * s) % n
        buf[right, send] = buf[r, send].clone()


def rs_plain(chunks: torch.Tensor, direction: int = 1) -> torch.Tensor:
    """B5's function. ``chunks`` ``[n, n, m]`` → ``[n, m]``: member r's
    slot r, summed around the ring."""
    n = chunks.shape[0]
    buf = chunks.clone()
    _rs_hops(buf, direction)
    r = torch.arange(n, device=chunks.device)
    return buf[r, r]


def ar_plain(view: torch.Tensor, dirs: Sequence[int]) -> torch.Tensor:
    """B7's function. ``view`` ``[n, n, S, m]`` (slot-major, then stream)
    → the same layout, every slot summed on every member; stream h rings in
    direction ``dirs[h]``."""
    buf = view.clone()
    for h, d in enumerate(dirs):
        stream = buf[:, :, h]  # a view: the hops write into buf
        _rs_hops(stream, d)
        _ag_hops(stream, d)
    return buf


# ---------------------------------------------------------------------------
# The library and the arena


@functools.cache
def _lib() -> ctypes.CDLL:
    from uccl_tpu_torch.utils import build

    lib = build.load("ring_ccl")
    i, p = ctypes.c_int, ctypes.c_void_p
    tab = ctypes.POINTER(ctypes.c_void_p)
    lib.uccl_ring_launch.argtypes = [i, i, i, i, i, i, i, ctypes.c_longlong,
                                     tab, tab, tab, tab, tab, p, i,
                                     ctypes.c_ulonglong, ctypes.c_ulonglong, p]
    lib.uccl_ring_launch.restype = i
    for name in ("uccl_ring_max_members", "uccl_ring_max_channels", "uccl_ring_flag_words"):
        getattr(lib, name).restype = i
    limits = (lib.uccl_ring_max_members(), lib.uccl_ring_max_channels(),
              lib.uccl_ring_flag_words())
    if limits != (MAX_MEMBERS, _MAX_CHANNELS, _FLAG_WORDS):
        raise RuntimeError(f"csrc/ring_ccl.cu limits {limits} disagree with ring_ccl.py")
    return lib


class _Lane:
    """The flag region of one collective id on one device: each member's
    flag words and the region's error word, both zeroed once, and the epoch
    counter that makes every launch's flag values larger than any earlier
    launch's."""

    def __init__(self, device: torch.device, cid: int):
        self.cid = cid
        self.flags = torch.zeros((MAX_MEMBERS, 2, _MAX_CHANNELS, _FLAG_WORDS),
                                 dtype=torch.int64, device=device)
        self.err = torch.zeros(8, dtype=torch.int32, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch >= 1 << 31:
            raise RuntimeError(f"collective id {self.cid}: epoch counter exhausted")
        return self.epoch

    def check(self, what: str) -> None:
        """Raise if a launch on this region reported a spin-wait timeout
        (reads the error word: waits for the current stream)."""
        word = self.err.tolist()
        if word[0]:
            self.err.zero_()
            kernel = KERNELS[word[1]] if 0 <= word[1] < len(KERNELS) else word[1]
            wait = _WAITS[word[7]] if 0 <= word[7] < len(_WAITS) else word[7]
            raise RuntimeError(
                f"{what}: kernel {kernel} timed out after {SPIN_TIMEOUT_MS.get()} ms in its "
                f"{wait} wait (member {word[2]}, step {word[3]}, collective id {word[4]}, "
                f"stream {word[5]}, channel {word[6]}); a peer never signalled"
            )


_lanes: Dict[Tuple[int, int], _Lane] = {}
_side_streams: Dict[int, torch.cuda.Stream] = {}
_arena_lock = threading.Lock()


def _lane(device: torch.device, cid: int) -> _Lane:
    with _arena_lock:
        key = (device.index, cid)
        lane = _lanes.get(key)
        if lane is None:
            lane = _lanes[key] = _Lane(device, cid)
        return lane


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    with _arena_lock:
        s = _side_streams.get(device.index)
        if s is None:
            s = _side_streams[device.index] = torch.cuda.Stream(device)
        return s


def _table(t: Optional[torch.Tensor], n: int):
    arr = (ctypes.c_void_p * n)()
    if t is not None:
        step = t.stride(0) * t.element_size()
        for r in range(n):
            arr[r] = t.data_ptr() + r * step
    return arr


def _check_operands(name: str, dtype: torch.dtype, *ts: torch.Tensor) -> None:
    n = ts[0].shape[0]
    if not 2 <= n <= MAX_MEMBERS:
        raise ValueError(f"{name}: world {n} outside 2..{MAX_MEMBERS}")
    if name != "ring_all_gather" and dtype not in _ADD_DTYPES:
        raise TypeError(f"{name} on CUDA adds in {sorted(map(str, _ADD_DTYPES))}; got {dtype}")
    dev = ts[0].device
    for t in ts:
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous, 16-byte aligned, on {dev}")


def _launch(name: str, x: torch.Tensor, buf: torch.Tensor, stage: Optional[torch.Tensor],
            out: Optional[torch.Tensor], streams: int, dirs: Sequence[int], cid: int,
            slot_bytes: int) -> _Lane:
    """Launch one kernel on the current stream; no sync and no error check
    (the caller checks the returned lane)."""
    operands = [t for t in (x, buf, stage, out) if t is not None]
    _check_operands(name, x.dtype, *operands)
    n = x.shape[0]
    lane = _lane(x.device, cid)
    stream = torch.cuda.current_stream(x.device)
    flags = _table(lane.flags, n)
    rc = _lib().uccl_ring_launch(
        _KERNEL_ID[name], _ADD_DTYPES.get(x.dtype, 0), n, n,
        streams, dirs[0], dirs[-1], slot_bytes, _table(x, n), _table(buf, n),
        _table(stage, n), _table(out, n), flags, ctypes.c_void_p(lane.err.data_ptr()), cid,
        lane.next_epoch(), SPIN_TIMEOUT_MS.get() * 1_000_000,
        ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with code {rc} on "
                           f"{torch.cuda.get_device_name(x.device)}; the kernel did not run")
    launch_counts[name] += 1
    return lane


def launch_ag(chunk: torch.Tensor, out: torch.Tensor, direction: int, cid: int) -> _Lane:
    """B4 on ``chunk`` ``[n, m]`` into ``out`` ``[n, n, m]``."""
    m_bytes = chunk[0].numel() * chunk.element_size()
    return _launch("ring_all_gather", chunk, out, None, None, 1, (direction,), cid, m_bytes)


def launch_rs(chunks: torch.Tensor, buf: torch.Tensor, stage: torch.Tensor,
              out: torch.Tensor, direction: int, cid: int) -> _Lane:
    """B5 on ``chunks`` ``[n, n, m]`` (scratch ``buf`` alike, ``stage``
    ``[n, 2, m]``) into ``out`` ``[n, m]``."""
    m_bytes = chunks.shape[2] * chunks.element_size()
    return _launch("ring_reduce_scatter", chunks, buf, stage, out, 1, (direction,), cid,
                   m_bytes)


def launch_ar(view: torch.Tensor, out: torch.Tensor, stage: torch.Tensor,
              dirs: Sequence[int], cid: int) -> _Lane:
    """B7 on ``view`` ``[n, n, S, m]`` into ``out`` alike (``stage``
    ``[n, S, 2, m]``)."""
    m_bytes = view.shape[3] * view.element_size()
    return _launch("ring_all_reduce", view, out, stage, None, len(dirs), dirs, cid, m_bytes)


def _ag_kernel(chunk, direction, cid):
    out = chunk.new_empty((chunk.shape[0],) + tuple(chunk.shape))
    return launch_ag(chunk, out, direction, cid), out


def _rs_kernel(chunks, direction, cid):
    n, _, m = chunks.shape
    buf, stage, out = chunks.new_empty(chunks.shape), chunks.new_empty((n, 2, m)), \
        chunks.new_empty((n, m))
    return launch_rs(chunks, buf, stage, out, direction, cid), out


def _ar_kernel(view, dirs, cid):
    n, _, s, m = view.shape
    out, stage = view.new_empty(view.shape), view.new_empty((n, s, 2, m))
    return launch_ar(view, out, stage, dirs, cid), out


def _run_pair(what: str, starts: Sequence[Callable[[], Tuple[_Lane, torch.Tensor]]],
              side_operands: Sequence[torch.Tensor], device: torch.device) -> List[torch.Tensor]:
    """Two launches in flight together: the first on the current stream,
    the second on a side stream, joined before returning. The second's
    operands (``side_operands``) were allocated on the current stream, so
    they are recorded on the side stream."""
    main, side = torch.cuda.current_stream(device), _side_stream(device)
    side.wait_stream(main)
    lane_a, out_a = starts[0]()
    with torch.cuda.stream(side):
        lane_b, out_b = starts[1]()
    main.wait_stream(side)
    for t in side_operands:
        t.record_stream(side)
    lane_a.check(what)
    lane_b.check(what)
    return [out_a, out_b]


# ---------------------------------------------------------------------------
# Entry points (member-stacked ports of the JAX per-shard functions)


def ring_all_gather(x: torch.Tensor, *, direction: int = 1, collective_id: int = 0,
                    wire_dtype=None, count: bool = True) -> torch.Tensor:
    """``[n, k, ...]`` → ``[n, n*k, ...]``: every member gathers all
    members' ``[k, ...]``, by B4 (n-1 neighbor hops). Falls back to the plan
    lowering past the arena budget. ``count=False`` leaves the wire bytes
    to a caller that counts its whole schedule."""
    _dma.resolve_wire_dtype(wire_dtype, "ring_all_gather")
    n = x.shape[0]
    if n == 1:
        return x
    k = x.shape[1]
    flat = x.reshape(n, -1)
    chunk, _, m = _dma.pad_chunks(flat, 1)  # [n, 1, rows, 128]
    itemsize = x.element_size()
    wire = (n - 1) * m * itemsize
    if _over_budget(x, ag_charge(flat.shape[1], itemsize, n), "all_gather"):
        from uccl_tpu_torch.collective import plan

        if count:
            _count_wire_bytes("ring_all_gather", "lax", None, wire)
        return plan.ring_all_gather(x)
    if count:
        _count_wire_bytes("ring_all_gather", "pallas", None, wire)
    chunk = chunk.reshape(n, m)
    if _is_cpu(x):
        buf = ag_plain(chunk, direction)
    else:
        lane, buf = _ag_kernel(chunk, direction, collective_id)
        lane.check("ring_all_gather")
    out = buf[:, :, : flat.shape[1]]
    return out.reshape((n, n * k) + tuple(x.shape[2:]))


def ring_reduce_scatter(x: torch.Tensor, *, direction: int = 1, collective_id: int = 0,
                        wire_dtype=None) -> torch.Tensor:
    """``[n, n*k, ...]`` → ``[n, k, ...]``: member r keeps reduced slot r
    (sum), by B5."""
    _dma.resolve_wire_dtype(wire_dtype, "ring_reduce_scatter")
    n = x.shape[0]
    if n == 1:
        return x
    if x.shape[1] % n:
        raise ValueError(f"leading dim {x.shape[1]} not divisible by {n}")
    k = x.shape[1] // n
    flat = x.reshape(n, -1)
    chunks, per, m = _dma.pad_chunks(flat, n)  # [n, n, rows, 128]
    itemsize = x.element_size()
    wire = (n - 1) * m * itemsize
    if _over_budget(x, rs_charge(flat.shape[1], itemsize, n), "reduce_scatter"):
        from uccl_tpu_torch.collective import plan

        _count_wire_bytes("ring_reduce_scatter", "lax", None, wire)
        return plan.ring_reduce_scatter(x)
    _count_wire_bytes("ring_reduce_scatter", "pallas", None, wire)
    chunks = chunks.reshape(n, n, m)
    if _is_cpu(x):
        out = rs_plain(chunks, direction)
    else:
        lane, out = _rs_kernel(chunks, direction, collective_id)
        lane.check("ring_reduce_scatter")
    return out[:, :per].reshape((n, k) + tuple(x.shape[2:]))


def _ar_layout(x: torch.Tensor, streams: int):
    """The payload slot-major, then by stream: ([n, n, S, m], k, m)."""
    n = x.shape[0]
    view, k, m = _dma.pad_chunks(x.reshape(n, -1), n * streams)
    return view.reshape(n, n, streams, m), k, m


def _ar_unlayout(buf: torch.Tensor, k: int, like: torch.Tensor) -> torch.Tensor:
    n, _, streams, m = buf.shape
    out = buf.reshape(n, n * streams, m)[:, :, :k].reshape(n, -1)
    return out[:, : like[0].numel()].reshape(like.shape)


def ring_all_reduce(x: torch.Tensor, *, bidirectional: bool = True, direction: int = 1,
                    collective_id: int = 0, wire_dtype=None) -> torch.Tensor:
    """Allreduce (sum) of member-stacked ``x`` as ONE B7 launch: RS phase,
    phase barrier, AG phase. ``bidirectional`` splits the payload over two
    counter-rotating streams; ``direction`` rotates the single ring
    otherwise."""
    _dma.resolve_wire_dtype(wire_dtype, "ring_all_reduce")
    n = x.shape[0]
    if n == 1:
        return x
    dirs = (1, -1) if bidirectional else (direction,)
    view, k, m = _ar_layout(x, len(dirs))
    itemsize = x.element_size()
    wire = 2 * (n - 1) * len(dirs) * m * itemsize
    if _over_budget(x, x[0].numel() * itemsize, "all_reduce"):
        from uccl_tpu_torch.collective import plan

        _count_wire_bytes("ring_all_reduce", "lax", None, wire)
        return plan.ring_all_reduce(x, bidirectional=bidirectional, direction=direction)
    _count_wire_bytes("ring_all_reduce", "pallas", None, wire)
    if _is_cpu(x):
        buf = ar_plain(view, dirs)
    else:
        lane, buf = _ar_kernel(view, dirs, collective_id)
        lane.check("ring_all_reduce")
    return _ar_unlayout(buf, k, x)


def bidir_all_reduce(x: torch.Tensor, *, collective_id: Optional[int] = None,
                     wire_dtype=None) -> torch.Tensor:
    """Allreduce (sum) over TWO counter-rotating B7 launches on paired
    collective ids, in flight together on two CUDA streams: each member's
    flat payload is split in half, the first half rings forward (+1), the
    second backward (-1). Past the arena budget both halves ride their
    directed plan lowerings as a pair, counted on ``ep_wire_fallback_total``
    and ``collective_plan_total{outcome="fallback"}``."""
    _dma.resolve_wire_dtype(wire_dtype, "bidir_all_reduce")
    n = x.shape[0]
    if n == 1:
        return x
    if collective_id is None:
        collective_id = _dma.CID_RING_BIDIR
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    half = size // 2
    if half == 0:  # nothing to split: one directed ring carries it
        return ring_all_reduce(x, bidirectional=False, collective_id=collective_id)
    halves = (flat[:, :half], flat[:, half:])
    itemsize = x.element_size()
    if _over_budget(x, bidir_pair_charge(size, itemsize, n), "all_reduce_bidir"):
        from uccl_tpu_torch.collective import plan

        plan.PLAN_TOTAL.inc(algo="bidir", chunks=2, wire_dtype="none", outcome="fallback")
        wire = sum(2 * (n - 1) * _dma.padded_chunk_elems(-(-h.shape[1] // n)) * itemsize
                   for h in halves)
        _count_wire_bytes("ring_all_reduce_bidir", "lax", None, wire)
        outs = [plan.ring_all_reduce(h, bidirectional=False, direction=d)
                for h, d in zip(halves, (1, -1))]
        return torch.cat(outs, dim=1).reshape(x.shape)
    # the pair's charge bounds each half's, so neither launch falls back
    if _is_cpu(x):
        outs = [ring_all_reduce(h, bidirectional=False, direction=d,
                                collective_id=collective_id + i)
                for i, (h, d) in enumerate(zip(halves, (1, -1)))]
        return torch.cat(outs, dim=1).reshape(x.shape)
    layouts = []
    for i, (h, d) in enumerate(zip(halves, (1, -1))):
        view, k, m = _ar_layout(h, 1)
        _count_wire_bytes("ring_all_reduce", "pallas", None, 2 * (n - 1) * m * itemsize)
        out, stage = view.new_empty(view.shape), view.new_empty((n, 1, 2, m))
        layouts.append((view, out, stage, (d,), collective_id + i, k, h))
    starts = [functools.partial(_start_ar, *lay[:5]) for lay in layouts]
    bufs = _run_pair("bidir_all_reduce", starts, layouts[1][:3], x.device)
    outs = [_ar_unlayout(b, lay[5], lay[6]) for b, lay in zip(bufs, layouts)]
    return torch.cat(outs, dim=1).reshape(x.shape)


def _start_ar(view, out, stage, dirs, cid):
    return launch_ar(view, out, stage, dirs, cid), out


def _start_ag(chunk, out, direction, cid):
    return launch_ag(chunk, out, direction, cid), out


def _ag_pair_lax_mirror(flat: torch.Tensor) -> torch.Tensor:
    """The plan lowering of the all-gather pair on ``[n, S]``: the same half
    split, reassembled to ``[n, n, S]`` (member, block, payload)."""
    from uccl_tpu_torch.collective import plan

    n, size = flat.shape
    half = size // 2
    outs = [plan.ring_all_gather(flat[:, :half]), plan.ring_all_gather(flat[:, half:])]
    return torch.cat([outs[0].reshape(n, n, half), outs[1].reshape(n, n, size - half)], dim=2)


def bidir_all_gather(x: torch.Tensor, *, collective_id: Optional[int] = None,
                     wire_dtype=None, count: bool = True) -> torch.Tensor:
    """``[n, k, ...]`` → ``[n, n*k, ...]`` over TWO counter-rotating B4
    launches on paired collective ids, in flight together: each member's
    flat payload is split in half, the first half rings forward, the second
    backward. Past the arena budget the pair rides the plan lowering,
    counted on ``ep_wire_fallback_total`` and ``collective_plan_total``."""
    _dma.resolve_wire_dtype(wire_dtype, "bidir_all_gather")
    n = x.shape[0]
    if n == 1:
        return x
    if collective_id is None:
        collective_id = _dma.CID_AG_BIDIR
    k = x.shape[1]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    half = size // 2
    if half == 0:
        return ring_all_gather(x, collective_id=collective_id, count=count)
    halves = (flat[:, :half], flat[:, half:])
    itemsize = x.element_size()
    if _over_budget(x, ag_pair_charge(size, itemsize, n), "all_gather_bidir"):
        from uccl_tpu_torch.collective import plan

        plan.PLAN_TOTAL.inc(algo="bidir", chunks=2, wire_dtype="none", outcome="fallback",
                            verb="all_gather")
        if count:
            wire = sum((n - 1) * _dma.padded_chunk_elems(h.shape[1]) * itemsize
                       for h in halves)
            _count_wire_bytes("ring_all_gather", "lax", None, wire)
        out = _ag_pair_lax_mirror(flat)
    elif _is_cpu(x):
        outs = [ring_all_gather(h, direction=d, collective_id=collective_id + i, count=count)
                for i, (h, d) in enumerate(zip(halves, (1, -1)))]
        out = torch.cat([outs[0].reshape(n, n, half), outs[1].reshape(n, n, size - half)], dim=2)
    else:
        lays = []
        for i, (h, d) in enumerate(zip(halves, (1, -1))):
            chunk, _, m = _dma.pad_chunks(h, 1)
            if count:
                _count_wire_bytes("ring_all_gather", "pallas", None, (n - 1) * m * itemsize)
            chunk = chunk.reshape(n, m)
            lays.append((chunk, chunk.new_empty((n, n, m)), d, collective_id + i))
        bufs = _run_pair("bidir_all_gather",
                         [functools.partial(_start_ag, *lay) for lay in lays], lays[1][:2],
                         x.device)
        out = torch.cat([bufs[0][:, :, :half], bufs[1][:, :, : size - half]], dim=2)
    return out.reshape((n, n * k) + tuple(x.shape[2:]))


def _bcast_wire_bytes(n: int, m: int, itemsize: int) -> int:
    """Per-member wire bytes of one scatter-allgather broadcast: the root's
    (n-1) scatter chunks amortized over the world + the AG pair's hops."""
    scatter = -(-(n - 1) * m * itemsize // n)
    h1 = m // 2
    ag = sum((n - 1) * _dma.padded_chunk_elems(h) * itemsize
             for h in ((h1, m - h1) if h1 else (m,)))
    return scatter + ag


def _scatter_from_root(chunks: torch.Tensor, root: int) -> torch.Tensor:
    """Rooted scatter on ``[n, n, m]``: member r ends holding ROOT's chunk
    r (pure data movement; the JAX package's direct root→j ppermutes)."""
    return chunks[root].clone()


def scatter_ag_broadcast(x: torch.Tensor, root: int = 0, *,
                         collective_id: Optional[int] = None, wire_dtype=None) -> torch.Tensor:
    """Rooted broadcast of member-stacked ``x``: every member returns the
    ROOT's row, as the scatter-allgather decomposition — the root scatters
    S/n chunks, then the counter-rotating B4 pair completes every member's
    copy. Bit-exact (pure data movement). Past the arena budget the pair's
    plan lowering, counted."""
    _dma.resolve_wire_dtype(wire_dtype, "scatter_ag_broadcast")
    n = x.shape[0]
    if n == 1:
        return x
    if collective_id is None:
        collective_id = _dma.CID_BCAST
    flat = x.reshape(n, -1)
    chunks, kk, m = _dma.pad_chunks(flat, n)  # [n, n, rows, 128]
    itemsize = x.element_size()
    kernel_ok = not _over_budget(x, bcast_pair_charge(flat.shape[1], itemsize, n), "broadcast")
    if not kernel_ok:
        from uccl_tpu_torch.collective import plan

        plan.PLAN_TOTAL.inc(algo="scatter_ag", chunks=2, wire_dtype="none",
                            outcome="fallback", verb="broadcast")
    _count_wire_bytes("bcast", "pallas" if kernel_ok else "lax", None,
                      _bcast_wire_bytes(n, m, itemsize))
    my_chunk = _scatter_from_root(chunks.reshape(n, n, m), root)  # [n, m]
    if kernel_ok:
        gathered = bidir_all_gather(my_chunk, collective_id=collective_id, count=False)
    else:
        gathered = _ag_pair_lax_mirror(my_chunk)
    out = gathered.reshape(n, n, m)[:, :, :kk].reshape(n, -1)[:, : flat.shape[1]]
    return out.reshape(x.shape)


def scatter_gather_broadcast_lax(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """The planned ``xla`` broadcast lowering: the same scatter-allgather
    schedule in plain torch (root scatter + one plan.ring_all_gather).
    Wire bytes on ``ep_bytes_total{verb="bcast", wire="xla"}``."""
    from uccl_tpu_torch.collective import plan

    n = x.shape[0]
    if n == 1:
        return x
    flat = x.reshape(n, -1)
    chunks, kk, m = _dma.pad_chunks(flat, n)
    itemsize = x.element_size()
    scatter = -(-(n - 1) * m * itemsize // n)
    _count_wire_bytes("bcast", "xla", None, scatter + (n - 1) * m * itemsize)
    my_chunk = _scatter_from_root(chunks.reshape(n, n, m), root)
    gathered = plan.ring_all_gather(my_chunk)  # [n, n*m]
    out = gathered.reshape(n, n, m)[:, :, :kk].reshape(n, -1)[:, : flat.shape[1]]
    return out.reshape(x.shape)
