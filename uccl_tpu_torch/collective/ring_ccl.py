"""Device-level ring collectives: hand-written CUDA kernels on member-stacked tensors.

Port of ``uccl_tpu/collective/pallas_ccl.py``. Its Pallas remote-DMA kernels
become five CUDA kernels in ``csrc/ring_ccl.cu``, built with ``nvcc`` for
``sm_90a`` at first use and called through ctypes:

* ``ring_all_gather`` (B4, replaces ``_ag_ring``): one push pass, no ring:
  member j's blocks read its contribution once and store it into slot j of
  every member's output row (:func:`ag_rows_plain`); backs
  :func:`ring_all_gather`, :func:`bidir_all_gather` (both halves into one
  output) and :func:`scatter_ag_broadcast` (contributions read straight
  from the root's row, results written in their final place).
* ``ring_reduce_scatter`` (B5): one pull pass, no ring: member k reads the
  W members' slot k of the caller's unpadded payload and adds them in the
  order the ring's hops would (:func:`rs_chain_plain`), storing slot k's
  sum once. No padding, no staging, no scratch.
* ``ring_all_reduce`` (B7): one pass, no ring: the blocks of chunk q's owner
  read the W members' chunk q of the unpadded payload, add them in the
  chain's order for the chunk's stream, and store the sum into every
  member's output row (:func:`ar_chain_plain`); one or two streams, and
  :func:`bidir_all_reduce` runs two directed launches on two CUDA streams
  into one output.
* ``ring_reduce_scatter_q`` (B6) and ``ring_all_reduce_q`` (B8): B5's and
  B7's one pass with a quantized wire (``wire_dtype="fp8"|"int8"``). On the
  ring every RS hop crosses as a 1-byte payload plus one f32 scale per
  128-lane row (the ``ops/quant.py`` block codec) and is dequantized before
  it is added in the input dtype; B8's owner then quantizes the reduced
  slot once and every member dequantizes those wire bytes. The kernels run
  that round trip at every link of the chain in registers, on the caller's
  unpadded rows, and write each result once in place
  (:func:`rs_q_chain_plain`, :func:`ar_q_chain_plain`), so all of B8's
  members end bit-identical. The quantized all-gather, and the broadcast's,
  quantize once outside the kernel and run B4 twice: on the payload, and on
  the packed scales on ``collective_id + CID_SCALE_OFFSET``.

Buffer model: where a JAX function takes one shard's ``x`` inside
``shard_map``, its port takes the member-stacked tensor ``[world, ...]``
whose row r is member r's shard, and returns the members' results stacked
the same way. One launch runs all members (see the CUDA source for the
address table, flags and epochs). On one card a hop is an HBM-to-HBM store.

Beside each kernel is its plain version (``*_plain``): the same hop schedule
on the member-stacked tensor — the same slot order, the same per-hop add in
the input dtype — so it is bit-identical to the kernel and to the JAX
kernels. The one-pass kernels' own contracts are on the unpadded payload:
:func:`ag_rows_plain` (B4), :func:`rs_chain_plain` (B5),
:func:`ar_chain_plain` (B7), :func:`rs_q_chain_plain` (B6) and
:func:`ar_q_chain_plain` (B8), each equal to its hop schedule on the padded
slots. A wrapper runs the hop schedule for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises, and raises if a kernel reports a
spin-wait timeout. ``launch_counts`` counts kernel launches.

On a CPU tensor over the arena budget (``dma.MAX_ARENA_BYTES``), a wrapper
falls back to the plan lowering (``plan.py``), counted on
``ep_wire_fallback_total`` and logged, as in the JAX package; on a CUDA
tensor it launches its kernel at every size. With a ``wire_dtype`` the
fallback is the quantized schedule's own plain version (the JAX package's
pure-lax mirror), so it changes counters and never numbers. Wire bytes per
member land on ``ep_bytes_total{verb, wire, wire_dtype}`` per call: the
quantized payload plus its scale sidecar, not logical element bytes. A
non-float payload under a ``wire_dtype`` ships full precision, counted on
``ep_wire_fallback_total`` (reason ``quant_dtype``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.collective import lanes as _lanes
from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.ops import quant as _quant

LANES = _dma.LANES

KERNELS = ("ring_all_gather", "ring_reduce_scatter", "ring_all_reduce",
           "ring_reduce_scatter_q", "ring_all_reduce_q")
launch_counts = {name: 0 for name in KERNELS}
_KERNEL_ID = {name: i for i, name in enumerate(KERNELS)}
# dtypes the reducing kernels add in (B6 and B8: the float ones); B4 moves
# bytes of any dtype
_ADD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}
_WIRE_ID = {"fp8": 0, "int8": 1}
MAX_MEMBERS = _lanes.MAX_MEMBERS
_FLAG_WORDS = 2  # kFlagWords in the source
# each member's flag words: [2 streams][channels][entry, exit]
_REGIONS = _lanes.Lanes((MAX_MEMBERS, 2, _lanes.MAX_CHANNELS, _FLAG_WORDS), KERNELS,
                        ("full-peer entry barrier (step: the peer awaited)",
                         "full-peer exit barrier (step: the peer awaited)"), "stream")

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
# The wire's rules and the charges: what one kernel holds in each member's
# arena, the arithmetic of the JAX package's gates (pallas_ccl.py:825-847,
# :929-975). Shared by the wrappers' gates and the planner's quiet probes.


def _ring_wire_dtype(x: torch.Tensor, wire_dtype, what: str):
    """Validate a ring's wire_dtype and downgrade non-float payloads to the
    full-precision wire — counted, never silent."""
    wire_dtype = _quant.resolve_wire_dtype(wire_dtype)
    if wire_dtype is not None and not x.dtype.is_floating_point:
        name = str(x.dtype).removeprefix("torch.")
        _dma.record_fallback(
            what, "quant_dtype", detail=name,
            msg=f"ring {what}: wire_dtype={wire_dtype!r} needs a float payload, got "
                f"{name}; shipping full precision",
        )
        return None
    return wire_dtype


def _hop_wire_bytes(m: int, itemsize: int, wire_dtype) -> int:
    """Bytes ONE ring hop of an m-element chunk moves: raw payload, or the
    1-byte quantized payload + packed f32 row-scale sidecar."""
    if wire_dtype is None:
        return m * itemsize
    return m + _dma.scale_rows(m // LANES) * LANES * 4


def rs_charge(nelems: int, itemsize: int, n: int, wire_dtype=None) -> int:
    """Charge of ONE reduce-scatter kernel on a flat ``nelems`` payload: the
    accumulator, plus the send + 2-slot staging wire scratches of a
    quantized wire."""
    if wire_dtype is None:
        return nelems * itemsize
    m = _dma.padded_chunk_elems(-(-nelems // n))
    return nelems * itemsize + 3 * _hop_wire_bytes(m, itemsize, wire_dtype)


def ar_charge(nelems: int, itemsize: int, n: int, streams: int, wire_dtype=None) -> int:
    """Charge of ONE all-reduce kernel of ``streams`` streams: the
    accumulator, plus a quantized wire's gather buffers and per-stream
    send + 2-slot staging."""
    if wire_dtype is None:
        return nelems * itemsize
    m = _dma.padded_chunk_elems(-(-nelems // (n * streams)))
    hb = _hop_wire_bytes(m, itemsize, wire_dtype)
    return nelems * itemsize + n * streams * hb + streams * 3 * hb


def ag_charge(nelems: int, itemsize: int, n: int, wire_dtype=None) -> int:
    """Charge of ONE all-gather kernel on a contributed ``nelems`` payload:
    the gathered buffer, or the gathered wire payload + scale sidecar."""
    if wire_dtype is None:
        return n * nelems * itemsize
    return n * _hop_wire_bytes(_dma.padded_chunk_elems(nelems), itemsize, wire_dtype)


def bidir_pair_charge(nelems: int, itemsize: int, n: int, wire_dtype=None) -> int:
    """Charge of the bidir all-reduce pair: both kernels fly at once, so
    their halves' charges add."""
    half = nelems // 2
    return sum(ar_charge(h, itemsize, n, 1, wire_dtype) for h in (half, nelems - half))


def ag_pair_charge(nelems: int, itemsize: int, n: int, wire_dtype=None) -> int:
    """Charge of the counter-rotating all-gather pair: the halves' sum."""
    half = nelems // 2
    halves = (half, nelems - half) if half else (nelems,)
    return sum(ag_charge(h, itemsize, n, wire_dtype) for h in halves)


def bcast_pair_charge(nelems: int, itemsize: int, n: int, wire_dtype=None) -> int:
    """Charge of the scatter-allgather broadcast: the AG pair over ONE
    padded S/n chunk."""
    m = _dma.padded_chunk_elems(-(-nelems // n))
    return ag_pair_charge(m, itemsize, n, wire_dtype)


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


def ag_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """B4's function on unpadded rows. ``x`` ``[n, per]`` (member j's
    contribution in row j) → ``[n, n, per]``: every member's row holds every
    contribution, slot j member j's; what :func:`ag_plain` gives on padded
    slots, in either direction."""
    n = x.shape[0]
    return x.unsqueeze(0).expand(n, *x.shape).clone()


def rs_plain(chunks: torch.Tensor, direction: int = 1) -> torch.Tensor:
    """The ring reduce-scatter's hop schedule (the JAX kernel's). ``chunks``
    ``[n, n, m]`` → ``[n, m]``: member r's slot r, summed around the ring."""
    n = chunks.shape[0]
    buf = chunks.clone()
    _rs_hops(buf, direction)
    r = torch.arange(n, device=chunks.device)
    return buf[r, r]


def rs_chain_plain(x: torch.Tensor, direction: int = 1) -> torch.Tensor:
    """B5's function. ``x`` ``[n, n*per]`` (member r's unpadded row) →
    ``[n, per]``: member k's slot k summed along the ring's chain,
    ``x[k][k] + (x[k-d][k] + (... + (x[k+2d][k] + x[k+d][k])))``, one add
    in the input dtype per ``+`` (the order :func:`_rs_hops` folds in)."""
    n = x.shape[0]
    slots = x.reshape(n, n, -1)  # [member, slot, per]
    k = torch.arange(n, device=x.device)
    acc = slots[(k + direction) % n, k]
    for j in range(2, n + 1):
        acc = slots[(k + j * direction) % n, k] + acc
    return acc


def ar_chain_plain(x: torch.Tensor, dirs: Sequence[int]) -> torch.Tensor:
    """B7's function on unpadded rows. ``x`` ``[n, size]`` → ``[n, size]``,
    every member's row the same. The row is cut into n·S chunks of
    k = ceil(size / (n·S)) elements, as :func:`_dma.pad_chunks` cuts it (the
    last short, any after it empty); chunk q, slot q // S of stream
    h = q % S, is summed along the ring's chain in direction ``dirs[h]``, as
    :func:`rs_chain_plain` sums a slot. What :func:`ar_plain` gives on the
    padded slot-major layout."""
    n, size = x.shape
    streams = len(dirs)
    k = -(-size // (n * streams))
    out = x.new_empty((n, size))
    for q in range(n * streams):
        lo, hi = q * k, min(size, (q + 1) * k)
        if lo >= hi:
            break
        o, d = q // streams, dirs[q % streams]
        acc = x[(o + d) % n, lo:hi]
        for j in range(2, n + 1):
            acc = x[(o + j * d) % n, lo:hi] + acc
        out[:, lo:hi] = acc
    return out


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


def _rs_q_hops(buf: torch.Tensor, direction: int, wire_dtype: str) -> None:
    """The quantized RS phase in place on ``buf`` ``[n, n, m]``: the slots
    of :func:`_rs_hops`, each hop quantize → move payload and scales →
    dequantize → add in the input dtype (pallas_ccl.py:382 _mirror_rs_hops)."""
    n, _, m = buf.shape
    r = torch.arange(n, device=buf.device)
    right = (r + direction) % n
    for s in range(n - 1):
        send = (r - direction * (s + 1)) % n
        q, sc = _quant.quantize_block(buf[r, send].reshape(n, m // LANES, LANES), wire_dtype, LANES)
        arrived = _quant.dequantize_block(q, sc, LANES, buf.dtype).reshape(n, m)
        buf[right, send] = buf[right, send] + arrived


def rs_q_plain(chunks: torch.Tensor, direction: int, wire_dtype: str) -> torch.Tensor:
    """B6's function. ``chunks`` ``[n, n, m]`` → ``[n, m]``: member r's slot
    r, summed around the ring over a quantized wire."""
    n = chunks.shape[0]
    buf = chunks.clone()
    _rs_q_hops(buf, direction, wire_dtype)
    r = torch.arange(n, device=chunks.device)
    return buf[r, r]


def _round_trip(v: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """One quantize → dequantize trip of ``v`` [..., len] in its dtype: the
    block codec on 128-element rows counted from the start of the last dim,
    a short last row's missing elements taken as zeros."""
    q, sc = _quant.quantize_block(v, wire_dtype, LANES)
    return _quant.dequantize_block(q, sc, LANES, v.dtype)


def rs_q_chain_plain(x: torch.Tensor, direction: int, wire_dtype: str) -> torch.Tensor:
    """B6's function on unpadded rows. ``x`` ``[n, n*per]`` → ``[n, per]``:
    member k's slot k summed along the ring's chain as
    :func:`rs_chain_plain` sums it, with one quantize round trip of the
    partial sum at every link: ``acc = x[k+d][k]``, then for j = 2..n
    ``acc = x[k+j·d][k] + RT(acc)`` (:func:`_round_trip` on the slot's rows,
    the add in the input dtype). What :func:`rs_q_plain` gives on padded
    slots."""
    n = x.shape[0]
    slots = x.reshape(n, n, -1)  # [member, slot, per]
    k = torch.arange(n, device=x.device)
    acc = slots[(k + direction) % n, k]
    for j in range(2, n + 1):
        acc = slots[(k + j * direction) % n, k] + _round_trip(acc, wire_dtype)
    return acc


def ar_q_chain_plain(x: torch.Tensor, dirs: Sequence[int], wire_dtype: str) -> torch.Tensor:
    """B8's function on unpadded rows. ``x`` ``[n, size]`` → ``[n, size]``,
    every member's row the same: the chunks of :func:`ar_chain_plain`, chunk
    q = o·S + h summed along the chain of direction ``dirs[h]`` with a round
    trip at every link (as :func:`rs_q_chain_plain`), then round-tripped
    once more, and that value written into every member's row. What
    :func:`ar_q_plain` gives on the padded layout, whose members all
    dequantize the owner's wire bytes."""
    n, size = x.shape
    streams = len(dirs)
    k = -(-size // (n * streams))
    out = x.new_empty((n, size))
    for q in range(n * streams):
        lo, hi = q * k, min(size, (q + 1) * k)
        if lo >= hi:
            break
        o, d = q // streams, dirs[q % streams]
        acc = x[(o + d) % n, lo:hi]
        for j in range(2, n + 1):
            acc = x[(o + j * d) % n, lo:hi] + _round_trip(acc, wire_dtype)
        out[:, lo:hi] = _round_trip(acc, wire_dtype)
    return out


def ar_q_plain(view: torch.Tensor, dirs: Sequence[int], wire_dtype: str) -> torch.Tensor:
    """B8's function. ``view`` ``[n, n, S, m]`` → the same layout: per
    stream the quantized RS hops, the reduced slot quantized ONCE, payload
    and scale bytes gathered verbatim, every slot (the member's own
    included) dequantized from them (pallas_ccl.py:417
    _mirror_quant_ar_stream)."""
    n, _, _, m = view.shape
    rows = m // LANES
    r = torch.arange(n, device=view.device)
    buf = view.clone()
    for h, d in enumerate(dirs):
        stream = buf[:, :, h]  # a view: the hops write into buf
        _rs_q_hops(stream, d, wire_dtype)
        q, sc = _quant.quantize_block(stream[r, r].reshape(n, rows, LANES), wire_dtype, LANES)
        qbuf = torch.zeros((n, n, m), dtype=torch.uint8, device=view.device)
        sbuf = torch.zeros((n, n, rows), dtype=torch.float32, device=view.device)
        qbuf[r, r] = q.view(torch.uint8).reshape(n, m)
        sbuf[r, r] = sc[..., 0]
        _ag_hops(qbuf, d)
        _ag_hops(sbuf, d)
        gathered = qbuf.view(q.dtype).reshape(n, n, rows, LANES)
        stream[...] = _quant.dequantize_block(gathered, sbuf[..., None], LANES,
                                              buf.dtype).reshape(n, n, m)
    return buf


# ---------------------------------------------------------------------------
# The library and the arena


@functools.cache
def _lib() -> ctypes.CDLL:
    return declare(_lanes.load_library("ring_ccl", "uccl_ring", _FLAG_WORDS))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/ring_ccl.cu``, the source's or a variant's)
    with its launch entry's argument types set."""
    i, p = ctypes.c_int, ctypes.c_void_p
    tab = ctypes.POINTER(ctypes.c_void_p)
    ll = ctypes.c_longlong
    lib.uccl_ring_launch.argtypes = [i, i, i, i, i, i, i, i, ll, ll, ll, ll, tab, tab, tab, p,
                                     i, ctypes.c_ulonglong, ctypes.c_ulonglong, p]
    lib.uccl_ring_launch.restype = i
    return lib


_side_streams: Dict[int, torch.cuda.Stream] = {}
_stream_lock = threading.Lock()


def _lane(device: torch.device, cid: int) -> _lanes.Lane:
    return _REGIONS.get(device, cid)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    with _stream_lock:
        s = _side_streams.get(device.index)
        if s is None:
            s = _side_streams[device.index] = torch.cuda.Stream(device)
        return s


def _check_world(name: str, dtype: torch.dtype, n: int) -> None:
    """Refuse a world or an add dtype the kernels do not take."""
    if not 2 <= n <= MAX_MEMBERS:
        raise ValueError(f"{name}: world {n} outside 2..{MAX_MEMBERS}")
    takes = [t for t in _ADD_DTYPES if t.is_floating_point or not name.endswith("_q")]
    if name != "ring_all_gather" and dtype not in takes:
        raise TypeError(f"{name} on CUDA adds in {sorted(map(str, takes))}; got {dtype}")


def _enqueue(name: str, x: torch.Tensor, out: torch.Tensor, streams: int, dirs: Sequence[int],
             cid: int, slot_bytes: int, *, row_elems: int = 0, slot_stride: int = 0,
             extent: int = 0, x_ptrs: Optional[Sequence[int]] = None,
             out_ptrs: Optional[Sequence[int]] = None,
             wire_dtype: Optional[str] = None) -> _lanes.Lane:
    """Launch one ring kernel on the current stream, its operands checked by
    the caller (``row_elems``, ``slot_stride``, ``extent``: as the C entry
    sets out); no sync and no error check (the caller checks the returned
    lane). ``x_ptrs`` and ``out_ptrs`` give the members' addresses where
    they are not the rows of ``x`` and ``out``."""
    n = x.shape[0]
    lane = _lane(x.device, cid)
    stream = torch.cuda.current_stream(x.device)
    t = _lanes.table
    rc = _lib().uccl_ring_launch(
        _KERNEL_ID[name], _ADD_DTYPES.get(x.dtype, 0), _WIRE_ID.get(wire_dtype, 0), n,
        n, streams, dirs[0], dirs[-1], slot_bytes, row_elems, slot_stride, extent,
        t(x, n) if x_ptrs is None else (ctypes.c_void_p * n)(*x_ptrs),
        t(out, n) if out_ptrs is None else (ctypes.c_void_p * n)(*out_ptrs), t(lane.flags, n),
        ctypes.c_void_p(lane.err.data_ptr()), cid, lane.next_epoch(),
        _lanes.SPIN_TIMEOUT_MS.get() * 1_000_000, ctypes.c_void_p(stream.cuda_stream))
    _lanes.raise_on_launch(rc, name, x.device)
    launch_counts[name] += 1
    return lane


def _check_rows(name: str, x: torch.Tensor, *ts: torch.Tensor) -> None:
    """``ts`` on ``x``'s device in its dtype, each row of elements
    contiguous (rows at any stride)."""
    for t in ts:
        if t.device != x.device or t.dtype != x.dtype or (t.stride(-1) != 1 and t.shape[-1] > 1):
            raise ValueError(f"{name}: operands must be of {x.dtype} with contiguous rows, "
                             f"on {x.device}")


def launch_ag(x: torch.Tensor, out: torch.Tensor, cid: int) -> _lanes.Lane:
    """B4: member j's contribution ``x[j]`` (``x`` ``[n, per]``, rows at any
    stride) into slot j of every member's row of ``out`` ``[n, n, per]``, a
    view at any member and slot strides (the bidir pair's halves are column
    ranges of one tensor). Any dtype: B4 moves bytes. No scratch."""
    name, (n, per) = "ring_all_gather", x.shape
    _check_world(name, x.dtype, n)
    if tuple(out.shape) != (n, n, per):
        raise ValueError(f"{name}: output {tuple(out.shape)} is not [{n}, {n}, {per}]")
    _check_rows(name, x, x, out)
    isz = x.element_size()
    stride = out.stride(1) * isz
    return _enqueue(name, x, out, 1, (1,), cid, per * isz, slot_stride=stride,
                    extent=per * isz + (n - 1) * stride)


def launch_ag_from_root(x: torch.Tensor, root: int, out: torch.Tensor, chunk: int, lo: int,
                        width: int, cid: int) -> _lanes.Lane:
    """B4 for the broadcast, on ``x`` ``[n, size]`` into ``out`` alike:
    member j contributes elements [j·chunk + lo, j·chunk + lo + width) of
    the root's row, and every member's row receives them in the same place;
    contributions are cut at ``size``, so nothing past the row is read or
    written."""
    name, (n, size) = "ring_all_gather", x.shape
    _check_world(name, x.dtype, n)
    if tuple(out.shape) != (n, size) or not 0 < width <= chunk or lo + width > chunk:
        raise ValueError(f"{name}: output {tuple(out.shape)} or chunk {chunk} [{lo}, "
                         f"{lo + width}) does not fit [{n}, {size}]")
    _check_rows(name, x, x, out)
    isz = x.element_size()
    row = x.data_ptr() + root * x.stride(0) * isz
    return _enqueue(name, x, out, 1, (1,), cid, width * isz,
                    slot_stride=chunk * isz, extent=(size - lo) * isz,
                    x_ptrs=[row + (j * chunk + lo) * isz for j in range(n)],
                    out_ptrs=[out.data_ptr() + (r * out.stride(0) + lo) * isz for r in range(n)])


def launch_rs(x: torch.Tensor, out: torch.Tensor, direction: int, cid: int,
              wire_dtype: Optional[str] = None) -> _lanes.Lane:
    """B5 (B6 with a ``wire_dtype``) on ``x`` ``[n, n*per]``, the members'
    unpadded rows (rows at any stride, slots at any element offset), into
    ``out`` ``[n, per]``; no scratch."""
    name = "ring_reduce_scatter_q" if wire_dtype else "ring_reduce_scatter"
    (n, size), per = x.shape, out.shape[-1]
    _check_world(name, x.dtype, n)
    if size != n * per or tuple(out.shape) != (n, per):
        raise ValueError(f"{name}: rows of {size} are not {n} slots of {per}")
    _check_rows(name, x, x, out)
    return _enqueue(name, x, out, 1, (direction,), cid, per * x.element_size(), row_elems=size,
                    wire_dtype=wire_dtype)


def launch_ar(x: torch.Tensor, out: torch.Tensor, dirs: Sequence[int], cid: int,
              wire_dtype: Optional[str] = None) -> _lanes.Lane:
    """B7 (B8 with a ``wire_dtype``) on ``x`` ``[n, size]``, the members'
    unpadded rows (rows at any stride), into ``out`` alike (the bidir pair's
    halves are column ranges of one tensor): every member's row receives
    :func:`ar_chain_plain`'s sums (:func:`ar_q_chain_plain`'s); no
    scratch."""
    name = "ring_all_reduce_q" if wire_dtype else "ring_all_reduce"
    n, size = x.shape
    _check_world(name, x.dtype, n)
    if tuple(out.shape) != (n, size) or size == 0:
        raise ValueError(f"{name}: output {tuple(out.shape)} is not [{n}, {size}] or empty")
    _check_rows(name, x, x, out)
    k = -(-size // (n * len(dirs)))
    return _enqueue(name, x, out, len(dirs), dirs, cid, k * x.element_size(), row_elems=size,
                    wire_dtype=wire_dtype)


def _ag_kernel(x, cid):
    """One B4 launch on ``x`` ``[n, per]``; (lane, out ``[n, n, per]``)."""
    out = x.new_empty((x.shape[0],) + tuple(x.shape))
    return launch_ag(x, out, cid), out


def _rs_kernel(x, direction, cid, wire_dtype=None):
    """One B5 (B6) launch on ``x`` ``[n, n*per]``; (lane, out ``[n, per]``)."""
    n = x.shape[0]
    out = x.new_empty((n, x.shape[1] // n))
    return launch_rs(x, out, direction, cid, wire_dtype), out


def _ar_kernel(x, dirs, cid, wire_dtype=None):
    """One B7 (B8) launch on ``x`` ``[n, size]``; (lane, out ``[n, size]``)."""
    out = x.new_empty(x.shape)
    return launch_ar(x, out, dirs, cid, wire_dtype), out


def _run_pair(what: str, starts: Sequence[Callable[[], Tuple[List[_lanes.Lane], object]]],
              side_operands: Sequence[torch.Tensor], device: torch.device) -> list:
    """Two groups of launches in flight together: the first on the current
    stream, the second on a side stream, joined before returning. Each start
    returns (its launches' lanes, its result). The second's operands
    (``side_operands``: inputs, outputs and scratch) were allocated on the
    current stream, so they are recorded on the side stream."""
    main, side = torch.cuda.current_stream(device), _side_stream(device)
    side.wait_stream(main)
    lanes_a, out_a = starts[0]()
    with torch.cuda.stream(side):
        lanes_b, out_b = starts[1]()
    main.wait_stream(side)
    for t in side_operands:
        t.record_stream(side)
    _lanes.check_all([(lane, what) for lane in (*lanes_a, *lanes_b)])
    return [out_a, out_b]


# ---------------------------------------------------------------------------
# Entry points (member-stacked ports of the JAX per-shard functions)


def _lax_wire(x: torch.Tensor, charge: int, what: str) -> str:
    """``"lax"`` when a CPU payload's charge is over the arena budget (the
    gate counts and logs it), else ``"pallas"``: the ``wire`` label of
    ``ep_bytes_total``."""
    return "lax" if _over_budget(x, charge, what) else "pallas"


class _AgQuant:
    """One quantized all-gather ring on ``flat`` ``[n, size]``: the payload
    quantized ONCE per 128-lane row of the padded chunk, B4 on the payload
    bytes and B4 on the packed scales (``cid + CID_SCALE_OFFSET``), and the
    dequantize of every member's gathered copy. Split into prepare / start /
    finish so that a pair's four launches can be in flight together."""

    def __init__(self, flat: torch.Tensor, wire_dtype: str):
        n = flat.shape[0]
        chunk, _, self.m = _dma.pad_chunks(flat, 1)  # [n, 1, rows, 128]
        self.rows, self.size, self.dtype = self.m // LANES, flat.shape[1], flat.dtype
        # one block per 128-lane row: q [n,1,rows,128], scales [n,1,rows,1]
        q, sc = _quant.quantize_block(chunk, wire_dtype, LANES)
        self.wdt = q.dtype
        self.q = q.view(torch.uint8).reshape(n, self.m)
        srows = _dma.scale_rows(self.rows)
        self.sp = _dma.pack_row_scales(sc[..., 0], srows).reshape(n, srows * LANES)

    def operands(self):
        """Inputs and gather buffers of the two launches."""
        n = self.q.shape[0]
        return self.q, self.sp, self.q.new_empty((n, *self.q.shape)), \
            self.sp.new_empty((n, *self.sp.shape))

    def start(self, cid: int, operands=None):
        """Both launches on the current stream; ([lanes], (payload, scales))."""
        q, sp, qbuf, sbuf = operands or self.operands()
        return [launch_ag(q, qbuf, cid),
                launch_ag(sp, sbuf, cid + _dma.CID_SCALE_OFFSET)], (qbuf, sbuf)

    def plain(self, direction: int):
        return ag_plain(self.q, direction), ag_plain(self.sp, direction)

    def finish(self, gathered) -> torch.Tensor:
        """``[n, n, size]``: every member's copy, dequantized."""
        qbuf, sbuf = gathered
        n = qbuf.shape[0]
        scg = _dma.unpack_row_scales(sbuf.reshape(n, n, -1, LANES), self.rows)  # [n, n, rows]
        out = _quant.dequantize_block(qbuf.view(self.wdt).reshape(n, n, self.rows, LANES),
                                      scg[..., None], LANES, self.dtype)
        return out.reshape(n, n, self.m)[:, :, : self.size]


def ring_all_gather(x: torch.Tensor, *, direction: int = 1, collective_id: int = 0,
                    wire_dtype=None, count: bool = True) -> torch.Tensor:
    """``[n, k, ...]`` → ``[n, n*k, ...]``: every member gathers all
    members' ``[k, ...]``, by B4 on the payload as it is (one pass: no
    padding, the result written in place); on the CPU by the ring's hops on
    padded slots, and past the arena budget by the plan lowering.
    ``wire_dtype``: the payload is quantized once and circulates with its
    scale sidecar; every member dequantizes the same wire bytes, so all
    copies are identical and one round trip from the input. ``count=False``
    leaves the wire bytes to a caller that counts its whole schedule."""
    wire_dtype = _ring_wire_dtype(x, wire_dtype, "all_gather")
    n = x.shape[0]
    if n == 1:
        return x
    k = x.shape[1]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    itemsize = x.element_size()
    m = _dma.padded_chunk_elems(size)
    hop_bytes = _hop_wire_bytes(m, itemsize, wire_dtype)
    wire = _lax_wire(x, ag_charge(size, itemsize, n, wire_dtype), "all_gather")
    if count:
        _count_wire_bytes("ring_all_gather", wire, wire_dtype, (n - 1) * hop_bytes)
    if wire_dtype is not None:
        ring = _AgQuant(flat, wire_dtype)
        if _is_cpu(x):  # in budget or past it: the same gather of the same wire bytes
            out = ring.finish(ring.plain(direction))
        else:
            lanes, gathered = ring.start(collective_id)
            _lanes.check_all([(lane, "ring_all_gather") for lane in lanes])
            out = ring.finish(gathered)
        return out.reshape((n, n * k) + tuple(x.shape[2:]))
    if wire == "lax":
        from uccl_tpu_torch.collective import plan

        return plan.ring_all_gather(x)
    if not _is_cpu(x):
        lane, out = _ag_kernel(_unit_rows(flat), collective_id)
        lane.check("ring_all_gather")
        return out.reshape((n, n * k) + tuple(x.shape[2:]))
    chunk = _dma.pad_chunks(flat, 1)[0].reshape(n, m)
    return ag_plain(chunk, direction)[:, :, :size].reshape((n, n * k) + tuple(x.shape[2:]))


def ring_reduce_scatter(x: torch.Tensor, *, direction: int = 1, collective_id: int = 0,
                        wire_dtype=None) -> torch.Tensor:
    """``[n, n*k, ...]`` → ``[n, k, ...]``: member r keeps reduced slot r
    (sum), by B5 on the payload as it is: no padding, no scratch, the
    result a view of B5's output. ``wire_dtype``: by B6, the same way — every
    hop's partial sum crosses block-quantized and is dequantized before it
    is added in the input precision, one quantize round trip of error per
    hop. On the CPU both run their hop schedule on padded slots."""
    wire_dtype = _ring_wire_dtype(x, wire_dtype, "reduce_scatter")
    n = x.shape[0]
    if n == 1:
        return x
    if x.shape[1] % n:
        raise ValueError(f"leading dim {x.shape[1]} not divisible by {n}")
    k = x.shape[1] // n
    flat = x.reshape(n, -1)
    per = flat.shape[1] // n
    m = _dma.padded_chunk_elems(per)
    itemsize = x.element_size()
    wire = _lax_wire(x, rs_charge(flat.shape[1], itemsize, n, wire_dtype), "reduce_scatter")
    _count_wire_bytes("ring_reduce_scatter", wire, wire_dtype,
                      (n - 1) * _hop_wire_bytes(m, itemsize, wire_dtype))
    if wire == "lax" and wire_dtype is None:
        from uccl_tpu_torch.collective import plan

        return plan.ring_reduce_scatter(x)
    if not _is_cpu(x):
        lane, out = _rs_kernel(_unit_rows(flat), direction, collective_id, wire_dtype)
        lane.check("ring_reduce_scatter")
        return out.reshape((n, k) + tuple(x.shape[2:]))
    # past the budget too: the quantized mirror is the plain version
    chunks = _dma.pad_chunks(flat, n)[0].reshape(n, n, m)
    out = rs_plain(chunks, direction) if wire_dtype is None else rs_q_plain(chunks, direction,
                                                                           wire_dtype)
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


def _ar_wire_bytes(n: int, streams: int, m: int, itemsize: int, wire_dtype) -> int:
    return 2 * (n - 1) * streams * _hop_wire_bytes(m, itemsize, wire_dtype)


def ring_all_reduce(x: torch.Tensor, *, bidirectional: bool = True, direction: int = 1,
                    collective_id: int = 0, wire_dtype=None) -> torch.Tensor:
    """Allreduce (sum) of member-stacked ``x`` as ONE B7 launch on the
    payload as it is (one pass: no padding, the sums written in place, in
    the ring's chain order). ``bidirectional`` splits the payload over two
    counter-rotating streams; ``direction`` rotates the single ring
    otherwise. ``wire_dtype``: ONE B8 launch, the same way — a round trip at
    every link of the chain and one more on the sum, which every member
    receives; the error is n-1 per-hop round trips into the sum plus one on
    the gathered copy. On the CPU the ring's hops on padded slots."""
    wire_dtype = _ring_wire_dtype(x, wire_dtype, "all_reduce")
    n = x.shape[0]
    if n == 1:
        return x
    dirs = (1, -1) if bidirectional else (direction,)
    m = _dma.padded_chunk_elems(-(-x[0].numel() // (n * len(dirs))))
    itemsize = x.element_size()
    wire = _lax_wire(x, ar_charge(x[0].numel(), itemsize, n, len(dirs), wire_dtype),
                     "all_reduce")
    _count_wire_bytes("ring_all_reduce", wire, wire_dtype,
                      _ar_wire_bytes(n, len(dirs), m, itemsize, wire_dtype))
    if wire == "lax" and wire_dtype is None:
        from uccl_tpu_torch.collective import plan

        return plan.ring_all_reduce(x, bidirectional=bidirectional, direction=direction)
    if not _is_cpu(x):
        lane, out = _ar_kernel(_unit_rows(x.reshape(n, -1)), dirs, collective_id, wire_dtype)
        lane.check("ring_all_reduce")
        return out.reshape(x.shape)
    view, k, _ = _ar_layout(x, len(dirs))
    buf = ar_plain(view, dirs) if wire_dtype is None else ar_q_plain(view, dirs, wire_dtype)
    return _ar_unlayout(buf, k, x)


def _unit_rows(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` ``[n, size]`` itself when its rows are contiguous (rows at
    any stride), else a contiguous copy."""
    return flat if flat.stride(1) == 1 or flat.shape[1] <= 1 else flat.contiguous()


def _start_ar(x, out, dirs, cid, wire_dtype):
    return [launch_ar(x, out, dirs, cid, wire_dtype)], out


def bidir_all_reduce(x: torch.Tensor, *, collective_id: Optional[int] = None,
                     wire_dtype=None) -> torch.Tensor:
    """Allreduce (sum) over TWO counter-rotating B7 launches (B8 with a
    ``wire_dtype``) on paired collective ids, in flight together on two CUDA
    streams: each member's flat payload is split in half, the first half
    rings forward (+1), the second backward (-1); B7 (B8) writes both
    halves' sums into one output, each into its own columns. Past the arena budget
    both halves ride their directed mirrors as a pair (the plan lowerings,
    or the quantized schedule's plain version), counted on
    ``ep_wire_fallback_total`` and ``collective_plan_total{outcome="fallback"}``."""
    wire_dtype = _ring_wire_dtype(x, wire_dtype, "all_reduce_bidir")
    n = x.shape[0]
    if n == 1:
        return x
    if collective_id is None:
        collective_id = _dma.CID_RING_BIDIR
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    half = size // 2
    if half == 0:  # nothing to split: one directed ring carries it
        return ring_all_reduce(x, bidirectional=False, collective_id=collective_id,
                               wire_dtype=wire_dtype)
    halves = (flat[:, :half], flat[:, half:])
    itemsize = x.element_size()
    if _over_budget(x, bidir_pair_charge(size, itemsize, n, wire_dtype), "all_reduce_bidir"):
        from uccl_tpu_torch.collective import plan

        plan.PLAN_TOTAL.inc(algo="bidir", chunks=2, wire_dtype=wire_dtype or "none",
                            outcome="fallback")
        wire = sum(_ar_wire_bytes(n, 1, _dma.padded_chunk_elems(-(-h.shape[1] // n)), itemsize,
                                  wire_dtype) for h in halves)
        _count_wire_bytes("ring_all_reduce_bidir", "lax", wire_dtype, wire)
        outs = []
        for h, d in zip(halves, (1, -1)):
            if wire_dtype is None:
                outs.append(plan.ring_all_reduce(h, bidirectional=False, direction=d))
            else:
                view, k, _ = _ar_layout(h, 1)
                outs.append(_ar_unlayout(ar_q_plain(view, (d,), wire_dtype), k, h))
        return torch.cat(outs, dim=1).reshape(x.shape)
    # the pair's charge bounds each half's, so neither launch falls back
    if _is_cpu(x):
        outs = [ring_all_reduce(h, bidirectional=False, direction=d,
                                collective_id=collective_id + i, wire_dtype=wire_dtype)
                for i, (h, d) in enumerate(zip(halves, (1, -1)))]
        return torch.cat(outs, dim=1).reshape(x.shape)
    for h in halves:
        m = _dma.padded_chunk_elems(-(-h.shape[1] // n))
        _count_wire_bytes("ring_all_reduce", "pallas", wire_dtype,
                          _ar_wire_bytes(n, 1, m, itemsize, wire_dtype))
    # both halves' sums straight into one output
    src = _unit_rows(flat)
    out = src.new_empty((n, size))
    starts = [functools.partial(_start_ar, src[:, lo:hi], out[:, lo:hi], (d,),
                                collective_id + i, wire_dtype)
              for i, (lo, hi, d) in enumerate(((0, half, 1), (half, size, -1)))]
    _run_pair("bidir_all_reduce", starts, (src, out), x.device)
    return out.reshape(x.shape)


def _ag_pair_lax_mirror(flat: torch.Tensor, wire_dtype=None) -> torch.Tensor:
    """The mirror of the all-gather pair on ``[n, S]``: the same half split,
    per half the plan lowering (or, with a wire dtype, quantize once, gather
    payload and scales verbatim, dequantize), reassembled to ``[n, n, S]``
    (member, block, payload)."""
    from uccl_tpu_torch.collective import plan

    n, size = flat.shape
    half = size // 2
    outs = []
    for h in (flat[:, :half], flat[:, half:]):
        if wire_dtype is None:
            outs.append(plan.ring_all_gather(h).reshape(n, n, -1))
        else:
            ring = _AgQuant(h, wire_dtype)
            outs.append(ring.finish(ring.plain(1)))
    return torch.cat(outs, dim=2)


def _start_ag(x, out, cid):
    return [launch_ag(x, out, cid)], out


def bidir_all_gather(x: torch.Tensor, *, collective_id: Optional[int] = None,
                     wire_dtype=None, count: bool = True) -> torch.Tensor:
    """``[n, k, ...]`` → ``[n, n*k, ...]`` over TWO B4 launches on paired
    collective ids, in flight together: each member's flat payload is split
    in half, the JAX package's counter-rotating pair (on the CPU: the first
    half rings forward, the second backward); on the card both halves land
    in one output, each in its own columns. ``wire_dtype`` quantizes each
    half once at the source and forwards wire bytes verbatim (two B4
    launches per half: payload and scales). Past the arena budget the pair
    rides its mirror, counted on ``ep_wire_fallback_total`` and
    ``collective_plan_total``."""
    wire_dtype = _ring_wire_dtype(x, wire_dtype, "all_gather_bidir")
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
        return ring_all_gather(x, collective_id=collective_id, wire_dtype=wire_dtype,
                               count=count)
    halves = (flat[:, :half], flat[:, half:])
    itemsize = x.element_size()
    if _over_budget(x, ag_pair_charge(size, itemsize, n, wire_dtype), "all_gather_bidir"):
        from uccl_tpu_torch.collective import plan

        plan.PLAN_TOTAL.inc(algo="bidir", chunks=2, wire_dtype=wire_dtype or "none",
                            outcome="fallback", verb="all_gather")
        if count:
            wire = sum((n - 1) * _hop_wire_bytes(_dma.padded_chunk_elems(h.shape[1]), itemsize,
                                                 wire_dtype) for h in halves)
            _count_wire_bytes("ring_all_gather", "lax", wire_dtype, wire)
        out = _ag_pair_lax_mirror(flat, wire_dtype)
    elif _is_cpu(x):
        outs = [ring_all_gather(h, direction=d, collective_id=collective_id + i,
                                wire_dtype=wire_dtype, count=count)
                for i, (h, d) in enumerate(zip(halves, (1, -1)))]
        out = torch.cat([outs[0].reshape(n, n, half), outs[1].reshape(n, n, size - half)], dim=2)
    else:
        if count:
            for h in halves:
                _count_wire_bytes(
                    "ring_all_gather", "pallas", wire_dtype,
                    (n - 1) * _hop_wire_bytes(_dma.padded_chunk_elems(h.shape[1]), itemsize,
                                              wire_dtype))
        if wire_dtype is None:
            src = _unit_rows(flat)
            out = src.new_empty((n, n, size))
            starts = [functools.partial(_start_ag, src[:, lo:hi], out[:, :, lo:hi],
                                        collective_id + i)
                      for i, (lo, hi) in enumerate(((0, half), (half, size)))]
            _run_pair("bidir_all_gather", starts, (src, out), x.device)
        else:
            rings = [_AgQuant(h, wire_dtype) for h in halves]
            operands = [ring.operands() for ring in rings]
            starts = [functools.partial(ring.start, collective_id + i, ops)
                      for i, (ring, ops) in enumerate(zip(rings, operands))]
            bufs = _run_pair("bidir_all_gather", starts, operands[1], x.device)
            out = torch.cat([ring.finish(b) for ring, b in zip(rings, bufs)], dim=2)
    return out.reshape((n, n * k) + tuple(x.shape[2:]))


def _bcast_wire_bytes(n: int, m: int, itemsize: int, wire_dtype=None) -> int:
    """Per-member wire bytes of one scatter-allgather broadcast: the root's
    (n-1) scatter chunks amortized over the world (full precision) + the AG
    pair's hops (the wire dtype)."""
    scatter = -(-(n - 1) * m * itemsize // n)
    h1 = m // 2
    ag = sum((n - 1) * _hop_wire_bytes(_dma.padded_chunk_elems(h), itemsize, wire_dtype)
             for h in ((h1, m - h1) if h1 else (m,)))
    return scatter + ag


def _start_bcast(x, root, out, chunk, lo, width, cid):
    return [launch_ag_from_root(x, root, out, chunk, lo, width, cid)], out


def scatter_ag_broadcast(x: torch.Tensor, root: int = 0, *,
                         collective_id: Optional[int] = None, wire_dtype=None) -> torch.Tensor:
    """Rooted broadcast of member-stacked ``x``: every member returns the
    ROOT's row, as the scatter-allgather decomposition — the root scatters
    S/n chunks, then the B4 pair (each chunk split in half, as the JAX
    package's counter-rotating pair splits it) completes every member's
    copy. On the card B4 reads the chunks straight from the root's row and
    writes them into every member's row in their final place: no scatter
    copy, no padding, no cut. Full precision is bit-exact (pure data
    movement); ``wire_dtype`` quantizes the all-gather legs once per chunk —
    one round trip of error, every member identical. Past the arena budget
    the pair's mirror, counted."""
    wire_dtype = _ring_wire_dtype(x, wire_dtype, "broadcast")
    n = x.shape[0]
    if n == 1:
        return x
    if collective_id is None:
        collective_id = _dma.CID_BCAST
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    kk = -(-size // n)  # elements of a scattered chunk; m with its padding
    m = _dma.padded_chunk_elems(kk)
    itemsize = x.element_size()
    kernel_ok = not _over_budget(
        x, bcast_pair_charge(size, itemsize, n, wire_dtype), "broadcast")
    if not kernel_ok:
        from uccl_tpu_torch.collective import plan

        plan.PLAN_TOTAL.inc(algo="scatter_ag", chunks=2, wire_dtype=wire_dtype or "none",
                            outcome="fallback", verb="broadcast")
    _count_wire_bytes("bcast", "pallas" if kernel_ok else "lax", wire_dtype,
                      _bcast_wire_bytes(n, m, itemsize, wire_dtype))
    if kernel_ok and wire_dtype is None and not _is_cpu(x):
        src = _unit_rows(flat)
        out = src.new_empty((n, size))
        h1 = kk // 2
        parts = ((0, h1), (h1, kk - h1)) if h1 else ((0, kk),)
        starts = [functools.partial(_start_bcast, src, root, out, kk, lo, width,
                                    collective_id + i) for i, (lo, width) in enumerate(parts)]
        if len(starts) == 2:
            _run_pair("scatter_ag_broadcast", starts, (src, out), x.device)
        else:
            lanes, _ = starts[0]()
            lanes[0].check("scatter_ag_broadcast")
        return out.reshape(x.shape)
    # member r holds the root's chunk r: a view of the root's padded row
    my_chunk = _dma.pad_chunks(flat, n)[0].reshape(n, n, m)[root]
    if kernel_ok:
        gathered = bidir_all_gather(my_chunk, collective_id=collective_id,
                                    wire_dtype=wire_dtype, count=False)
    else:
        gathered = _ag_pair_lax_mirror(my_chunk, wire_dtype)
    out = gathered.reshape(n, n, m)[:, :, :kk].reshape(n, -1)[:, :size]
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
    my_chunk = chunks.reshape(n, n, m)[root]  # member r holds the root's chunk r
    gathered = plan.ring_all_gather(my_chunk)  # [n, n*m]
    out = gathered.reshape(n, n, m)[:, :, :kk].reshape(n, -1)[:, : flat.shape[1]]
    return out.reshape(x.shape)
