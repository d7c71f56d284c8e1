"""The EP all-to-all on member-stacked tensors: hand-written CUDA kernels B9 and B10.

Port of ``uccl_tpu/ep/pallas_a2a.py``. Its two Pallas remote-DMA kernels
become two CUDA kernels in ``csrc/ep_a2a.cu``, built with ``nvcc`` for
``sm_90a`` at first use and called through ctypes:

* ``a2a`` (B9, replaces ``_a2a_kernel``): the whole exchange in one launch,
  full-peer entry barrier, local short-circuit, the W-1 exchanges on two
  counter-rotating streams into write-once per-source slots. Backs
  :func:`all_to_all` and its chunk pipeline.
* ``sched_round`` (B10, replaces ``_sched_round_kernel``): one
  contention-free permutation round of a schedule from
  :func:`uccl_tpu_torch.ep.a2a_sched.wire_schedule`, writing each pair
  whose designated round it is straight into the exchange's one receive
  buffer (and, in round 0, the diagonal). Backs
  :func:`scheduled_all_to_all`, one launch per round. The JAX kernel writes
  fresh round slots that its wrapper reassembles by designated round (a
  TPU kernel's output is a fresh VMEM block); the port writes each pair
  once into its final slot, so no round buffers and no assembly.

Buffer model: where the JAX function takes one shard's ``x`` ``[W, ...]``
inside ``shard_map`` (``W`` destination chunks), its port takes the
member-stacked ``[W, W, ...]``, row r being member r's buffer, and returns
``x.transpose(0, 1)``: member r's chunk d lands in member d's slot r, the
contract of ``lax.all_to_all(x, axis, 0, 0, tiled=True)``. ``chunk_axis``
keeps the JAX meaning: an axis of one member's buffer (1 is the axis after
the destination axis). The view a kernel moves is
``dma.pad_chunks(x[r].reshape(-1), W)``: each chunk padded to a multiple of
1024 elements, so its slot is a whole number of 16-byte vectors.

Beside each kernel is its plain version (:func:`a2a_plain`,
:func:`sched_round_plain`): the same steps, or the same round's writes, on
the member-stacked view; B9's steps, and a whole schedule's rounds, give the
transpose by construction. A wrapper runs it for
CPU tensors; for a CUDA tensor it launches the kernel or raises, and raises
if the kernel reports a spin-wait timeout: the error words are read once per
call, after its last launch, or once per enclosing scope
(``collective/lanes.py``). ``launch_counts`` counts kernel launches.

Fallbacks, as in the JAX package, are for CPU tensors only: a payload over
the arena budget (``dma.MAX_ARENA_BYTES``) takes the stock wire (the plain
transpose, XLA's ``all_to_all`` in JAX), a chunk pipeline over its
double-buffer budget the unchunked exchange, and a schedule over its budget
the unscheduled kernel, each counted on ``ep_wire_fallback_total``. CUDA
tensors launch the kernels at every size.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import numpy as np
import torch

from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.collective import lanes as _lanes

LANES = _dma.LANES

KERNELS = ("a2a", "sched_round")
launch_counts = {name: 0 for name in KERNELS}
_KERNEL_ID = {name: i for i, name in enumerate(KERNELS)}
MAX_MEMBERS = _lanes.MAX_MEMBERS
_FLAG_WORDS = MAX_MEMBERS + 1  # kFlagWords in the source
# each member's flag words: [channels][one arrival word per source, entry]
_REGIONS = _lanes.Lanes((MAX_MEMBERS, _lanes.MAX_CHANNELS, _FLAG_WORDS), KERNELS,
                        ("entry barrier", "receive"), "waiting on member")


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _is_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"EP all-to-all: tensor on {x.device} (want cpu or cuda)")


def _lax_fallback(x: torch.Tensor) -> torch.Tensor:
    """The stock wire: the tiled all-to-all as a transpose of the member axes."""
    return x.transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# Plain versions on the member-stacked view [n, n, rows, LANES]


def a2a_plain(view: torch.Tensor) -> torch.Tensor:
    """B9's function on ``view`` ``[n, n, ...]`` (member r's send chunks in
    row r): the kernel's steps, local chunk first, then at step s chunk r+s
    forward and chunk r-s backward (the antipodal chunk forward only for
    even n), each into the destination's slot r. Returns ``[n, n, ...]``,
    member d's slot r = ``view[r, d]``."""
    n = view.shape[0]
    r = torch.arange(n, device=view.device)
    out = torch.empty_like(view)
    out[r, r] = view[r, r]
    s_fwd, s_bwd = n // 2, (n - 1) // 2
    for s in range(1, s_fwd + 1):
        for d in ((1, -1) if s <= s_bwd else (1,)):
            dst = (r + d * s) % n
            out[dst, r] = view[r, dst]
    return out


def round_bits(perms, k_mat, k: int):
    """B10's per-round arguments for round ``k`` of a schedule: the members
    whose pair ``(r, perms[k][r])`` is due in this round (``K[r, pi[r]] ==
    k``, off the diagonal) as a tuple of bools, and whether the round copies
    the diagonal (round 0)."""
    pi = perms[k]
    return tuple(d != r and int(k_mat[r][d]) == k for r, d in enumerate(pi)), k == 0


def sched_round_plain(view: torch.Tensor, out: torch.Tensor, pi, send, local: bool
                      ) -> torch.Tensor:
    """B10's function: one permutation round into the exchange's receive
    buffer. ``view`` and ``out`` ``[n, n, ...]``, ``pi`` the round's
    destinations, ``send`` / ``local`` as :func:`round_bits` gives them:
    member r writes ``view[r, pi[r]]`` into ``out[pi[r], r]`` when
    ``send[r]``, and ``local`` writes the diagonal. Nothing else of ``out``
    is touched. Returns ``out``."""
    src = [r for r, due in enumerate(send) if due]
    if src:
        s = torch.as_tensor(src, dtype=torch.long, device=view.device)
        d = torch.as_tensor([int(pi[r]) for r in src], dtype=torch.long, device=view.device)
        out[d, s] = view[s, d]
    if local:
        r = torch.arange(view.shape[0], device=view.device)
        out[r, r] = view[r, r]
    return out


# ---------------------------------------------------------------------------
# The library and the flag regions


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _lanes.load_library("ep_a2a", "uccl_a2a", _FLAG_WORDS)
    i, p = ctypes.c_int, ctypes.c_void_p
    tab = ctypes.POINTER(ctypes.c_void_p)
    lib.uccl_a2a_launch.argtypes = [i, i, i, ctypes.c_longlong, tab, tab, tab, p,
                                    ctypes.POINTER(ctypes.c_int), ctypes.c_uint, i, i,
                                    ctypes.c_ulonglong, ctypes.c_ulonglong, p]
    lib.uccl_a2a_launch.restype = i
    return lib


def _lane(device: torch.device, cid: int) -> _lanes.Lane:
    return _REGIONS.get(device, cid)


def _launch(name: str, view: torch.Tensor, out: torch.Tensor, cid: int, pi=None, send=(),
            local: bool = False) -> _lanes.Lane:
    """Launch one kernel on the current stream; no sync and no error check
    (the caller checks the returned lane). ``view`` and ``out``
    ``[n, n, ...]``."""
    n = view.shape[0]
    if not 2 <= n <= MAX_MEMBERS:
        raise ValueError(f"{name}: world {n} outside 2..{MAX_MEMBERS}")
    slot_bytes = view[0, 0].numel() * view.element_size()
    dev = view.device
    for t in (view, out):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16 or t.dtype != view.dtype:
            raise ValueError(f"{name}: operands must be contiguous, 16-byte aligned, of one "
                             f"dtype, on {dev}")
    if out.shape != view.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} is not the view's {tuple(view.shape)}")
    if slot_bytes % 16:
        raise ValueError(f"{name}: a chunk slot of {slot_bytes} B is not a whole number of "
                         "16-byte vectors")
    lane = _lane(dev, cid)
    perm = None if pi is None else (ctypes.c_int * n)(*[int(d) for d in pi])
    send_mask = sum(1 << r for r, due in enumerate(send) if due)
    stream = torch.cuda.current_stream(dev)
    t = _lanes.table
    rc = _lib().uccl_a2a_launch(
        _KERNEL_ID[name], n, n, slot_bytes, t(view, n), t(out, n), t(lane.flags, n),
        ctypes.c_void_p(lane.err.data_ptr()), perm, send_mask, int(local), cid,
        lane.next_epoch(),
        _lanes.SPIN_TIMEOUT_MS.get() * 1_000_000, ctypes.c_void_p(stream.cuda_stream))
    _lanes.raise_on_launch(rc, name, dev)
    launch_counts[name] += 1
    return lane


def launch_a2a(view: torch.Tensor, out: torch.Tensor, cid: int) -> _lanes.Lane:
    """B9 on ``view`` ``[n, n, rows, LANES]`` into ``out`` alike."""
    return _launch("a2a", view, out, cid)


def launch_sched_round(view: torch.Tensor, out: torch.Tensor, pi, send, local: bool,
                       cid: int) -> _lanes.Lane:
    """B10, round ``pi``, on ``view`` ``[n, n, rows, LANES]`` into the
    exchange's receive buffer ``out`` alike: the pairs ``send`` marks, and
    the diagonal when ``local`` (:func:`round_bits`)."""
    return _launch("sched_round", view, out, cid, pi=pi, send=send, local=local)


# ---------------------------------------------------------------------------
# Entry points (member-stacked ports of the JAX per-shard functions)


def _as_bytes(x: torch.Tensor):
    """1-byte float payloads (the quantized wire's fp8) move as uint8: the
    kernels copy bytes, and the CPU's index copies do not take float8."""
    if x.element_size() == 1 and x.dtype.is_floating_point:
        return x.view(torch.uint8), x.dtype
    return x, None


def _view(x: torch.Tensor):
    """``[n, n, ...]`` → the kernels' view ``[n, n, rows, LANES]``, k, m."""
    n = x.shape[0]
    return _dma.pad_chunks(x.reshape(n, -1), n)


def _unview(buf: torch.Tensor, k: int, like: torch.Tensor) -> torch.Tensor:
    n = buf.shape[0]
    return buf.reshape(n, n, -1)[:, :, :k].reshape(like.shape)


def _check_world(x: torch.Tensor) -> int:
    n = x.shape[0]
    if n > 1 and (x.ndim < 2 or x.shape[1] != n):
        raise ValueError(
            f"all_to_all leading dim {x.shape[1] if x.ndim > 1 else None} != axis size {n}")
    return n


def _chunk_slices(x: torch.Tensor, n_chunks: int, chunk_axis: int):
    """Pad per-member axis ``chunk_axis`` of ``x`` to a multiple of
    ``n_chunks`` (``dma.pad_capacity``) and cut it: (padded x, chunk size,
    original size, tensor axis), or None when it cannot chunk."""
    axis = chunk_axis + 1
    if x.ndim <= axis:
        return None
    size = x.shape[axis]
    n_chunks = min(n_chunks, size)
    if size == 0 or n_chunks <= 1:
        return None
    padded = _dma.pad_capacity(size, n_chunks)
    if padded != size:
        pad = [0, 0] * (x.ndim - 1 - axis) + [0, padded - size]
        x = torch.nn.functional.pad(x, pad)
    return x, padded // n_chunks, size, axis, n_chunks


def _all_to_all_chunked(x: torch.Tensor, collective_id: int, n_chunks: int,
                        chunk_axis: int) -> Optional[torch.Tensor]:
    """Split per-member axis ``chunk_axis`` into ``n_chunks`` independent
    B9 launches on 2-parity rotated collective ids (the wire padded with
    empty slots by ``dma.pad_capacity``). None when the shape cannot chunk
    or, for a CPU tensor, the 2-deep footprint is over budget; the caller
    then runs the unchunked exchange."""
    n = x.shape[0]
    cut = _chunk_slices(x, n_chunks, chunk_axis)
    if cut is None:
        return None
    xp, cs, size, axis, n_chunks = cut
    per_peer = x[0].numel() // size * cs // n
    if _is_cpu(x) and not _dma.chunk_budget(n, per_peer, x.element_size(),
                                            "ep_all_to_all_chunked"):
        return None
    outs: List[torch.Tensor] = []
    for c in range(n_chunks):
        xc = _dma.tie_chunk(xp.narrow(axis, c * cs, cs), outs[c - 2] if c >= 2 else None)
        outs.append(all_to_all(xc, collective_id=_dma.chunk_collective_id(collective_id, c)))
    return torch.cat(outs, dim=axis).narrow(axis, 0, size)


def all_to_all(x: torch.Tensor, *, collective_id: Optional[int] = None, n_chunks: int = 1,
               chunk_axis: int = 1) -> torch.Tensor:
    """Member-stacked ``[W, W, ...]`` → ``x.transpose(0, 1)`` as ONE B9
    launch: member r's chunk d lands in member d's slot r. A world of 1 is
    the identity. ``n_chunks > 1`` splits per-member axis ``chunk_axis`` (a
    slot axis, never 0, the destination axis) into that many launches on
    rotated ids; the same bits either way. The launches' error words are
    read once, after the last (``lanes.one_check``)."""
    with _lanes.one_check():
        return _all_to_all(x, collective_id, n_chunks, chunk_axis)


def _all_to_all(x: torch.Tensor, collective_id: Optional[int], n_chunks: int,
                chunk_axis: int) -> torch.Tensor:
    n = _check_world(x)
    if n == 1:
        return x
    if collective_id is None:
        collective_id = _dma.CID_A2A
    xb, fp = _as_bytes(x)
    if n_chunks > 1:
        if chunk_axis == 0:
            raise ValueError("chunk_axis 0 is the member axis; chunk a trailing (slot) axis "
                             "instead")
        out = _all_to_all_chunked(xb, collective_id, n_chunks, chunk_axis)
        if out is not None:
            return out if fp is None else out.view(fp)
    view, k, m = _view(xb)
    if _is_cpu(x):
        # send and receive buffers of the exchange, as the JAX gate charges
        if not _dma.check_budget(2 * n * m * x.element_size(), "ep_all_to_all"):
            out = _lax_fallback(xb)
            return out if fp is None else out.view(fp)
        buf = a2a_plain(view)
    else:
        buf = torch.empty_like(view)
        launch_a2a(view, buf, collective_id).check("all_to_all")  # at the scope's end
    out = _unview(buf, k, xb)
    return out if fp is None else out.view(fp)


# ---------------------------------------------------------------------------
# The scheduled wire: one B10 launch per contention-free round


def _normalize_schedule(schedule, n: int):
    """Accept (rounds, K) from ``a2a_sched.wire_schedule`` (Round objects or
    raw permutation tuples) and return (perm tuples, K) validated against
    the world."""
    rounds, k_mat = schedule
    perms = []
    for rnd in rounds:
        perm = tuple(getattr(rnd, "perm", rnd))
        if sorted(perm) != list(range(n)):
            raise ValueError(f"scheduled a2a round {perm} is not a permutation of range({n})")
        perms.append(perm)
    k_arr = np.asarray(k_mat, np.int32)
    if k_arr.shape != (n, n):
        raise ValueError(f"designated-round matrix is {k_arr.shape}, want {(n, n)}")
    if perms and (k_arr.max() >= len(perms) or k_arr.min() < 0):
        raise ValueError("designated-round matrix indexes a missing round")
    for s in range(n):
        for d in range(n):
            if s != d and perms and perms[k_arr[s, d]][s] != d:
                raise ValueError(f"round {k_arr[s, d]} does not carry pair ({s}, {d})")
    return perms, k_arr


def _run_rounds(view: torch.Tensor, perms, k_mat, base_cid: int, launch_seq: list
                ) -> torch.Tensor:
    """One round per permutation over ``view`` ``[n, n, rows, LANES]``, all
    into one receive buffer alike, each pair written once, in its designated
    round. ``launch_seq`` is the global launch list shared across chunks:
    launch i takes id parity i & 1 (``chunk_collective_id(base, i)``) and
    ties to launch i-2, so at most two round kernels are ever in flight on
    the {base, base+1} pair."""
    out = torch.empty_like(view)
    for k, pi in enumerate(perms):
        send, local = round_bits(perms, k_mat, k)
        i = len(launch_seq)
        v = _dma.tie_chunk(view, launch_seq[i - 2] if i >= 2 else None)
        if _is_cpu(view):
            sched_round_plain(v, out, pi, send, local)
        else:
            lane = launch_sched_round(v, out, pi, send, local,
                                      _dma.chunk_collective_id(base_cid, i))
            lane.check("scheduled_all_to_all")  # deferred to the caller's scope end
        launch_seq.append(out)
    return out


def _scheduled_chunked(x: torch.Tensor, perms, k_mat, collective_id: int, n_chunks: int,
                       chunk_axis: int) -> Optional[torch.Tensor]:
    """The chunk-pipelined scheduled exchange: the slot axis split as in
    :func:`_all_to_all_chunked`, every chunk running the whole schedule, all
    (chunk, round) launches on one global sequence. None when the shape
    cannot chunk or (CPU tensors) past the double-buffer budget."""
    n = x.shape[0]
    cut = _chunk_slices(x, n_chunks, chunk_axis)
    if cut is None:
        return None
    xp, cs, size, axis, n_chunks = cut
    per_peer = x[0].numel() // size * cs // n
    if _is_cpu(x) and not _dma.chunk_budget(n, per_peer, x.element_size(),
                                            "ep_a2a_sched_chunked"):
        return None
    launch_seq: list = []
    outs = []
    for c in range(n_chunks):
        xc = xp.narrow(axis, c * cs, cs)
        view, kc, _ = _view(xc)
        outs.append(_unview(_run_rounds(view, perms, k_mat, collective_id, launch_seq), kc, xc))
    return torch.cat(outs, dim=axis).narrow(axis, 0, size)


def scheduled_all_to_all(x: torch.Tensor, schedule, *, collective_id: Optional[int] = None,
                         n_chunks: int = 1, chunk_axis: int = 1) -> torch.Tensor:
    """Member-stacked ``[W, W, ...]`` all-to-all driven one contention-free
    permutation round at a time (one B10 launch per round), each pair
    written into its final slot in its designated round: the same contract
    and bits as :func:`all_to_all`.
    ``schedule`` is the ``(rounds, K)`` pair of
    ``a2a_sched.wire_schedule``. Composes with ``n_chunks`` as the
    unscheduled wire does. Past its budget a CPU tensor takes the
    unscheduled exchange, counted. The rounds' error words are read once,
    after the last launch."""
    with _lanes.one_check():
        return _scheduled_all_to_all(x, schedule, collective_id, n_chunks, chunk_axis)


def _scheduled_all_to_all(x: torch.Tensor, schedule, collective_id: Optional[int],
                          n_chunks: int, chunk_axis: int) -> torch.Tensor:
    n = _check_world(x)
    if n == 1:
        return x
    perms, k_mat = _normalize_schedule(schedule, n)
    if not perms:  # nothing would cross the wire at n > 1
        raise ValueError("scheduled a2a needs at least one round at n > 1")
    if collective_id is None:
        collective_id = _dma.CID_SCHED
    xb, fp = _as_bytes(x)
    if n_chunks > 1:
        if chunk_axis == 0:
            raise ValueError("chunk_axis 0 is the member axis; chunk a trailing (slot) axis "
                             "instead")
        out = _scheduled_chunked(xb, perms, k_mat, collective_id, n_chunks, chunk_axis)
        if out is not None:
            return out if fp is None else out.view(fp)
    view, k, m = _view(xb)
    # charged as the JAX kernel is (the [n, ...] send view and one round slot,
    # two round kernels in flight), so a CPU tensor falls back where it does
    if _is_cpu(x) and not _dma.check_budget(2 * (n + 1) * m * x.element_size(), "ep_a2a_sched"):
        return all_to_all(x)
    launch_seq: list = []
    buf = _run_rounds(view, perms, k_mat, collective_id, launch_seq)
    out = _unview(buf, k, xb)
    return out if fp is None else out.view(fp)
