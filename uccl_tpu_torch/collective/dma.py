"""Shared building blocks of the device-level ring kernels.

Port of ``uccl_tpu/collective/dma.py``: chunk padding, the collective-id
map, the arena budget gate, neighbor arithmetic and the counted fallback.

What changed on the way from the TPU:

* ``MAX_VMEM_BYTES`` was the per-shard VMEM ceiling of a Pallas kernel.
  Here :data:`MAX_ARENA_BYTES` is the arena each member would hold for
  one ring kernel (its data slots and staging), and it keeps the knob name
  ``UCCL_TPU_PALLAS_CCL_MAX_BYTES``. It models nothing on the card, where
  the kernels allocate their buffers per call and take every size: it is
  the planner's quiet probe, so ``auto`` decides as in the JAX package, and
  the gate of CPU tensors, whose larger payloads fall back to the plan
  lowering, counted.
* The interpreter knobs (``interpret_default``, ``faithful_sync``,
  ``interp``, ``MESH``, ``remote_kwargs``) have no counterpart: there is no
  interpret mode of a CUDA kernel, and the CPU runs the kernels' plain
  versions instead.
* The entry and phase barriers (``ring_barrier``, ``all_barrier``) are flag
  waits inside ``csrc/ring_ccl.cu``.
* The scale sidecar's layout (``scale_rows``, ``pack_row_scales``,
  ``unpack_row_scales``) is carried over as it is: one f32 scale per
  128-lane payload row, 128 scales per sidecar row, zero tail.
* The chunk pipeline's helpers (``pad_capacity``, ``chunk_budget``,
  ``tie_chunk``) serve the EP all-to-all (``ep/pallas_a2a.py``).
  ``chunk_budget`` charges what the JAX package charges on a TPU (every
  resident chunk kernel's send and receive slots), not its interpreter's
  single-buffer ceiling; like every gate here it decides for CPU tensors
  only. ``tie_chunk`` is the identity: the EP wrappers launch every chunk
  kernel on the caller's current CUDA stream, whose order already puts
  chunk c after chunk c-2.
"""

from __future__ import annotations

from typing import Tuple

import torch

from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.utils import config as _config

LANES = 128
# Pad each chunk to a multiple of 8x128 elements, as the JAX package does,
# so both packages slice payloads into the same slots and compare bit for bit.
CHUNK_QUANTUM = 8 * LANES

MAX_ARENA_BYTES = _config.param(
    "PALLAS_CCL_MAX_BYTES",
    2 << 30,
    int,
    "per-member arena budget of one ring collective kernel (its data slots"
    " and staging): the planner's auto probe, and on CPU tensors the gate past"
    " which a kernel algo falls back to the plan lowering, counted on"
    " ep_wire_fallback_total; CUDA tensors launch the kernels at every size",
)

# Every transparent kernel-to-lowering downgrade increments this counter
# with its site (``what``) and ``reason``; declared at import so the series
# exists (as 0) before the first fallback.
WIRE_FALLBACK = _obsc.counter(
    "ep_wire_fallback_total",
    "transparent pallas-wire downgrades (chunked->unchunked->lax) by "
    "site (what) and reason",
)
_fallback_logged = set()  # (what, reason, detail): log once per shape


def record_fallback(what: str, reason: str, detail=None, msg=None) -> None:
    """Count a transparent wire downgrade and log it ONCE per
    (what, reason, detail)."""
    WIRE_FALLBACK.inc(what=what, reason=reason)
    key = (what, reason, detail)
    if key in _fallback_logged:
        return
    _fallback_logged.add(key)
    from uccl_tpu_torch.utils.logging import log

    log("INFO", msg or f"ring {what}: falling back ({reason}, {detail})", subsys="COLL")


# collective_id allocation for kernels that may be in flight at once; each
# id owns its own flag region of the arena (ring_ccl), so two kernels that
# fly together must never share one. 0 = the ring collectives (default),
# {2,3}/{4,5}/{6,7} = EP dispatch/combine/generic a2a lanes, +8 = their
# scale lanes, {16,17} = the bidir allreduce's fwd/bwd rings, {18,19} = the
# bidir all-gather pair, {20,21} = the broadcast's all-gather pair,
# {22,23}/{32,33} = the scheduled EP a2a rounds.
CID_EP_DISPATCH = 2
CID_EP_COMBINE = 4
CID_A2A = 6
CID_SCALE_OFFSET = 8
CID_RING_BIDIR = 16
CID_AG_BIDIR = 18
CID_BCAST = 20
CID_SCHED = 22
CID_SCHED_COMBINE = 32


def chunk_collective_id(base: int, chunk: int) -> int:
    """2-deep rotation: chunk kernels alternate ``base``/``base+1`` so chunk
    c+1 can enter while chunk c-1 drains, without sharing flags."""
    return base + (chunk & 1)


def scale_rows(rows: int) -> int:
    """Rows of the packed per-row scale buffer a quantized-wire kernel moves
    beside its payload: one f32 scale per 128-lane payload row, packed
    LANES scales per buffer row — ``ceil(rows / LANES)``."""
    return -(-rows // LANES)


def pack_row_scales(s: torch.Tensor, srows: int) -> torch.Tensor:
    """[..., rows] per-row f32 scales → the [..., srows, LANES] wire buffer
    (zero-padded tail; a zero scale dequantizes padding to exact zeros).
    Pure layout: values are untouched."""
    *lead, rows = s.shape
    pad = srows * LANES - rows
    if pad:
        s = torch.nn.functional.pad(s, (0, pad))
    return s.reshape(*lead, srows, LANES)


def unpack_row_scales(sp: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_row_scales`: [..., srows, LANES] → [..., rows]."""
    *lead, srows, lanes = sp.shape
    return sp.reshape(*lead, srows * lanes)[..., :rows]


def pad_chunks(flat: torch.Tensor, parts: int) -> Tuple[torch.Tensor, int, int]:
    """Split the last dim of ``flat`` ([..., N]) into ``parts`` equal chunks
    of k elements (tail zero-padded), then pad EACH chunk to m (a
    CHUNK_QUANTUM multiple) — chunk boundaries are slots, so padding is per
    chunk, not at the tail. Returns ([..., parts, m//128, 128], k, m)."""
    *lead, size = flat.shape
    k = -(-size // parts)
    m = -(-k // CHUNK_QUANTUM) * CHUNK_QUANTUM
    out = flat.new_zeros((*lead, parts, m))
    full, rem = divmod(size, k) if k else (0, 0)
    if full:
        out[..., :full, :k] = flat[..., : full * k].reshape(*lead, full, k)
    if rem:
        out[..., full, :rem] = flat[..., full * k:]
    return out.reshape(*lead, parts, m // LANES, LANES), k, m


def pad_capacity(cap: int, n_chunks: int) -> int:
    """Round a capacity/slot count up to a multiple of ``n_chunks``: the one
    rounding rule of every chunked EP pipeline, so chunking pads the wire
    with empty slots and never changes which tokens drop."""
    n_chunks = max(1, int(n_chunks))
    if cap % n_chunks:
        cap += n_chunks - cap % n_chunks
    return cap


def tie_chunk(x, prev):
    """The chunk pipeline's launch-granularity credit: chunk c's kernel must
    not start before chunk c-2's (its collective-id parity twin) has
    finished. The JAX package ties the two with a dataflow edge. Here every
    chunk kernel goes to the caller's current CUDA stream, which runs
    launches in order, so the tie holds already and ``x`` is returned as it
    is; a caller that moves chunk launches to a second stream must order
    them with CUDA events instead. ``prev`` is chunk c-2's result (or None)."""
    del prev
    return x


def chunk_budget(world: int, chunk_elems_per_peer: int, itemsize: int, what: str,
                 resident_kernels: int = 2, quiet: bool = False) -> bool:
    """Budget gate of the double-buffered chunk pipeline: ``resident_kernels``
    chunk kernels at once, each holding a send and a receive buffer of
    ``[world, m]`` padded slots (2 for one chunked exchange, 4 for the
    pipelined MoE layer: two per dispatch and combine family). Charged up
    front, so that a pipeline over budget falls back to the unchunked wire
    as a whole (counted, as :func:`check_budget` does)."""
    m = padded_chunk_elems(chunk_elems_per_peer)
    return check_budget(resident_kernels * 2 * world * m * itemsize, what, quiet=quiet)


def padded_chunk_elems(elems_per_peer: int) -> int:
    """Elements per peer after the CHUNK_QUANTUM padding pad_chunks applies
    — the m in the kernels' [world, m] slot layout."""
    return -(-elems_per_peer // CHUNK_QUANTUM) * CHUNK_QUANTUM


def neighbors(r, n: int, d: int):
    """(r, right, left) of member ``r`` on a ring of ``n`` in direction
    ``d``: it sends to ``right`` and receives from ``left``."""
    return r, (r + d + n) % n, (r - d + n) % n


def budget_limit() -> int:
    """The effective per-member arena size (no logging), shared by the gate
    and by observers that ask what it would decide."""
    return MAX_ARENA_BYTES.get()


def check_budget(nbytes: int, what: str, quiet: bool = False) -> bool:
    """True when a kernel's per-member charge fits the arena. Otherwise a
    CPU caller takes its plan lowering, counted on ``ep_wire_fallback_total``
    (reason ``arena_budget``) and logged once per shape; ``quiet`` asks what
    the gate would decide without counting."""
    limit = budget_limit()
    if nbytes > limit:
        if not quiet:
            record_fallback(
                what, "arena_budget", detail=nbytes,
                msg=(f"ring {what}: {nbytes}B exceeds the arena budget {limit}B; "
                     "falling back to the plan lowering"),
            )
        return False
    return True
