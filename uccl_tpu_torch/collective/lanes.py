"""Flag regions of the hand-written collective kernels, and their error checks.

Shared by the ring wrappers (``collective/ring_ccl.py``, B4-B8) and the EP
all-to-all wrappers (``ep/pallas_a2a.py``, B9 and B10). Their kernels
synchronize members through single-writer 64-bit flags (the device side is
``csrc/collective.cuh``). One collective id on one device owns a region, a
:class:`Lane`: the flag words, zeroed once; an error word that a spin-wait
past :data:`SPIN_TIMEOUT_MS` writes; and the epoch counter that makes every
launch's marks larger than any earlier launch's. A :class:`Lanes` table
holds one library's regions, its flag shape a parameter.

Error checks. Reading an error word is a host read, so it waits for the
stream. A wrapper calls :meth:`Lane.check` after its last launch. Inside a
:class:`one_check` scope that call only notes the lane; the scope reads
every noted lane with one host read when it closes, so a verb of many
launches (a chunk pipeline, a round schedule, payload then scales) waits
once, at its end, and the host queues all of it before the first kernel
finishes. Scopes nest: the outermost one checks. A scope opened with
``blocking=False`` (a verb with ``async_finish``) copies the words to host
memory without waiting and returns a :class:`Pending`: its ``resolve()``
reads them and raises. The next blocking check resolves every pending one
first, so a timeout always surfaces, at the latest there.

JAX counterpart: none. The Pallas kernels' semaphores live in the kernels'
own scratch, and a hung TPU DMA has no error word.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from uccl_tpu_torch.utils.config import param

MAX_MEMBERS = 16  # kMaxMembers in csrc/collective.cuh
MAX_CHANNELS = 64  # kMaxChannels

SPIN_TIMEOUT_MS = param(
    "SPIN_TIMEOUT_MS", 10000, int,
    "bound on any one spin-wait of the ring and EP all-to-all kernels; a wait "
    "past it writes the kernel's error word and the wrapper raises",
)


class Lane:
    """The flag region of one collective id on one device."""

    def __init__(self, owner: "Lanes", device: torch.device, cid: int):
        self.owner, self.cid = owner, cid
        self.flags = torch.zeros(owner.flag_shape, dtype=torch.int64, device=device)
        self.err = torch.zeros(8, dtype=torch.int32, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch >= 1 << 31:
            raise RuntimeError(f"collective id {self.cid}: epoch counter exhausted")
        return self.epoch

    def check(self, what: str) -> None:
        """Raise if a launch on this region reported a spin-wait timeout
        (reads the error word: waits for the stream), or, inside a
        :class:`one_check` scope, leave that to the scope's end."""
        check_all([(self, what)])

    def _message(self, word: Sequence[int], what: str) -> str:
        kernels, waits = self.owner.kernels, self.owner.waits
        kernel = kernels[word[1]] if 0 <= word[1] < len(kernels) else word[1]
        wait = waits[word[7]] if 0 <= word[7] < len(waits) else word[7]
        return (f"{what}: kernel {kernel} timed out after {SPIN_TIMEOUT_MS.get()} ms in its "
                f"{wait} wait (member {word[2]}, step {word[3]}, collective id {word[4]}, "
                f"{self.owner.peer_label} {word[5]}, channel {word[6]}); a peer never signalled")


class Lanes:
    """One kernel library's flag regions, by (device, collective id).
    ``flag_shape`` is a region's flag words, ``kernels`` and ``waits`` name
    the error word's kernel and wait codes, ``peer_label`` its sixth word."""

    def __init__(self, flag_shape: Tuple[int, ...], kernels: Sequence[str],
                 waits: Sequence[str], peer_label: str):
        self.flag_shape, self.kernels, self.waits = flag_shape, kernels, waits
        self.peer_label = peer_label
        self._lanes: Dict[Tuple[int, int], Lane] = {}
        self._lock = threading.Lock()

    def get(self, device: torch.device, cid: int) -> Lane:
        with self._lock:
            key = (device.index, cid)
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = Lane(self, device, cid)
            return lane


# ---------------------------------------------------------------------------
# The checks


_local = threading.local()
_pending: List["Pending"] = []
_pending_lock = threading.Lock()


def _raise_first(checks: Sequence[Tuple[Lane, str]], words: List[List[int]]) -> None:
    for (lane, what), word in zip(checks, words):
        if word[0]:
            lane.err.zero_()
            raise RuntimeError(lane._message(word, what))


def _unique(checks: Sequence[Tuple[Lane, str]]) -> List[Tuple[Lane, str]]:
    seen: Dict[int, Tuple[Lane, str]] = {}
    for lane, what in checks:
        seen.setdefault(id(lane), (lane, what))
    return list(seen.values())


def _words(checks: Sequence[Tuple[Lane, str]]) -> torch.Tensor:
    errs = [lane.err for lane, _ in checks]
    return errs[0][None] if len(errs) == 1 else torch.stack(errs)


def check_all(checks: Sequence[Tuple[Lane, str]]) -> None:
    """Raise on the first of ``checks`` ((lane, what) pairs) whose error
    word is set, with one host read for all of them; inside a
    :class:`one_check` scope, note them for the scope's end instead."""
    scope = getattr(_local, "scope", None)
    if scope is not None:
        scope.checks.extend(checks)
        return
    resolve_pending()
    checks = _unique(checks)
    if checks:
        _raise_first(checks, _words(checks).tolist())


class Pending:
    """Error words copied to host memory without a wait, read by
    :meth:`resolve` (which waits for the copy)."""

    def __init__(self, checks: List[Tuple[Lane, str]]):
        self.checks = checks
        words = _words(checks)
        self.host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
        self.host.copy_(words, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(words.device))
        self.done = False

    def ready(self) -> bool:
        return self.done or self.event.query()

    def resolve(self) -> None:
        if self.done:
            return
        self.done = True
        with _pending_lock:
            if self in _pending:
                _pending.remove(self)
        self.event.synchronize()
        _raise_first(self.checks, self.host.tolist())


def resolve_pending() -> None:
    """Resolve every outstanding :class:`Pending`, oldest first."""
    with _pending_lock:
        todo = list(_pending)
    for p in todo:
        p.resolve()


class one_check:
    """A scope whose kernel launches are checked once, at its end (see the
    module docstring). ``blocking=False`` leaves a :class:`Pending` in
    ``self.pending`` instead of waiting; nested scopes defer to the
    outermost. Nothing is checked when the scope exits by an exception."""

    def __init__(self, *, blocking: bool = True):
        self.blocking = blocking
        self.checks: List[Tuple[Lane, str]] = []
        self.pending: Optional[Pending] = None

    def __enter__(self) -> "one_check":
        self.outer = getattr(_local, "scope", None)
        if self.outer is None:
            _local.scope = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.outer is not None:
            return False
        _local.scope = None
        checks = _unique(self.checks)
        if exc_type is not None or not checks:
            return False
        if self.blocking:
            check_all(checks)
        else:
            self.pending = Pending(checks)
            with _pending_lock:
                _pending.append(self.pending)
        return False


# ---------------------------------------------------------------------------
# The libraries


def load_library(name: str, prefix: str, flag_words: int) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library, built first if needed, its limits
    (``<prefix>_max_members``, ``_max_channels``, ``_flag_words``) checked
    against this side's."""
    from uccl_tpu_torch.utils import build

    lib = build.load(name)
    getters = [getattr(lib, f"{prefix}_{w}") for w in ("max_members", "max_channels",
                                                       "flag_words")]
    for g in getters:
        g.restype = ctypes.c_int
    limits = tuple(g() for g in getters)
    if limits != (MAX_MEMBERS, MAX_CHANNELS, flag_words):
        raise RuntimeError(f"csrc/{name}.cu limits {limits} disagree with "
                           f"{(MAX_MEMBERS, MAX_CHANNELS, flag_words)}")
    return lib


def table(t: Optional[torch.Tensor], n: int):
    """One address per member: row r of ``t`` (null for no tensor)."""
    arr = (ctypes.c_void_p * n)()
    if t is not None:
        step = t.stride(0) * t.element_size()
        for r in range(n):
            arr[r] = t.data_ptr() + r * step
    return arr


def raise_on_launch(rc: int, name: str, device: torch.device) -> None:
    """A launch entry point's return code: 0, a cudaError_t, or -1."""
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with code {rc} on "
                           f"{torch.cuda.get_device_name(device)}; the kernel did not run")
