"""NCCL-shaped Communicator over a mesh axis of members.

Port of ``uccl_tpu/collective/communicator.py``. Buffer model, as there: a
collective's buffer has a leading **rank dimension** of size ``world``, one
row per member (``all_reduce(x)[i] == sum_j x[j]`` etc.). In the JAX package
that dimension is laid out over the devices of the mesh axis; here every
member of the mesh lives on ``mesh.device``, so the buffer is one
member-major tensor on that device, and the ring kernels
(``ring_ccl``: B4, B5, B7) run all members in one launch. Results have the
JAX verbs' global shapes and live on the members' device.

Algorithms per verb, as in the JAX package:

* ``all_reduce``: ``xla`` (the library reduction), ``ring``, ``hd``,
  ``torus`` (plan lowerings, plain torch), ``pallas`` (one B7 launch, two
  counter-rotating streams), ``bidir`` (two B7 launches in flight), and
  ``auto`` (the planner); ops sum, max, min, mean, prod (kernels: sum).
* ``all_gather``: ``xla``, ``ring`` (B4), ``bidir`` (two B4), ``auto``.
* ``reduce_scatter``: ``xla``, ``ring`` (B5), ``auto``.
* ``broadcast``: ``xla`` (scatter + plan all-gather), ``tree``,
  ``scatter_ag`` (scatter + two B4), ``psum``, ``auto``.
* ``all_to_all``, ``permute``, ``ring_shift``, ``send_recv``, ``barrier``.

Every resolution (modeled, forced, explicit) is emitted on
``collective_plan_total`` once per distinct request (the plan memo). The
quantized wire is not ported yet: a ``wire_dtype`` raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.collective import ops as _ops
from uccl_tpu_torch.collective import plan as _plan
from uccl_tpu_torch.collective import ring_ccl
from uccl_tpu_torch.parallel.mesh import AXIS, Mesh, get_mesh, mesh_axis_size
from uccl_tpu_torch.utils.topology import ppermute_pairs

Axis = Union[str, Tuple[str, ...]]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    AVG = "mean"
    PROD = "prod"


def _as_tuple(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Communicator:
    """Collective communicator over one (or a tuple of) mesh axes, the
    counterpart of an ``ncclComm_t``. Its members are the mesh's members
    along those axes, linearized row-major."""

    def __init__(self, mesh: Optional[Mesh] = None, axis: Axis = AXIS.DP):
        self.mesh = mesh if mesh is not None else get_mesh()
        self.axes = _as_tuple(axis)
        for a in self.axes:
            if a not in self.mesh.shape:
                raise ValueError(f"axis {a!r} not in mesh axes {tuple(self.mesh.shape)}")
        self.world = mesh_axis_size(self.mesh, self.axes)
        # request → resolved plan: planner emission happens once per
        # distinct request, so repeated calls do no obs work
        self._plan_memo = {}

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _check(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if x.dim() < 1 or x.shape[0] != self.world:
            raise ValueError(
                f"expected leading rank dim of size {self.world}, got shape {tuple(x.shape)}"
            )
        return x.to(self.device)

    def device_put(self, x) -> torch.Tensor:
        """A host array with a leading rank dim, as the members' buffers on
        the members' device."""
        return self._check(x).contiguous()

    def _payload_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape[1:]) if x.dim() > 1 else (1,)

    def _worlds(self) -> Tuple[int, ...]:
        return tuple(self.mesh.shape[a] for a in self.axes)

    def _pallas_ok(self) -> bool:
        """Can the ring kernels address this communicator? A single axis."""
        return len(self.axes) == 1

    def _single_axis(self, what: str) -> None:
        if len(self.axes) != 1:
            raise ValueError(f"{what} rings a single mesh axis")

    def _memo(self, req, resolve):
        memo = self._plan_memo.get(req)
        if memo is None:
            memo = self._plan_memo[req] = resolve()
        return memo

    # -- all_reduce ----------------------------------------------------------

    def _resolve_ar_plan(self, x, op, algo):
        planner = _plan.get_planner()
        kw = dict(n_axes=len(self.axes), worlds=self._worlds())
        plan_ = None
        if algo == "auto":
            if op != ReduceOp.SUM:
                algo = "xla"  # the explicit plans are sum-only
            else:
                plan_ = planner.plan_all_reduce(self._payload_shape(x), x.dtype, self.world,
                                                pallas_ok=self._pallas_ok(), **kw)
                algo = plan_.algo
        if algo not in ("xla", "ring", "hd", "torus", "pallas", "bidir"):
            raise ValueError(f"unknown all_reduce algo {algo!r}")
        if plan_ is None:
            plan_ = planner.plan_explicit(algo, self._payload_shape(x), x.dtype, self.world,
                                          **kw)
        return plan_.algo

    def all_reduce(self, x, op: str = ReduceOp.SUM, algo: str = "xla",
                   wire_dtype=None) -> torch.Tensor:
        """out[i] = reduce_j x[j] for every rank i (see the module
        docstring for the algos); ``UCCL_TPU_AR_ALGO`` forces ``auto``."""
        x = self._check(x)
        _dma.resolve_wire_dtype(wire_dtype, "all_reduce")
        req = ("ar", op, algo, tuple(x.shape), x.dtype,
               _plan._AR_FORCE_ALGO.get() if algo == "auto" else "")
        algo = self._memo(req, lambda: self._resolve_ar_plan(x, op, algo))
        if algo in ("pallas", "bidir", "ring", "hd", "torus") and op != ReduceOp.SUM:
            raise ValueError(f"{algo} allreduce supports sum only")
        if algo in ("pallas", "bidir"):
            self._single_axis(f"{algo} allreduce")
            if algo == "bidir":
                return ring_ccl.bidir_all_reduce(x)
            return ring_ccl.ring_all_reduce(x)
        if algo == "ring":
            return _plan.ring_all_reduce(x)
        if algo == "hd":
            return _plan.hd_all_reduce(x)
        if algo == "torus":
            if len(self.axes) != 2:
                raise ValueError("torus allreduce needs a 2-axis communicator")
            return _plan.torus_all_reduce(x, self._worlds(), self.axes)
        return _ops.reduce_members(x, op)

    # -- all_gather ----------------------------------------------------------

    def _resolve_verb_plan(self, verb, x, algo, allowed, plan_fn):
        planner = _plan.get_planner()
        kw = dict(n_axes=len(self.axes), worlds=self._worlds())
        if algo == "auto":
            return plan_fn(planner)(self._payload_shape(x), x.dtype, self.world,
                                    pallas_ok=self._pallas_ok(), **kw).algo
        if algo not in allowed:
            raise ValueError(f"unknown {verb} algo {algo!r}")
        planner.plan_explicit(algo, self._payload_shape(x), x.dtype, self.world, verb=verb,
                              **kw)
        return algo

    def all_gather(self, x, algo: str = "auto", wire_dtype=None) -> torch.Tensor:
        """Every rank receives the concatenation over the rank dim: out is
        the same global array, replicated on every member (NCCL allgather
        semantics; the kernels build every member's copy)."""
        x = self._check(x)
        _dma.resolve_wire_dtype(wire_dtype, "all_gather")
        algo = self._memo(("ag", algo, tuple(x.shape), x.dtype), lambda: self._resolve_verb_plan(
            "all_gather", x, algo, ("xla", "ring", "bidir"), lambda p: p.plan_all_gather))
        if algo in ("ring", "bidir"):
            self._single_axis(f"{algo} all_gather")
            fn = ring_ccl.bidir_all_gather if algo == "bidir" else ring_ccl.ring_all_gather
            # member 0's copy: [1, k...] per member gathered to [world, ...]
            return fn(x.unsqueeze(1))[0].reshape(x.shape)
        return _ops.all_gather(x.unsqueeze(1))[0].reshape(x.shape)

    # -- reduce_scatter ------------------------------------------------------

    def reduce_scatter(self, x, op: str = ReduceOp.SUM, algo: str = "auto",
                       wire_dtype=None) -> torch.Tensor:
        """x: [world, N, ...] (each rank contributes a full buffer); out:
        [world, N/world, ...] with out[i] = reduce_j x[j] chunk i."""
        x = self._check(x)
        if x.dim() < 2 or x.shape[1] % self.world != 0:
            raise ValueError(
                f"reduce_scatter payload dim {tuple(x.shape)} must divide world {self.world}"
            )
        if op != ReduceOp.SUM:
            raise NotImplementedError("reduce_scatter supports sum only")
        _dma.resolve_wire_dtype(wire_dtype, "reduce_scatter")
        algo = self._memo(("rs", algo, tuple(x.shape), x.dtype), lambda: self._resolve_verb_plan(
            "reduce_scatter", x, algo, ("xla", "ring"), lambda p: p.plan_reduce_scatter))
        if algo == "ring":
            self._single_axis("ring reduce_scatter")
            return ring_ccl.ring_reduce_scatter(x)
        return _ops.reduce_scatter(x)

    # -- all_to_all ----------------------------------------------------------

    def all_to_all(self, x) -> torch.Tensor:
        """x: [world, world, ...]; out[i, j] = x[j, i]."""
        x = self._check(x)
        if x.dim() < 2 or x.shape[1] != self.world:
            raise ValueError(f"all_to_all needs shape [world, world, ...], got {tuple(x.shape)}")
        return _ops.all_to_all(x, split_dim=0, concat_dim=0)

    # -- broadcast -----------------------------------------------------------

    def broadcast(self, x, root: int = 0, algo: str = "auto",
                  wire_dtype=None) -> torch.Tensor:
        """out[i] = x[root] for every i."""
        x = self._check(x)
        if not 0 <= root < self.world:
            raise ValueError(f"root {root} outside world {self.world}")
        _dma.resolve_wire_dtype(wire_dtype, "broadcast")
        algo = self._memo(("bc", algo, tuple(x.shape), x.dtype), lambda: self._resolve_verb_plan(
            "broadcast", x, algo, ("xla", "tree", "scatter_ag", "psum"),
            lambda p: p.plan_broadcast))
        if algo == "scatter_ag":
            self._single_axis("scatter_ag broadcast")
            return ring_ccl.scatter_ag_broadcast(x, root)
        if algo == "tree":
            return _plan.tree_broadcast(x, root)
        if algo == "psum":
            # the legacy lowering, kept as the wire-byte baseline: mask every
            # non-root contribution to zero, then sum (bytes at the tree
            # volume 2S, as the JAX package counts them)
            ring_ccl._count_wire_bytes("bcast", "psum", None, 2 * x[0].numel() * x.element_size())
            masked = torch.zeros_like(x)
            masked[root] = x[root]
            return _ops.reduce_members(masked, "sum")
        return ring_ccl.scatter_gather_broadcast_lax(x, root)

    # -- point to point ------------------------------------------------------

    def permute(self, x, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """out[dst] = x[src] for each (src, dst); ranks not named as a dst
        receive zeros (``lax.ppermute`` semantics)."""
        x = self._check(x)
        return _ops.ppermute(x, [(int(s), int(d)) for s, d in perm])

    def ring_shift(self, x, shift: int = 1) -> torch.Tensor:
        return self.permute(x, ppermute_pairs(self.world, shift))

    def send_recv(self, x, src: int, dst: int) -> torch.Tensor:
        return self.permute(x, [(src, dst)])

    def barrier(self) -> None:
        """Run a tiny allreduce and wait for it."""
        token = torch.zeros((self.world, 1), dtype=torch.float32, device=self.device)
        self.all_reduce(token)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
