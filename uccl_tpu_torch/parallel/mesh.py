"""The framework's canonical parallel axes, over a grid of members.

Port of ``uccl_tpu/parallel/mesh.py``. There a :class:`jax.sharding.Mesh`
lays the named axes ``('pp','dp','cp','tp')`` over devices. Here a
:class:`Mesh` lays the same axes over a grid of **members**, and records the
device each member lives on. In this slice every member lives on one device:
a collective's buffer is a member-major tensor ``[world, ...]`` on that
device, whose row ``r`` is member ``r``'s buffer, and the ring kernels run
all members of a world in one launch. A later slice that puts members on
separate cards gives each member its own device.

* ``dp`` — data parallel; ``pp`` — pipeline; ``cp`` — context/sequence;
  ``tp`` — tensor parallel (innermost); expert parallel runs over the
  flattened (``dp``, ``cp``) world.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from uccl_tpu_torch import DeviceLike, resolve_device


class AXIS:
    """Canonical mesh-axis names."""

    PP = "pp"
    DP = "dp"
    CP = "cp"
    TP = "tp"
    ALL: Tuple[str, ...] = ("pp", "dp", "cp", "tp")
    # Expert parallelism runs over the flattened data+context world.
    EP: Tuple[str, ...] = ("dp", "cp")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes of each parallel axis. Product must equal the member count."""

    pp: int = 1
    dp: int = 1
    cp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.pp * self.dp * self.cp * self.tp

    @property
    def ep(self) -> int:
        """Expert-parallel world size (dp × cp)."""
        return self.dp * self.cp

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.pp, self.dp, self.cp, self.tp)

    @staticmethod
    def auto(n_devices: int, want_pp: bool = True, want_cp: bool = True) -> "MeshConfig":
        """Pick a balanced config for n members, spending factors in priority
        order tp → dp → pp → cp, two-way at a time; any odd residue folds
        into dp."""
        sizes = {"pp": 1, "dp": 1, "cp": 1, "tp": 1}
        order = ["tp", "dp"] + (["pp"] if want_pp else []) + (["cp"] if want_cp else [])
        remaining = n_devices
        i = 0
        while remaining > 1:
            if remaining % 2 == 0:
                sizes[order[i]] *= 2
                remaining //= 2
            else:
                sizes["dp"] *= remaining
                remaining = 1
            i = (i + 1) % len(order)
        cfg = MeshConfig(**sizes)
        if cfg.size != n_devices:
            raise ValueError(f"MeshConfig.auto({n_devices}) built {cfg}")
        return cfg


@dataclass(frozen=True)
class Mesh:
    """The named axes ``AXIS.ALL`` over a grid of members, and the device
    every member lives on. ``shape`` maps axis name to size, as
    ``jax.sharding.Mesh.shape`` does."""

    config: MeshConfig
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS.ALL

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXIS.ALL, self.config.axis_sizes()))

    @property
    def size(self) -> int:
        return self.config.size


def make_mesh(config: Optional[MeshConfig] = None, device: DeviceLike = None,
              n_members: Optional[int] = None) -> Mesh:
    """Build the canonical 4-axis mesh of members on ``device`` (``cuda``
    unless the caller asks for the CPU).

    With no config, all ``n_members`` land on ``dp`` (one member when
    ``n_members`` is not given either). A config whose size is not
    ``n_members`` raises, as a JAX mesh whose config does not match its
    device count does."""
    if config is None:
        config = MeshConfig(dp=n_members or 1)
    if n_members is not None and config.size != n_members:
        raise ValueError(f"mesh config {config} needs {config.size} members, have {n_members}")
    return Mesh(config, resolve_device(device))


_default_mesh: Optional[Mesh] = None


def set_mesh(mesh: Mesh) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_mesh() -> Mesh:
    """The process-wide default mesh, creating a one-member mesh lazily."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh()
    return _default_mesh


def mesh_axis_size(mesh: Mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))
