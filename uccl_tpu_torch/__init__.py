"""uccl_tpu_torch: the PyTorch and CUDA port of uccl_tpu, for NVIDIA Hopper.

The JAX package ``uccl_tpu`` is the reference; this package carries the same
modules under the same paths (``models/flagship.py`` here ports
``uccl_tpu/models/flagship.py``), in plain PyTorch, with every Pallas kernel
of the ported paths rewritten by hand for Hopper under ``csrc/``. It imports
neither ``jax`` nor ``uccl_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Asking for CUDA where there is none raises; nothing falls back to the CPU
silently. On a CPU tensor each kernel wrapper runs the kernel's plain
PyTorch version instead.
"""

from __future__ import annotations

from typing import Union

import torch

from uccl_tpu_torch.version import __version__  # noqa: F401

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises ``RuntimeError`` for a CUDA device when PyTorch sees no GPU, so a
    run meant for the card never runs on the CPU by accident."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    return dev
