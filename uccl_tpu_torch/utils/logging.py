"""Leveled, subsystem-scoped logging.

Equivalent of the reference's ``include/util/debug.h:1-60``:
``UCCL_LOG(level)`` / ``UCCL_LOG(INFO, subsys)`` with levels FATAL/ERROR/WARN/INFO
and env-controlled subsystem filtering.

Env controls (mirroring UCCL_DEBUG / UCCL_DEBUG_SUBSYS):

* ``UCCL_TPU_DEBUG``        — minimum level name (FATAL|ERROR|WARN|INFO|DEBUG).
* ``UCCL_TPU_DEBUG_SUBSYS`` — comma list of subsystems to enable, or ``ALL``.

``CHECK`` / ``DCHECK`` are the reference's ``UCCL_CHECK`` / ``UCCL_DCHECK``:
an always-on and a debug-only invariant check raising :class:`CheckError`
(``UCCL_TPU_DCHECK=0`` turns the second off).

Port copy of ``uccl_tpu/utils/logging.py`` (jax-free there too); the port's
loggers hang under ``uccl_tpu_torch`` so the two packages never share handlers.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Any, Optional

SUBSYSTEMS = (
    "INIT",
    "COLL",
    "P2P",
    "EP",
    "PARALLEL",
    "OPS",
    "MODEL",
    "NATIVE",
    "UTIL",
)

_LEVELS = {
    "FATAL": logging.CRITICAL,
    "ERROR": logging.ERROR,
    "WARN": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
}

_lock = threading.Lock()
_configured = False
_enabled_subsys: Optional[set] = None  # None => ALL


def _configure() -> None:
    global _configured, _enabled_subsys
    with _lock:
        if _configured:
            return
        level_name = os.environ.get("UCCL_TPU_DEBUG", "WARN").upper()
        level = _LEVELS.get(level_name, logging.WARNING)
        root = logging.getLogger("uccl_tpu_torch")
        root.setLevel(level)
        if not root.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter(
                    "[%(asctime)s %(levelname)s %(name)s] %(message)s", "%H:%M:%S"
                )
            )
            root.addHandler(h)
        root.propagate = False
        subsys = os.environ.get("UCCL_TPU_DEBUG_SUBSYS", "ALL").upper()
        _enabled_subsys = (
            None if subsys == "ALL" else {s.strip() for s in subsys.split(",")}
        )
        _configured = True


def get_logger(subsys: str = "UTIL") -> logging.Logger:
    _configure()
    if subsys not in SUBSYSTEMS:
        raise ValueError(f"unknown subsystem {subsys!r}; one of {SUBSYSTEMS}")
    logger = logging.getLogger(f"uccl_tpu_torch.{subsys}")
    if _enabled_subsys is not None and subsys not in _enabled_subsys:
        logger.setLevel(logging.CRITICAL)  # effectively silenced except FATAL
    return logger


def log(level: str, msg: str, *args: Any, subsys: str = "UTIL") -> None:
    """UCCL_LOG(level, subsys)-style one-shot logging."""
    lvl = _LEVELS.get(level.upper())
    if lvl is None:
        raise ValueError(f"unknown level {level!r}")
    get_logger(subsys).log(lvl, msg, *args)
    if level.upper() == "FATAL":
        raise RuntimeError(f"FATAL[{subsys}]: {msg % args if args else msg}")


class CheckError(AssertionError):
    pass


def CHECK(cond: Any, msg: str = "CHECK failed") -> None:
    """Always-on invariant check (reference UCCL_CHECK)."""
    if not cond:
        raise CheckError(msg)


_DCHECK_ON = os.environ.get("UCCL_TPU_DCHECK", "1") not in ("0", "false", "off")


def DCHECK(cond: Any, msg: str = "DCHECK failed") -> None:
    """Debug-only check (reference UCCL_DCHECK); disable with UCCL_TPU_DCHECK=0."""
    if _DCHECK_ON and not cond:
        raise CheckError(msg)
