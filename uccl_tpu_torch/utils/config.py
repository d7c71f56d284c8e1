"""Environment-driven configuration parameters.

Port of ``uccl_tpu/utils/config.py`` (the ``UCCL_TPU_*`` param system), kept
as the port's own copy so that the port never imports the JAX package:

* A param is named once, reads ``UCCL_TPU_<NAME>`` lazily on first access,
  caches the value, and can be overridden programmatically (tests) or via an
  env file.
* Typed: int / float / bool / str, with a declared default.
* ``dump_params()`` returns every registered param.

The same environment variables drive both packages, so a knob such as
``UCCL_TPU_FLASH_BLOCK_Q`` keeps its name across the port.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

_ENV_PREFIX = "UCCL_TPU_"

_registry: Dict[str, "Param"] = {}
_registry_lock = threading.Lock()

# Values loaded from an env file; consulted before os.environ.
_env_file_values: Dict[str, str] = {}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on", "y")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    int: lambda s: int(s, 0),
    float: float,
    bool: _parse_bool,
    str: lambda s: s,
}


class Param:
    """A lazily-cached, env-overridable configuration value."""

    def __init__(self, name: str, default: Any, type_: type = None, help: str = ""):
        self.name = name
        self.env = _ENV_PREFIX + name.upper()
        self.default = default
        self.type = type_ or type(default)
        self.help = help
        self._cached: Optional[Any] = None
        self._resolved = False
        self._override: Optional[Any] = None
        if self.type not in _PARSERS:
            raise TypeError(f"unsupported param type {self.type} for {name}")

    def get(self) -> Any:
        if self._override is not None:
            return self._override
        if not self._resolved:
            raw = _env_file_values.get(self.env, os.environ.get(self.env))
            if raw is None:
                self._cached = self.default
            else:
                self._cached = _PARSERS[self.type](raw)
            self._resolved = True
        return self._cached

    def set(self, value: Any) -> None:
        """Programmatic override (wins over env); pass None to clear."""
        self._override = value

    def reset(self) -> None:
        """Drop the cache so the next get() re-reads the environment."""
        self._cached = None
        self._resolved = False
        self._override = None

    def __call__(self) -> Any:
        return self.get()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Param({self.name}={self.get()!r} env={self.env})"


def param(name: str, default: Any, type_: type = None, help: str = "") -> Param:
    """Declare (or fetch) a named config param. Idempotent per name."""
    with _registry_lock:
        existing = _registry.get(name)
        if existing is not None:
            return existing
        p = Param(name, default, type_, help)
        _registry[name] = p
        return p


def set_env_file(path: str) -> None:
    """Load KEY=VALUE lines; those values take precedence over os.environ."""
    values: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            values[k.strip()] = v.strip()
    _env_file_values.update(values)
    with _registry_lock:
        for p in _registry.values():
            p.reset()


def reset_all() -> None:
    """Test helper: drop every cached value."""
    with _registry_lock:
        for p in _registry.values():
            p.reset()
    _env_file_values.clear()


def dump_params() -> Dict[str, Any]:
    with _registry_lock:
        return {name: p.get() for name, p in sorted(_registry.items())}
