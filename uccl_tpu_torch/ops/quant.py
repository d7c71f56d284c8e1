"""Block-scaled wire codec: fp8 / int8 payloads + per-block f32 scales.

Port of ``uccl_tpu/ops/quant.py``, whole public surface, in plain torch (the
JAX codec is XLA code, not a Pallas kernel). It is the ONE scale rule every
quantized wire of the port shares: the ring collectives
(``collective/ring_ccl.py``, ``wire_dtype=``) quantize per 128-lane row of
their padded chunk layout, and the CUDA kernels B6 and B8
(``csrc/ring_ccl.cu``) carry the same arithmetic in their bodies, so a
kernel and its plain version agree bit for bit.

Codec contract (``quantize_block`` / ``dequantize_block``), as in the JAX
package:

* symmetric block scaling along the LAST dim: ``scale = amax / QMAX`` per
  block (``QMAX`` = 448 for fp8 e4m3fn, 127 for int8), values divided by the
  scale, clipped to ±QMAX and cast (int8 rounds to nearest even first).
  The scale is computed as ``amax * (1 / QMAX)``, the reciprocal rounded to
  f32 once: that is what the JAX package computes wherever it runs compiled
  (XLA rewrites a division by the constant QMAX into this product, in the
  Pallas kernels and in every jitted caller), and the port follows the
  compiled arithmetic so that its results equal the JAX package's bit for
  bit. Run op by op outside ``jit``, the JAX codec divides, and a block's
  scale can then differ from the port's by one ulp;
* **padding-safe**: a trailing block that does not divide the last dim is
  zero-padded internally and sliced back;
* **zero/denormal-safe**: an exact-zero block takes ``scale = 1.0`` and
  round-trips to exact zeros, a denormal-amax block's scale is floored at
  the smallest normal f32, and ``dequantize_block`` maps zero/denormal/nan
  scales to 0;
* **non-finite-loud**: a block holding any inf/nan element gets scale +inf,
  so the whole block dequantizes non-finite instead of arriving as zeros.

Per-block error bound of one quantize→dequantize round trip:
``|err| <= amax / 27.7`` for fp8 and ``amax / 254`` for int8
(:data:`ROUND_TRIP_DIVISOR`). The fp8 divisor carries the slack of a
substrate that double-rounds the f32→e4m3 cast through f16 (XLA:CPU does);
torch, on the CPU and on the card, rounds once, so the two packages' fp8
payloads can differ by one step on an exact tie of that double rounding and
nowhere else.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0  # max normal of e4m3fn
INT8_MAX = 127.0  # symmetric int8 (−127..127; −128 unused)

# wire_dtype name -> (payload torch dtype, QMAX, needs integer rounding)
WIRE_DTYPES = {
    "fp8": (FP8_DTYPE, FP8_MAX, False),
    "int8": (torch.int8, INT8_MAX, True),
}
# 1 / QMAX rounded to f32: the factor that turns a block's amax into its scale
_INV_QMAX = {name: (torch.ones((), dtype=torch.float32) / qmax).item()
             for name, (_, qmax, _) in WIRE_DTYPES.items()}

# One quantize→dequantize trip is bounded by |err| <= amax / ROUND_TRIP_DIVISOR.
ROUND_TRIP_DIVISOR = {"fp8": 27.7, "int8": 254.0}

# scale floor: the smallest NORMAL f32, so |x / scale| stays finite
_SCALE_TINY = float(torch.finfo(torch.float32).tiny)


def round_trip_bound(amax: float, wire_dtype: str) -> float:
    """Max |error| of one quantize→dequantize round trip for a block whose
    abs-max is ``amax`` (the documented contract, not a re-derivation)."""
    return float(amax) / ROUND_TRIP_DIVISOR[resolve_wire_dtype(wire_dtype)]


def resolve_wire_dtype(wire_dtype: Optional[str]) -> Optional[str]:
    """Validate a ``wire_dtype`` knob value (None | "fp8" | "int8")."""
    if wire_dtype is None or wire_dtype in ("", "none"):
        return None
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r} (want None, 'fp8', or 'int8')")
    return wire_dtype


def wire_payload_dtype(wire_dtype: str) -> torch.dtype:
    """The torch payload dtype of a wire_dtype."""
    return WIRE_DTYPES[wire_dtype][0]


def wire_qmax(wire_dtype: str) -> float:
    return WIRE_DTYPES[wire_dtype][1]


def adapt_block(d: int, block: int) -> int:
    """Adapt a block size to a dim: the largest divisor of ``d`` no bigger
    than the requested block."""
    if d % block:
        block = max(b for b in range(min(block, d), 0, -1) if d % b == 0)
    return block


def paying_block(d: int, block: int) -> Optional[int]:
    """The adapted block when block-scaled quantization PAYS on the wire,
    else None: 1 payload byte + 4/g scale bytes beats bf16's 2 only for
    g > 4; the established margin is g >= 8."""
    g = adapt_block(d, block)
    return g if g >= 8 else None


def wire_bytes_of(shape, dtype: torch.dtype, wire_dtype: Optional[str] = None,
                  quant_group: int = 128) -> int:
    """Actual wire bytes one exchange of a payload array moves under the
    block codec: quantized payload (1 byte/elem) PLUS the f32 scale sidecar
    when the wire dtype applies, raw element bytes otherwise — the ONE
    arithmetic ``ep_bytes_total`` and the planner's cost model share."""
    elems = math.prod(int(s) for s in shape)
    if wire_dtype is None or not dtype.is_floating_point:
        return elems * dtype.itemsize  # full precision / non-float raw wire
    g = paying_block(int(shape[-1]), quant_group) if len(shape) else None
    if g is None:
        return elems * dtype.itemsize  # quantization would not pay — raw wire
    return elems + (elems // g) * 4


def quantize_block(x: torch.Tensor, wire_dtype: str = "fp8",
                   block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled symmetric quantization along the last dim.

    x: [..., D] → (values [..., D] in the wire payload dtype,
    scales [..., ceil(D/block)] f32) such that ``values * scale ≈ x``."""
    wire_dtype = resolve_wire_dtype(wire_dtype)
    if wire_dtype is None:
        raise ValueError("quantize_block needs a wire_dtype ('fp8'/'int8')")
    dtype, qmax, integer = WIRE_DTYPES[wire_dtype]
    *lead, d = x.shape
    nb = -(-d // block)
    pad = nb * block - d
    g = x.to(torch.float32)
    if pad:
        g = F.pad(g, (0, pad))
    g = g.reshape(*lead, nb, block)
    amax = g.abs().amax(dim=-1, keepdim=True)  # propagates nan, like jnp.max
    scale = torch.where(amax > 0.0,
                        torch.clamp_min(amax * _INV_QMAX[wire_dtype], _SCALE_TINY), 1.0)
    # a block holding any non-finite element: scale +inf, so the whole
    # block dequantizes non-finite (divergence stays loud)
    scale = torch.where(torch.isfinite(amax), scale, math.inf)
    q = torch.clamp(g / scale, -qmax, qmax)
    if integer:
        # round half to even; nan (a poisoned block) casts to 0, stated
        # here because a float→int cast of nan is otherwise unspecified
        q = torch.nan_to_num(torch.round(q), nan=0.0)
    q = q.to(dtype).reshape(*lead, nb * block)
    if pad:
        q = q[..., :d]
    return q, scale[..., 0]


def dequantize_block(q: torch.Tensor, scale: torch.Tensor, block: int = 128,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_block`. A zero/denormal/nan scale
    dequantizes its block to exact zeros; a **+inf** scale (the quantizer's
    marker of a non-finite block) is let through, so the block arrives
    non-finite."""
    *lead, d = q.shape
    nb = scale.shape[-1]
    pad = nb * block - d
    g = q.to(torch.float32)
    if pad:
        g = F.pad(g, (0, pad))
    g = g.reshape(*lead, nb, block)
    scale = scale.to(torch.float32)
    safe = torch.where(torch.isnan(scale) | (scale < _SCALE_TINY), 0.0, scale)
    out = (g * safe[..., None]).reshape(*lead, nb * block)
    if pad:
        out = out[..., :d]
    return out.to(dtype)


# -- legacy fp8 surface: thin wrappers over the generic codec ----------------


def quantize_fp8(x: torch.Tensor, group_size: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last dim in groups (D % group_size == 0):
    returns (fp8 values, f32 scales [..., D // group_size])."""
    if x.shape[-1] % group_size:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by group size {group_size}")
    return quantize_block(x, "fp8", group_size)


def dequantize_fp8(q: torch.Tensor, scale: torch.Tensor, group_size: int = 128,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_fp8`."""
    return dequantize_block(q, scale, group_size, dtype=dtype)
