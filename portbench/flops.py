"""The yardstick's arithmetic: the model FLOP count, the flash kernels' least
times from their shapes, and the table of peaks.

``model_flops_per_token`` is the JAX package's MFU numerator (its
``bench.py`` ``_model_flops_per_token``), copied as plain Python so that it
counts the same work whatever implements the step: matmuls only, the top-k
active experts (no capacity padding), fwd + bwd = 3x fwd (remat's recompute
is not counted), causal attention at half the full score cost, the
unembedding but not the embedding lookup.

A kernel's least time is ``max(ops / peak FLOP/s, bytes / peak bytes/s)``,
each input read once and each output written once (the kernel table's rule).
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA's data sheet for the H100 SXM part, dense rates, at its 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,  # FLOP/s, also float16
        "tf32": 495e12,
        "float32": 66.9e12,  # outside the tensor cores
        "hbm": 3.35e12,  # bytes/s
    },
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card (or a CPU) the table lacks."""
    return PEAKS.get(device_name)


def model_flops_per_token(m: Dict, seq: int) -> float:
    """Model FLOPs of one training step per token, for the flagship family's
    widths ``m`` (the configuration file's ``model``) at sequence ``seq``."""
    h, hd = m["dim"], m["head_dim"]
    qd = m["n_heads"] * hd
    kvd = m["n_kv_heads"] * hd
    per_layer_params = (
        h * qd  # wq
        + 2 * h * kvd  # wk, wv
        + qd * h  # wo
        + h * m["moe_experts"]  # router
        + m["moe_topk"] * 3 * h * m["moe_ffn"]  # active experts (SwiGLU)
    )
    n_active = m["n_layers"] * per_layer_params + h * m["vocab"]  # + unembed
    attn_core = m["n_layers"] * 2 * m["n_heads"] * hd * seq  # causal qk^T + att@v
    fwd = 2.0 * n_active + attn_core
    return 3.0 * fwd


# matmuls of [rows, D] x [D, cols] each flash kernel runs over the visible
# (query, key) pairs: forward S = QK^T, O = PV; dQ: S, dP = dO V^T, dQ = dS K;
# dK/dV: S, dP, dV = P^T dO, dK = dS^T Q.
FLASH_MATMULS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def flash_least_s(kernel: str, b: int, s: int, h: int, hkv: int, d: int, *,
                  causal: bool, itemsize: int, flops_peak: float, hbm: float) -> float:
    """The least time of one launch of a bf16 flash kernel (B1-B3) on
    q ``[b, s, h, d]`` and k, v ``[b, s, hkv, d]``."""
    pairs = s * (s + 1) / 2 if causal else s * s
    ops = FLASH_MATMULS[kernel] * 2.0 * b * h * pairs * d
    q = b * s * h * d * itemsize
    kv = b * s * hkv * d * itemsize
    row = b * h * s * 4  # lse or delta, float32
    if kernel == "flash_fwd":
        moved = q + 2 * kv + q + row  # q, k, v in; out, lse out
    elif kernel == "flash_bwd_dq":
        moved = q + 2 * kv + q + 2 * row + q  # q, k, v, dO, lse, delta in; dQ out
    else:
        moved = q + 2 * kv + q + 2 * row + 2 * kv  # ... in; dK, dV out
    return max(ops / flops_peak, moved / hbm)
