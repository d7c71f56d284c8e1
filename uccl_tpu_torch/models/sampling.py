"""Stochastic token sampling shared by both serving stacks.

Port of ``uccl_tpu/models/sampling.py``. One sampling definition, used by
the slot primitives (``prefill_slots`` / ``decode_step_slots`` /
``verify_slots`` on the dense and MoE stacks) and by the one-shot
``generate`` oracles. At equal seeds the engine's tokens equal the sampled
oracle's because both paths call this function on equal logits rows, and
every row is sampled on its own: the batch a row shares cannot change it.

**The keys are JAX's, bit for bit.** The key for a request's output
position ``i`` is ``fold_in(PRNGKey(seed), i)``, JAX's threefry2x32 key,
and the draw is ``jax.random.categorical``: ``argmax(gumbel + logits)``
with Gumbel noise ``-log(-log(u))`` (mode ``"low"``) over uniform floats
from ``random_bits`` in JAX's default ``jax_threefry_partitionable`` mode
(element ``i`` of a ``[V]`` draw hashes the counter pair ``(0, i)`` and
keeps the XOR of the two output words). Everything here runs in plain
torch on ``int64`` tensors masked to 32 bits, on the logits' device, and
never touches torch's global RNG: a key is a pure function of (seed,
position), so chunked prefill, slot reuse and a verify window all draw the
same noise for the same position.

**Per-row temperature 0 means greedy.** ``temp <= 0`` rows return the
argmax, so one sampled call serves mixed greedy/sampled batches.

Masking is top-k then top-p (nucleus over the k-survivors). Ties at the
k-th logit all survive (``z >= kth``); nucleus keeps every token whose
preceding cumulative mass is ``< top_p``, so the most probable token always
survives; ``top_p >= 1`` disables the nucleus mask exactly.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    """int64 tensor holding ``x`` modulo 2**32 (JAX's uint32 conversion:
    a negative int32 wraps)."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (``jax._src.prng.threefry2x32``): key
    words ``(k0, k1)``, counter words ``(x0, x1)``, all ``int64`` in
    ``[0, 2**32)`` and broadcastable. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed) -> torch.Tensor:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` for int32 seeds:
    ``[..., 2]`` words ``(0, seed mod 2**32)`` (the high word is the seed
    shifted right by 32, which is 0 for a 32-bit seed)."""
    lo = _u32(seed)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashes the counter ``(0, data)``."""
    d = _u32(data).to(key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def fold_key(seed, pos) -> torch.Tensor:
    """The lockstep key for output position ``pos`` of a request seeded
    ``seed`` (both may be tensors of one shape): ``[..., 2]`` words."""
    return fold_in(prng_key(seed), pos)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` in the partitionable mode, for
    a batch of keys ``[..., 2]``: ``[..., n]`` words in ``[0, 2**32)``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(i), i)
    return y0 ^ y1


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` in the partitionable mode: key ``i``
    is the two threefry output words of the counter ``(0, i)`` (the
    ``fold_in`` of ``i``). One key ``[2]`` -> ``[n, 2]``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


# XLA's float32 erf_inv (the chlo legalization JAX lowers lax.erf_inv to):
# Giles' single-precision approximation, one degree-8 polynomial in
# w = -log1p(-x*x) - 2.5 below w = 5 and one in sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` for float32, in torch ops: the same constants and the
    same order of operations. XLA contracts each Horner step ``c + p * w``
    into a fused multiply-add; here it is one float64 multiply-add rounded
    to float32 (the product of two floats is exact in float64), which
    matches it but for a rare double rounding. ``log1p`` and the last
    products may still round otherwise: results lie within a few ulp of
    XLA's (``tests/test_torch_init.py`` states the bound)."""
    w = -torch.log1p(x * -x)
    lt5 = w < 5.0
    w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GT5, dtype=torch.float32, device=x.device)
    p = torch.where(lt5, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        c = torch.where(lt5, lo[i], hi[i])
        p = (c.double() + p.double() * w.double()).float()
    return torch.where(x.abs() == 1.0, torch.inf * x, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: uniform floats on
    ``[nextafter(-1, 0), 1)`` from the partitionable bits of the flattened
    shape, then ``sqrt(2) * erf_inv``. The bits are integer hashing and
    equal JAX's on any device; the polynomial may differ by a few ulp."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, n, minval=lo, maxval=1.0)
    return (torch.tensor(math.sqrt(2), dtype=torch.float32, device=key.device)
            * erf_inv(u)).reshape(shape)


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled in f32."""
    bits = random_bits(key, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode ``"low"``)."""
    return -torch.log(-torch.log(uniform(key, n, minval=_F32_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` per row: ``argmax(gumbel +
    logits)`` over the last axis (the first index among equal maxima)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def _nucleus_keep(z: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Boolean top-p keep mask over logits rows ``z`` ``[B, V]``: a token
    stays if the cumulative mass strictly before it (descending order, ties
    in index order) is ``< top_p``; ``top_p >= 1`` keeps every token."""
    probs = torch.softmax(z, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, -1, order)
    tp = top_p[:, None]
    keep_sorted = ((torch.cumsum(sp, dim=-1) - sp) < tp) | (tp >= 1.0)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def sample_tokens(seeds, pos, logits: torch.Tensor, temp, top_p, top_k) -> torch.Tensor:
    """Sample one token from each row: seeds/pos/temp/top_p/top_k ``[B]``,
    logits ``[B, V]`` -> int32 ``[B]``.

    ``temp <= 0`` -> the argmax; otherwise temperature-scale, top-k mask,
    top-p nucleus mask, then ``categorical`` under the position's key."""
    dev = logits.device
    b, v = logits.shape
    as_dev = lambda x, dt: torch.as_tensor(x, device=dev).to(dt).reshape(b)  # noqa: E731
    temp = as_dev(temp, torch.float32)
    top_p = as_dev(top_p, torch.float32)
    top_k = as_dev(top_k, torch.int64)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    z = logits.float() / torch.clamp_min(temp, 1e-6)[:, None]
    k_eff = torch.where((top_k <= 0) | (top_k >= v), v, top_k)
    sorted_desc = torch.sort(z, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (k_eff - 1).clamp(0, v - 1)[:, None])
    neg_inf = torch.tensor(float("-inf"), device=dev)
    z = torch.where(z >= kth, z, neg_inf)
    z = torch.where(_nucleus_keep(z, top_p), z, neg_inf)
    key = fold_key(as_dev(seeds, torch.int64), as_dev(pos, torch.int64))
    sampled = categorical(key, z).to(torch.int32)
    return torch.where(temp > 0.0, sampled, greedy)


def sample_margins(seed, pos, logits: torch.Tensor, temp, top_p, top_k) -> dict:
    """How near one row's sample is to a tie, for diagnosing a token that two
    runs drew differently: ``score_gap``, the gap between the best two
    ``gumbel + z`` scores among the kept tokens (the argmax
    ``categorical`` takes; the raw top-2 logit gap when ``temp <= 0``), and
    ``nucleus_margin``, the least distance of any token's preceding mass
    from ``top_p`` (a token that close to the nucleus edge may be kept by
    one run and cut by the other). logits ``[V]``."""
    v = logits.shape[-1]
    if temp <= 0:
        top = torch.topk(logits.double(), 2).values
        return {"score_gap": float(top[0] - top[1]), "nucleus_margin": None}
    z = logits.float()[None] / max(float(temp), 1e-6)
    k_eff = v if (top_k <= 0 or top_k >= v) else int(top_k)
    kth = torch.sort(z, dim=-1, descending=True).values[:, k_eff - 1:k_eff]
    z = torch.where(z >= kth, z, torch.tensor(float("-inf"), device=z.device))
    probs = torch.softmax(z, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    before = (torch.cumsum(sp, dim=-1) - sp)[sp > 0]
    tp = torch.tensor([float(top_p)], device=z.device)
    z = torch.where(_nucleus_keep(z, tp), z, torch.tensor(float("-inf"), device=z.device))
    scores = gumbel(fold_key(torch.tensor(int(seed)), torch.tensor(int(pos))).to(z.device), v) + z
    top = torch.topk(scores[0].double(), 2).values
    return {"score_gap": float(top[0] - top[1]),
            "nucleus_margin": None if top_p >= 1 else float((before - top_p).abs().min())}


def sample_window(seeds, pos0, logits: torch.Tensor, temp, top_p, top_k) -> torch.Tensor:
    """Sample a verify/prefill window: logits ``[B, S, V]`` -> tokens
    ``[B, S]``. Column ``j`` of row ``b`` uses the key of output position
    ``pos0[b] + j``: the tokens vanilla decode would draw there."""
    b, s, v = logits.shape
    dev = logits.device

    def rep(x):
        return torch.as_tensor(x, device=dev).reshape(b, 1).expand(b, s).reshape(-1)

    pos = (torch.as_tensor(pos0, device=dev).to(torch.int64).reshape(b, 1)
           + torch.arange(s, device=dev)[None, :]).reshape(-1)
    tok = sample_tokens(rep(seeds), pos, logits.reshape(b * s, v), rep(temp), rep(top_p),
                        rep(top_k))
    return tok.reshape(b, s)


def broadcast_params(n: int, seed, temp, top_p, top_k, device=None):
    """One request's scalar sampling params as per-row tensors ``(seeds,
    temp, top_p, top_k)`` of length ``n`` (the oracle-side helper)."""
    return (
        torch.full((n,), int(seed), dtype=torch.int32, device=device),
        torch.full((n,), float(temp), dtype=torch.float32, device=device),
        torch.full((n,), float(top_p), dtype=torch.float32, device=device),
        torch.full((n,), int(top_k), dtype=torch.int32, device=device),
    )
