"""Flash attention on Hopper: forward and backward CUDA kernels, LSE-exposing API.

Port of ``uccl_tpu/ops/pallas_attention.py``. Its three Pallas kernels become
three CUDA kernels in ``csrc/flash_attention.cu``, built with ``nvcc`` for
``sm_90a`` at first use and called through ctypes:

* ``flash_fwd``     (replaces ``_fwd_kernel``): out ``[B,S,H,D]`` and lse
  ``[B,H,S]`` f32, online softmax, causal tiles past the diagonal skipped;
  on ``wgmma``, fed by a TMA ring of K/V tiles that one producer warp keeps
  ahead of the consumer warpgroups.
* ``flash_bwd_dq``  (replaces ``_bwd_dq_kernel``): dq, recomputing
  ``P = exp(S*scale - lse)`` from the saved lse; K/V tiles stream.
* ``flash_bwd_dkv`` (replaces ``_bwd_dkv_kernel``): dk and dv, with the GQA
  sum over the ``n_rep`` query heads done inside the kernel (no atomics: the
  same inputs give the same bits); Q/dO tiles and their lse/delta stream.

The backward kernels run on ``wgmma`` too, fed by TMA rings that one producer
warp keeps ahead of the consumer warpgroups.

Beside each kernel is its plain PyTorch version (``*_plain``): the same
function, in float32, materialising ``[S, S]``. A wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises. ``launch_counts`` counts kernel launches (plain runs do not count),
so a run can show that it went through the kernels.

Public API, as in the JAX package:

* :func:`flash_attention_lse` returns ``(out, lse)``; the lse output is
  differentiable: its cotangent folds into the backward row term
  ``delta = rowsum(dO*O) - g_lse``.
* :func:`flash_attention` returns ``out``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from uccl_tpu_torch.ops.attention import HOPPER_TILES, _NEG_INF, _repeat_kv, auto_block
from uccl_tpu_torch.utils.config import param

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
launch_counts = {name: 0 for name in KERNELS}

_HEAD_DIMS = (64, 128)
_STREAM_TILE = 64  # rows of the tile every kernel streams (one wgmma M or N of 64)


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _default_blocks() -> Tuple[int, int]:
    """Tile knobs (UCCL_TPU_FLASH_BLOCK_Q/K, 0 = auto), as in the JAX
    package: block_q is the q rows of a forward or dQ CTA, block_k the KV
    rows of a dK/dV CTA."""
    bq = param("flash_block_q", 0, help="flash attention q-tile rows (0 = auto-size)")
    bk = param("flash_block_k", 0, help="flash attention kv-tile rows (0 = auto-size)")
    return int(bq.get()), int(bk.get())


# ---------------------------------------------------------------------------
# The library


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its C signatures declared."""
    from uccl_tpu_torch.utils import build

    return declare(build.load("flash_attention"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures on a loaded build of the source (pointers and
    the stream as c_void_p, so ctypes never cuts them to 32 bits)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.uccl_flash_fwd.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.uccl_flash_bwd_dq.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.uccl_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.uccl_flash_fwd_smem.argtypes = [i, i]
    lib.uccl_flash_bwd_smem.argtypes = [i, i, i]
    for fn in (lib.uccl_flash_fwd, lib.uccl_flash_bwd_dq, lib.uccl_flash_bwd_dkv,
               lib.uccl_flash_fwd_smem, lib.uccl_flash_bwd_smem):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({torch.cuda.get_device_name()}); the kernel "
            "did not run"
        )


def _is_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain version's domain);
    raises for a mix, or for a device that is neither CPU nor CUDA."""
    types = {t.device.type for t in ts}
    if types == {"cpu"}:
        return True
    if types == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"flash attention: tensors on {sorted({str(t.device) for t in ts})}")


def _check_cuda(q, k, v, *, block: int, rows: int, others=()) -> None:
    """What the CUDA kernels take; raises on anything else. ``block`` is the
    launch's CTA tile and ``rows`` the sequence length it must divide."""
    for name, t in (("q", q), ("k", k), ("v", v), *others):
        if t.dtype != (torch.float32 if name in ("lse", "delta") else torch.bfloat16):
            raise TypeError(
                f"flash attention on CUDA: {name} is {t.dtype}; the kernels take "
                "bfloat16 q/k/v/dout and float32 lse/delta"
            )
        if not t.is_contiguous():
            raise ValueError(f"flash attention on CUDA: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention on CUDA: {name} is not 16-byte aligned")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want [B,S,H,D] and equal k/v")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim")
    sk, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {hkv}")
    want = {"dout": (b, sq, h, d), "lse": (b, h, sq), "delta": (b, h, sq)}
    for name, t in others:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"flash attention: {name} is {tuple(t.shape)}, want {want[name]}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention on CUDA: head dim {d} not in {_HEAD_DIMS}")
    if block not in HOPPER_TILES:
        raise ValueError(f"flash attention on CUDA: tile {block} not in {HOPPER_TILES}")
    if rows % block or sq % _STREAM_TILE or sk % _STREAM_TILE:
        raise ValueError(
            f"flash attention on CUDA: seq lengths ({sq},{sk}) must divide "
            f"{_STREAM_TILE}, and {rows} the tile {block}"
        )


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# Plain versions (float32, [S, S] materialised)


def _masked_scores(q, k, causal):
    """f32 [B,H,Sq,Sk] scores with KV heads repeated, -1e30 where masked."""
    n_rep = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _repeat_kv(k.float(), n_rep)) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill((qpos[:, None] < kpos[None, :])[None, None], _NEG_INF)
    return s, n_rep, scale


def flash_fwd_plain(q, k, v, causal: bool = True):
    """The forward kernel's function: (out in q's dtype, lse f32 [B,H,S])."""
    s, n_rep, _ = _masked_scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, _repeat_kv(v.float(), n_rep))
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _plain_p_ds(q, k, v, dout, lse, delta, causal):
    s, n_rep, scale = _masked_scores(q, k, causal)
    p = torch.exp(s - lse[..., None])  # masked scores underflow to 0
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), _repeat_kv(v.float(), n_rep))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, n_rep


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool = True):
    """The dQ kernel's function: dq in q's dtype."""
    _, ds, n_rep = _plain_p_ds(q, k, v, dout, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k.float(), n_rep))
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool = True):
    """The dK/dV kernel's function: (dk, dv) in k's dtype, summed over each
    KV head's n_rep query heads."""
    p, ds, n_rep = _plain_p_ds(q, k, v, dout, lse, delta, causal)
    b, sk, hkv, d = k.shape
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(b, sk, hkv, n_rep, d).sum(3)
    dv = dv.reshape(b, sk, hkv, n_rep, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(out, g_out, g_lse=None):
    """The backward row term ``rowsum(dO*O) - g_lse``, f32 ``[B,H,S]``.
    It was XLA code outside the Pallas kernels and stays one torch
    expression here."""
    delta = (g_out.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


# How far a kernel may sit from its plain version on the same bf16 inputs,
# element by element: |got - want| <= ATOL * rms(want's row) + RTOL * |want|.
# The kernels accumulate in f32 but round P and dS to bf16 before the second
# product of each pair, and store bf16 outputs: the stored value is off by
# up to 2^-8 of itself, and the rounded P/dS add an error that scales with
# the size of the D-wide row it sums into, not with the element. A fault
# that misses a tile or a term moves a row by a fair share of its rms, many
# times ATOL.
KERNEL_RTOL = 2.0 ** -7
KERNEL_ATOL_OF_ROW_RMS = 2.0 ** -5


def kernel_error(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A kernel's output against its plain version: ``worst`` is the largest
    ``|got - want| / (ATOL * row rms + RTOL * |want|)`` (1 is the limit),
    with the largest absolute error and the norm ratio ``|got-want|/|want|``."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    # A row that is 0 in exact arithmetic (dq of causal row 0 when the lse
    # cotangent is 0) is rounding noise in both: floor its rms at 1e-3 of
    # the tensor's.
    rms = w.square().mean().sqrt()
    row_rms = w.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-3 * rms)
    limit = (KERNEL_ATOL_OF_ROW_RMS * row_rms + KERNEL_RTOL * w.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    return {"worst": (diff / limit).max().item(), "max_abs_err": diff.max().item(),
            "norm_ratio": (diff.norm() / w.norm()).item()}


# ---------------------------------------------------------------------------
# Kernel wrappers


def _block_q(q, block_q):
    return block_q if block_q is not None else (_default_blocks()[0] or auto_block(q.shape[1]))


def _block_k(k, block_k):
    return block_k if block_k is not None else (_default_blocks()[1] or auto_block(k.shape[1]))


def flash_fwd(q, k, v, causal: bool = True, block_q: Optional[int] = None):
    """Forward: q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> (out [B,Sq,H,D], lse [B,H,Sq])."""
    if _is_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal)
    block_q = _block_q(q, block_q)
    _check_cuda(q, k, v, block=block_q, rows=q.shape[1])
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _lib().uccl_flash_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse),
        b, sq, sk, h, hkv, d, int(causal), block_q, _stream(q),
    )
    _raise_on(err, "flash_fwd")
    launch_counts["flash_fwd"] += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                 block_q: Optional[int] = None):
    """dQ: -> dq [B,Sq,H,D] in q's dtype."""
    if _is_cpu(q, k, v, dout, lse, delta):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    block_q = _block_q(q, block_q)
    _check_cuda(q, k, v, block=block_q, rows=q.shape[1],
                others=(("dout", dout), ("lse", lse), ("delta", delta)))
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    err = _lib().uccl_flash_bwd_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(dq),
        b, sq, sk, h, hkv, d, int(causal), block_q, _stream(q),
    )
    _raise_on(err, "flash_bwd_dq")
    launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                  block_k: Optional[int] = None):
    """dK/dV: -> (dk, dv) [B,Sk,Hkv,D] in k's dtype."""
    if _is_cpu(q, k, v, dout, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal)
    block_k = _block_k(k, block_k)
    _check_cuda(q, k, v, block=block_k, rows=k.shape[1],
                others=(("dout", dout), ("lse", lse), ("delta", delta)))
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib().uccl_flash_bwd_dkv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(dk),
        _ptr(dv), b, sq, sk, h, hkv, d, int(causal), block_k, _stream(q),
    )
    _raise_on(err, "flash_bwd_dkv")
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Autograd and the public API


class _FlashAttentionLSE(torch.autograd.Function):
    """(out, lse) with both outputs differentiable; the backward runs the dQ
    and dK/dV kernels (the JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = flash_fwd(q, k, v, causal, block_q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_q, ctx.block_k = causal, block_q, block_k
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = flash_delta(out, g_out, g_lse)
        dout = g_out.to(q.dtype).contiguous()
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal, ctx.block_q)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal, ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning (out [B,S,H,D], lse [B,H,S]).

    q: [B, S, H, D]; k/v: [B, Sk, Hkv, D] (GQA-aware). The lse output is
    differentiable. block_q/block_k default from UCCL_TPU_FLASH_BLOCK_Q/K,
    and unset (0) from :func:`~uccl_tpu_torch.ops.attention.auto_block`;
    they only matter on CUDA."""
    return _FlashAttentionLSE.apply(q, k, v, causal, block_q, block_k)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention. Forward and backward run as CUDA kernels on the card;
    no [S, S] tensor is materialised there in either direction."""
    out, _ = flash_attention_lse(q, k, v, causal, block_q, block_k)
    return out
