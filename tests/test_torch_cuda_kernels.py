"""The port's CUDA flash-attention kernels against their plain versions, on
the card.

Every test here needs an NVIDIA Hopper GPU and ``nvcc``; without a GPU each
skips. This file imports neither jax nor the JAX package, so on a machine
without JAX it runs alone, past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

The backward's own checks: every variant the dispatch builds, B3's bits
(and the f32 B1's, B2's and B3's) from run to run, and the pipeline-wait rule (a stalled ring ends its launch
with a CUDA error, in a subprocess, within 60 s).

bf16 tolerance: each kernel reads the same bf16 inputs as the plain float32
version, accumulates in f32, and rounds P and dS to bf16 before the second
product of each pair, as flash-attention kernels do; outputs are stored in
bf16. Each element is held to ``fa.kernel_error``'s limit, ``|got - want| <=
KERNEL_ATOL_OF_ROW_RMS * rms(want's D-wide row) + KERNEL_RTOL * |want|`` (the
rule ``chip_smoke.py`` holds the kernels to), and lse (f32, no bf16 product in
its path) to 1e-3 absolute.

f32 tolerance (the f32 kernels, at the end of this file): the same rule at
f32 scale, ``fa.F32_KERNEL_ATOL_OF_ROW_RMS`` = ``fa.F32_KERNEL_RTOL`` =
2^-14, lse to ``fa.F32_LSE_ATOL`` = 1e-5 absolute (see ops/flash_attention.py
for why); planted faults of the source must fail it, single TF32 passes and
dropped cross terms of 3xTF32 (in B1, B2 and B3) among them.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from uccl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

LSE_ATOL = 1e-3
NO_F32 = {name: 0 for name in fa.F32_KERNELS}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _inputs(dev, b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, dtype=torch.bfloat16):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32).to(dev, dtype)

    q, k, v = t(b, sq, h, d), t(b, sk, hkv, d), t(b, sk, hkv, d)
    dout = t(b, sq, h, d)
    g_lse = t(b, h, sq, dtype=torch.float32) * 0.5
    return q, k, v, dout, g_lse


def _assert_close(got, want, what):
    e = fa.kernel_error(got, want)
    assert e["worst"] <= 1, f"{what}: {e}"


SHAPES = [
    # b, sq, sk, h, hkv, d, causal, block_q, block_k
    (2, 256, 256, 4, 1, 64, True, 64, 64),
    (2, 256, 256, 4, 4, 64, False, 64, 64),
    (1, 512, 512, 8, 2, 128, True, 128, 128),
    (1, 256, 256, 4, 2, 64, True, 128, 128),
    (1, 256, 256, 4, 2, 128, False, 64, 128),
    (1, 128, 256, 4, 2, 64, False, 64, 64),
    (4, 512, 512, 8, 2, 64, False, 64, 64),  # a ring step's shard: non-causal GQA
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_kernels_match_plain(dev, shape):
    b, sq, sk, h, hkv, d, causal, bq, bk = shape
    q, k, v, dout, g_lse = _inputs(dev, b, sq, sk, h, hkv, d)
    out, lse = fa.flash_fwd(q, k, v, causal, bq)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    _assert_close(out, out_p, "out")
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()

    delta = fa.flash_delta(out_p, dout, g_lse)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse_p, delta, causal, bq)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse_p, delta, causal, bk)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, causal)
    torch.cuda.synchronize()
    _assert_close(dq, dq_p, "dq")
    _assert_close(dk, dk_p, "dk")
    _assert_close(dv, dv_p, "dv")


# Every forward variant the dispatch builds (D, block_q, causal), with GQA,
# and for each a case whose KV length differs from Q's.
FWD_VARIANTS = [(d, bq, causal) for d in (64, 128) for bq in (64, 128) for causal in (True, False)]


@pytest.mark.parametrize("d,block_q,causal", FWD_VARIANTS, ids=lambda v: str(v))
def test_forward_every_variant(dev, d, block_q, causal):
    for b, sq, sk, h, hkv in ((2, 384, 384, 8, 2), (1, 256, 512, 4, 1), (1, 256, 192, 4, 4)):
        q, k, v, _, _ = _inputs(dev, b, sq, sk, h, hkv, d, seed=d + block_q)
        fa.reset_launch_counts()
        out, lse = fa.flash_fwd(q, k, v, causal, block_q)
        torch.cuda.synchronize()
        assert fa.launch_counts["flash_fwd"] == 1
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        _assert_close(out, out_p, f"out {(b, sq, sk, h, hkv)}")
        assert (lse - lse_p).abs().max().item() <= LSE_ATOL
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()


# Every backward variant the dispatch builds (D, tile, causal); for each, GQA
# with n_rep 1, 2, 4 and 8, KV lengths that differ from Q's, and the lse
# cotangent folded into delta. With tile 128 and causal, dK/dV's 128-row KV
# tiles meet the diagonal against 64-row q tiles.
BWD_VARIANTS = [(d, t, causal) for d in (64, 128) for t in (64, 128) for causal in (True, False)]
BWD_SHAPES = [  # b, sq, sk, h, hkv
    (2, 384, 384, 8, 2), (1, 256, 256, 8, 8), (1, 256, 256, 8, 1), (2, 256, 256, 4, 2),
    (1, 256, 512, 4, 1), (1, 512, 256, 8, 2),
]


@pytest.mark.parametrize("d,tile,causal", BWD_VARIANTS, ids=lambda v: str(v))
def test_backward_every_variant(dev, d, tile, causal):
    for b, sq, sk, h, hkv in BWD_SHAPES:
        what = f"{(b, sq, sk, h, hkv)}"
        q, k, v, dout, g_lse = _inputs(dev, b, sq, sk, h, hkv, d, seed=d + tile + sq)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        delta = fa.flash_delta(out_p, dout, g_lse)
        fa.reset_launch_counts()
        dq = fa.flash_bwd_dq(q, k, v, dout, lse_p, delta, causal, tile)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse_p, delta, causal, tile)
        torch.cuda.synchronize()
        assert fa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                                    **NO_F32}
        dq_p = fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, causal)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, causal)
        for got, want, name in ((dq, dq_p, "dq"), (dk, dk_p, "dk"), (dv, dv_p, "dv")):
            assert torch.isfinite(got.float()).all(), f"{name} {what}"
            _assert_close(got, want, f"{name} {what}")


@pytest.mark.parametrize("tile", (64, 128))
def test_dkv_is_deterministic(dev, tile):
    """The GQA sum stays in registers (no atomics): the same inputs give the
    same bits."""
    q, k, v, dout, g_lse = _inputs(dev, 2, 512, 512, 16, 2, 64, seed=5)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    delta = fa.flash_delta(out_p, dout, g_lse)
    first = fa.flash_bwd_dkv(q, k, v, dout, lse_p, delta, True, tile)
    second = fa.flash_bwd_dkv(q, k, v, dout, lse_p, delta, True, tile)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# Launches dQ from a build whose producer announces 16 more bytes a stage
# than its TMA loads bring, so no stage ever completes; prints the error the
# synchronize raises and exits 3.
_STALLED_DQ = """
import ctypes, sys, torch
from uccl_tpu_torch.ops import flash_attention as fa
lib = fa.declare(ctypes.CDLL(sys.argv[1]))
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, dout = (torch.randn((1, 256, 4, 64), generator=g, device="cuda").bfloat16()
                 for _ in range(4))
lse = torch.zeros((1, 4, 256), device="cuda")
delta, dq = torch.zeros_like(lse), torch.empty_like(q)
err = lib.uccl_flash_bwd_dq(*map(fa._ptr, (q, k, v, dout, lse, delta, dq)),
                            1, 256, 256, 4, 4, 64, 1, 64, fa._stream(q))
print("launch returned", err, flush=True)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("CUDA error:", e, flush=True)
    sys.exit(3)
print("no error", flush=True)
"""


def test_pipeline_fault_ends_the_launch(dev):
    """The pipeline-wait rule: a wait on the kernel's own mbarrier that can
    never complete traps after its bound (2 s), so the launch ends with a
    CUDA error instead of hanging; it ends that process's CUDA context only."""
    from uccl_tpu_torch.utils import build

    lib = build.build_variant(
        "flash_attention", "dq_expect_tx_plus_16",
        [("kv_stage_bytes = 2 * 64 * D * 2;", "kv_stage_bytes = 2 * 64 * D * 2 + 16;")])
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _STALLED_DQ, str(lib)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=60)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 3 and "CUDA error" in proc.stdout, (proc.stdout, proc.stderr)
    assert "launch returned 0" in proc.stdout and seconds < 60
    # this process's context is untouched: B2 runs and is right
    q, k, v, dout, g_lse = _inputs(dev, 1, 256, 256, 4, 4, 64, seed=7)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    delta = fa.flash_delta(out_p, dout, g_lse)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse_p, delta, True)
    torch.cuda.synchronize()
    _assert_close(dq, fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, True), "dq")


def test_autograd_counts_and_grads(dev):
    q, k, v, dout, g_lse = _inputs(dev, 2, 256, 256, 8, 2, 64, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_lse(*leaves, True)
    grads = torch.autograd.grad((out, lse), leaves, (dout, g_lse))
    torch.cuda.synchronize()
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                                **NO_F32}
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    delta = fa.flash_delta(out_p, dout, g_lse)
    want = (fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, True),
            *fa.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, True))
    for got, ref, name in zip(grads, want, ("dq", "dk", "dv")):
        _assert_close(got, ref, name)


def test_wrapper_refuses_what_the_kernels_do_not_take(dev):
    q, k, v, _, _ = _inputs(dev, 1, 128, 128, 2, 1, 64)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fa.flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                     v[..., :32].contiguous())
    with pytest.raises(ValueError):
        fa.flash_fwd(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        fa.flash_fwd(q[:, :96].contiguous(), k[:, :96].contiguous(), v[:, :96].contiguous())
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k.cpu(), v)
    lse = torch.zeros((1, 2, 128), device=dev)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq(q, k, v, q, lse[:, :1].contiguous(), lse)


def test_flagship_flash_matches_plain_attention(dev):
    from uccl_tpu_torch.models import flagship as fl
    from uccl_tpu_torch.models.sampling import prng_key

    cfg = fl.FlagshipConfig(vocab=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, moe_experts=4, moe_ffn=192,
                            capacity_factor=1.25, dtype=torch.bfloat16)
    params = fl.init_params(prng_key(0), cfg, dev)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (2, 128)), device=dev)
    targets = torch.tensor(rng.integers(0, cfg.vocab, (2, 128)), device=dev)
    flash = fl.loss_fn(params, tokens, targets, cfg)[0].item()
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    plain = fl.loss_fn(params, tokens, targets, plain_cfg)[0].item()
    assert np.isfinite(flash) and abs(flash - plain) <= 1e-2 * abs(plain)


# ---------------------------------------------------------------------------
# The f32 kernels

F32_SHAPES = [
    # b, sq, sk, h, hkv, d, causal
    (2, 256, 256, 8, 2, 64, True),
    (2, 77, 77, 4, 1, 64, True),  # one partial tile
    (2, 200, 136, 8, 2, 64, False),  # Sq != Sk, partial tiles
    (1, 130, 130, 4, 4, 128, False),
    (1, 320, 320, 8, 2, 128, True),
    (4, 512, 512, 8, 2, 64, False),  # a ring step's shard: non-causal GQA
    (1, 100, 300, 16, 2, 64, True),  # n_rep 8, more KV than q rows
]


def _inputs_f32(dev, b, sq, sk, h, hkv, d, seed=0):
    return tuple(t.float() for t in _inputs(dev, b, sq, sk, h, hkv, d, seed))


def _assert_close_f32(got, want, what):
    assert got.dtype == torch.float32, what
    e = fa.kernel_error(got, want)
    assert e["worst"] <= 1, f"{what}: {e}"


@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_f32_kernels_match_plain(dev, shape):
    b, sq, sk, h, hkv, d, causal = shape
    q, k, v, dout, g_lse = _inputs_f32(dev, b, sq, sk, h, hkv, d)
    fa.reset_launch_counts()
    out, lse = fa.flash_fwd_f32(q, k, v, causal)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.flash_delta(out_p, dout, g_lse)
    dq = fa.flash_bwd_dq_f32(q, k, v, dout, lse_p, delta, causal)
    dk, dv = fa.flash_bwd_dkv_f32(q, k, v, dout, lse_p, delta, causal)
    torch.cuda.synchronize()
    assert fa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                "flash_fwd_f32": 1, "flash_bwd_dq_f32": 1,
                                "flash_bwd_dkv_f32": 1}
    assert (lse - lse_p).abs().max().item() <= fa.F32_LSE_ATOL
    dq_p = fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, causal)
    for got, want, name in ((out, out_p, "out"), (dq, dq_p, "dq"), (dk, dk_p, "dk"),
                            (dv, dv_p, "dv")):
        _assert_close_f32(got, want, f"{name} {shape}")


def test_f32_dkv_is_deterministic(dev):
    q, k, v, dout, g_lse = _inputs_f32(dev, 2, 512, 512, 16, 2, 64, seed=5)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    delta = fa.flash_delta(out_p, dout, g_lse)
    first = fa.flash_bwd_dkv_f32(q, k, v, dout, lse_p, delta, True)
    second = fa.flash_bwd_dkv_f32(q, k, v, dout, lse_p, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_f32_fwd_is_deterministic(dev):
    q, k, v, _, _ = _inputs_f32(dev, 2, 512, 512, 16, 2, 64, seed=7)
    first = fa.flash_fwd_f32(q, k, v, True)
    second = fa.flash_fwd_f32(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_f32_dq_is_deterministic(dev):
    q, k, v, dout, g_lse = _inputs_f32(dev, 2, 512, 512, 16, 2, 64, seed=6)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    delta = fa.flash_delta(out_p, dout, g_lse)
    first = fa.flash_bwd_dq_f32(q, k, v, dout, lse_p, delta, True)
    second = fa.flash_bwd_dq_f32(q, k, v, dout, lse_p, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# Text substitutions of the source that plant a fault in one f32 kernel.
# B1's and B2's dropped tiles are still streamed by the ring (B1's is masked
# whole, B2's skipped by the products); the single TF32 passes and dropped
# cross terms take TF32 products out of the 3xTF32 sums.
F32_FAULTS = {
    "mask_off_by_one": ("fwd", [("(causal && key > row)", "(causal && key > row + 1)")]),
    "fwd_tile_dropped": ("fwd", [
        ("const int cols = Sk - k0;", "const int cols = k0 == 2 * kF32Rows ? 0 : Sk - k0;"),
        ("return k0 + kF32Rows > Sk ||", "return k0 == 2 * kF32Rows || k0 + kF32Rows > Sk ||")]),
    "fwd_single_tf32_pass": ("fwd", [("constexpr int kF32FwdTerms = 3;",
                                      "constexpr int kF32FwdTerms = 1;")]),
    "fwd_cross_term_dropped": ("fwd", [("constexpr int kF32FwdTerms = 3;",
                                        "constexpr int kF32FwdTerms = 2;")]),
    "dq_tile_dropped": ("dq", [("const float* sK = ring + (kt % R)",
                                "if (kt == 2) continue;\n    const float* sK = ring + (kt % R)")]),
    "gqa_wrong_group": ("dkv", [("const int h_first = hk * n_rep;",
                                 "const int h_first = ((hk + 1) % Hkv) * n_rep;")]),
    "dq_single_tf32_pass": ("dq", [("constexpr int kDqTerms = 3;", "constexpr int kDqTerms = 1;")]),
    "dk_cross_term_dropped": ("dkv", [("constexpr int kDkvTerms = 3;",
                                       "constexpr int kDkvTerms = 2;")]),
}


def test_f32_planted_faults_fail_the_rule(dev, monkeypatch):
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from uccl_tpu_torch.utils import build

    with ThreadPoolExecutor(len(F32_FAULTS)) as pool:
        libs = dict(zip(F32_FAULTS, pool.map(
            lambda kv: build.build_variant("flash_attention", f"test_f32_{kv[0]}", kv[1][1]),
            F32_FAULTS.items())))
    q, k, v, dout, g_lse = _inputs_f32(dev, 2, 256, 256, 8, 2, 64, seed=9)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    delta = fa.flash_delta(out_p, dout, g_lse)
    want = {"fwd": out_p, "dq": fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, True),
            "dkv": fa.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, True)[0]}
    for fault, (kernel, _) in F32_FAULTS.items():
        lib = fa.declare(ctypes.CDLL(str(libs[fault])))
        monkeypatch.setattr(fa, "_lib", lambda lib=lib: lib)
        got = {"fwd": lambda: fa.flash_fwd_f32(q, k, v, True)[0],
               "dq": lambda: fa.flash_bwd_dq_f32(q, k, v, dout, lse_p, delta, True),
               "dkv": lambda: fa.flash_bwd_dkv_f32(q, k, v, dout, lse_p, delta, True)[0]}[kernel]()
        torch.cuda.synchronize()
        assert fa.kernel_error(got, want[kernel])["worst"] > 1, fault


def test_f32_autograd_counts_and_grads(dev):
    q, k, v, dout, g_lse = _inputs_f32(dev, 2, 192, 192, 8, 2, 64, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_lse(*leaves, True)
    grads = torch.autograd.grad((out, lse), leaves, (dout, g_lse))
    torch.cuda.synchronize()
    assert fa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                "flash_fwd_f32": 1, "flash_bwd_dq_f32": 1,
                                "flash_bwd_dkv_f32": 1}
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    delta = fa.flash_delta(out.detach(), dout, g_lse)
    want = (fa.flash_bwd_dq_plain(q, k, v, dout, lse.detach(), delta, True),
            *fa.flash_bwd_dkv_plain(q, k, v, dout, lse.detach(), delta, True))
    _assert_close_f32(out.detach(), out_p, "out")
    for got, ref, name in zip(grads, want, ("dq", "dk", "dv")):
        _assert_close_f32(got, ref, name)


def test_f32_wrappers_refuse_other_dtypes_and_mixes(dev):
    q, k, v, dout, _ = _inputs_f32(dev, 1, 128, 128, 2, 1, 64)
    with pytest.raises(TypeError):
        fa.flash_fwd_f32(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        fa.flash_fwd_f32(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError):  # f16 goes to the bf16 kernels, which refuse it
        fa.flash_attention(q.half(), k.half(), v.half())
    lse = torch.zeros((1, 2, 128), device=dev)
    with pytest.raises(TypeError):
        fa.flash_bwd_dq_f32(q, k, v, dout.bfloat16(), lse, lse)
    with pytest.raises(ValueError):
        fa.flash_fwd_f32(q[..., :32].contiguous(), k[..., :32].contiguous(),
                         v[..., :32].contiguous())


def test_f32_flagship_trains_through_the_f32_kernels(dev):
    from uccl_tpu_torch.models import flagship as fl
    from uccl_tpu_torch.models.sampling import prng_key

    cfg = fl.FlagshipConfig(vocab=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, moe_experts=4, moe_ffn=192)
    assert cfg.dtype == torch.float32
    params = fl.init_params(prng_key(0), cfg, dev)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (2, 96)), device=dev)
    targets = torch.tensor(rng.integers(0, cfg.vocab, (2, 96)), device=dev)
    fa.reset_launch_counts()
    flash = fl.loss_fn(params, tokens, targets, cfg)[0].item()
    assert fa.launch_counts["flash_fwd_f32"] == cfg.n_layers
    plain = fl.loss_fn(params, tokens, targets, dataclasses.replace(cfg, attn_impl="xla"))[0]
    assert np.isfinite(flash) and abs(flash - plain.item()) <= 1e-5 * abs(plain.item())


@pytest.mark.parametrize("seq_mode", ["ring", "ulysses"])
def test_f32_context_parallel_attention_on_the_kernels(dev, seq_mode):
    """Ring and Ulysses attention over cp = 2 in float32 on the kernels
    against their plain torch impl, forward and gradients (the ring's lse
    cotangent reaches B2/B3 through delta); launches: the ring's n per call
    (each backward as many), Ulysses' one."""
    from uccl_tpu_torch.ops import attention as attn

    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    q, k, v, cot = t(2, 2, 256, 8, 64), t(2, 2, 256, 2, 64), t(2, 2, 256, 2, 64), \
        t(2, 2, 256, 8, 64)
    fn = attn.ring_attention if seq_mode == "ring" else attn.ulysses_attention
    outs = {}
    for impl in ("xla", "flash"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fa.reset_launch_counts()
        out = fn(*leaves, "cp", causal=True, impl=impl)
        grads = torch.autograd.grad((out * cot).sum(), leaves)
        torch.cuda.synchronize()
        outs[impl] = (out.detach(), *grads)
        n = 2 if seq_mode == "ring" and impl == "flash" else int(impl == "flash")
        assert {k_: fa.launch_counts[k_] for k_ in fa.F32_KERNELS} == \
            {"flash_fwd_f32": n, "flash_bwd_dq_f32": n, "flash_bwd_dkv_f32": n}
    for name, got, want in zip(("out", "dq", "dk", "dv"), outs["flash"], outs["xla"]):
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, msg=name)


def test_f32_flagship_at_a_mesh_matches_world_1(dev):
    """The flagship over dp = 2, cp = 2, tp = 2 on the card (ring attention
    on the f32 kernels, 2 forward launches a layer) against world 1, at a
    capacity that drops nothing and without the per-member aux losses."""
    from uccl_tpu_torch.models import flagship as fl
    from uccl_tpu_torch.models.sampling import prng_key
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    cfg = fl.FlagshipConfig(vocab=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, moe_experts=4, moe_ffn=192, capacity_factor=2.0,
                            aux_loss_weight=0.0, z_loss_weight=0.0)
    params = fl.init_params(prng_key(0), cfg, dev)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (4, 256)), device=dev)
    targets = torch.tensor(rng.integers(0, cfg.vocab, (4, 256)), device=dev)
    mesh = make_mesh(MeshConfig(dp=2, cp=2, tp=2), dev)
    fa.reset_launch_counts()
    with torch.no_grad():
        got = fl.loss_fn(params, tokens, targets, cfg, mesh)[0].item()
        assert fa.launch_counts["flash_fwd_f32"] == 2 * cfg.n_layers
        want = fl.loss_fn(params, tokens, targets, cfg)[0].item()
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)
