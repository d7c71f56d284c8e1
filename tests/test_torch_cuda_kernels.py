"""The port's CUDA flash-attention kernels against their plain versions, on
the card.

Every test here needs an NVIDIA Hopper GPU and ``nvcc``; without a GPU each
skips. This file imports neither jax nor the JAX package, so on a machine
without JAX it runs alone, past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

bf16 tolerance: each kernel reads the same bf16 inputs as the plain float32
version, accumulates in f32, and rounds P and dS to bf16 before the second
product of each pair, as flash-attention kernels do; outputs are stored in
bf16. Each element is held to ``fa.kernel_error``'s limit, ``|got - want| <=
KERNEL_ATOL_OF_ROW_RMS * rms(want's D-wide row) + KERNEL_RTOL * |want|`` (the
rule ``chip_smoke.py`` holds the kernels to), and lse (f32, no bf16 product in
its path) to 1e-3 absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uccl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

LSE_ATOL = 1e-3


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


def test_autograd_counts_and_grads(dev):
    q, k, v, dout, g_lse = _inputs(dev, 2, 256, 256, 8, 2, 64, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_lse(*leaves, True)
    grads = torch.autograd.grad((out, lse), leaves, (dout, g_lse))
    torch.cuda.synchronize()
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
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

    cfg = fl.FlagshipConfig(vocab=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, moe_experts=4, moe_ffn=192,
                            capacity_factor=1.25, dtype=torch.bfloat16)
    params = fl.init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (2, 128)), device=dev)
    targets = torch.tensor(rng.integers(0, cfg.vocab, (2, 128)), device=dev)
    flash = fl.loss_fn(params, tokens, targets, cfg)[0].item()
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    plain = fl.loss_fn(params, tokens, targets, plain_cfg)[0].item()
    assert np.isfinite(flash) and abs(flash - plain) <= 1e-2 * abs(plain)
