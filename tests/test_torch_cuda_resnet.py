"""The ResNet path on the card: one member's forward and backward of
ResNet-50 (full width, 32 images of 224x224, a member's batch on
``chip_smoke.py``'s ``resnet_path``) in float32 against the same step in
float64, and a DDP gradient bucket through B7 (``ring_ar_kernel``).

Every test needs a CUDA GPU and skips without one. This file imports neither
jax nor the JAX package, so it runs alone, past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_resnet.py

Tolerances (``chip_smoke.py``'s ``resnet_path`` rule, which says why):
against float64, the logits within 1e-4 relative in norm and each gradient
leaf within 1e-2 relative in norm plus 1e-5 of the whole gradient's norm
(float32 convolutions and sums in another order, and the cancellation in
train-mode BN's backward; TF32 convolutions fail the rule, as
``resnet_path``'s planted fault shows). The caller's TF32 setting is on
throughout: the model's guard must turn it off for its own convolutions and
leave it on afterwards; one guarded convolution, forward and backward,
within 1e-5 relative in norm of float64 under every TF32 flag setting
(TF32 operands keep 10 mantissa bits, f32's 23). B7's result:
bit-identical to ``ar_chain_plain``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from uccl_tpu_torch.collective import Communicator, ring_ccl
from uccl_tpu_torch.models import resnet
from uccl_tpu_torch.models.sampling import prng_key
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

pytestmark = pytest.mark.cuda

LOGITS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-2, 1e-5
CONV_RTOL = 1e-5  # one f32 convolution against float64: sums of 256 products


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the DDP sync runs B7, which has no CPU or interpret mode)")
    return torch.device("cuda")


def _batch(dev, n, hw, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64) * 5 % 10
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _grads(params, state, x, y, cfg):
    params = resnet._tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = resnet.loss_fn(params, state, x, y, cfg)
    return torch.autograd.grad(loss, resnet.tree_leaves(params))


def test_member_step_matches_float64_with_tf32_on_outside(dev):
    cfg = resnet.ResNetConfig()
    params, state = resnet.init_params(prng_key(0), cfg, dev)
    x, y = _batch(dev, 32, 224, seed=1)  # one member's batch on the DDP path
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            logits = resnet.forward(params, state, x, cfg)[0]
        grads = _grads(params, state, x, y, cfg)
        assert (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32) == (True, True)
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    p64 = resnet._tree_map(lambda t: t.double(), params)
    with torch.no_grad():
        logits64 = resnet.forward(p64, state, x, cfg64)[0]
    g64 = _grads(p64, state, x, y, cfg64)
    assert torch.isfinite(logits).all()
    assert (logits.double() - logits64).norm() <= LOGITS_RTOL * logits64.norm()
    total = math.sqrt(sum(g.square().sum().item() for g in g64))
    for g, w in zip(grads, g64):
        assert (g.double() - w).norm() <= GRAD_RTOL * w.norm() + GRAD_FLOOR * total, g.shape


@pytest.mark.parametrize("conv_tf32,matmul_tf32",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_guarded_convolution_is_f32_under_every_tf32_setting(dev, conv_tf32, matmul_tf32):
    """A stage-2 projection (1x1, stride 2, 256 -> 512 channels, 32 images
    of 56x56) forward and backward through the model's guarded convolution,
    whatever TF32 flags the caller set: within CONV_RTOL of float64."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(32, 256, 56, 56, device=dev, generator=g).to(
        memory_format=torch.channels_last)
    w = torch.randn(512, 256, 1, 1, device=dev, generator=g) * 0.05
    gy = torch.randn(32, 512, 28, 28, device=dev, generator=g).to(
        memory_format=torch.channels_last)
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    y64 = torch.nn.functional.conv2d(x64, w64, stride=2)
    y64.backward(gy.double())
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = conv_tf32, matmul_tf32
    try:
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = resnet._Conv.apply(xs, ws, 2, (0, 0))
        y.backward(gy)
        assert (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32) == (conv_tf32, matmul_tf32)
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved
    for got, want in ((y, y64), (xs.grad, x64.grad), (ws.grad, w64.grad)):
        assert (got.double() - want).norm() <= CONV_RTOL * want.norm()


def test_ddp_bucket_through_b7_is_bit_equal_to_its_plain_version(dev):
    """Four members' gradients of ResNet-18 (full width, 64x64 images),
    flattened into one [W, K] bucket and summed by the Communicator's
    "pallas" all-reduce: one B7 launch, every row ar_chain_plain's."""
    w, cfg = 4, resnet.ResNetConfig(depth=18)
    params, state = resnet.init_params(prng_key(0), cfg, dev)
    rows = []
    for m in range(w):
        x, y = _batch(dev, 4, 64, seed=10 + m)
        rows.append(torch.cat([g.reshape(-1) for g in _grads(params, state, x, y, cfg)]))
    bucket = torch.stack(rows)
    assert bucket.shape == (w, resnet.num_params(params))
    comm = Communicator(make_mesh(MeshConfig(dp=w), device=dev), "dp")
    torch.cuda.synchronize()
    ring_ccl.reset_launch_counts()
    got = comm.all_reduce(bucket, algo="pallas")
    torch.cuda.synchronize()
    assert {k: v for k, v in ring_ccl.launch_counts.items() if v} == {"ring_all_reduce": 1}
    assert torch.equal(got, ring_ccl.ar_chain_plain(bucket, (1, -1)))
