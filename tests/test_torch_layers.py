"""uccl_tpu_torch.models.layers against uccl_tpu.models.layers (CPU, f32).

Same inputs from a seeded numpy generator through both; rtol 1e-5 /
atol 1e-6 (float32 elementwise math, summation order the only difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.models import layers as jl
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.models import layers as tl

RTOL, ATOL = 1e-5, 1e-6


def test_rms_norm(rng):
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tl.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rms_norm_keeps_dtype(rng):
    x = torch.tensor(rng.standard_normal((4, 16)), dtype=torch.bfloat16)
    assert tl.rms_norm(x, torch.ones(16)).dtype == torch.bfloat16


@pytest.mark.parametrize("per_sequence", [False, True], ids=["pos_S", "pos_BS"])
def test_rope(rng, per_sequence):
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    if per_sequence:
        pos = np.stack([np.arange(12) + 5, np.arange(12) + 40]).astype(np.int32)
    else:
        pos = (np.arange(12) + 7).astype(np.int32)
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tl.rope(torch.tensor(x), torch.tensor(pos), 10000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cross_entropy_world1(rng):
    logits = (rng.standard_normal((24, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (24,)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jfn = shard_map(
        lambda lg, t: jl.tp_cross_entropy(lg, t, 0, "tp"),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False,
    )
    want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(targets)))
    got = tl.tp_cross_entropy(torch.tensor(logits), torch.tensor(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cross_entropy_grad_is_softmax_minus_onehot(rng):
    logits = torch.tensor(rng.standard_normal((6, 10)), dtype=torch.float32,
                          requires_grad=True)
    targets = torch.tensor(rng.integers(0, 10, (6,)))
    (g,) = torch.autograd.grad(tl.tp_cross_entropy(logits, targets).sum(), logits)
    want = torch.softmax(logits.detach(), -1) - torch.nn.functional.one_hot(targets, 10)
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
