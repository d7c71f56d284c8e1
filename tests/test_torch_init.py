"""The port's weights are the JAX package's, seed for seed.

``sampling.split`` and ``sampling.normal`` against ``jax.random.split`` and
``jax.random.normal`` (the partitionable threefry mode the installed jax
runs by default), and every stack's ``init_params(prng_key(s))`` against the
JAX ``init_params(PRNGKey(s))`` at two seeds. Keys and the uniform bits are
exact. The normals go through XLA's float32 ``erf_inv`` polynomial, which
the port writes in torch ops: each normal lies within ULP_BOUND units in
the last place of JAX's (the largest difference measured on the CPU is 3).
"""

import jax
import numpy as np
import pytest
import torch

from uccl_tpu.models import dense as jdense
from uccl_tpu.models import flagship as jflag
from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.serving import adapters as jadapters
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import flagship as tflag
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.models import sampling as tsamp
from uccl_tpu_torch.serving import adapters as tadapters

ULP_BOUND = 4
SEEDS = (0, 7)


def _ulps(got, want):
    """Largest distance in units in the last place between two f32 arrays
    of one sign pattern (both sides' bits as ordered integers)."""
    def ordered(a):
        i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(got) - ordered(want)).max()) if np.size(want) else 0


def _key_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, -5])
def test_split_keys_are_jax_keys_exactly(seed):
    jk = jax.random.PRNGKey(seed)
    tk = tsamp.prng_key(seed)
    assert np.array_equal(tk.numpy(), _key_words(jk))
    for n in (2, 10, 12):
        want = _key_words(jax.random.split(jk, n))
        assert np.array_equal(tsamp.split(tk, n).numpy(), want)
    # a split of a split: the init's keys feed draws directly
    assert np.array_equal(tsamp.split(tsamp.split(tk, 3)[2], 4).numpy(),
                          _key_words(jax.random.split(jax.random.split(jk, 3)[2], 4)))


@pytest.mark.parametrize("shape", [(1000,), (3, 64, 77), (2, 4, 32, 48)])
def test_uniform_bits_exact_and_normals_within_the_ulp_bound(shape):
    jk = jax.random.split(jax.random.PRNGKey(3), 2)[1]
    tk = tsamp.split(tsamp.prng_key(3), 2)[1]
    n = int(np.prod(shape))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    ju = np.asarray(jax.random.uniform(jk, (n,), jax.numpy.float32, lo, 1.0))
    assert np.array_equal(tsamp.uniform(tk, n, minval=lo, maxval=1.0).numpy(), ju)
    want = np.asarray(jax.random.normal(jk, shape, jax.numpy.float32))
    got = tsamp.normal(tk, shape)
    assert got.shape == shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), want) <= ULP_BOUND


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jax.numpy.asarray(x.numpy())))
    got = tsamp.erf_inv(x).numpy()
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[1]) and got[1] > 0
    assert got[2] == 0.0
    assert _ulps(got[2:], want[2:]) <= ULP_BOUND


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)}


STACKS = {
    "dense": (jdense, tdense, dict(vocab=96, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                   head_dim=8, ffn=48)),
    "moe": (jmoe, tmoe, dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
                             moe_experts=4, moe_topk=2, moe_ffn=40)),
    "flagship": (jflag, tflag, dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                    head_dim=8, moe_experts=4, moe_ffn=40)),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("seed", SEEDS)
def test_init_params_are_the_jax_init_of_the_same_seed(stack, seed):
    jmod, tmod, size = STACKS[stack]
    cfg_name = {"dense": "DenseConfig", "moe": "MoEServeConfig", "flagship": "FlagshipConfig"}
    want = _leaves(jax.tree.map(np.asarray, jmod.init_params(
        jax.random.PRNGKey(seed), getattr(jmod, cfg_name[stack])(**size))))
    got = _leaves(tmod.init_params(tsamp.prng_key(seed), getattr(tmod, cfg_name[stack])(**size),
                                   "cpu"))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == np.float32, name
        assert _ulps(got[name], w) <= ULP_BOUND, name
    # a different seed draws different weights
    other = _leaves(tmod.init_params(tsamp.prng_key(seed + 1),
                                     getattr(tmod, cfg_name[stack])(**size), "cpu"))
    assert not np.array_equal(other["embed"], got["embed"])


def test_make_lora_draws_the_jax_adapter():
    want = jadapters.make_lora(jax.random.PRNGKey(7919 + 1), 2, 32, 32, 16, 4)
    got = tadapters.make_lora(tsamp.prng_key(7919 + 1), 2, 32, 32, 16, 4)
    for t in ("wq", "wv"):
        for m in ("a", "b"):
            assert got[t][m].shape == want[t][m].shape
            assert _ulps(got[t][m], want[t][m]) <= ULP_BOUND


def test_no_weight_init_reads_a_torch_generator():
    import inspect

    for mod in (tdense, tmoe, tflag):
        src = inspect.getsource(mod.init_params)
        assert "Generator" not in src and "randn" not in src
