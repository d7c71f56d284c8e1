"""uccl_tpu_torch's sampling against the JAX package's, and the serving
sampling policy and LRU copies.

The port computes JAX's threefry keys in plain torch, so the tolerance is
none where the arithmetic is integer: the key words of
``fold_in(PRNGKey(seed), pos)`` and the ``random_bits`` words equal
``jax.random.key_data`` / ``jax.random.bits`` for seeds 0..63, positions
0..63 and V in {256, 16384}, and the uniform floats equal
``jax.random.uniform``'s bit for bit. The Gumbel noise ``-log(-log(u))``
goes through two logs, each of which XLA:CPU and PyTorch round within 1 ulp
of each other (held below); near ``u = 1/e`` the outer log's argument is
near 1 and its result near 0, so the noise is held to 2 ulps of
``max(1, |g|)``. Sampled tokens must equal JAX's on every row drawn here
(the logits are the same numpy arrays on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.models import sampling as jsamp
from uccl_tpu.serving import sampling as jserv
from uccl_tpu.utils.lru import LRUFnCache as JLRU
from uccl_tpu_torch.models import sampling as tsamp
from uccl_tpu_torch.serving import sampling as tserv
from uccl_tpu_torch.utils.lru import LRUFnCache

@pytest.fixture(autouse=True, scope="module")
def _warm_torch_threads():
    """Run torch's CPU exp and log once on every intra-op thread before any
    comparison: on the CPU build these tests run with, the first vectorized
    exp or log a fresh OpenMP worker thread computes can be off by ~1e-4 of
    each value over that thread's whole chunk (ROADMAP C8); the second is
    right. The Gumbel draws here are large enough to use every thread."""
    x = torch.rand(torch.get_num_threads() * 65536) + 0.5
    torch.exp(x), torch.log(x)


# jitted once per shape: the JAX functions are the module's own, eager
# dispatch of their vmapped sorts is what would cost the time
J_SAMPLE_TOKENS = jax.jit(jsamp.sample_tokens)
J_SAMPLE_WINDOW = jax.jit(jsamp.sample_window)
SEEDS = np.arange(64, dtype=np.int32)
POSITIONS = np.arange(64, dtype=np.int32)
TINY = np.finfo(np.float32).tiny


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.fixture(scope="module")
def jax_keys():
    """key_data of fold_in(PRNGKey(seed), pos) for every (seed, pos): [64, 64, 2]."""
    grid = jax.vmap(jax.vmap(jsamp.fold_key, in_axes=(None, 0)), in_axes=(0, None))
    return np.asarray(jax.random.key_data(grid(jnp.asarray(SEEDS), jnp.asarray(POSITIONS))))


def _torch_keys():
    s = torch.as_tensor(SEEDS).to(torch.int64)[:, None].expand(64, 64)
    p = torch.as_tensor(POSITIONS).to(torch.int64)[None, :].expand(64, 64)
    return tsamp.fold_key(s, p)


def test_prng_key_matches_jax_for_any_int32_seed():
    for seed in (0, 1, 7, 2 ** 31 - 1, -1, -(2 ** 31)):
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).astype(np.int64)
        assert tsamp.prng_key(torch.tensor(seed)).tolist() == want.tolist(), seed


def test_fold_in_keys_bit_identical(jax_keys):
    assert np.array_equal(_torch_keys().numpy(), jax_keys.astype(np.int64))


@pytest.mark.parametrize("v", [256, 16384])
def test_random_bits_and_uniform_bit_identical(jax_keys, v):
    keys = jax_keys if v == 256 else jax_keys[np.arange(64), np.arange(64)][:, None]
    flat = keys.reshape(-1, 2)
    jkeys = jax.random.wrap_key_data(jnp.asarray(flat))
    jbits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (v,), jnp.uint32))(jkeys))
    juni = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (v,), jnp.float32, minval=TINY, maxval=1.0))(jkeys))
    tkeys = torch.as_tensor(flat.astype(np.int64))
    assert np.array_equal(tsamp.random_bits(tkeys, v).numpy(), jbits.astype(np.int64))
    tuni = tsamp.uniform(tkeys, v, minval=TINY).numpy()
    assert np.array_equal(tuni.view(np.int32), juni.view(np.int32))


def test_gumbel_within_two_ulps_of_max_one_and_each_log_within_one(jax_keys):
    flat = jax_keys[::7, ::7].reshape(-1, 2)
    v = 16384
    jkeys = jax.random.wrap_key_data(jnp.asarray(flat))
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,), jnp.float32))(jkeys))
    tkeys = torch.as_tensor(flat.astype(np.int64))
    tg = tsamp.gumbel(tkeys, v).numpy()
    scale = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32)).astype(np.float64)
    assert (np.abs(jg.astype(np.float64) - tg) / scale).max() <= 2.0
    u = tsamp.uniform(tkeys, v, minval=TINY).numpy()
    inner_j = np.asarray(jax.jit(lambda x: -jnp.log(x))(jnp.asarray(u)))
    inner_t = (-torch.log(torch.as_tensor(u))).numpy()
    assert _ulps(inner_j, inner_t).max() <= 1
    outer_j = np.asarray(jax.jit(jnp.log)(jnp.asarray(inner_j)))
    outer_t = torch.log(torch.as_tensor(inner_j)).numpy()
    assert _ulps(outer_j, outer_t).max() <= 1


def _rows(rng, b, v, ties=False):
    logits = (rng.standard_normal((b, v)) * 3.0).astype(np.float32)
    if ties:  # every row's top 8 logits equal: top-k ties and argmax order
        logits[:, 5:13] = logits.max(axis=1, keepdims=True) + 1.0
    return logits


CASES = [  # (V, temperature, top_p, top_k); the JAX sampler's sort at V = 16384 is the cost
    (256, 0.8, 0.95, 50), (256, 1.0, 1.0, 0), (256, 0.5, 0.7, 0), (256, 1.3, 1.0, 10),
    (256, 0.0, 0.9, 5), (256, 0.7, 0.999999, 200), (16384, 0.8, 0.95, 50),
    (16384, 1.0, 1.0, 0),
]


@pytest.mark.parametrize("v,temp,top_p,top_k", CASES,
                         ids=[f"v{v}-t{t}-p{p}-k{k}" for v, t, p, k in CASES])
def test_sample_tokens_identical_to_jax(rng, v, temp, top_p, top_k):
    b = 48
    logits = _rows(rng, b, v, ties=v == 256)
    seeds = rng.integers(0, 2 ** 31 - 1, b).astype(np.int32)
    pos = rng.integers(0, 4096, b).astype(np.int32)
    temp, top_p, top_k = (np.full(b, x, dt) for x, dt in zip((temp, top_p, top_k),
                                                             (np.float32, np.float32, np.int32)))
    want = np.asarray(J_SAMPLE_TOKENS(*map(jnp.asarray, (seeds, pos, logits, temp, top_p,
                                                              top_k))))
    got = tsamp.sample_tokens(seeds, pos, torch.as_tensor(logits), temp, top_p, top_k)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()


def test_mixed_rows_greedy_rows_take_the_argmax_and_ignore_the_key(rng):
    logits = _rows(rng, 16, 256)
    temp = np.where(np.arange(16) % 2 == 0, 0.0, 0.9).astype(np.float32)
    got = tsamp.sample_tokens(np.arange(16), np.zeros(16), torch.as_tensor(logits), temp,
                              np.ones(16), np.zeros(16))
    want = np.asarray(J_SAMPLE_TOKENS(
        jnp.arange(16, dtype=jnp.int32), jnp.zeros(16, jnp.int32), jnp.asarray(logits),
        jnp.asarray(temp), jnp.ones(16, jnp.float32), jnp.zeros(16, jnp.int32)))
    assert got.numpy().tolist() == want.tolist()
    assert (got.numpy()[::2] == logits[::2].argmax(1)).all()


def test_top_p_one_keeps_an_extreme_tail_token():
    """top_p >= 1 disables the nucleus exactly: over a peaked row the f32
    cumulative mass reaches 1.0 before the tail, yet the tail stays."""
    z = torch.full((1, 64), -60.0)
    z[0, 0] = 40.0
    keep = tsamp._nucleus_keep(z, torch.tensor([1.0]))
    assert bool(keep.all())
    jkeep = np.asarray(jsamp._nucleus_keep(jnp.asarray(z.numpy()[0]), jnp.float32(1.0)))
    assert jkeep.all()
    assert not bool(tsamp._nucleus_keep(z, torch.tensor([0.5]))[0, 1:].any())


def test_top_k_ties_all_survive():
    """top_k=1 over a row whose maximum is shared by three tokens keeps all
    three (``z >= kth``): every seed draws one of them, and each is drawn."""
    row = np.zeros(32, np.float32)
    row[[4, 9, 20]] = 5.0
    logits = np.tile(row, (64, 1))
    n = len(logits)
    got = tsamp.sample_tokens(np.arange(n), np.zeros(n), torch.as_tensor(logits),
                              np.ones(n), np.ones(n), np.ones(n))
    assert set(got.tolist()) == {4, 9, 20}
    want = np.asarray(J_SAMPLE_TOKENS(
        jnp.arange(n, dtype=jnp.int32), jnp.zeros(n, jnp.int32), jnp.asarray(logits),
        jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32), jnp.ones(n, jnp.int32)))
    assert got.numpy().tolist() == want.tolist()


def test_sample_window_uses_consecutive_positions(rng):
    b, s, v = 4, 5, 256
    logits = (rng.standard_normal((b, s, v)) * 2).astype(np.float32)
    seeds = np.array([3, 4, 5, 6], np.int32)
    pos0 = np.array([0, 7, 100, 3], np.int32)
    params = (np.full(b, 0.9, np.float32), np.full(b, 0.9, np.float32), np.full(b, 20, np.int32))
    want = np.asarray(J_SAMPLE_WINDOW(jnp.asarray(seeds), jnp.asarray(pos0),
                                          jnp.asarray(logits), *map(jnp.asarray, params)))
    got = tsamp.sample_window(seeds, pos0, torch.as_tensor(logits), *params)
    assert got.numpy().tolist() == want.tolist()
    for j in range(s):
        col = tsamp.sample_tokens(seeds, pos0 + j, torch.as_tensor(logits[:, j]), *params)
        assert got[:, j].tolist() == col.tolist()


def test_sampling_never_touches_torch_global_rng(rng):
    logits = torch.as_tensor(_rows(rng, 8, 256))
    args = (np.arange(8), np.arange(8), logits, np.full(8, 0.8), np.full(8, 0.95),
            np.full(8, 40))
    torch.manual_seed(1)
    a = tsamp.sample_tokens(*args)
    torch.manual_seed(2)
    state = torch.get_rng_state()
    b = tsamp.sample_tokens(*args)
    assert torch.equal(a, b) and torch.equal(state, torch.get_rng_state())


def test_broadcast_params_matches_jax():
    got = tsamp.broadcast_params(3, 5, 0.7, 0.9, 4)
    want = jsamp.broadcast_params(3, 5, 0.7, 0.9, 4)
    for g, w in zip(got, want):
        assert g.numpy().tolist() == np.asarray(w).tolist()
        assert str(g.dtype).removeprefix("torch.") == str(np.asarray(w).dtype)


def test_sample_margins_read_the_tie_the_draw_sits_at(rng):
    logits = torch.as_tensor(_rows(rng, 1, 256))[0]
    greedy = tsamp.sample_margins(0, 0, logits, 0.0, 1.0, 0)
    top = torch.topk(logits.double(), 2).values
    assert greedy["score_gap"] == pytest.approx(float(top[0] - top[1]))
    m = tsamp.sample_margins(3, 9, logits, 0.8, 0.95, 50)
    assert m["score_gap"] > 0 and m["nucleus_margin"] >= 0
    assert tsamp.sample_margins(3, 9, logits, 0.8, 1.0, 50)["nucleus_margin"] is None


# -- serving/sampling.py and utils/lru.py: copies, held to the originals ---


@pytest.mark.parametrize("bad", [dict(temperature=float("nan")), dict(top_p=0.0),
                                 dict(top_p=1.5), dict(top_k=-1), dict(seed=2 ** 31)])
def test_sampling_params_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        jserv.SamplingParams(**bad)
    with pytest.raises(ValueError):
        tserv.SamplingParams(**bad)


def test_slot_arrays_stamp_and_pack_match_jax():
    j, t = jserv.slot_arrays(4), tserv.slot_arrays(4)
    for arrays, mod in ((j, jserv), (t, tserv)):
        mod.stamp_slot(arrays, 1, mod.SamplingParams(temperature=0.7, top_p=0.9, top_k=3,
                                                     seed=-5))
        mod.stamp_slot(arrays, 2, mod.SamplingParams(seed=9))
        mod.stamp_slot(arrays, 2, None)
    for a, b in zip(jserv.pack(j, [0, 1, 2, 3]), tserv.pack(t, [0, 1, 2, 3])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tserv.FIELDS == jserv.FIELDS


def test_lru_fn_cache_matches_jax():
    for cls in (JLRU, LRUFnCache):
        c = cls(2)
        built = []
        for key in ("a", "b", "a", "c", "b"):
            c.get(key, lambda key=key: built.append(key) or key)
        assert built == ["a", "b", "c", "b"] and len(c) == 2 and "a" not in c
        with pytest.raises(ValueError):
            cls(0)
