"""uccl_tpu_torch's dense serving stack (models/dense.py, models/inference.py)
against the JAX package's, on the same weights carried through numpy.

Tolerances are tests/test_dense_inference.py's: logits at rtol 1e-4 /
atol 1e-5 in float32, the KV rows the same. Greedy and sampled tokens, the
per-slot lengths, the accepted draft counts and everything integer are held
exactly. Float64 (the serving engine's batch-invariant mode) is held to the
JAX float32 logits at the same tolerance: it differs from them by JAX's own
float32 rounding.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.models import dense as jdense
from uccl_tpu.models import inference as jinf
from uccl_tpu.serving.sampling import SamplingParams as JSampling
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import inference as tinf
from uccl_tpu_torch.models.sampling import prng_key
from uccl_tpu_torch.serving.sampling import SamplingParams

SIZES = dict(vocab=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, ffn=128)
RTOL, ATOL = 1e-4, 1e-5
MAX_SEQ = 32


@pytest.fixture(scope="module")
def models():
    jcfg = jdense.DenseConfig(**SIZES)
    jp = jdense.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tdense.DenseConfig(**SIZES)
    tp = tdense.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


def test_bridge_round_trips_names_and_layouts(models):
    _, jp, _, tp = models
    back = tdense.params_to_numpy(tp)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jp),
                                 jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(want), got), path


def test_init_params_shapes_match_jax(models):
    jcfg, jp, tcfg, _ = models
    tp = tdense.init_params(prng_key(0), tcfg, device="cpu")
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda t: tuple(t.shape), tdense.params_to_numpy(tp))
    assert got == want


def test_prefill_and_decode_logits_match(models, rng):
    jcfg, jp, tcfg, tp = models
    prompt = rng.integers(0, 256, (2, 9)).astype(np.int32)
    jl, jc = jinf.prefill(jp, jnp.asarray(prompt), jcfg, MAX_SEQ)
    tl, tc = tinf.prefill(tp, prompt, tcfg, MAX_SEQ)
    _close(tl, jl)
    _close(tc.k, jc.k)
    assert tc.length == int(jc.length) == 9
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jc = jinf.decode_step(jp, jnp.asarray(tok), jc, jcfg)
        tl, tc = tinf.decode_step(tp, tok, tc, tcfg)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    _close(tc.v, jc.v)
    with pytest.raises(ValueError):
        tinf.prefill(tp, np.zeros((1, MAX_SEQ + 1), np.int32), tcfg, MAX_SEQ)


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_tokens_identical(models, rng, sampled):
    jcfg, jp, tcfg, tp = models
    prompt = rng.integers(0, 256, (3, 7)).astype(np.int32)
    kw = dict(temperature=0.8, top_p=0.95, top_k=50, seed=11)
    want = jinf.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=10, max_seq=MAX_SEQ,
                         sampling=JSampling(**kw) if sampled else None)
    got = tinf.generate(tp, prompt, tcfg, max_new_tokens=10, max_seq=MAX_SEQ,
                        sampling=SamplingParams(**kw) if sampled else None)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == np.asarray(want).tolist()
    with pytest.raises(ValueError):
        tinf.generate(tp, prompt, tcfg, max_new_tokens=MAX_SEQ, max_seq=MAX_SEQ)


J_PREFILL_SLOTS = jax.jit(jinf.prefill_slots, static_argnames=("cfg",))
J_VERIFY_SLOTS = jax.jit(jinf.verify_slots, static_argnames=("cfg",))


def _slot_caches(jcfg, tcfg, n):
    return jinf.SlotKVCache.empty(jcfg, n, MAX_SEQ), tinf.SlotKVCache.empty(tcfg, n, MAX_SEQ,
                                                                           device="cpu")


def _same_cache(tc, jc):
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()


def test_prefill_slots_with_start_offsets_and_sampling(models, rng):
    """Two slots prefill a prompt in two windows (offsets 0 then 6), a third
    stays idle; the second window samples slot 0's first token."""
    jcfg, jp, tcfg, tp = models
    jc, tc = _slot_caches(jcfg, tcfg, 3)
    prompts = rng.integers(0, 256, (3, 12)).astype(np.int32)
    lens = np.array([11, 12, 1], np.int32)
    mask = np.array([True, True, False])
    samp = (np.array([5, 0, 0], np.int32), np.zeros(3, np.int32),
            np.array([0.9, 0.0, 0.0], np.float32), np.array([0.95, 1.0, 1.0], np.float32),
            np.array([40, 0, 0], np.int32))
    for start, sampling in ((0, None), (6, samp)):
        window = prompts[:, start:start + 6]
        starts = np.full(3, start, np.int32)
        jt, jc = J_PREFILL_SLOTS(jp, jnp.asarray(window), jnp.asarray(lens), jnp.asarray(mask),
                                 jc, cfg=jcfg, start=jnp.asarray(starts),
                                 sampling=None if sampling is None else tuple(
                                     map(jnp.asarray, sampling)))
        tt, tc = tinf.prefill_slots(tp, window, lens, mask, tc, tcfg, start=starts,
                                    sampling=sampling)
        assert tt.numpy()[:2].tolist() == np.asarray(jt)[:2].tolist()
        _same_cache(tc, jc)
    assert tc.lengths.tolist() == [11, 12, 0]


def test_verify_and_decode_step_slots(models, rng):
    jcfg, jp, tcfg, tp = models
    jc, tc = _slot_caches(jcfg, tcfg, 3)
    prompts = rng.integers(0, 256, (3, 8)).astype(np.int32)
    lens = np.full(3, 8, np.int32)
    mask = np.ones(3, bool)
    jt, jc = J_PREFILL_SLOTS(jp, jnp.asarray(prompts), jnp.asarray(lens), jnp.asarray(mask), jc,
                             cfg=jcfg)
    tt, tc = tinf.prefill_slots(tp, prompts, lens, mask, tc, tcfg)
    assert tt.tolist() == np.asarray(jt).tolist()
    # row 0 drafts the model's own continuation, row 1 a wrong draft, row 2 idle
    first = np.asarray(jt)
    gen = np.asarray(jinf.generate(jp, jnp.asarray(prompts[:1]), jcfg, max_new_tokens=4,
                                   max_seq=MAX_SEQ))[0]
    window = np.stack([gen[:4], np.array([first[1], 1, 2, 3]), np.zeros(4)]).astype(np.int32)
    active = np.array([True, True, False])
    jt, jn, jc = J_VERIFY_SLOTS(jp, jnp.asarray(window), jnp.asarray(active), jc, cfg=jcfg)
    tt, tn, tc = tinf.verify_slots(tp, window, active, tc, tcfg)
    assert tt.numpy()[:2].tolist() == np.asarray(jt)[:2].tolist()
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tn[0] == 3
    _same_cache(tc, jc)
    jt, jc = jinf.decode_step_slots(jp, jnp.asarray(tt.numpy()[:, 0]), jnp.asarray(active), jc,
                                    jcfg)
    tt2, tc = tinf.decode_step_slots(tp, tt.numpy()[:, 0], active, tc, tcfg)
    assert tt2.numpy()[:2].tolist() == np.asarray(jt)[:2].tolist()
    _same_cache(tc, jc)


def test_greedy_acceptance_and_spec_advance_match_jax(rng):
    tokens = rng.integers(0, 4, (16, 5)).astype(np.int32)
    tok = rng.integers(0, 4, (16, 5)).astype(np.int32)
    tok[:, :-1] = np.where(rng.random((16, 4)) < 0.7, tokens[:, 1:], tok[:, :-1])
    active = rng.random(16) < 0.7
    lengths = rng.integers(0, 9, 16).astype(np.int32)
    jn = jinf.greedy_acceptance(jnp.asarray(tokens), jnp.asarray(tok))
    tn = tinf.greedy_acceptance(torch.as_tensor(tokens), torch.as_tensor(tok))
    assert tn.tolist() == np.asarray(jn).tolist()
    want = jinf.spec_advance(jnp.asarray(lengths), jnp.asarray(active), jn)
    got = tinf.spec_advance(torch.as_tensor(lengths), torch.as_tensor(active), tn)
    assert got.tolist() == np.asarray(want).tolist() and got.dtype == torch.int32
    one = tinf.greedy_acceptance(torch.as_tensor(tokens[:, :1]), torch.as_tensor(tok[:, :1]))
    assert one.tolist() == [0] * 16


def test_slot_rows_export_import_copy_match_jax(models, rng):
    jcfg, _, tcfg, _ = models
    jc, tc = _slot_caches(jcfg, tcfg, 3)
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    jc = jc.import_rows(1, k, v, length=5)
    tc = tc.import_rows(1, k, v, length=5)
    _same_cache(tc, jc)
    for a, b in zip(tc.export_rows(1, 1, 4), jc.export_rows(1, 1, 4)):
        assert np.array_equal(a, b)
    jc, tc = jc.copy_prefix(2, 1, 3), tc.copy_prefix(2, 1, 3)
    _same_cache(tc, jc)


def test_lora_delta_matches_jax(rng):
    h = rng.standard_normal((3, 4, 8)).astype(np.float32)
    a = rng.standard_normal((2, 5, 8, 3)).astype(np.float32)
    b = rng.standard_normal((2, 5, 3, 6)).astype(np.float32)
    a[:, 0], b[:, 0] = 0.0, 0.0
    ids = np.array([0, 3, 1], np.int32)
    want = np.asarray(jinf._lora_delta(jnp.asarray(h), (jnp.asarray(a), jnp.asarray(b)),
                                       jnp.asarray(ids), 1))
    got = tinf._lora_delta(torch.as_tensor(h), (torch.as_tensor(a), torch.as_tensor(b)),
                           torch.as_tensor(ids), 1)
    _close(got, want)
    assert not got[0].any()


def test_decode_step_elastic_names_its_queue_item(models):
    _, _, tcfg, tp = models
    with pytest.raises(NotImplementedError, match="queue A item 16"):
        tinf.decode_step_elastic(tp, np.zeros(1, np.int32), None, tcfg)
