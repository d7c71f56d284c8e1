"""Speculative decoding in the port (``serving/spec.py`` and the engine's
``spec_k``) against the JAX package's.

The drafter and the scheduling cases run on host stubs (no model): each
case runs on the JAX engine and on the port's, and both must meet the JAX
test's exact assertions. The model cases run the JAX engine and the
port's engine on the same weights (carried through numpy) and the same
numpy-seeded requests: tokens, finish reasons, the spec counters and the
snapshot's acceptance numbers must be identical (no tolerance), every
request must equal its ``replay_alone`` (same ``spec_k``, same drafter),
and on the CPU a greedy speculating engine must equal vanilla greedy.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from uccl_tpu import obs as jobs
from uccl_tpu.models import dense as jdense
from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import request as jreq
from uccl_tpu.serving import sampling as jsamp
from uccl_tpu.serving import spec as jspec
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import request as treq
from uccl_tpu_torch.serving import sampling as tsamp
from uccl_tpu_torch.serving import spec as tspec

PKGS = {
    "jax": SimpleNamespace(engine=jengine, spec=jspec, req=jreq, samp=jsamp, obs=jobs),
    "torch": SimpleNamespace(engine=tengine, spec=tspec, req=treq, samp=tsamp, obs=tobs),
}
DENSE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MOE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
           moe_experts=8, moe_topk=2, moe_ffn=64)
MAX_SEQ = 40


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


# -- the drafter ---------------------------------------------------------------

DRAFTS = [  # (max_ngram, min_ngram, context, k)
    (3, 1, [1, 2, 3, 1, 2, 3, 1, 2], 3),
    (2, 1, [5, 1, 2, 7, 1, 2, 9, 1, 2], 2),
    (3, 1, [2, 3, 4, 8, 7, 4, 9, 2, 3, 4], 1),
    (3, 1, list(range(10)), 4),
    (3, 1, [7], 4),
    (3, 1, [1, 2, 1], 0),
    (1, 1, [4, 5, 6, 7, 4], 2),
    (3, 2, [9, 9, 9, 9, 9, 9], 5),
]


@pytest.mark.parametrize("hi,lo,ctx,k", DRAFTS)
def test_ngram_drafter_proposes_what_the_jax_drafter_proposes(hi, lo, ctx, k):
    got = tspec.NGramDrafter(hi, lo).draft(np.asarray(ctx, np.int32), k)
    want = jspec.NGramDrafter(hi, lo).draft(np.asarray(ctx, np.int32), k)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()


def test_ngram_drafter_validation():
    for hi, lo in ((2, 3), (2, 0)):
        with pytest.raises(ValueError, match="min_ngram"):
            tspec.NGramDrafter(max_ngram=hi, min_ngram=lo)


# -- scheduling on a stub target ---------------------------------------------


class _SpecStub:
    """Target whose greedy continuation is always last_token + 1: prefill
    emits 100, verify scores a window against the arithmetic continuation
    of its column-0 token. Records every call."""

    def __init__(self, n_slots=2, max_seq=64):
        self.n_slots, self.max_seq, self.calls = n_slots, max_seq, []

    def prefill(self, tokens, lens, mask, start=None):
        self.calls.append(("prefill", tuple(int(s) for s in np.flatnonzero(mask))))
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.calls.append(("decode", tuple(int(s) for s in np.flatnonzero(active))))
        return (tokens + 1).astype(np.int32)

    def verify(self, tokens, active):
        s = tokens.shape[1]
        out = np.zeros((self.n_slots, s), np.int32)
        n_acc = np.zeros(self.n_slots, np.int32)
        for b in np.flatnonzero(active):
            out[b] = int(tokens[b, 0]) + 1 + np.arange(s)
            m = 0
            for j in range(1, s):
                if tokens[b, j] != out[b, j - 1]:
                    break
                m += 1
            n_acc[b] = m
        self.calls.append(("verify", tuple(int(b) for b in np.flatnonzero(active))))
        return out, n_acc


def _arith(P):
    class Arithmetic(P.spec.Drafter):
        def draft(self, context, k):
            return np.asarray(context)[-1] + 1 + np.arange(k, dtype=np.int32)
    return Arithmetic()


def _zero(P):
    class Zero(P.spec.Drafter):
        def draft(self, context, k):
            return np.zeros(k, np.int32)
    return Zero()


def _oracle(n):
    return list(range(100, 100 + n))


def test_full_accept_commits_k_plus_one_per_step(P):
    eng = P.engine.ServingEngine(_SpecStub(n_slots=1), spec_k=3, drafter=_arith(P))
    r = eng.submit([1, 2], max_new_tokens=9)
    eng.step()
    assert r.n_generated == 5
    eng.drain()
    assert r.out_tokens == _oracle(9) and r.finish_reason == "length"
    assert (eng.metrics.decode_calls, eng.metrics.decode_tokens) == (2, 8)
    assert eng.metrics.spec_accepted == 6 and eng.metrics.spec_proposed == 6
    assert eng.pool.leaked() == 0


def test_full_reject_is_vanilla_pace_same_output(P):
    eng = P.engine.ServingEngine(_SpecStub(n_slots=1), spec_k=3, drafter=_zero(P))
    r = eng.submit([1, 2], max_new_tokens=5)
    eng.drain()
    assert r.out_tokens == _oracle(5)
    assert (eng.metrics.decode_calls, eng.metrics.decode_tokens) == (4, 4)
    assert eng.metrics.spec_accepted == 0 and eng.metrics.accepted_len == [0, 0, 0, 0]


@pytest.mark.parametrize("eos,budget,want", [(102, 10, [100, 101, 102]),
                                             (None, 3, [100, 101, 102])])
def test_eos_or_budget_inside_an_accepted_prefix_truncates_the_commit(P, eos, budget, want):
    eng = P.engine.ServingEngine(_SpecStub(n_slots=1), spec_k=4, drafter=_arith(P))
    r = eng.submit([1], max_new_tokens=budget, eos_id=eos)
    eng.drain()
    assert r.out_tokens == want and r.finish_reason == ("eos" if eos else "length")
    assert eng.pool.leaked() == 0


def test_chunk_finishing_joins_same_step_verify(P):
    eng = P.engine.ServingEngine(_SpecStub(n_slots=2), prefill_chunk=2, spec_k=2,
                                 drafter=_arith(P))
    r = eng.submit([1, 2, 3, 4], max_new_tokens=6)
    eng.step()
    assert r.state.value == "partial_prefill"
    assert eng.backend.calls == [("prefill", (0,))]
    eng.step()
    assert eng.backend.calls[1:] == [("prefill", (0,)), ("verify", (0,))]
    assert r.n_generated == 4
    eng.drain()
    assert r.out_tokens == _oracle(6) and eng.pool.leaked() == 0


def test_spec_budget_charges_verify_width(P):
    eng = P.engine.ServingEngine(_SpecStub(n_slots=2), prefill_chunk=8, step_tokens=8,
                                 spec_k=3, drafter=_zero(P))
    a = eng.submit([1, 2], max_new_tokens=8)
    eng.step()
    b = eng.submit([3, 4], max_new_tokens=2)
    eng.step()
    assert b.state.value == "queued"
    eng.drain()
    assert a.out_tokens == _oracle(8) and b.out_tokens == _oracle(2)


def test_mixed_slots_conservation_and_metrics(P):
    eng = P.engine.ServingEngine(_SpecStub(n_slots=2), spec_k=2, drafter=_arith(P), max_queue=4)
    reqs = [eng.submit([1], max_new_tokens=5) for _ in range(4)]
    for _ in range(2):
        eng.step()
        s = eng.snapshot()
        assert s["submitted"] == s["completed"] + s["active"] + s["queued"] + s["rejected"]
    eng.drain()
    assert all(r.out_tokens == _oracle(5) for r in reqs)
    s = eng.snapshot()
    assert s["decode_tokens"] == 16 and s["spec_acceptance_rate"] == 1.0
    assert "p50" in s["accepted_len"] and eng.pool.leaked() == 0


def test_vanilla_accounting_unchanged(P):
    eng = P.engine.ServingEngine(_SpecStub(n_slots=2))
    [eng.submit([1, 2], max_new_tokens=4) for _ in range(3)]
    eng.drain()
    s = eng.snapshot()
    assert (s["output_tokens"], s["decode_tokens"]) == (12, 9)
    assert "spec_acceptance_rate" not in s


# -- the model: the port's engine against the JAX engine ------------------------


def _spec_counts(obs):
    fams = ("spec_tokens_total", "spec_accepted_len_total", "spec_resample_total")
    return {f: {tuple(sorted(l.items())): v for l, v in obs.counter(f).samples()} for f in fams}


def _delta(after, before):
    return {f: {k: v - before[f].get(k, 0) for k, v in d.items() if v - before[f].get(k, 0)}
            for f, d in after.items()}


def _trace(vocab, n, seed):
    """Repetitive prompts (a tiled motif, where prompt lookup accepts) and
    random ones, budgets 3..8, every third request sampled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2:
            p = rng.integers(0, vocab, int(rng.integers(3, 12)))
        else:
            p = np.tile(rng.integers(0, vocab, int(rng.integers(1, 3))), 6)[:int(rng.integers(4, 12))]
        sp = dict(temperature=0.8, top_p=0.9, top_k=16, seed=50 + i) if i % 3 == 1 else None
        out.append((p.astype(np.int32), int(rng.integers(3, 9)), sp))
    return out


def _drive(P, backend, trace, **kw):
    before = _spec_counts(P.obs)
    eng = P.engine.ServingEngine(backend, **kw)
    reqs = []
    for i, (p, n, sp) in enumerate(trace):
        reqs.append(eng.submit(p, max_new_tokens=n,
                               sampling=None if sp is None else P.samp.SamplingParams(**sp)))
        if i % 2:
            eng.step()
    eng.drain()
    snap = eng.snapshot()
    assert eng.pool.leaked() == 0
    eng.close()
    return eng, reqs, snap, _delta(_spec_counts(P.obs), before)


def _twin(jbackend, tbackend, trace, **kw):
    _, jr, js, jc = _drive(PKGS["jax"], jbackend, trace, **kw)
    eng, tr, ts, tc = _drive(PKGS["torch"], tbackend, trace, **kw)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.finish_reason for r in tr] == [r.finish_reason for r in jr]
    assert tc == jc
    for key in ("completed", "decode_calls", "decode_tokens", "prefill_calls",
                "spec_acceptance_rate", "accepted_len"):
        assert ts.get(key) == js.get(key), key
    for r in tr:
        assert tengine.replay_alone(tbackend, r, drafter=eng.drafter).tolist() == r.out_tokens
    return tr, tc


@pytest.fixture(scope="module")
def dense_pair():
    cfg = jdense.DenseConfig(**DENSE)
    jp = jdense.init_params(jax.random.PRNGKey(3), cfg)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (jengine.DenseBackend(jp, cfg, n_slots=3, max_seq=MAX_SEQ),
            tengine.DenseBackend(params, tdense.DenseConfig(**DENSE), n_slots=3,
                                 max_seq=MAX_SEQ))


def test_dense_spec_chunked_engine_identical_to_jax_engine(dense_pair):
    jb, tb = dense_pair
    tr, counts = _twin(jb, tb, _trace(DENSE["vocab"], 8, seed=0), spec_k=3, prefill_chunk=4,
                       step_tokens=16)
    assert counts["spec_tokens_total"].get((("outcome", "accepted"),), 0) > 0
    assert all(r.spec_k == 3 and r.prefill_chunk == 4 for r in tr)


def test_dense_greedy_spec_equals_vanilla_on_the_cpu(dense_pair):
    _, tb = dense_pair
    trace = [(p, n, None) for p, n, _ in _trace(DENSE["vocab"], 6, seed=1)]
    outs = {}
    for k in (None, 1, 3):
        _, reqs, _, _ = _drive(PKGS["torch"], tb, trace, spec_k=k)
        outs[k] = [r.out_tokens for r in reqs]
    assert outs[1] == outs[None] and outs[3] == outs[None]


def test_moe_spec_engine_identical_to_jax_engine_and_its_replay(devices):
    cfg = jmoe.MoEServeConfig(**MOE)
    jp = jmoe.init_params(jax.random.PRNGKey(4), cfg)
    npt = jax.tree.map(np.asarray, jp)
    jsrv = jmoe.MoEServer(cfg, Mesh(np.array(devices[:2]), ("dp",)))
    tsrv = tmoe.MoEServer(tmoe.MoEServeConfig(**MOE, moe_wire="pallas"),
                          make_mesh(MeshConfig(dp=2), "cpu", 2))
    _twin(jengine.MoEBackend(jsrv, jsrv.shard_params(jp), batch_local=2, max_seq=MAX_SEQ),
          tengine.MoEBackend(tsrv, tsrv.shard_params(tmoe.params_from_jax(npt, "cpu")),
                             batch_local=2, max_seq=MAX_SEQ),
          _trace(MOE["vocab"], 6, seed=2), spec_k=2)
