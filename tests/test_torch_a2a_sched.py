"""The port's copy of the a2a round scheduler (uccl_tpu_torch/ep/a2a_sched.py)
against the JAX package's (uccl_tpu/ep/a2a_sched.py).

Both are numpy only, so the same seeded matrices go through both and every
result must be equal: the decomposition's rounds and loads, the device
schedule's full-permutation rounds and designated-round matrix K, the skew
and degree features, the Zipf routing draws, the traffic matrix, and the
series each records on its own counter registry.
"""

import numpy as np
import pytest

from uccl_tpu.ep import a2a_sched as jsched
from uccl_tpu_torch.ep import a2a_sched as tsched


def _matrices(w: int, seed: int):
    """Uniform, Zipf-routed, random sparse and all-zero [w, w] matrices."""
    rng = np.random.default_rng(seed)
    uniform = np.ones((w, w)) - np.eye(w)
    idx = jsched.zipf_topk(rng, w, 64, 2, 2 * w, alpha=1.2)
    zipf = jsched.traffic_from_topk(idx, 2 * w, 20, w)
    sparse = rng.integers(0, 5, (w, w)) * (rng.random((w, w)) < 0.4)
    return {"uniform": uniform, "zipf": zipf, "sparse": sparse.astype(float),
            "zero": np.zeros((w, w))}


def _rows(rounds):
    """Rounds as plain tuples (the two packages' Round classes differ)."""
    return [(r.perm, r.load) for r in rounds]


@pytest.mark.parametrize("w", [2, 3, 4, 5, 8, 16])
def test_rounds_and_designated_matrix_match(w):
    for name, m in _matrices(w, seed=w).items():
        assert _rows(tsched.decompose(m)) == _rows(jsched.decompose(m)), name
        t_rounds, t_k = tsched.wire_schedule(m, w)
        j_rounds, j_k = jsched.wire_schedule(m, w)
        assert _rows(t_rounds) == _rows(j_rounds), name
        np.testing.assert_array_equal(t_k, j_k)
        assert t_k.dtype == j_k.dtype
        assert tsched.skew(m) == jsched.skew(m), name
        assert tsched.max_degree(m) == jsched.max_degree(m), name
        for r in t_rounds:  # full permutations, every off-diagonal pair designated
            assert sorted(r.perm) == list(range(w))
        for s in range(w):
            for d in range(w):
                if s != d:
                    assert t_rounds[t_k[s, d]].perm[s] == d
    assert [r.perm for r in tsched.full_rounds(w)] == [r.perm for r in jsched.full_rounds(w)]


@pytest.mark.parametrize("alpha", [0.0, 1.2])
def test_zipf_draws_and_traffic_match(alpha):
    t_idx = tsched.zipf_topk(np.random.default_rng(7), 4, 128, 2, 8, alpha)
    j_idx = jsched.zipf_topk(np.random.default_rng(7), 4, 128, 2, 8, alpha)
    np.testing.assert_array_equal(t_idx, j_idx)
    assert t_idx.dtype == j_idx.dtype
    for cap in (1, 20, 1000):
        np.testing.assert_array_equal(tsched.traffic_from_topk(t_idx, 8, cap, 4),
                                      jsched.traffic_from_topk(j_idx, 8, cap, 4))


def test_round_inverse_and_edges_match():
    m = _matrices(5, seed=3)["zipf"]
    for t, j in zip(tsched.decompose(m), jsched.decompose(m)):
        assert (t.n_edges, t.inverse()) == (j.n_edges, j.inverse())


@pytest.mark.parametrize("algo,n_rounds", [("ep_sched", 5), ("ep_streams", None)])
def test_recorded_series_match(algo, n_rounds):
    m = _matrices(4, seed=11)["zipf"]

    def delta(mod):
        before = mod.ROUNDS_TOTAL.get(algo=algo)
        mod.record_decision(algo, 4, n_rounds=n_rounds, matrix=m)
        return mod.ROUNDS_TOTAL.get(algo=algo) - before, mod.SKEW_GAUGE.get()

    assert delta(tsched) == delta(jsched)


@pytest.mark.parametrize("bad", [np.ones((3, 4)), -np.ones((3, 3)), np.ones(3)])
def test_bad_matrices_raise_alike(bad):
    for mod in (tsched, jsched):
        with pytest.raises(ValueError):
            mod.decompose(bad)


def test_world_and_shape_errors_alike():
    for mod in (tsched, jsched):
        with pytest.raises(ValueError):
            mod.wire_schedule(np.ones((3, 3)), 4)
        with pytest.raises(ValueError):
            mod.traffic_from_topk(np.zeros((2, 4, 2), int), 8, 4, 4)
        with pytest.raises(ValueError):
            mod.traffic_from_topk(np.zeros((4, 4, 2), int), 6, 4, 4)
