"""The port's EP all-to-all (uccl_tpu_torch/ep/pallas_a2a.py) against the JAX
package's (uccl_tpu/ep/pallas_a2a.py).

The same seeded numpy inputs go through both. The JAX side runs as
tests/test_pallas_a2a.py runs it: a 1-axis mesh of the virtual CPU devices,
its Pallas kernels in the faithful TPU interpreter for a few tiny cases
(a few KiB per member), everything else on its "lax" wire, which that file
holds bit-identical to the kernels. The port's side runs on CPU tensors, so
its wrappers take the kernels' plain versions (the same steps and rounds on
the member-stacked tensor). Tolerance: none; an exchange moves bytes, so
every result must be bit-identical, for f32 and bf16, worlds 2-8, sizes
that need padding, chunked or not, scheduled or not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.ep import a2a_sched as jsched
from uccl_tpu.ep import pallas_a2a as jpa
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.collective import dma
from uccl_tpu_torch.ep import a2a_sched as tsched
from uccl_tpu_torch.ep import pallas_a2a as tpa

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype, seed):
    """The same values in both frameworks (bf16 rounded from f32 by both)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _jax(devices, n, fn, x):
    """``fn`` on each shard of member-stacked ``x`` over a 1-axis mesh."""
    mesh = Mesh(np.array(devices[:n]), ("ep",))
    mapped = shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=(P("ep"),),
                       out_specs=P("ep"), check_vma=False)
    return np.asarray(jax.jit(mapped)(x).astype(jnp.float32))


def _lax(v):
    return jax.lax.all_to_all(v, "ep", 0, 0, tiled=True)


def _eq(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.float().numpy(), want)


def _zipf_schedule(n, seed, mod=jsched):
    idx = mod.zipf_topk(np.random.default_rng(seed), n, 64, 2, 2 * n, alpha=1.2)
    return mod.wire_schedule(mod.traffic_from_topk(idx, 2 * n, 12, n), n)


# The kernels in the interpreter: tiny payloads (5 x 9 trailing, never an
# 8x128 multiple, so every chunk needs padding).
@pytest.mark.parametrize("n,dtype", [(2, "f32"), (4, "bf16"), (5, "f32")])
def test_all_to_all_matches_pallas_kernel(devices, n, dtype):
    xj, xt = _inputs((n, n, 5, 9), dtype, seed=n)
    want = _jax(devices, n, lambda v: jpa.all_to_all(v, "ep", interpret=True), xj)
    _eq(tpa.all_to_all(xt), want)


@pytest.mark.parametrize("n,kind", [(4, "uniform"), (4, "zipf"), (3, "zipf")])
def test_scheduled_matches_pallas_round_kernel(devices, n, kind):
    xj, xt = _inputs((n, n, 3, 7), "f32", seed=10 + n)
    if kind == "uniform":
        sched = jsched.wire_schedule(np.ones((n, n)) - np.eye(n), n)
    else:
        sched = _zipf_schedule(n, seed=n)
    want = _jax(devices, n, lambda v: jpa.scheduled_all_to_all(v, "ep", sched, interpret=True),
                xj)
    _eq(tpa.scheduled_all_to_all(xt, sched), want)


def test_chunked_matches_pallas_kernel(devices):
    n = 4
    xj, xt = _inputs((n, n, 2, 6, 5), "f32", seed=3)
    want = _jax(devices, n, lambda v: jpa.all_to_all(v, "ep", n_chunks=3, chunk_axis=2,
                                                     interpret=True), xj)
    _eq(tpa.all_to_all(xt, n_chunks=3, chunk_axis=2), want)


# Everything else against the lax wire.
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_all_to_all_matches_lax(devices, n, dtype):
    xj, xt = _inputs((n, n, 2, 7, 33), dtype, seed=20 + n)
    want = _jax(devices, n, _lax, xj)
    for n_chunks in (1, 2, 3):
        _eq(tpa.all_to_all(xt, n_chunks=n_chunks, chunk_axis=2), want)
    _eq(tpa.all_to_all(xt, n_chunks=2, chunk_axis=1), want)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_scheduled_matches_lax(devices, n, kind):
    xj, xt = _inputs((n, n, 2, 7, 33), "bf16" if n % 2 else "f32", seed=30 + n)
    want = _jax(devices, n, _lax, xj)
    if kind == "uniform":
        mat = np.ones((n, n)) - np.eye(n)
        sched = tsched.wire_schedule(mat, n)
        assert len(sched[0]) >= n - 1
    else:
        sched = _zipf_schedule(n, seed=n, mod=tsched)
    for n_chunks in (1, 2, 3):
        _eq(tpa.scheduled_all_to_all(xt, sched, n_chunks=n_chunks, chunk_axis=2), want)
    # Round objects or raw permutation tuples
    raw = ([r.perm for r in sched[0]], sched[1])
    _eq(tpa.scheduled_all_to_all(xt, raw), want)


@pytest.mark.parametrize("n", [2, 4, 5, 16])
def test_plain_versions_are_the_transpose(n):
    """a2a_plain's steps, and sched_round_plain's rounds into one
    sentinel-filled receive buffer, on 1-byte payloads too, land every chunk
    where the transpose puts it. Round by round, each slot is written once,
    in its designated round (round 0 for the diagonal); a shadow duplicate
    (a pair an earlier round carries) leaves its slot untouched."""
    g = torch.Generator().manual_seed(n)
    sentinel = 255
    view = torch.randint(0, sentinel, (n, n, 3, 128), generator=g, dtype=torch.uint8)
    assert torch.equal(tpa.a2a_plain(view), view.transpose(0, 1))
    shadows = 0
    for sched in (tsched.wire_schedule(np.ones((n, n)) - np.eye(n), n),
                  _zipf_schedule(n, seed=n, mod=tsched)):
        rounds, k_mat = sched
        perms = [r.perm for r in rounds]
        out = torch.full_like(view, sentinel)
        written = np.full((n, n), -1)  # [receiver, source] -> the round that wrote it
        for k, pi in enumerate(perms):
            before = out.clone()
            send, local = tpa.round_bits(perms, k_mat, k)
            assert tpa.sched_round_plain(view, out, pi, send, local) is out
            changed = (out != before).flatten(2).any(-1).numpy()
            for d, s in zip(*np.nonzero(changed)):
                assert written[d, s] == -1, f"slot ({d}, {s}) written twice"
                written[d, s] = k
            for s, d in enumerate(pi):
                if s != d and k_mat[s][d] != k:  # a shadow duplicate
                    shadows += 1
                    assert torch.equal(out[d, s], before[d, s])
        assert torch.equal(out, view.transpose(0, 1))
        want = np.array(k_mat).T.copy()  # slot (d, s) in round K[s, d]
        np.fill_diagonal(want, 0)
        np.testing.assert_array_equal(written, want)
    assert shadows > 0 or n == 2


def test_fp8_payload_moves_its_bytes():
    x = torch.randn(4, 4, 3, 128).to(torch.float8_e4m3fn)
    got = tpa.all_to_all(x, n_chunks=2, chunk_axis=1)
    assert got.dtype == x.dtype
    assert torch.equal(got.view(torch.uint8), x.view(torch.uint8).transpose(0, 1))
    sched = tsched.wire_schedule(np.ones((4, 4)), 4)
    assert torch.equal(tpa.scheduled_all_to_all(x, sched).view(torch.uint8),
                       x.view(torch.uint8).transpose(0, 1))


def test_world1_identity_and_shape_errors():
    x = torch.randn(1, 1, 4, 4)
    assert tpa.all_to_all(x) is x
    assert tpa.scheduled_all_to_all(x, ([], np.zeros((1, 1)))) is x
    with pytest.raises(ValueError, match="leading dim"):
        tpa.all_to_all(torch.randn(4, 3, 8))
    with pytest.raises(ValueError, match="leading dim"):
        tpa.scheduled_all_to_all(torch.randn(4, 5, 8), tsched.wire_schedule(np.ones((4, 4)), 4))
    with pytest.raises(ValueError, match="chunk_axis 0"):
        tpa.all_to_all(torch.randn(4, 4, 8), n_chunks=2, chunk_axis=0)
    with pytest.raises(ValueError, match="chunk_axis 0"):
        tpa.scheduled_all_to_all(torch.randn(4, 4, 8), tsched.wire_schedule(np.ones((4, 4)), 4),
                                 n_chunks=2, chunk_axis=0)


def _bad_schedules(n=4):
    rounds, k_mat = jsched.wire_schedule(np.ones((n, n)) - np.eye(n), n)
    perms = [r.perm for r in rounds]
    wrong_k = k_mat.copy()
    wrong_k[0, 1] = (wrong_k[0, 1] + 1) % len(perms)
    return {
        "not a permutation": ([(0, 0, 1, 2)] + perms[1:], k_mat),
        "K of the wrong shape": (perms, k_mat[:3]),
        "K names a missing round": (perms, k_mat + len(perms)),
        "K names a round without the pair": (perms, wrong_k),
        "no rounds": ([], k_mat),
    }


@pytest.mark.parametrize("case", list(_bad_schedules()))
def test_bad_schedules_raise_as_in_jax(devices, case):
    sched = _bad_schedules()[case]
    with pytest.raises(ValueError):
        tpa.scheduled_all_to_all(torch.randn(4, 4, 8), sched)
    if sched[0]:  # the JAX validator, on its own (no round runs)
        with pytest.raises(ValueError):
            jpa._normalize_schedule(sched, 4)


def _fallbacks(what):
    return dma.WIRE_FALLBACK.get(what=what, reason="arena_budget")


def test_cpu_budget_fallbacks_are_counted(devices):
    """Past the arena budget a CPU payload takes the stock wire (or the
    unchunked exchange, or the unscheduled one), with the same bits, each
    downgrade counted."""
    n = 4
    xj, xt = _inputs((n, n, 4, 256), "f32", seed=5)
    want = _jax(devices, n, _lax, xj)
    sched = tsched.wire_schedule(np.ones((n, n)), n)
    before = {w: _fallbacks(w) for w in ("ep_all_to_all", "ep_all_to_all_chunked",
                                         "ep_a2a_sched", "ep_a2a_sched_chunked")}
    # per member: 4 chunks of m = 1024 f32 -> the exchange charges 2*4*1024*4
    # = 32768 B, a schedule 2*5*1024*4 = 40960 B, a 2-chunk pipeline (512
    # elements per peer, padded to 1024) 2 x 2*4*1024*4 = 65536 B
    dma.MAX_ARENA_BYTES.set(30000)
    try:
        _eq(tpa.all_to_all(xt), want)
        _eq(tpa.all_to_all(xt, n_chunks=2, chunk_axis=1), want)
        _eq(tpa.scheduled_all_to_all(xt, sched), want)
        _eq(tpa.scheduled_all_to_all(xt, sched, n_chunks=2, chunk_axis=1), want)
    finally:
        dma.MAX_ARENA_BYTES.set(None)
    after = {w: _fallbacks(w) - before[w] for w in before}
    # the unscheduled fallback of each schedule, and the unchunked fallback of
    # each pipeline, each fall back once more to the stock wire
    assert after == {"ep_all_to_all": 4, "ep_all_to_all_chunked": 1, "ep_a2a_sched": 2,
                     "ep_a2a_sched_chunked": 1}
    dma.MAX_ARENA_BYTES.set(50000)  # the exchange and the schedule fit, 2 chunks do not
    try:
        base = _fallbacks("ep_all_to_all")
        _eq(tpa.all_to_all(xt, n_chunks=2, chunk_axis=1), want)
        _eq(tpa.scheduled_all_to_all(xt, sched), want)
        assert _fallbacks("ep_all_to_all") == base
    finally:
        dma.MAX_ARENA_BYTES.set(None)
