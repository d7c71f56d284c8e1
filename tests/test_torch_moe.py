"""uccl_tpu_torch.ep.ops against uccl_tpu.ep.ops at world 1 (CPU).

Routing decisions are compared as exact integers (top-k ids, slots,
token_for_slot, kept counts), with drops forced by a small capacity and gate
ties forced by integer-valued logits: ties must resolve to the lower expert
index, as lax.top_k does. moe_ffn values are compared at rtol 1e-5 /
atol 1e-6, the tolerance of tests/test_ep.py.

The sorted path's gather pair (ep/gather.py: dispatch_rows, combine_rows)
is held, forward and backward, to the padded-take path it replaced
(_take_member_rows, _weighted_sum) and to the dense one-hot oracle, and in
float32 to jax.vjp of the JAX package's dispatch_sorted and combine_sorted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.ep import ops as jops
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.ep import gather as tgather
from uccl_tpu_torch.ep import ops as tops

T, E, K, H, F = 48, 8, 2, 16, 24


def _logits(rng, ties: bool):
    if ties:
        # few distinct values per row: many exactly equal gates
        return rng.integers(0, 3, (T, E)).astype(np.float32)
    return rng.standard_normal((T, E)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "forced_ties"])
def test_gate_topk_matches_as_integers(rng, ties):
    logits = _logits(rng, ties)
    jv, ji, ja, jz = jops._gate_topk(jnp.asarray(logits), K, True)
    tv, ti, ta, tz = tops._gate_topk(torch.tensor(logits), K, True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    np.testing.assert_allclose(tz.item(), float(jz), rtol=1e-6)


def test_forced_ties_pick_the_lower_index():
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    _, idx = tops.topk_stable(gates, 2)
    assert idx.tolist() == [[0, 1], [1, 3]]


@pytest.mark.parametrize("capacity", [1, 3, 7, 64])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "forced_ties"])
def test_slots_and_masks_match_as_integers(rng, capacity, ties):
    logits = _logits(rng, ties)
    _, idx, _, _ = jops._gate_topk(jnp.asarray(logits), K, True)
    wts = rng.random((T, K)).astype(np.float32)
    j_tfs, j_slot, j_kept = jops.sorted_from_topk(idx, E, capacity)
    t_tfs, t_slot, t_kept = tops.sorted_from_topk(torch.tensor(np.asarray(idx)), E, capacity)
    np.testing.assert_array_equal(t_tfs.numpy(), np.asarray(j_tfs))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(j_kept))

    j_d, j_c, j_n = jops.masks_from_topk(idx, jnp.asarray(wts), E, capacity)
    t_d, t_c, t_n = tops.masks_from_topk(torch.tensor(np.asarray(idx)), torch.tensor(wts),
                                         E, capacity)
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
    np.testing.assert_array_equal(t_c.numpy(), np.asarray(j_c))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    if capacity < T * K // E:
        assert int(t_kept.sum()) < T * K  # drops happened


def _moe_inputs(rng, ties=False):
    return (
        rng.standard_normal((T, H)).astype(np.float32),
        _logits(rng, ties),
        (rng.standard_normal((E, H, F)) / np.sqrt(H)).astype(np.float32),
        (rng.standard_normal((E, H, F)) / np.sqrt(H)).astype(np.float32),
        (rng.standard_normal((E, F, H)) / np.sqrt(F)).astype(np.float32),
    )


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
def test_sort_and_dense_agree(rng, capacity_factor):
    """Same routing decision exactly (the dense mask is the sorted plan's
    slots, drops included); outputs equal up to summation order, at
    tests/test_ep.py's rtol 1e-5 / atol 1e-6."""
    args = [torch.tensor(a) for a in _moe_inputs(rng, ties=True)]
    cap = max(1, int(capacity_factor * T * K / E))
    rs = tops.route_topk_sorted(args[1], K, cap)
    r = tops.route_topk(args[1], K, cap)
    from_slots = torch.zeros(T, E * cap + 1, dtype=torch.bool)
    from_slots.scatter_(1, rs.slot.long(), True)
    np.testing.assert_array_equal(from_slots[:, :-1].reshape(T, E, cap).numpy(),
                                  r.dispatch_mask.numpy())
    np.testing.assert_array_equal(rs.counts.numpy(), r.counts.numpy())
    out_s, aux_s, z_s = tops.moe_ffn(*args, num_selected=K,
                                     capacity_factor=capacity_factor, impl="sort")
    out_d, aux_d, z_d = tops.moe_ffn(*args, num_selected=K,
                                     capacity_factor=capacity_factor, impl="dense")
    np.testing.assert_allclose(out_s.numpy(), out_d.numpy(), rtol=1e-5, atol=1e-6)
    assert aux_s.item() == aux_d.item() and z_s.item() == z_d.item()


@pytest.mark.parametrize("impl", ["sort", "dense"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_ffn_matches_jax(rng, impl, capacity_factor):
    x, logits, wg, wu, wd = _moe_inputs(rng)
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))
    jfn = shard_map(
        lambda *a: jops.moe_ffn(*a, "ep", num_selected=K, capacity_factor=capacity_factor,
                                impl=impl),
        mesh=mesh, in_specs=(P(),) * 5, out_specs=(P(), P(), P()), check_vma=False,
    )
    j_out, j_aux, j_z = jfn(*map(jnp.asarray, (x, logits, wg, wu, wd)))
    t_out, t_aux, t_z = tops.moe_ffn(*map(torch.tensor, (x, logits, wg, wu, wd)),
                                     num_selected=K, capacity_factor=capacity_factor,
                                     impl=impl)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_aux.item(), float(j_aux), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_z.item(), float(j_z), rtol=1e-5, atol=1e-6)


def test_moe_ffn_grads_sort_equal_dense(rng):
    def grads(impl):
        leaves = [torch.tensor(a, requires_grad=True) for a in _moe_inputs(
            np.random.default_rng(3))]
        out, aux, z = tops.moe_ffn(*leaves, num_selected=K, capacity_factor=1.0, impl=impl)
        return torch.autograd.grad((out ** 2).sum() + aux + z, leaves)

    for gs, gd in zip(grads("sort"), grads("dense")):
        np.testing.assert_allclose(gs.numpy(), gd.numpy(), rtol=1e-5, atol=1e-6)


def test_slot_plan_drives_dispatch_and_combine(rng):
    x = torch.tensor(rng.standard_normal((T, H)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, E, (T, K)))
    plan = tops.plan_slots(idx, E, 4)
    xe = tops.dispatch_sorted(x, plan, E, 4)
    assert xe.shape == (E, 4, H)
    back = tops.combine_sorted(xe, plan, torch.ones(T, K))
    # each kept assignment returns its own token; a dropped one returns zeros
    kept = (plan.slot < E * 4).float().sum(1, keepdim=True)
    np.testing.assert_allclose(back.numpy(), (x * kept).numpy(), rtol=1e-6, atol=1e-6)


def test_unported_impl_raises():
    """An unknown impl raises; "ll" (ep/ll.py) is ported and runs at world 1
    (tests/test_torch_ep_buffer.py holds it against the JAX package)."""
    args = [torch.zeros(4, 8), torch.zeros(4, 2), torch.zeros(2, 8, 4),
            torch.zeros(2, 8, 4), torch.zeros(2, 4, 8)]
    out, aux, z = tops.moe_ffn(*args, impl="ll")
    assert out.shape == (4, 8) and aux.shape == z.shape == ()
    with pytest.raises(ValueError):
        tops.moe_ffn(*args, impl="bogus")


# (routing, capacity factor): "random" routes by random logits; "balanced"
# gives every expert exactly C choices (no drop, no empty slot); "hot" sends
# every token to experts 0 and 1, so every token past the capacity has each
# of its choices dropped
PAIR_CASES = [("random", 1.0), ("random", 1.25), ("random", E / K), ("balanced", 1.0),
              ("hot", 1.0)]
# f32: the paths differ in summation order only (dw's dot products); bf16
# rows: the replaced path rounds the weights, the sums and the weights'
# gradient to bf16, the pair each result once (worst gap 5.2e-3)
PAIR_TOL = {torch.float32: dict(rtol=2e-6, atol=2e-6),
            torch.bfloat16: dict(rtol=2**-7, atol=2**-7)}


def _pair_routing(rng, routing, w):
    """Each member's top-k expert ids [T, K]."""
    def one():
        if routing == "balanced":
            return np.stack([np.arange(T) % E, (np.arange(T) + E // 2) % E], -1)
        if routing == "hot":
            return np.tile([0, 1], (T, 1))
        return np.argsort(-rng.standard_normal((T, E)), -1, kind="stable")[:, :K]

    return [torch.tensor(one()) for _ in range(w)]


def _pair_run(impl, x, y, wts, idx, cap, gx, gout):
    """(dispatched rows [W, E*C, H], combined [W, T, H], dx, dy, dw) of one
    dispatch of x and one combine of y, through ``impl``."""
    x, y, wts = (t.detach().clone().requires_grad_() for t in (x, y, wts))
    plan = tops.plan_slots(torch.stack(idx), E, cap)
    if impl == "pair":
        xe = tgather.dispatch_rows(x, plan.token_for_slot, plan.slot)
        out = tgather.combine_rows(y, plan.slot, wts)
    elif impl == "take":
        xe = tops._take_member_rows(x, plan.token_for_slot)
        out = tops._weighted_sum(wts, tops._take_member_rows(y, plan.slot))
    else:  # the dense one-hot oracle, member by member
        masks = [tops.masks_from_topk(i, wt, E, cap) for i, wt in zip(idx, wts)]
        xe = torch.stack([tops.dispatch(xr, d) for xr, (d, _, _) in zip(x, masks)])
        out = torch.stack([tops.combine(yr.reshape(E, cap, H), c)
                           for yr, (_, c, _) in zip(y, masks)])
        xe = xe.reshape(len(idx), E * cap, H)
    loss = (xe.float() * gx).sum() + (out.float() * gout).sum()
    return (xe.detach(), out.detach(), *torch.autograd.grad(loss, (x, y, wts)))


def _pair_case(rng, routing, capacity_factor, w, dtype):
    """(capacity, ids, plan, x, y, weights, gx, gout) of one case, after
    checking that its routing drops and empties what the case names."""
    cap = max(1, int(capacity_factor * T * K / E))
    idx = _pair_routing(rng, routing, w)
    plan = tops.plan_slots(torch.stack(idx), E, cap)
    dropped = (plan.slot == E * cap).sum(-1)  # [W, T] choices dropped a token
    empty = int((plan.token_for_slot == T).sum())
    assert {("random", 1.0): dropped.sum() > 0 and empty > 0,
            ("random", 1.25): empty > 0,
            ("random", E / K): dropped.sum() == 0 and empty > 0,
            ("balanced", 1.0): dropped.sum() == 0 and empty == 0,
            ("hot", 1.0): bool((dropped == K).any())}[(routing, capacity_factor)]
    x = torch.tensor(rng.standard_normal((w, T, H)), dtype=dtype)
    y = torch.tensor(rng.standard_normal((w, E * cap, H)), dtype=dtype)
    wts = torch.tensor(rng.random((w, T, K)), dtype=torch.float32)
    gx = torch.tensor(rng.standard_normal((w, E * cap, H)), dtype=torch.float32)
    gout = torch.tensor(rng.standard_normal((w, T, H)), dtype=torch.float32)
    return cap, idx, plan, x, y, wts, gx, gout


_PAIR_IDS = [f"{r}-{c:g}" for r, c in PAIR_CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("routing,capacity_factor", PAIR_CASES, ids=_PAIR_IDS)
def test_gather_pair_matches_take_and_dense(rng, routing, capacity_factor, w, dtype):
    cap, idx, plan, x, y, wts, gx, gout = _pair_case(rng, routing, capacity_factor, w, dtype)
    dropped = (plan.slot == E * cap).sum(-1)
    tgather.reset_launch_counts()
    pair = _pair_run("pair", x, y, wts, idx, cap, gx, gout)
    assert set(tgather.launch_counts.values()) == {0}  # CPU tensors run the plain versions
    take = _pair_run("take", x, y, wts, idx, cap, gx, gout)
    dense = _pair_run("dense", x, y, wts, idx, cap, gx, gout)
    assert pair[0].dtype == pair[1].dtype == pair[2].dtype == pair[3].dtype == dtype
    assert pair[4].dtype == torch.float32
    assert torch.equal(pair[0], take[0])  # the dispatch copies rows: the same bits
    np.testing.assert_array_equal(pair[0].float().numpy(), dense[0].float().numpy())
    for name, got, *want in zip(("xe", "out", "dx", "dy", "dw"), pair, take, dense):
        for ref in want:
            np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                       err_msg=name, **PAIR_TOL[dtype])
    # a token whose every choice is dropped gets no row back and no gradient
    for r, t in (dropped == K).nonzero().tolist():
        assert not pair[1][r, t].any() and not pair[2][r, t].any() and not pair[4][r, t].any()


def _jax_sorted_vjp(x, y, wts, idx, cap, gx, gout):
    """(xe [E*C, H], out [T, H], dx, dy [E*C, H], dw) of the JAX package's
    dispatch_sorted and combine_sorted at world 1, on its own slot plan,
    with the cotangents gx and gout (jax.vjp inside the shard_map)."""
    tfs, slot, _ = jops.sorted_from_topk(jnp.asarray(idx.numpy()), E, cap)

    def body(x, y, wts, gx, gout):
        xe, d_vjp = jax.vjp(lambda x: jops.dispatch_sorted(x, tfs, E, cap, "ep"), x)
        out, c_vjp = jax.vjp(lambda y, w: jops.combine_sorted(y, slot, w, "ep"), y, wts)
        (dx,) = d_vjp(gx.reshape(xe.shape))
        dy, dw = c_vjp(gout)
        return xe.reshape(E * cap, H), out, dx, dy.reshape(E * cap, H), dw

    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))
    fn = shard_map(body, mesh=mesh, in_specs=(P(),) * 5, out_specs=(P(),) * 5,
                   check_vma=False)
    return fn(*(jnp.asarray(a.numpy()) for a in (x, y.reshape(E, cap, H), wts, gx, gout)))


@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("routing,capacity_factor", PAIR_CASES, ids=_PAIR_IDS)
def test_gather_pair_matches_jax_vjp(rng, routing, capacity_factor, w):
    """float32: the pair's forward and (dx, dy, dw) against jax.vjp of the
    JAX package's sorted dispatch and combine, member by member; the
    dispatch and dy copy or scale rows, so they match bit for bit."""
    cap, idx, _, x, y, wts, gx, gout = _pair_case(rng, routing, capacity_factor, w,
                                                  torch.float32)
    pair = _pair_run("pair", x, y, wts, idx, cap, gx, gout)
    for r in range(w):
        want = _jax_sorted_vjp(x[r], y[r], wts[r], idx[r], cap, gx[r], gout[r])
        for name, got, ref in zip(("xe", "out", "dx", "dy", "dw"), pair, want):
            if name in ("xe", "dy"):
                np.testing.assert_array_equal(got[r].numpy(), np.asarray(ref), err_msg=name)
            np.testing.assert_allclose(got[r].numpy(), np.asarray(ref), err_msg=name,
                                       **PAIR_TOL[torch.float32])


def _graph_names(t: torch.Tensor):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("axis", [None, "ep"], ids=["world1", "member_stacked"])
def test_sort_backward_graph_has_no_index_node(rng, axis):
    """moe_ffn(impl="sort")'s backward runs the gather pair's two nodes and
    no IndexBackward / index_put node (no accumulating scatter); the dense
    oracle is unchanged."""
    leaves = [torch.tensor(a, requires_grad=True) for a in _moe_inputs(rng)]
    if axis is not None:  # a world of 2 members, 4 experts each
        leaves = [torch.stack([a.detach(), a.detach().flip(0)]).requires_grad_()
                  for a in leaves[:2]] + [a.detach().reshape(2, E // 2, *a.shape[1:])
                                          .requires_grad_() for a in leaves[2:]]
    out, aux, z = tops.moe_ffn(*leaves, axis, num_selected=K, capacity_factor=1.0,
                               impl="sort")
    names = _graph_names(out.sum() + aux.sum() + z.sum())
    assert {"_DispatchRowsBackward", "_CombineRowsBackward"} <= names
    assert not [n for n in names if "Index" in n], sorted(names)
