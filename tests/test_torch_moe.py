"""uccl_tpu_torch.ep.ops against uccl_tpu.ep.ops at world 1 (CPU).

Routing decisions are compared as exact integers (top-k ids, slots,
token_for_slot, kept counts), with drops forced by a small capacity and gate
ties forced by integer-valued logits: ties must resolve to the lower expert
index, as lax.top_k does. moe_ffn values are compared at rtol 1e-5 /
atol 1e-6, the tolerance of tests/test_ep.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.ep import ops as jops
from uccl_tpu.utils.jaxcompat import shard_map
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
