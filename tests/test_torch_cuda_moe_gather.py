"""The sorted MoE layer's gather pair (uccl_tpu_torch/csrc/moe_gather.cu,
ep/gather.py) against its plain versions, on the card.

Every test here needs an NVIDIA Hopper GPU and ``nvcc``; without a GPU each
skips. This file imports neither jax nor the JAX package, so it runs alone,
past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_moe_gather.py

Tolerance. The dispatch copies rows, and the combine's sums, the dispatch's
backward and the combine's ``dy`` are the plain versions' float32 sums in
their order, each product and sum rounded once: all must equal the plain
versions bit for bit. Only ``dw``'s dot products sum in another order: each
within ``H * 2**-24 * sum |dout * y|`` of the plain one, the float32
accumulation's rounding.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from uccl_tpu_torch.ep import gather
from uccl_tpu_torch.ep import ops

pytestmark = pytest.mark.cuda

# (name, members, tokens, hidden, experts, capacity, choices, dtype): the
# benchmark's two cells' layers, then the unaligned and odd arms
SHAPES = [
    ("flagship", 1, 131072, 1024, 8, 40960, 2, torch.bfloat16),
    ("mixtral", 1, 4096, 4096, 8, 4096, 2, torch.bfloat16),
    ("members_f32", 2, 3000, 1024, 8, 800, 2, torch.float32),
    ("h_odd_bf16", 2, 777, 100, 4, 700, 3, torch.bfloat16),
    ("h_odd_f32", 3, 500, 37, 6, 90, 1, torch.float32),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _inputs(dev, w, t, h, e, c, k, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    topk = torch.randn((w, t, e), generator=g, device=dev).argsort(-1, descending=True)[..., :k]
    plan = ops.plan_slots(topk, e, c)
    x = torch.randn((w, t, h), generator=g, device=dev).to(dtype)
    y = torch.randn((w, e * c, h), generator=g, device=dev).to(dtype)
    wts = torch.rand((w, t, k), generator=g, device=dev)
    dout = torch.randn((w, t, h), generator=g, device=dev).to(dtype)
    return plan, x, y, wts, dout


def _dw_bound(dout, y, slot):
    """Per choice, H * 2**-24 * sum |dout * y|: the float32 dot product's
    rounding."""
    index, _ = gather._choices(slot, y.shape[1])
    mag = torch.stack([(dout.float().abs() * gather._rows_at(y, index[..., j]).float().abs())
                       .sum(-1) for j in range(slot.shape[-1])], -1)
    return y.shape[-1] * 2**-24 * mag


def _run_all(plan, x, y, wts, dout):
    return {"dispatch": gather.gather_rows(x, plan.token_for_slot),
            "dispatch_bwd": gather.gather_sum(y, plan.slot, role="dispatch_bwd"),
            "combine": gather.gather_sum(y, plan.slot, wts),
            "combine_bwd": gather.scatter_rows(dout, y, plan.slot, wts)}


def _plain_all(plan, x, y, wts, dout):
    return {"dispatch": gather.gather_rows_plain(x, plan.token_for_slot),
            "dispatch_bwd": gather.gather_sum_plain(y, plan.slot),
            "combine": gather.gather_sum_plain(y, plan.slot, wts),
            "combine_bwd": gather.scatter_rows_plain(dout, y, plan.slot, wts)}


@pytest.mark.parametrize("name,w,t,h,e,c,k,dtype", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernels_equal_plain(dev, name, w, t, h, e, c, k, dtype):
    plan, x, y, wts, dout = _inputs(dev, w, t, h, e, c, k, dtype, seed=len(name))
    assert (plan.token_for_slot == t).any()  # empty slots
    gather.reset_launch_counts()
    got = _run_all(plan, x, y, wts, dout)
    torch.cuda.synchronize()
    assert gather.launch_counts == {role: 1 for role in gather.ROLES}
    want = _plain_all(plan, x, y, wts, dout)
    for role in ("dispatch", "dispatch_bwd", "combine"):
        assert got[role].dtype == dtype and torch.equal(got[role], want[role]), role
    (dy, dw), (dy_p, dw_p) = got["combine_bwd"], want["combine_bwd"]
    assert dy.dtype == dtype and torch.equal(dy, dy_p)
    kept = plan.slot < e * c
    assert dw.dtype == torch.float32 and not dw[~kept].any()
    gap = (dw - dw_p).abs()
    assert bool((gap <= _dw_bound(dout, y, plan.slot)).all()), float(gap.max())


def test_dropped_choices_and_every_choice_dropped(dev):
    """Experts 0 and 1 take every token: past the capacity a token has both
    choices dropped, gets zeros back and no gradient; the empty slots of
    experts 2-7 read zeros and get zero gradient."""
    w, t, h, e, c, k = 2, 1000, 256, 8, 300, 2
    topk = torch.tensor([0, 1], device=dev).expand(w, t, k)
    plan = ops.plan_slots(topk, e, c)
    _, x, y, wts, dout = _inputs(dev, w, t, h, e, c, k, torch.bfloat16, seed=3)
    got = _run_all(plan, x, y, wts, dout)
    assert torch.equal(got["dispatch"], gather.gather_rows_plain(x, plan.token_for_slot))
    assert not got["dispatch"][:, 2 * c:].any() and not got["combine"][:, c:].any()
    assert not got["dispatch_bwd"][:, c:].any()
    dy, dw = got["combine_bwd"]
    assert not dy[:, 2 * c:].any() and not dw[:, c:].any() and dw[:, :c].all()


# Planted faults: a copy of the source with one slot read one off
FAULTS = {
    "dispatch_slot_shifted": [("const int t = token_for_slot[row];",
                               "const int t = token_for_slot[row + (row == 5)];")],
    "choice_slot_shifted": [("const int v = slot[row * k + lane];",
                             "const int v = slot[row * k + lane] + (row == 3 && lane == 0);")],
}


def test_planted_faults_fail_the_rule(dev, monkeypatch):
    from concurrent.futures import ThreadPoolExecutor

    from uccl_tpu_torch.utils import build

    with ThreadPoolExecutor(len(FAULTS)) as pool:
        libs = dict(zip(FAULTS, pool.map(
            lambda kv: build.build_variant("moe_gather", f"test_{kv[0]}", kv[1]),
            FAULTS.items())))
    w, t, h, e, c, k = 2, 4096, 1024, 8, 1280, 2
    plan, x, y, wts, dout = _inputs(dev, w, t, h, e, c, k, torch.bfloat16, seed=11)
    assert bool((plan.token_for_slot[:, :7] < t).all() and (plan.slot[:, 3, 0] < e * c).all())
    want = _plain_all(plan, x, y, wts, dout)
    caught = {}
    for fault in FAULTS:
        lib = gather.declare(ctypes.CDLL(str(libs[fault])))
        monkeypatch.setattr(gather, "_lib", lambda lib=lib: lib)
        got = _run_all(plan, x, y, wts, dout)
        torch.cuda.synchronize()
        caught[fault] = sorted(
            role for role in gather.ROLES
            if not (torch.equal(got[role][0], want[role][0]) if role == "combine_bwd"
                    else torch.equal(got[role], want[role])))
    assert caught == {"dispatch_slot_shifted": ["dispatch"],
                      "choice_slot_shifted": ["combine", "combine_bwd", "dispatch_bwd"]}


def test_autograd_pair_on_the_card(dev):
    """dispatch_rows and combine_rows through autograd: each kernel once,
    the gradients the plain versions'."""
    w, t, h, e, c, k = 2, 2048, 512, 8, 640, 2
    plan, x, y, wts, dout = _inputs(dev, w, t, h, e, c, k, torch.bfloat16, seed=5)
    gxe = torch.randn((w, e * c, h), device=dev).to(torch.bfloat16)
    leaves = [a.clone().requires_grad_() for a in (x, y, wts)]
    gather.reset_launch_counts()
    xe = gather.dispatch_rows(leaves[0], plan.token_for_slot, plan.slot)
    out = gather.combine_rows(leaves[1], plan.slot, leaves[2])
    dx, dy, dw = torch.autograd.grad((xe, out), leaves, (gxe, dout))
    torch.cuda.synchronize()
    assert gather.launch_counts == {role: 1 for role in gather.ROLES}
    assert torch.equal(dx, gather.gather_sum_plain(gxe, plan.slot))
    dy_p, dw_p = gather.scatter_rows_plain(dout, y, plan.slot, wts)
    assert torch.equal(dy, dy_p)
    assert bool(((dw - dw_p).abs() <= _dw_bound(dout, y, plan.slot)).all())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    plan, x, y, wts, dout = _inputs(dev, 1, 256, 64, 4, 128, 2, torch.bfloat16, seed=1)
    with pytest.raises(TypeError):
        gather.gather_rows(x.half(), plan.token_for_slot)
    with pytest.raises(ValueError):
        gather.gather_sum(y, plan.slot.cpu(), wts)
    with pytest.raises(ValueError):
        gather.scatter_rows(dout.float(), y, plan.slot, wts)


def test_flagship_step_runs_every_layer_through_the_pair(dev):
    """One train step at the flagship's widths (B 2 x S 1024), remat full:
    each MoE layer's dispatch and combine run forward, again in the
    recompute, and backward, all on the kernels."""
    from uccl_tpu_torch.models import flagship
    from uccl_tpu_torch.models.sampling import prng_key

    cfg = flagship.bench_config()
    assert cfg.remat == "full" and cfg.moe_impl == "sort"
    params = flagship.init_params(prng_key(0), cfg, dev)
    train_step, init_opt = flagship.make_train_step(cfg, dev)
    rng = np.random.default_rng(0)
    tokens, targets = (torch.tensor(rng.integers(0, cfg.vocab, (2, 1024)), device=dev)
                       for _ in range(2))
    gather.reset_launch_counts()
    _, _, metrics = train_step(params, init_opt(params), tokens, targets)
    assert np.isfinite(metrics["loss"].item())
    n = cfg.n_layers
    assert gather.launch_counts == {"dispatch": 2 * n, "dispatch_bwd": n, "combine": 2 * n,
                                    "combine_bwd": n}
    # the same step in float32 runs the f32 kernels
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    train_step, init_opt = flagship.make_train_step(cfg32, dev)
    gather.reset_launch_counts()
    _, _, metrics = train_step(params, init_opt(params), tokens[:1], targets[:1])
    assert np.isfinite(metrics["loss"].item()) and gather.launch_counts["combine_bwd"] == n
