"""Pipeline parallelism over the ``pp`` axis: GPipe and the manual 1F1B.

Port of ``uccl_tpu/parallel/pipeline.py``. The JAX functions run per shard
inside ``shard_map``; a stage's identity comes from ``lax.axis_index`` and
activations hop stages by ``lax.ppermute``. Here they run on tensors
member-stacked over the pipeline axis: dim 0 of every activation, stage
parameter and per-stage scalar is the stage (any other dims, such as the
rest of a member grid, ride along). Every stage runs each slot of the
schedule in the same call on its own row, so a slot is one program over all
stages, with the schedule's tables choosing what each stage keeps (the
select-not-branch form JAX's ``uniform`` mode uses); the hand-off is
``collective/ops.ppermute`` on dim 0.

Not ported yet: ``interleaved_1f1b`` and ``_simulate_interleaved`` (virtual
pipeline chunks; nothing in the package calls them).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from uccl_tpu_torch.collective import ops as cops
from uccl_tpu_torch.collective.plan import tree_broadcast
from uccl_tpu_torch.parallel.sharding import tree_map
from uccl_tpu_torch.utils.topology import ppermute_pairs


def _per_stage(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [P] mask shaped to broadcast against a stage-stacked tensor."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def gpipe_spmd(
    stage_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    xmb: torch.Tensor,
    axis: str = "pp",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run microbatches through the pipeline stages.

    Args:
      stage_fn: ``x -> (y, aux)`` on all stages at once: x/y ``[P, B_mb,
        ...]`` (row s is stage s's microbatch, the same shape in and out),
        aux ``[P, ...]`` a per-stage side loss, summed over valid
        microbatches.
      xmb: ``[P, M, B_mb, ...]`` the microbatched stage-0 input stream,
        member-stacked over the pipeline axis (only row 0 is read).

    Returns (out ``[P, M, B_mb, ...]``, the last stage's outputs on every
    stage; aux ``[P, ...]`` summed over stages and microbatches, on every
    stage).

    Schedule: at step t stage s works on microbatch t - s (valid when 0 <=
    t - s < M); M + P - 1 steps; every stage runs every step (on zeros
    before its first microbatch arrives), and validity masks what it keeps.
    """
    p, m = xmb.shape[:2]
    if p == 1:  # one stage: every step's microbatch is valid, nothing hops
        outs, aux = [], None
        for t in range(m):
            y, aux_step = stage_fn(xmb[:, t])
            outs.append(y[:, None])
            aux = aux_step if aux is None else aux + aux_step
        return (outs[0] if m == 1 else torch.cat(outs, dim=1)), aux
    stage = torch.arange(p, device=xmb.device)
    perm = ppermute_pairs(p, 1)
    xbuf = torch.zeros_like(xmb[:, 0])
    outs, aux = [None] * m, None
    for t in range(m + p - 1):
        fresh = xmb[:, min(t, m - 1)]
        x_in = torch.cat([fresh[:1], xbuf[1:]])
        y, aux_step = stage_fn(x_in)
        valid = (t - stage >= 0) & (t - stage < m)
        aux_step = torch.where(_per_stage(valid, aux_step), aux_step, torch.zeros_like(aux_step))
        aux = aux_step if aux is None else aux + aux_step
        if t - (p - 1) >= 0:  # the last stage finished microbatch t - (P-1)
            outs[t - (p - 1)] = y
        xbuf = cops.ppermute(y, perm)
    outbuf = torch.stack(outs, dim=1)
    # the last stage's outputs to every stage (a binomial tree), so the loss
    # code downstream is the same program on every stage
    return tree_broadcast(outbuf, root=p - 1), cops.all_reduce(aux, "sum")


# ---------------------------------------------------------------------------
# 1F1B (manual schedule): bounded-activation pipeline training


def _simulate_1f1b(m: int, p: int):
    """Slot-synchronous 1F1B schedule. Returns four [T, P] int tables:
    (do_fwd, fwd_mb, do_bwd, bwd_mb) — what stage s runs at slot t.

    Policy per stage: run a backward as soon as a cotangent is available;
    otherwise run the next forward if its input is available. Capping
    in-flight forwards at (P - s) yields the classic 1F1B memory profile.
    """
    fwd_done = [0] * p
    bwd_done = [0] * p
    # activation availability: arrival_slot of mb f at stage s
    ready_f = [[0 if s == 0 else None for _ in range(m)] for s in range(p)]
    ready_b = [[0 if s == p - 1 else None for _ in range(m)] for s in range(p)]
    rows = []
    t = 0
    while any(bwd_done[s] < m for s in range(p)) and t < 4 * (m + p):
        row = []
        for s in range(p):
            do_f, f_mb, do_b, b_mb = 0, 0, 0, 0
            inflight = fwd_done[s] - bwd_done[s]
            b = bwd_done[s]
            f = fwd_done[s]
            can_b = (
                b < m
                and b < fwd_done[s]  # its own fwd must have run
                and ready_b[s][b] is not None
                and ready_b[s][b] <= t
            )
            can_f = (
                f < m
                and ready_f[s][f] is not None
                and ready_f[s][f] <= t
                and inflight < min(m, p - s)  # 1F1B in-flight cap
            )
            if can_b:
                do_b, b_mb = 1, b
                bwd_done[s] += 1
            elif can_f:
                do_f, f_mb = 1, f
                fwd_done[s] += 1
            row.append((do_f, f_mb, do_b, b_mb))
        # propagate availability for slot t+1
        for s in range(p):
            do_f, f_mb, do_b, b_mb = row[s]
            if do_f and s + 1 < p:
                ready_f[s + 1][f_mb] = t + 1
            if do_b and s - 1 >= 0:
                ready_b[s - 1][b_mb] = t + 1
        rows.append(row)
        t += 1
    if any(bwd_done[s] < m for s in range(p)):
        raise RuntimeError(f"1F1B schedule did not converge (m={m}, p={p})")
    tab = np.asarray(rows, np.int32)  # [T, P, 4]
    return tab[..., 0], tab[..., 1], tab[..., 2], tab[..., 3]


def pipeline_train(
    stage_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
    loss_fn: Callable[..., torch.Tensor],
    params,
    loss_params,
    xmb: torch.Tensor,
    ymb,
    axis: str = "pp",
    aux_weight: float = 1.0,
    uniform: bool = False,
):
    """Manual 1F1B training step with boundary gradients.

    Args:
      stage_fn: ``(stage_params, x) -> (y, aux)`` on all stages at once:
        ``x``/``y`` ``[P, B_mb, ...]``, ``aux`` ``[P, ...]`` a per-stage
        side loss.
      loss_fn: ``(loss_params, y, target) -> [1, ...]`` per-member loss on
        the last stage's outputs (called with each argument's last-stage row
        ``[P-1:]``), summed over microbatches.
      params: the stage parameter pytree, stage-stacked ``[P, ...]``.
      loss_params: the loss-side parameters, stage-stacked (final norm,
        unembedding, ...); differentiated where the last stage computes the
        loss.
      xmb: ``[P, M, B_mb, ...]`` microbatches (row 0 is consumed).
      ymb: per-microbatch loss targets, a pytree of ``[P, M, ...]``.
      aux_weight: weight of the summed aux losses in the total.
      uniform: run the stage in every slot. Otherwise a slot in which no
        stage runs a forward (a backward) skips it; a slot that runs any
        runs all stages and masks, so the results are the same either way
        (in JAX the flag decides whether each member branches on its own).

    Every member's loss and aux are seeded with 1 and ``aux_weight``, as the
    JAX vjps are. Returns ``(total, loss, dparams, d_loss_params, d_xmb)``:
    total and loss ``[P, ...]`` (loss + aux_weight * sum(aux), and the loss
    alone; the same on every stage), dparams stage-stacked, d_loss_params
    and d_xmb ``[P, M, ...]`` the same on every stage.
    """
    p, m = xmb.shape[:2]
    slots, qslots = min(m, p), min(m, p + 1)
    do_f_t, f_mb_t, do_b_t, b_mb_t = _simulate_1f1b(m, p)
    n_slots = do_f_t.shape[0]
    arr_t = np.zeros_like(do_f_t)
    arr_t[1:, 1:] = do_f_t[:-1, :-1]
    arr_idx_t = np.zeros_like(do_f_t)
    arr_idx_t[1:] = np.cumsum(arr_t, axis=0)[:-1]
    dev = xmb.device
    fwd_perm, bwd_perm = ppermute_pairs(p, 1), ppermute_pairs(p, -1)
    # this step's own leaves: the gradients are taken against them
    leaves = [a.detach().requires_grad_() for a in _leaves(params)]
    params = _unflatten(params, leaves)
    last = slice(p - 1, p)
    lp_leaves = [a.detach()[last].requires_grad_() for a in _leaves(loss_params)]
    lp_last = _unflatten(loss_params, lp_leaves)

    mb_shape = tuple(xmb.shape[2:])
    stash = xmb.new_zeros((p, slots) + mb_shape)
    queue = xmb.new_zeros((p, qslots) + mb_shape)
    fwd_in = bwd_in = xmb.new_zeros((p,) + mb_shape)
    dparams = [torch.zeros_like(a) for a in leaves]
    dlp = [torch.zeros_like(a) for a in lp_leaves]
    dx_buf = torch.zeros_like(xmb[0])
    loss_acc = aux_acc = None

    def mask(row) -> torch.Tensor:
        return torch.as_tensor(row == 1, device=dev)

    for t in range(n_slots):
        for s in range(p):  # bank the activation that arrived from stage s-1
            if arr_t[t, s]:
                queue[s, arr_idx_t[t, s] % qslots] = fwd_in[s]

        y_out = xmb.new_zeros((p,) + mb_shape)
        if uniform or do_f_t[t].any():
            with torch.no_grad():
                x = torch.stack([xmb[0, f_mb_t[t, 0]] if s == 0
                                 else queue[s, f_mb_t[t, s] % qslots] for s in range(p)])
                y, aux = stage_fn(params, x)
                on = mask(do_f_t[t])
                y_out = torch.where(_per_stage(on, y), y, torch.zeros_like(y))
                aux = torch.where(_per_stage(on, aux), aux.float(),
                                  torch.zeros_like(aux, dtype=torch.float32))
            aux_acc = aux if aux_acc is None else aux_acc + aux
            for s in range(p):
                if do_f_t[t, s]:
                    stash[s, f_mb_t[t, s] % slots] = x[s]

        dx_out = xmb.new_zeros((p,) + mb_shape)
        if uniform or do_b_t[t].any():
            x = torch.stack([stash[s, b_mb_t[t, s] % slots] for s in range(p)]).requires_grad_()
            tgt = tree_map(lambda a: a[p - 1, b_mb_t[t, p - 1]][None], ymb)
            with torch.enable_grad():
                y, aux = stage_fn(params, x)
                # the loss head only where it is real: the last stage
                y_last = y[last].detach().requires_grad_()
                lval = loss_fn(lp_last, y_last, tgt).float()
                g = torch.autograd.grad(lval, [y_last] + lp_leaves, torch.ones_like(lval),
                                        allow_unused=True)
                gy = torch.cat([bwd_in[:p - 1].to(y.dtype), g[0].to(y.dtype)])
                outs = [(y, gy), (aux, torch.full_like(aux, aux_weight))]
                outs = [(o, c) for o, c in outs if o.requires_grad]  # an aux may be constant
                grads = torch.autograd.grad([o for o, _ in outs], leaves + [x],
                                            [c for _, c in outs], allow_unused=True)
            on = mask(do_b_t[t])
            with torch.no_grad():
                for i, ga in enumerate(grads[:-1]):
                    if ga is not None:
                        dparams[i] = dparams[i] + torch.where(_per_stage(on, ga), ga,
                                                              torch.zeros_like(ga))
                dx_out = torch.where(_per_stage(on, grads[-1]), grads[-1],
                                     torch.zeros_like(grads[-1])).detach()
                if do_b_t[t, p - 1]:
                    for i, gl in enumerate(g[1:]):
                        if gl is not None:
                            dlp[i] = dlp[i] + gl
                    lval = lval.detach()
                    loss_acc = lval if loss_acc is None else loss_acc + lval
            if do_b_t[t, 0]:  # stage 0's dx is the cotangent of xmb[b_mb]
                dx_buf[b_mb_t[t, 0]] = dx_out[0]

        if p > 1:
            fwd_in = cops.ppermute(y_out, fwd_perm)
            bwd_in = cops.ppermute(dx_out, bwd_perm)

    def on_every_stage(v):  # the psum over pp of [1, ...] only one stage holds
        return v.expand((p,) + tuple(v.shape[1:])).clone()

    loss = on_every_stage(loss_acc)
    aux_sum = cops.all_reduce(aux_acc, "sum") if p > 1 else aux_acc
    total = loss + aux_weight * aux_sum
    d_loss_params = _unflatten(loss_params, [on_every_stage(g) for g in dlp])
    d_xmb = on_every_stage(dx_buf[None])
    return total, loss, _unflatten(params, dparams), d_loss_params, d_xmb


def one_f_one_b(
    stage_fn: Callable[..., torch.Tensor],
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    params,
    xmb: torch.Tensor,
    axis: str = "pp",
):
    """Manual 1F1B pipeline training step: ``stage_fn(stage_params, x) ->
    y`` on all stages at once, ``loss_fn(y) -> [1]`` on the last stage's
    outputs summed over microbatches, ``params`` stage-stacked, ``xmb``
    ``[P, M, B_mb, ...]``. Returns ``(loss [P], d_params)``. A thin adapter
    over :func:`pipeline_train` (no aux channel, no loss parameters, input
    cotangents discarded)."""
    def stage2(p_, x):
        return stage_fn(p_, x), torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)

    def loss2(_lp, y, _tgt):
        return loss_fn(y)

    p, m = xmb.shape[:2]
    total, _loss, dparams, _dlp, _dxmb = pipeline_train(
        stage2, loss2, params, {}, xmb,
        torch.zeros((p, m, 1), dtype=torch.float32, device=xmb.device), axis, aux_weight=0.0)
    return total, dparams
