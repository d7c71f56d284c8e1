"""Pipeline parallelism over the ``pp`` axis: GPipe, the manual 1F1B and
the interleaved 1F1B.

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

``interleaved_1f1b`` (V virtual chunks a stage, L = P*V logical stages) runs
on the same stage-stacked form, with parameters ``[P, V, ...]``: a slot
gathers each stage's chunk of the slot and the schedule tables (the JAX
package's, entry for entry) choose what each stage keeps. Nothing in either
package calls it; it is not wired into the models.
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


# ---------------------------------------------------------------------------
# Interleaved 1F1B (virtual pipeline chunks): each device holds V model
# chunks, so the pipeline has L = P*V logical stages and the warm-up/drain
# bubble shrinks by ~V (each ramp slot is 1/V of a device's layer budget).
# The reference's PP story is one-sided activation sends with zero compute
# occupancy (lite-ep/README.md:24); here the analog stays "two ppermutes per
# slot" because of the stage numbering below — interleaving adds no new
# communication structure, only a denser static schedule.


def _simulate_interleaved(m: int, p: int, v: int, policy: str = "best"):
    """Slot-synchronous interleaved 1F1B schedule.

    Chunk ``c`` on device ``s`` is global stage ``g = c*p + s`` of ``L = p*v``
    stages. Every forward hop g -> g+1 is then a ring ``+1`` hop over the pp
    axis (the chunk wrap (c, p-1) -> (c+1, 0) included) and every backward
    hop a ring ``-1`` hop, so the runtime needs exactly one forward and one
    backward wire regardless of V.

    Policies (one op per device per slot, like :func:`_simulate_1f1b`):

    * ``greedy`` — backward-first in Megatron order preference; forwards
      choose the ready candidate earliest in Megatron's interleaved order
      ``(mb//p, c, mb%p)``, capped per chunk at ``min(m, (v-1-c)*p + p - s)``
      in-flight (= downstream stages + 1, the interleaved generalization of
      the classic ``p - s`` cap).
    * ``strict`` — the Megatron static schedule: ``2(p-s-1) + (v-1)p + 1``
      warm-up forwards in strict order, then backward-preferred alternation,
      idling when the next op in order isn't ready.
    * ``best`` (default) — build both and keep the shorter table.

    Queue/stash slots are allocated by a free-list here at build time, so the
    runtime's ring buffers are plain static-size arrays with precomputed
    bank/read indices. Returns a dict of [T, P] int32 tables + capacities.
    """
    if policy == "best":
        cands = [_simulate_interleaved(m, p, v, pol)
                 for pol in ("greedy", "strict")]
        cands = [c for c in cands if c is not None]
        if not cands:
            raise RuntimeError(
                f"interleaved 1F1B schedule did not converge "
                f"(m={m}, p={p}, v={v})"
            )
        return min(cands, key=lambda c: c["do_f"].shape[0])
    L = p * v
    fwd_done = [[0] * v for _ in range(p)]
    bwd_done = [[0] * v for _ in range(p)]
    ready_f = [[[None] * m for _ in range(v)] for _ in range(p)]
    ready_b = [[[None] * m for _ in range(v)] for _ in range(p)]
    for mb in range(m):
        ready_f[0][0][mb] = 0

    class _Alloc:
        def __init__(self):
            self.used = set()
            self.high = 0

        def get(self):
            i = 0
            while i in self.used:
                i += 1
            self.used.add(i)
            self.high = max(self.high, i + 1)
            return i

        def put(self, i):
            self.used.discard(i)

    qf_a = [_Alloc() for _ in range(p)]
    qb_a = [_Alloc() for _ in range(p)]
    st_a = [_Alloc() for _ in range(p)]
    qf_slot = [[[None] * m for _ in range(v)] for _ in range(p)]
    qb_slot = [[[None] * m for _ in range(v)] for _ in range(p)]
    st_slot = [[[None] * m for _ in range(v)] for _ in range(p)]

    # Megatron interleaved op order per device: microbatches in groups of p,
    # chunks inner-sequenced within the group; backwards mirror with chunks
    # reversed (deepest drains first).
    fseq = sorted(
        ((mb // p, c, mb % p), c, mb) for c in range(v) for mb in range(m)
    )
    bseq = sorted(
        ((mb // p, v - 1 - c, mb % p), c, mb)
        for c in range(v)
        for mb in range(m)
    )
    fi, bi = [0] * p, [0] * p
    warm = [min(2 * (p - s - 1) + (v - 1) * p + 1, m * v) for s in range(p)]

    def _f_ready(s, c, f, t):
        if s == 0 and c == 0:
            return True
        return ready_f[s][c][f] is not None and ready_f[s][c][f] <= t

    def _b_ready(s, c, b, t):
        if fwd_done[s][c] <= b:
            return False
        if s == p - 1 and c == v - 1:
            return True
        return ready_b[s][c][b] is not None and ready_b[s][c][b] <= t

    def _pick(s, t):
        """Returns ('f'|'b', chunk) or None for this device this slot."""
        if policy == "strict":
            nf = fseq[fi[s]] if fi[s] < m * v else None
            nb = bseq[bi[s]] if bi[s] < m * v else None
            if fi[s] >= warm[s] and nb and _b_ready(s, nb[1], nb[2], t):
                return "b", nb[1]
            if nf and _f_ready(s, nf[1], nf[2], t):
                return "f", nf[1]
            return None
        cand_b = []
        for c in range(v):
            b = bwd_done[s][c]
            if b < m and _b_ready(s, c, b, t):
                cand_b.append(((b // p, -c, b % p), c))
        if cand_b:
            return "b", min(cand_b)[1]
        cand_f = []
        for c in range(v):
            f = fwd_done[s][c]
            if f >= m or not _f_ready(s, c, f, t):
                continue
            cap = min(m, (v - 1 - c) * p + (p - s))
            if fwd_done[s][c] - bwd_done[s][c] >= cap:
                continue
            cand_f.append(((f // p, c, f % p), c))
        if cand_f:
            return "f", min(cand_f)[1]
        return None

    rows, qf_banks, qb_banks = [], [], []
    next_qf_bank = [-1] * p
    next_qb_bank = [-1] * p
    t = 0
    limit = 8 * (v * m + p) + 16
    while (
        any(bwd_done[s][c] < m for s in range(p) for c in range(v))
        and t < limit
    ):
        qf_banks.append(next_qf_bank)
        qb_banks.append(next_qb_bank)
        next_qf_bank = [-1] * p
        next_qb_bank = [-1] * p
        row = []
        for s in range(p):
            do_f = f_c = f_mb = st_put = 0
            do_b = b_c = b_mb = st_get = 0
            f_src = b_src = -1
            pick = _pick(s, t)
            if pick and pick[0] == "b":
                c = pick[1]
                b = bwd_done[s][c]
                do_b, b_c, b_mb = 1, c, b
                bwd_done[s][c] += 1
                bi[s] += 1
                st_get = st_slot[s][c][b]
                st_a[s].put(st_get)
                g = c * p + s
                if g < L - 1:
                    b_src = qb_slot[s][c][b]
                    qb_a[s].put(b_src)
                if g > 0:
                    d = (s - 1) % p
                    c2 = c if s > 0 else c - 1
                    a = qb_a[d].get()
                    qb_slot[d][c2][b] = a
                    ready_b[d][c2][b] = t + 1
                    next_qb_bank[d] = a
            elif pick and pick[0] == "f":
                c = pick[1]
                f = fwd_done[s][c]
                do_f, f_c, f_mb = 1, c, f
                fwd_done[s][c] += 1
                fi[s] += 1
                if not (s == 0 and c == 0):
                    f_src = qf_slot[s][c][f]
                    qf_a[s].put(f_src)
                st_put = st_a[s].get()
                st_slot[s][c][f] = st_put
                g = c * p + s
                if g < L - 1:
                    d = (s + 1) % p
                    c2 = c if s < p - 1 else c + 1
                    a = qf_a[d].get()
                    qf_slot[d][c2][f] = a
                    ready_f[d][c2][f] = t + 1
                    next_qf_bank[d] = a
            row.append(
                (do_f, f_c, f_mb, f_src, st_put, do_b, b_c, b_mb, b_src, st_get)
            )
        rows.append(row)
        t += 1
    if any(bwd_done[s][c] < m for s in range(p) for c in range(v)):
        return None
    tab = np.asarray(rows, np.int32)  # [T, P, 10]
    return {
        "do_f": tab[..., 0],
        "f_c": tab[..., 1],
        "f_mb": tab[..., 2],
        "f_src": tab[..., 3],
        "st_put": tab[..., 4],
        "do_b": tab[..., 5],
        "b_c": tab[..., 6],
        "b_mb": tab[..., 7],
        "b_src": tab[..., 8],
        "st_get": tab[..., 9],
        "qf_bank": np.asarray(qf_banks, np.int32),
        "qb_bank": np.asarray(qb_banks, np.int32),
        "n_qf": max(1, max(a.high for a in qf_a)),
        "n_qb": max(1, max(a.high for a in qb_a)),
        "n_stash": max(1, max(a.high for a in st_a)),
    }


def interleaved_1f1b(
    stage_fn: Callable[..., torch.Tensor],
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    params,
    xmb: torch.Tensor,
    n_chunks: int,
    axis: str = "pp",
):
    """Interleaved-schedule pipeline training step on stage-stacked tensors.

    Args:
      stage_fn: ``(chunk_params, x) -> y`` for one model chunk on all
        stages at once: ``chunk_params`` a pytree of ``[P, ...]`` (row s is
        the chunk stage s runs this slot), x/y ``[P, B_mb, ...]`` with
        matching shapes across all chunks.
      loss_fn: ``y -> [1]`` applied to the final logical stage's outputs
        (``[1, B_mb, ...]``, stage P-1's row), summed over microbatches.
      params: the chunk parameters, leaves ``[P, V, ...]``: chunk ``c`` of
        stage ``s`` holds global stage ``c*P + s`` (Megatron-interleaved
        assignment).
      xmb: ``[P, M, B_mb, ...]`` microbatches (row 0 is consumed: stage 0's
        chunk 0 is the first logical stage).
      n_chunks: V, the virtual-chunk count per stage.

    Returns ``(loss [P], d_params)``: the loss on every stage, d_params
    stacked like ``params``. The warm-up/drain bubble is ~1/V of
    :func:`one_f_one_b`'s in wall-clock terms (each slot runs one chunk =
    1/V of a stage's layers). A slot runs the forward (the backward) only
    if some stage does one in it, on every stage, and the tables mask what
    each keeps; every forward hop is a ring +1 hop over the stages and every
    backward hop a ring -1 hop.
    """
    p, m = xmb.shape[:2]
    v = int(n_chunks)
    if m < 1 or v < 1:
        raise ValueError(f"need >=1 microbatch and >=1 chunk (m={m}, v={v})")
    leaves0 = _leaves(params)
    leading = {tuple(a.shape[:2]) for a in leaves0}
    if leading != {(p, v)}:
        raise ValueError(
            f"params leaves must stack {p} stages x {v} chunks on axes 0, 1; got "
            f"leading dims {sorted(leading)}")
    sched = _simulate_interleaved(m, p, v)
    n_slots = sched["do_f"].shape[0]
    dev = xmb.device
    rows = torch.arange(p, device=dev)
    fwd_perm, bwd_perm = ppermute_pairs(p, 1), ppermute_pairs(p, -1)
    leaves = [a.detach() for a in leaves0]

    def chunk(c_row):  # each stage's chunk of this slot: leaves [P, ...]
        idx = torch.as_tensor(c_row, device=dev)
        return [a[rows, idx] for a in leaves]

    mb_shape = tuple(xmb.shape[2:])
    stash = xmb.new_zeros((p, sched["n_stash"]) + mb_shape)
    qf = xmb.new_zeros((p, sched["n_qf"]) + mb_shape)
    qb = xmb.new_zeros((p, sched["n_qb"]) + mb_shape)
    fwd_in = bwd_in = xmb.new_zeros((p,) + mb_shape)
    dparams = [torch.zeros_like(a) for a in leaves]
    loss_acc = torch.zeros(1, dtype=torch.float32, device=dev)

    def mask(row) -> torch.Tensor:
        return torch.as_tensor(row == 1, device=dev)

    for t in range(n_slots):
        for s in range(p):  # bank this slot's wire arrivals into their slots
            if sched["qf_bank"][t, s] >= 0:
                qf[s, sched["qf_bank"][t, s]] = fwd_in[s]
            if sched["qb_bank"][t, s] >= 0:
                qb[s, sched["qb_bank"][t, s]] = bwd_in[s]

        y_out = xmb.new_zeros((p,) + mb_shape)
        do_f = sched["do_f"][t]
        if do_f.any():
            f_src, f_mb = sched["f_src"][t], sched["f_mb"][t]
            x = torch.stack([xmb[0, f_mb[s]] if f_src[s] < 0 else qf[s, max(f_src[s], 0)]
                             for s in range(p)])
            with torch.no_grad():
                y = stage_fn(_unflatten(params, chunk(sched["f_c"][t])), x)
            y_out = torch.where(_per_stage(mask(do_f), y), y, torch.zeros_like(y))
            for s in range(p):
                if do_f[s]:
                    stash[s, sched["st_put"][t, s]] = x[s]

        dx_out = xmb.new_zeros((p,) + mb_shape)
        do_b = sched["do_b"][t]
        if do_b.any():
            b_src, b_c = sched["b_src"][t], sched["b_c"][t]
            x = torch.stack([stash[s, sched["st_get"][t, s]] for s in range(p)]).requires_grad_()
            pc = [a.requires_grad_() for a in chunk(b_c)]
            # b_src < 0 marks the final logical stage: its cotangent comes
            # from the loss instead of the wire
            final = bool(do_b[p - 1]) and b_src[p - 1] < 0
            with torch.enable_grad():
                y = stage_fn(_unflatten(params, pc), x)
                gy = torch.stack([qb[s, max(b_src[s], 0)] for s in range(p)]).to(y.dtype)
                if final:
                    y_last = y[p - 1:].detach().requires_grad_()
                    lval = loss_fn(y_last)
                    (gl,) = torch.autograd.grad(lval, [y_last], torch.ones_like(lval))
                    gy = torch.cat([gy[:p - 1], gl.to(y.dtype)])
                grads = torch.autograd.grad([y], pc + [x], [gy], allow_unused=True)
            on = mask(do_b)
            with torch.no_grad():
                for i, ga in enumerate(grads[:-1]):
                    if ga is None:
                        continue
                    for s in range(p):
                        if do_b[s]:
                            dparams[i][s, b_c[s]] += ga[s]
                dx_out = torch.where(_per_stage(on, grads[-1]), grads[-1],
                                     torch.zeros_like(grads[-1])).detach()
                if final:
                    loss_acc = loss_acc + lval.detach().float().reshape(1)

        if p > 1:
            fwd_in = cops.ppermute(y_out, fwd_perm)
            bwd_in = cops.ppermute(dx_out, bwd_perm)
        else:  # one stage: the chunk wrap (c, 0) -> (c + 1, 0) is a self hop
            fwd_in, bwd_in = y_out, dx_out

    return loss_acc.expand(p).clone(), _unflatten(params, dparams)
