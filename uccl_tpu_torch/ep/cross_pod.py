"""Cross-pod expert parallelism: experts sharded over DCN-connected pods.

Port of ``uccl_tpu/ep/cross_pod.py``. The reference's EP pillar spans hosts
through its CPU proxies posting RDMA (ep/src/proxy.cpp:701, rdma.cpp:1554 —
the dispatch/combine all-to-all runs over the NIC fabric between nodes,
*inside torch autograd*: training fwd+bwd both cross the wire). Inside a pod
the experts run on the pod's card; this module adds the inter-pod leg over
the DCN transfer engine — training-grade:

* **forward**: tokens bucket by destination pod (vectorized numpy — one
  broadcasting pass, no Python loops over k), payloads + routing metadata
  ride ``DcnGroup.all_to_all`` (direct pairwise writes), each pod computes
  its own experts' contributions on its device (``ep.ops.sorted_from_topk``
  and the caller's expert GEMMs), the weighted partials return over the
  same exchange.
* **backward**: the same two DCN exchanges in cotangent space —
  ``backward(dout)`` ships per-slot output cotangents to the pods that
  computed them, runs ``torch.autograd`` of the local expert compute on the
  saved received buffers, and returns (d_x, d_topk_weights) to the source
  pods while d_expert_weights stays where the experts live. Gradients match
  a single-process oracle (tests/test_torch_cross_pod.py).
* **overlap**: ``n_chunks > 1`` pipelines the slot space — the exchange of
  chunk c+1 overlaps the (asynchronously launched) expert compute of chunk
  c, and the return exchange of chunk c overlaps compute of c+1; the moral
  analog of the reference's proxy threads running ahead of the GPU
  (proxy.cpp:701 drains rings while kernels run).

Semantics: drop-and-renormalize like the on-mesh path, with capacity applied
per (token, pod) bucket — a token reaching experts in ``p`` pods occupies
``p`` slots. Every pod calls forward/backward collectively (SPMD across
pods). Eager PyTorch compiles nothing, so the JAX module's per-shape
compiled-program caches have no counterpart here.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.collective.hierarchical import DcnGroup
from uccl_tpu_torch.ep import ops as ep_ops


class _StageClock:
    """Env-gated per-stage wall profiler (UCCL_TPU_XPOD_PROFILE=1): the
    knob that localizes cross-pod overhead (comm vs host glue vs compute)
    without guessing — the stats-surface idiom of the reference's proxy
    timing counters (dispatch_wait_recv_cost_stats, internode_ll.cu:66)."""

    def __init__(self):
        # read per instance (one per forward): enabling the profiler after
        # module import must work
        self.enabled = os.environ.get("UCCL_TPU_XPOD_PROFILE", "") == "1"
        self.t = {}
        self._t0 = time.perf_counter()

    def lap(self, name: str):
        if not self.enabled:
            return
        now = time.perf_counter()
        self.t[name] = self.t.get(name, 0.0) + (now - self._t0) * 1e3
        self._t0 = now

    def dump(self, tag: str):
        if self.enabled and self.t:
            total = sum(self.t.values())
            parts = " ".join(f"{k}={v:.1f}ms" for k, v in self.t.items())
            print(f"[xpod-profile] {tag}: total={total:.1f}ms {parts}",
                  flush=True)


def _np_token_for_slot(idx: np.ndarray, num_experts: int,
                       capacity: int) -> np.ndarray:
    """numpy twin of ep_ops.sorted_from_topk's token_for_slot output —
    same k-major flattening and STABLE sort, so drop semantics stay
    byte-identical to the device path. idx: [T, K] bucket ids; returns
    [E*C] with T as the empty sentinel."""
    t, k = idx.shape
    tk = t * k
    flat_e = idx.T.reshape(tk)
    flat_t = np.tile(np.arange(t, dtype=np.int32), k)
    order = np.argsort(flat_e, kind="stable")
    sorted_t = flat_t[order]
    counts = np.bincount(flat_e, minlength=num_experts)[:num_experts]
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_ids = np.arange(num_experts * capacity)
    e_of = slot_ids // capacity
    p_of = slot_ids % capacity
    j = seg_start[e_of] + p_of
    kept = np.minimum(counts, capacity)
    valid = p_of < kept[e_of]
    return np.where(
        valid, sorted_t[np.clip(j, 0, tk - 1)], t
    ).astype(np.int32)


class CrossPodMoE:
    """MoE layer whose experts live across DCN-connected pods.

    Args:
      dcn: the cross-pod group (one member per pod).
      mesh: this pod's :class:`~uccl_tpu_torch.parallel.mesh.Mesh` (or a
        device): the local expert compute runs on its device.
      num_global_experts: total experts; pod i owns the contiguous block
        ``[i*E/P, (i+1)*E/P)``.
      capacity_factor: per-(token, pod) bucketing slack.
      n_chunks: slot-space pipelining depth (1 = no overlap; 2+ overlaps DCN
        exchanges with expert compute).
      a2a_sched: "off" | "on" | "auto" — order the pairwise DCN exchanges
        by the contention-aware round schedule built from ``a2a_traffic``
        (uccl_tpu_torch.ep.a2a_sched; heavy inter-pod flows first, each
        round a partial matching so no pod's NIC carries two transfers at
        once; every write still rides the multipath Channel's SACK +
        PathQuality steering). "auto" schedules only when the matrix is
        actually skewed — a uniform matrix keeps the fixed hop order.
        Identical bytes and result either way. The matrix is SPMD state:
        every pod must construct with the same one.
      a2a_traffic: host [P, P] inter-pod routing matrix (None = uniform).
    """

    def __init__(
        self,
        dcn: DcnGroup,
        mesh,
        *,
        num_global_experts: int,
        num_selected: int = 2,
        capacity_factor: float = 1.25,
        n_chunks: int = 1,
        a2a_sched: str = "off",
        a2a_traffic=None,
    ):
        self.dcn = dcn
        self.mesh = mesh
        self.device = resolve_device(getattr(mesh, "device", mesh))
        self.n_pods = dcn.active_world
        if num_global_experts % self.n_pods:
            raise ValueError(
                f"experts {num_global_experts} must divide pods {self.n_pods}"
            )
        if a2a_sched not in ("off", "on", "auto"):
            raise ValueError(
                f"unknown a2a_sched {a2a_sched!r} (want 'off', 'on', or "
                "'auto')"
            )
        self.num_global_experts = num_global_experts
        self.experts_per_pod = num_global_experts // self.n_pods
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        self.n_chunks = max(1, int(n_chunks))
        self._dcn_schedule = self._resolve_dcn_schedule(a2a_sched,
                                                        a2a_traffic)
        self._ctx = None

    def _resolve_dcn_schedule(self, mode: str, traffic):
        """Build the (rounds, K) order the DCN exchanges will follow, or
        None for the fixed hop order. Decided once at construction (the
        matrix is static per layer, like ep.Buffer's): "on" pins the
        schedule; "auto" takes it only when the matrix is skewed — the
        host-side rounds cost nothing extra, so the only reason to keep
        the fixed order on a uniform matrix is that it IS that schedule
        already. The decision lands on the rounds/skew series either way
        (a2a_sched.record_decision)."""
        if mode == "off" or self.n_pods <= 1:
            return None
        from uccl_tpu_torch.ep import a2a_sched as _sched

        mat = traffic
        if mat is None:
            mat = np.ones((self.n_pods, self.n_pods), float)
            np.fill_diagonal(mat, 0.0)
        mat = np.asarray(mat, float)
        sk = _sched.skew(mat)
        if mode == "auto" and sk <= 1.0 + 1e-9:
            _sched.record_decision("ep_streams", self.n_pods, matrix=mat)
            return None
        schedule = _sched.wire_schedule(mat, self.n_pods)
        _sched.record_decision("ep_sched", self.n_pods,
                               n_rounds=len(schedule[0]), matrix=mat)
        # the return exchange sees the transposed traffic (partials flow
        # home) — ordered by its own decomposition
        back = _sched.wire_schedule(mat.T, self.n_pods)
        return (schedule, back)

    # ------------------------------------------------------------------
    def _pod_capacity(self, t: int) -> int:
        # worst case every one of a token's K experts lives in one pod; the
        # expected per-pod demand is T*K/P, bucketed with slack
        cap = max(
            1,
            int(self.capacity_factor * t * self.num_selected / self.n_pods),
        )
        # chunked pipelining slices the slot axis evenly — the SAME rounding
        # rule as the device-level chunked wire (dma.pad_capacity), so the
        # host and device pipelines cannot drift on drop semantics
        return _dma.pad_capacity(cap, self.n_chunks)

    def _local_fn(self, expert_fn):
        """The per-pod compute: (xs [S,H], idx [S,K] local ids with -1
        invalid, wts [S,K], warrs) -> weighted partial sums [S,H], on the
        pod's device."""
        epp = self.experts_per_pod

        def f(xs, idx, wts, warrs):
            valid = (idx >= 0) & (idx < epp)
            w = torch.where(valid, wts, torch.zeros_like(wts))
            k = idx.shape[-1]
            # one expert can legally receive up to S*K assignments (duplicate
            # expert ids within a token's top-k are allowed)
            cap = xs.shape[0] * k
            tfs, slot, _ = ep_ops.sorted_from_topk(
                torch.where(valid, idx, torch.full_like(idx, epp)), epp + 1, cap
            )
            # gather per-expert buffers [epp+1, cap, H]; bucket epp = invalid
            buf = ep_ops._take_rows(xs, tfs).reshape(epp + 1, cap, -1)
            out_e = expert_fn(buf[:epp], warrs)
            out_e = torch.cat(
                [out_e, torch.zeros_like(out_e[:1])], dim=0
            ).reshape((epp + 1) * cap, -1)
            yk = ep_ops._take_rows(out_e, slot)
            return torch.einsum("sk,skh->sh", w, yk)

        return f

    def _local_vjp(self, expert_fn):
        """torch.autograd of the local compute w.r.t. (xs, wts, warrs):
        (xs, idx, wts, warrs, ct) -> (dxs, dwts, dwarrs)."""
        f = self._local_fn(expert_fn)

        def g(xs, idx, wts, warrs, ct):
            names = list(warrs)
            xs_ = xs.detach().requires_grad_(True)
            wts_ = wts.detach().requires_grad_(True)
            leaves = {n: warrs[n].detach().requires_grad_(True) for n in names}
            with torch.enable_grad():
                out = f(xs_, idx, wts_, leaves)
                grads = torch.autograd.grad(
                    out, [xs_, wts_] + [leaves[n] for n in names], ct,
                    allow_unused=True)
            dw = {n: (g_ if g_ is not None else torch.zeros_like(leaves[n]))
                  for n, g_ in zip(names, grads[2:])}
            return grads[0], grads[1], dw

        return g

    # ------------------------------------------------------------------
    def _bucket(self, x, topk_idx, topk_weights):
        """Vectorized host bucketing: slots, payload, per-slot metadata.

        Returns (tfs [P*cap], valid_slot, safe_tfs, hits [P*cap, K],
        meta_idx, meta_w, payload [P*cap, H])."""
        t, h = x.shape
        k = topk_idx.shape[-1]
        n_pods = self.n_pods
        cap = self._pod_capacity(t)
        epp = self.experts_per_pod

        pod_of = topk_idx // epp  # [T, K]
        # dedup (token, pod): keep the FIRST k hitting each pod — one
        # broadcasting compare against earlier k-slots, no Python loop
        eq = pod_of[:, :, None] == pod_of[:, None, :]  # [T, K, K]
        dup = np.tril(eq, -1).any(axis=-1)  # [T, K] matches an earlier k
        coarse = np.where(~dup, pod_of, n_pods)  # sentinel: no slot
        # pure-numpy twin of ep_ops.sorted_from_topk's token_for_slot: the
        # bucketing is host-side, so it stays off the device's queue
        tfs = _np_token_for_slot(coarse, n_pods + 1, cap)[: n_pods * cap]

        valid_slot = tfs < t
        safe_tfs = np.where(valid_slot, tfs, 0)
        payload = np.where(valid_slot[:, None], x[safe_tfs], 0).astype(
            np.float32
        )
        slot_pod = np.repeat(np.arange(n_pods), cap)  # [P*cap]
        # hits[s, j]: assignment (token(s), j) targets slot s's pod
        hits = valid_slot[:, None] & (pod_of[safe_tfs] == slot_pod[:, None])
        meta_idx = np.where(hits, topk_idx[safe_tfs] % epp, -1).astype(
            np.int32
        )
        meta_w = np.where(hits, topk_weights[safe_tfs], 0.0).astype(
            np.float32
        )
        return tfs, valid_slot, safe_tfs, hits, meta_idx, meta_w, payload

    def _chunked_exchange_compute(self, wire, fn_args_builder, fn,
                                  clk=None):
        """Pipelined: all_to_all chunk c, launch compute c (CUDA launches
        return before the device finishes), exchange c+1 while c computes,
        then return-exchange each chunk's result as it resolves. wire:
        [P, cap, D]. Returns [P*cap, H] numpy."""
        n_pods, cap = wire.shape[0], wire.shape[1]
        cs = cap // self.n_chunks
        sched_out, sched_back = self._dcn_schedule or (None, None)
        partials = []
        for c in range(self.n_chunks):
            sl = slice(c * cs, (c + 1) * cs)
            recv = self.dcn.all_to_all(np.ascontiguousarray(wire[:, sl]),
                                       schedule=sched_out)
            if clk:
                clk.lap("a2a_out")
            partials.append(fn(*fn_args_builder(recv)))  # async launch
            if clk:
                clk.lap("dispatch")
        backs = []
        for c in range(self.n_chunks):
            part = partials[c].detach().cpu().numpy()  # waits on chunk c only
            if clk:
                clk.lap("compute_wait")
            h = part.shape[-1]
            backs.append(
                self.dcn.all_to_all(
                    np.ascontiguousarray(part.reshape(n_pods, cs, h)),
                    schedule=sched_back,
                )
            )
            if clk:
                clk.lap("a2a_back")
        return np.concatenate(backs, axis=1).reshape(n_pods * cap, -1)

    # ------------------------------------------------------------------
    def forward(
        self,
        x,
        topk_idx,
        topk_weights,
        expert_weights,
        *,
        save_for_backward: bool = True,
    ) -> np.ndarray:
        """x: [T, H] host tokens; topk_idx: [T, K] GLOBAL expert ids;
        topk_weights: [T, K] (numpy or tensors; the bucketing runs on the
        host). ``expert_weights`` is a dict with ``"fn"``:
        ``(buf [epp, cap, H], warrs) -> [epp, cap, H]`` computing every
        local expert on its bucketed tokens, plus the tensors fn needs
        (on the pod's device). Returns [T, H] numpy. With
        save_for_backward, :meth:`backward` afterwards produces the
        gradients."""
        x, topk_idx, topk_weights = (_host(a) for a in (x, topk_idx, topk_weights))
        t, h = x.shape
        k = topk_idx.shape[-1]
        if k != self.num_selected:
            raise ValueError(
                f"topk_idx has K={k} but the layer was built with "
                f"num_selected={self.num_selected} (capacity is sized by it)"
            )
        n_pods = self.n_pods
        cap = self._pod_capacity(t)
        clk = _StageClock()

        tfs, valid_slot, safe_tfs, hits, meta_idx, meta_w, payload = (
            self._bucket(x, topk_idx, topk_weights)
        )
        clk.lap("bucket")

        # wire rows: payload + (local idx, weight) metadata per k
        wire = np.concatenate(
            [payload, meta_idx.astype(np.float32), meta_w], axis=1
        ).reshape(n_pods, cap, h + 2 * k)
        clk.lap("pack")

        warrs = {kk: v for kk, v in expert_weights.items() if kk != "fn"}
        fn = self._local_fn(expert_weights["fn"])
        dev = self.device
        recvs = []

        def build_args(recv):
            flat = torch.from_numpy(recv.reshape(-1, h + 2 * k)).to(dev)
            xs = flat[:, :h]
            idx_r = flat[:, h:h + k].to(torch.int32)
            w_r = flat[:, h + k:]
            recvs.append((xs, idx_r, w_r))
            return xs, idx_r, w_r, warrs

        back = self._chunked_exchange_compute(wire, build_args, fn, clk=clk)

        out = np.zeros((t, h), np.float32)
        np.add.at(out, safe_tfs[valid_slot], back[valid_slot])
        clk.lap("combine")
        clk.dump(f"forward pod={self.dcn.pos} chunks={self.n_chunks}")

        if save_for_backward:
            self._ctx = dict(
                t=t, h=h, k=k, cap=cap, recvs=recvs, hits=hits,
                valid_slot=valid_slot, safe_tfs=safe_tfs,
                expert_fn=expert_weights["fn"], warrs=warrs,
            )
        return out

    def backward(self, dout):
        """Cotangent pass: dout [T, H] → (d_x [T, H], d_topk_weights [T, K],
        d_expert_weights dict). d_x and d_topk_weights are host numpy, as
        the forward's output; d_expert_weights are tensors on the pod's
        device (the experts live there). Runs the same two DCN exchanges as
        forward, in cotangent space; every pod calls it collectively."""
        ctx = self._ctx
        if ctx is None:
            raise RuntimeError("backward() without a saved forward")
        dout = _host(dout)
        t, h, k, cap = ctx["t"], ctx["h"], ctx["k"], ctx["cap"]
        n_pods = self.n_pods
        valid_slot, safe_tfs = ctx["valid_slot"], ctx["safe_tfs"]

        # leg 1 (cotangent of the partial-return exchange): each slot's
        # output cotangent is dout at its source token; ship to the pod
        # that computed that slot's partial
        dpart = np.where(
            valid_slot[:, None], dout[safe_tfs], 0.0
        ).astype(np.float32).reshape(n_pods, cap, h)

        vjp_fn = self._local_vjp(ctx["expert_fn"])
        warrs = ctx["warrs"]
        d_warrs_acc = None
        outs = []
        chunk_i = [0]
        dev = self.device

        def build_args(recv_ct):
            xs, idx_r, w_r = ctx["recvs"][chunk_i[0]]
            chunk_i[0] += 1
            ct = torch.from_numpy(np.ascontiguousarray(recv_ct.reshape(-1, h))).to(dev)
            return xs, idx_r, w_r, warrs, ct

        # local vjp returns (dxs, dwts, dwarrs); the wire carries dxs+dwts,
        # dwarrs stays on this pod (experts live here)
        def fn(xs, idx_r, w_r, warrs_, ct):
            dxs, dwts, dwarrs = vjp_fn(xs, idx_r, w_r, warrs_, ct)
            outs.append(dwarrs)
            return torch.cat([dxs, dwts.to(dxs.dtype)], dim=1)

        back = self._chunked_exchange_compute(dpart, build_args, fn)
        for dwarrs in outs:
            if d_warrs_acc is None:
                d_warrs_acc = dict(dwarrs)
            else:
                d_warrs_acc = {n: d_warrs_acc[n] + dwarrs[n] for n in d_warrs_acc}

        dxs_back = back[:, :h]
        dwts_back = back[:, h:]

        d_x = np.zeros((t, h), np.float32)
        np.add.at(d_x, safe_tfs[valid_slot], dxs_back[valid_slot])
        d_w = np.zeros((t, k), np.float32)
        hits = ctx["hits"]  # [P*cap, K]
        rows = np.repeat(safe_tfs, k).reshape(-1, k)
        np.add.at(
            d_w,
            (rows[hits], np.broadcast_to(np.arange(k), hits.shape)[hits]),
            dwts_back[hits],
        )
        return d_x, d_w, d_warrs_acc


def _host(a) -> np.ndarray:
    """A host numpy view (or copy, for a device tensor) of one input."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
