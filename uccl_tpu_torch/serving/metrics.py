"""Serving metrics: queue depth, slot occupancy, goodput, TTFT/TPOT.

Port copy of ``uccl_tpu/serving/metrics.py`` (jax-free there too).

Definitions (shared with serve.py's one-shot percentiles and
benchmarks/serving_bench.py — docs/SERVING.md spells them out):

* **TTFT** — submit → first generated token, queue wait included.
* **queue wait** — submit → admission into a KV slot: the scheduling delay
  alone, reported as its own series so scheduling and compute delays are
  separable (TTFT − queue wait ≈ prefill/compute time).
* **TPOT** — per-request mean seconds per output token AFTER the first
  (decode steady state): (t_finish - t_first) / (n_out - 1).
* **decode step latency** — wall time of one masked batched decode call.
* **engine step latency** — wall time of one full ``step()`` (admission +
  prefill work + decode); its MAX is the decode-stall bound chunked
  prefill exists to shrink (docs/SERVING.md).
* **goodput** — completed requests' output tokens per second of serving
  wall time (first submit → last finish). Tokens of in-flight or rejected
  requests never count: goodput is *useful delivered* throughput.

The snapshot is JSON-ready and also exported through the stats thread
(``uccl_tpu_torch.utils.stats.registry``) under the ``serving`` source, which
mirrors it into the obs registry's pull sources.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from uccl_tpu_torch import obs
from uccl_tpu_torch.serving.request import Request, now

# Merge-safe latency histograms (docs/OBSERVABILITY.md): the sample lists
# below stay the exact in-process percentile source, but sample lists
# cannot be combined across processes — these log-bucketed families SUM,
# so obs/aggregate.py can federate N workers' /metrics into one fleet
# distribution. Observed by the SAME lifecycle hooks that append the
# samples, so the two derivations agree to a bucket width by construction
# (check_obs --fleet asserts it; serving_bench stamps both).
TTFT_HIST = obs.histogram(
    "serving_ttft_seconds", "submit -> first token, queue wait included"
)
QUEUE_WAIT_HIST = obs.histogram(
    "serving_queue_wait_seconds", "submit -> admission into a KV slot"
)
TPOT_HIST = obs.histogram(
    "serving_tpot_seconds", "per-token decode steady state after the first"
)
STEP_HIST = obs.histogram(
    "serving_step_seconds", "one full engine step() wall time"
)
TRANSFER_HIST = obs.histogram(
    "serving_transfer_seconds",
    "disagg KV transfer tail: prefill-done -> adopt (decode side)",
)
DISAGG_TTFT_HIST = obs.histogram(
    "serving_disagg_ttft_seconds",
    "disaggregated end-to-end TTFT: queue + prefill + transfer "
    "(wall-clock marks carried in the stream's control messages)",
)

_LATENCY_HISTS = (TTFT_HIST, QUEUE_WAIT_HIST, TPOT_HIST, STEP_HIST,
                  TRANSFER_HIST, DISAGG_TTFT_HIST)


def reset_latency_histograms() -> None:
    """Zero the process-wide serving latency histograms — called with
    ``ServingEngine.reset_metrics`` so compile-warmup observations never
    pollute the recorded distributions (warmups reset every engine in the
    process before the measured window, so clearing the shared families
    there is exact)."""
    for fam in _LATENCY_HISTS:
        fam.clear()


def percentile(xs: List[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy's default), None when empty."""
    if not xs:
        return None
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    frac = pos - lo
    if lo + 1 >= len(s):
        return float(s[-1])
    return float(s[lo] * (1.0 - frac) + s[lo + 1] * frac)


def percentiles_ms(xs: List[float], qs=(50, 95)) -> Dict[str, float]:
    """{'p50': ..., 'p95': ...} in milliseconds (empty dict when no samples)."""
    out = {}
    for q in qs:
        v = percentile(xs, q)
        if v is not None:
            out[f"p{q}"] = round(v * 1e3, 3)
    return out


def dist(xs: List[float], qs=(50, 95)) -> Dict[str, float]:
    """Percentiles + mean/max in the samples' OWN units (token counts,
    ratios — anything that is not a duration; durations go through
    :func:`percentiles_ms`). Empty dict when no samples."""
    out = {}
    for q in qs:
        v = percentile(xs, q)
        if v is not None:
            out[f"p{q}"] = round(v, 3)
    if xs:
        out["mean"] = round(sum(xs) / len(xs), 3)
        out["max"] = round(float(max(xs)), 3)
    return out


class ServingMetrics:
    """Counters + latency samples for one engine; host-only, jax-free."""

    def __init__(self):
        self.submitted = 0
        self.rejected = 0
        self.expired = 0  # queued requests dropped by deadline or cancel()
        # requests stranded on THIS engine when its replica died (the
        # fault-recovery sink term): a recovered request's resubmission on
        # a survivor is a NEW submission there, so the dead copy must
        # leave through `lost` for fleet conservation to stay exact —
        # submitted == completed+active+queued+rejected+expired+lost
        self.lost = 0
        self.admitted = 0
        self.adopted = 0  # requests entering via adopt() (disagg decode)
        self.preempted = 0  # pauses of a lower-class request at a chunk boundary
        self.resumed = 0  # preempted requests re-admitted (KV restored)
        self.completed = 0
        self.output_tokens = 0  # completed requests only (goodput numerator)
        self.prefill_calls = 0
        self.prefill_chunks = 0  # chunked-prefill calls (subset of prefill_calls)
        self.decode_calls = 0
        # tokens COMMITTED by decode/verify calls — under speculative
        # decoding a step commits 0..k+1 tokens per slot, so throughput
        # derives from this count, never from an assumed 1 token per call
        self.decode_tokens = 0
        # speculative decoding (per active slot per verify window):
        # proposed = tokens the drafter actually proposed (window pads
        # from abstentions are excluded), accepted = its matched prefix
        self.spec_windows = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.accepted_len: List[int] = []
        self.ttft_s: List[float] = []
        self.queue_wait_s: List[float] = []
        self.tpot_s: List[float] = []
        self.latency_s: List[float] = []
        self.prefill_s: List[float] = []
        self.decode_step_s: List[float] = []
        self.step_s: List[float] = []
        # disaggregated TTFT split (decode side, wall-clock seconds carried
        # in the stream's control messages — docs/SERVING.md): submit→admit
        # on the prefill fleet, admit→prefill-done, prefill-done→adopt
        # (the transfer tail), and the end-to-end sum per adopted request.
        self.disagg_queue_s: List[float] = []
        self.disagg_prefill_s: List[float] = []
        self.disagg_transfer_s: List[float] = []
        self.disagg_ttft_s: List[float] = []
        # per-priority-class series (SLO attainment is judged per class —
        # docs/SERVING.md): every request lands in exactly one class bucket
        self.class_submitted: Dict[str, int] = {}
        self.class_completed: Dict[str, int] = {}
        self.class_ttft_s: Dict[str, List[float]] = {}
        self.class_tpot_s: Dict[str, List[float]] = {}
        self.class_queue_wait_s: Dict[str, List[float]] = {}
        # per-tenant series: isolation is judged per tenant —
        # the multi-tenant bench derives each tenant's SLO attainment and
        # goodput share from these, so an overloading neighbor's damage
        # (or the fair scheduler's lack thereof) is directly visible
        self.tenant_submitted: Dict[str, int] = {}
        self.tenant_completed: Dict[str, int] = {}
        self.tenant_output_tokens: Dict[str, int] = {}
        self.tenant_ttft_s: Dict[str, List[float]] = {}
        self.tenant_tpot_s: Dict[str, List[float]] = {}
        self.tenant_queue_wait_s: Dict[str, List[float]] = {}
        self.t_first_submit: Optional[float] = None
        self.t_last_finish: Optional[float] = None

    # -- lifecycle hooks (the engine calls these) ---------------------------
    def on_submit(self, req: Request) -> None:
        self.submitted += 1
        self.class_submitted[req.priority] = \
            self.class_submitted.get(req.priority, 0) + 1
        self.tenant_submitted[req.tenant] = \
            self.tenant_submitted.get(req.tenant, 0) + 1
        if self.t_first_submit is None:
            self.t_first_submit = req.t_submit

    def on_reject(self, req: Request) -> None:
        self.rejected += 1

    def on_expire(self, req: Request) -> None:
        """A queued request left by deadline expiry or cancellation."""
        self.expired += 1

    def on_lost(self, req: Request) -> None:
        """A request stranded on this (dead) engine left the fleet — or
        was re-run on a survivor as a metrically-new submission. Either
        way THIS engine's copy exits through the `lost` term (the
        conservation invariant's recovery sink, docs/SERVING.md)."""
        self.lost += 1

    def on_admit(self, req: Request) -> None:
        self.admitted += 1
        if req.queue_wait is not None:
            self.queue_wait_s.append(req.queue_wait)
            QUEUE_WAIT_HIST.observe(req.queue_wait)
            self.class_queue_wait_s.setdefault(req.priority, []).append(
                req.queue_wait
            )
            self.tenant_queue_wait_s.setdefault(req.tenant, []).append(
                req.queue_wait
            )

    def on_preempt(self, req: Request) -> None:
        """A lower-class request was paused at a chunk boundary (its KV
        saved, its slot handed to an interactive arrival)."""
        self.preempted += 1

    def on_resume(self, req: Request) -> None:
        """A preempted request re-entered a slot (KV restored) — NOT a new
        admission: its queue-wait and admitted count were recorded at its
        first admission, so conservation stays exact."""
        self.resumed += 1

    def on_first_token(self, req: Request) -> None:
        if req.ttft is not None:
            self.ttft_s.append(req.ttft)
            TTFT_HIST.observe(req.ttft)
            self.class_ttft_s.setdefault(req.priority, []).append(req.ttft)
            self.tenant_ttft_s.setdefault(req.tenant, []).append(req.ttft)

    def on_adopt(self, req: Request, *, queue_s: Optional[float] = None,
                 prefill_s: Optional[float] = None,
                 transfer_s: Optional[float] = None) -> None:
        """A request adopted mid-stream (disagg decode side): its KV and
        first token arrived over the wire, so TTFT decomposes into the
        prefill fleet's queue + prefill time plus the transfer tail."""
        self.adopted += 1
        if queue_s is not None:
            self.disagg_queue_s.append(max(0.0, queue_s))
        if prefill_s is not None:
            self.disagg_prefill_s.append(max(0.0, prefill_s))
        if transfer_s is not None:
            self.disagg_transfer_s.append(max(0.0, transfer_s))
            TRANSFER_HIST.observe(max(0.0, transfer_s))
        if None not in (queue_s, prefill_s, transfer_s):
            ttft = (max(0.0, queue_s) + max(0.0, prefill_s)
                    + max(0.0, transfer_s))
            self.disagg_ttft_s.append(ttft)
            DISAGG_TTFT_HIST.observe(ttft)

    def on_finish(self, req: Request) -> None:
        self.completed += 1
        self.class_completed[req.priority] = \
            self.class_completed.get(req.priority, 0) + 1
        self.tenant_completed[req.tenant] = \
            self.tenant_completed.get(req.tenant, 0) + 1
        self.output_tokens += req.n_generated
        self.tenant_output_tokens[req.tenant] = \
            self.tenant_output_tokens.get(req.tenant, 0) + req.n_generated
        self.t_last_finish = req.t_finish
        if req.tpot is not None:
            self.tpot_s.append(req.tpot)
            TPOT_HIST.observe(req.tpot)
            self.class_tpot_s.setdefault(req.priority, []).append(req.tpot)
            self.tenant_tpot_s.setdefault(req.tenant, []).append(req.tpot)
        if req.latency is not None:
            self.latency_s.append(req.latency)

    def on_prefill(self, dt: float, n_new: int, *,
                   chunked: bool = False) -> None:
        self.prefill_calls += 1
        if chunked:
            self.prefill_chunks += 1
        self.prefill_s.append(dt)

    def on_decode_step(self, dt: float, n_active: int,
                       tokens: Optional[int] = None) -> None:
        """One masked decode/verify call over ``n_active`` slots that
        committed ``tokens`` output tokens (None = the vanilla 1 token per
        active slot; speculative steps pass their actual commit count)."""
        self.decode_calls += 1
        self.decode_step_s.append(dt)
        self.decode_tokens += n_active if tokens is None else tokens

    def on_spec(self, *, proposed: int, accepted: int) -> None:
        """One slot's verify outcome: ``proposed`` drafted tokens entered
        the window, ``accepted`` matched the target's greedy output."""
        self.spec_windows += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.accepted_len.append(accepted)

    def on_step(self, dt: float) -> None:
        self.step_s.append(dt)
        STEP_HIST.observe(dt)

    # -- derived ------------------------------------------------------------
    def goodput(self) -> Optional[float]:
        """Completed output tokens / serving wall seconds."""
        if self.t_last_finish is None or self.t_first_submit is None:
            return None
        dt = self.t_last_finish - self.t_first_submit
        if dt <= 0:
            return None
        return self.output_tokens / dt

    def snapshot(self, *, queued: int = 0, active: int = 0,
                 n_slots: int = 0, occupancy: float = 0.0) -> Dict:
        """JSON-ready state. Conservation invariant (tested):
        submitted == completed + active + queued + rejected + expired
        + lost (preemptions move requests between active and queued,
        never out; `lost` is the fault-recovery sink — a request
        stranded on a dead replica leaves here, and its survivor-side
        re-run is a new submission there)."""
        snap = {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "expired": self.expired,
            "lost": self.lost,
            "admitted": self.admitted,
            "completed": self.completed,
            "queued": queued,
            "active": active,
            "n_slots": n_slots,
            "occupancy": round(occupancy, 4),
            "output_tokens": self.output_tokens,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": self.prefill_chunks,
            "decode_calls": self.decode_calls,
            "decode_tokens": self.decode_tokens,
            "ttft_ms": percentiles_ms(self.ttft_s),
            "queue_wait_ms": percentiles_ms(self.queue_wait_s),
            "tpot_ms": percentiles_ms(self.tpot_s),
            "latency_ms": percentiles_ms(self.latency_s),
            "prefill_ms": percentiles_ms(self.prefill_s),
            "decode_step_ms": percentiles_ms(self.decode_step_s),
            "step_ms": percentiles_ms(self.step_s),
        }
        if self.step_s:
            snap["max_step_ms"] = round(max(self.step_s) * 1e3, 3)
        # decode throughput off the COMMITTED token count over decode-call
        # wall time — honest whether a call commits n_active tokens
        # (vanilla) or up to (k+1) * n_active (speculative)
        decode_wall = sum(self.decode_step_s)
        if decode_wall > 0 and self.decode_tokens:
            snap["decode_tok_s"] = round(self.decode_tokens / decode_wall, 1)
        if self.spec_windows:
            snap["spec_windows"] = self.spec_windows
            snap["spec_proposed"] = self.spec_proposed
            snap["spec_accepted"] = self.spec_accepted
            if self.spec_proposed:
                snap["spec_acceptance_rate"] = round(
                    self.spec_accepted / self.spec_proposed, 4
                )
            snap["accepted_len"] = dist(self.accepted_len)
        if self.preempted or self.resumed:
            snap["preempted"] = self.preempted
            snap["resumed"] = self.resumed
        # per-class SLO surfaces, emitted once a second class shows up (a
        # single-class engine's snapshot keeps its single-class keys)
        if len(self.class_submitted) > 1:
            snap["per_class"] = {
                cls: {
                    "submitted": n,
                    "completed": self.class_completed.get(cls, 0),
                    "ttft_ms": percentiles_ms(
                        self.class_ttft_s.get(cls, [])
                    ),
                    "tpot_ms": percentiles_ms(
                        self.class_tpot_s.get(cls, [])
                    ),
                    "queue_wait_ms": percentiles_ms(
                        self.class_queue_wait_s.get(cls, [])
                    ),
                }
                for cls, n in sorted(self.class_submitted.items())
            }
        # per-tenant SLO surfaces, same emission rule: a single-tenant
        # engine's snapshot stays byte-compatible with the pre-tenancy one
        if len(self.tenant_submitted) > 1:
            snap["per_tenant"] = {
                t: {
                    "submitted": n,
                    "completed": self.tenant_completed.get(t, 0),
                    "output_tokens": self.tenant_output_tokens.get(t, 0),
                    "ttft_ms": percentiles_ms(
                        self.tenant_ttft_s.get(t, [])
                    ),
                    "tpot_ms": percentiles_ms(
                        self.tenant_tpot_s.get(t, [])
                    ),
                    "queue_wait_ms": percentiles_ms(
                        self.tenant_queue_wait_s.get(t, [])
                    ),
                }
                for t, n in sorted(self.tenant_submitted.items())
            }
        if self.adopted:
            snap["adopted"] = self.adopted
            snap["disagg_queue_ms"] = percentiles_ms(self.disagg_queue_s)
            snap["disagg_prefill_ms"] = percentiles_ms(self.disagg_prefill_s)
            snap["disagg_transfer_ms"] = percentiles_ms(
                self.disagg_transfer_s
            )
            snap["disagg_ttft_ms"] = percentiles_ms(self.disagg_ttft_s)
        gp = self.goodput()
        if gp is not None:
            snap["goodput_tok_s"] = round(gp, 1)
        return snap

    @staticmethod
    def merged(parts: List["ServingMetrics"]) -> "ServingMetrics":
        """One metrics object spanning N replica engines (the router's
        aggregate snapshot): counts add, sample lists concatenate — so the
        merged percentiles are computed over the REAL union of samples, not
        averaged per-replica percentiles (which would be meaningless) —
        and the goodput window spans first submit to last finish across
        the whole replica set."""
        out = ServingMetrics()
        for m in parts:
            for attr, v in vars(m).items():
                cur = getattr(out, attr)
                if attr in ("t_first_submit", "t_last_finish"):
                    continue  # merged below (min/max, not sum)
                if isinstance(v, bool):
                    continue
                if isinstance(v, (int, float)):
                    setattr(out, attr, cur + v)
                elif isinstance(v, list):
                    cur.extend(v)
                elif isinstance(v, dict):
                    for k2, v2 in v.items():
                        if isinstance(v2, list):
                            cur.setdefault(k2, []).extend(v2)
                        else:
                            cur[k2] = cur.get(k2, 0) + v2
            if m.t_first_submit is not None:
                out.t_first_submit = (m.t_first_submit
                                      if out.t_first_submit is None
                                      else min(out.t_first_submit,
                                               m.t_first_submit))
            if m.t_last_finish is not None:
                out.t_last_finish = (m.t_last_finish
                                     if out.t_last_finish is None
                                     else max(out.t_last_finish,
                                              m.t_last_finish))
        return out

    # -- repo-wide stats thread export --------------------------------------
    @staticmethod
    def prometheus_lines(snapshot: Dict,
                         prefix: str = "uccl_serving") -> List[str]:
        """The snapshot as Prometheus text lines (the ``/metrics`` face of
        the same numbers — names through the shared obs sanitizer so this
        exporter and :func:`obs.prometheus_text` cannot drift).
        Percentile sub-dicts become one series per quantile, labeled
        ``{q="p50"}``; booleans and strings are skipped."""
        from uccl_tpu_torch.obs import escape_label_value, sanitize_name

        lines: List[str] = []
        for k, v in snapshot.items():
            name = sanitize_name(f"{prefix}_{k}")
            if k == "per_class" and isinstance(v, dict):
                # one series per (class, metric[, quantile]) — the SLO
                # surfaces check_obs --router greps for
                for cls, metrics in v.items():
                    c = escape_label_value(str(cls))
                    for mk, mv in metrics.items():
                        mname = sanitize_name(f"{prefix}_class_{mk}")
                        if isinstance(mv, dict):
                            for q, qv in mv.items():
                                if isinstance(qv, (int, float)) \
                                        and not isinstance(qv, bool):
                                    lines.append(
                                        f'{mname}{{cls="{c}",'
                                        f'q="{escape_label_value(str(q))}"'
                                        f"}} {qv}"
                                    )
                        elif isinstance(mv, (int, float)) \
                                and not isinstance(mv, bool):
                            lines.append(f'{mname}{{cls="{c}"}} {mv}')
                continue
            if k == "per_tenant" and isinstance(v, dict):
                # one series per (tenant, metric[, quantile]) — the
                # isolation surfaces check_obs --tenants greps for
                for ten, metrics in v.items():
                    tl = escape_label_value(str(ten))
                    for mk, mv in metrics.items():
                        mname = sanitize_name(f"{prefix}_tenant_{mk}")
                        if isinstance(mv, dict):
                            for q, qv in mv.items():
                                if isinstance(qv, (int, float)) \
                                        and not isinstance(qv, bool):
                                    lines.append(
                                        f'{mname}{{tenant="{tl}",'
                                        f'q="{escape_label_value(str(q))}"'
                                        f"}} {qv}"
                                    )
                        elif isinstance(mv, (int, float)) \
                                and not isinstance(mv, bool):
                            lines.append(
                                f'{mname}{{tenant="{tl}"}} {mv}'
                            )
                continue
            if isinstance(v, dict):
                for q, qv in v.items():
                    if isinstance(qv, (int, float)) \
                            and not isinstance(qv, bool):
                        lines.append(
                            f'{name}{{q="{escape_label_value(str(q))}"}} '
                            f"{qv}"
                        )
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f"{name} {v}")
        return lines

    def register(self, engine, name: str = "serving") -> None:
        """Export through uccl_tpu_torch.utils.stats — the same periodic
        snapshot channel the transport engines report on, mirrored into the
        obs registry, so /metrics and /snapshot carry it too."""
        from uccl_tpu_torch.utils.stats import registry

        def source() -> Dict[str, float]:
            s = engine.snapshot()
            return {
                k: float(v) for k, v in s.items()
                if isinstance(v, (int, float))
            }

        registry.register(name, source)

    def unregister(self, name: str = "serving") -> None:
        from uccl_tpu_torch.utils.stats import registry

        registry.unregister(name)
