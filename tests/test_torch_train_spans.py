"""The train step's spans and the MoE counters of the port (CPU, tiny widths).

Under a ``torch.profiler`` capture the flagship's train step opens a
``record_function`` range for each of its layer spans, and every backward
node leads back, through the forward op that created it (same thread and
sequence number), to the span that op ran under: the embedding's row gather
to ``flagship.embed``, the dispatch's and the combine's to their spans, the
slices of the stacked leaves to ``flagship.stack_slice``; under remat
``full`` as under ``none`` (followed by the benchmark's attribution,
``portbench/spans.py``). With the obs tracer and the profiler both off,
``obs.span`` is the cached null span and no range is made. The MoE counts
equal a plain count of ``sorted_from_topk``, count once a forward under
remat, and cost nothing with tracing off.
"""

import collections
import importlib.util
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uccl_tpu_torch import obs
from uccl_tpu_torch.ep import ops as ep_ops
from uccl_tpu_torch.models import flagship
from uccl_tpu_torch.models.sampling import prng_key
from uccl_tpu_torch.obs import tracer
from uccl_tpu_torch.utils import tracing

SIZE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, moe_experts=4,
            moe_topk=2, moe_ffn=48, capacity_factor=1.25, attn_impl="xla")
B, S = 2, 16
SPANS = ("flagship.embed", "flagship.attention", "moe.route", "moe.dispatch", "moe.experts",
         "moe.combine", "flagship.head", "flagship.stack_slice", "flagship.block", "adamw")
_spec = importlib.util.spec_from_file_location(
    "portbench_spans", Path(__file__).resolve().parent.parent / "portbench" / "spans.py")
_SPANS_MOD = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_SPANS_MOD)


@pytest.fixture(autouse=True)
def _quiet():
    """One intra-op thread; the tracer off and the counts zero around each
    test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.disable_tracing()
    ep_ops.MOE_COUNTS.reset()
    yield
    obs.disable_tracing()
    ep_ops.MOE_COUNTS.reset()
    torch.set_num_threads(n)


def _step(remat="full", **over):
    cfg = flagship.FlagshipConfig(**{**SIZE, "remat": remat, **over})
    params = flagship.init_params(prng_key(0), cfg, "cpu")
    step, init = flagship.make_train_step(cfg, "cpu")
    opt = init(params)
    g = torch.Generator().manual_seed(3)
    tok, tgt = (torch.randint(0, cfg.vocab, (B, S), generator=g) for _ in range(2))
    return cfg, lambda: step(params, opt, tok, tgt)


def _traced(remat):
    cfg, run = _step(remat)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return cfg, prof.events()


def _spans_of_backward_nodes(events):
    """Each backward node's name -> the span each of its instances leads
    to, by the benchmark's attribution (``portbench/spans.py``)."""
    att = _SPANS_MOD.Attribution(events)
    found = collections.defaultdict(list)
    for ev in events:
        if ev.name.startswith(_SPANS_MOD.BACKWARD):
            found[ev.name[len(_SPANS_MOD.BACKWARD):]].append(att.span(ev))
    return found


def test_a_traced_step_shows_every_span():
    _, events = _traced("full")
    names = collections.Counter(ev.name for ev in events)
    assert all(names[s] > 0 for s in SPANS), names
    assert all(ev.is_user_annotation for ev in events if ev.name in SPANS)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_backward_nodes_lead_to_their_spans(remat):
    cfg, events = _traced(remat)
    found = _spans_of_backward_nodes(events)
    n = cfg.n_layers
    # the embedding's lookup is the one index node; the MoE layer's gathers
    # are the gather pair's nodes (ep/gather.py), once a layer each
    assert found["IndexBackward0"] == ["flagship.embed"]
    assert found["_DispatchRowsBackward"] == ["moe.dispatch"] * n
    assert found["_CombineRowsBackward"] == ["moe.combine"] * n
    # every stacked leaf's slice, once a layer
    assert found["SelectBackward0"].count("flagship.stack_slice") == len(flagship._BLOCK_KEYS) * n
    assert {"flagship.attention", "moe.route", "moe.experts", "flagship.head"} <= set(
        found["MmBackward0"] + found["BmmBackward0"])


def test_spans_cost_nothing_with_tracing_off(monkeypatch):
    made = []

    def counting(name, *args):
        made.append(name)
        return torch.profiler.record_function(name, *args)

    monkeypatch.setattr(tracer, "record_function", counting)
    assert obs.span("flagship.embed", "train") is tracer._NULL_SPAN
    _, run = _step("full")
    run()
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    assert set(SPANS) <= set(made)


def test_the_tracer_records_the_step_on_its_tracks():
    _, run = _step("none")
    tr = obs.enable_tracing()
    run()
    tracks = {(e.name, e.track) for e in tr.events()}
    assert ("flagship.embed", flagship.TRACK) in tracks and ("adamw", flagship.TRACK) in tracks
    assert ("moe.dispatch", ep_ops.TRACK) in tracks
    with tracing.annotate("unit_region"):  # annotate is the obs span, and NVTX on a card
        pass
    assert tr.events()[-1].name == "unit_region"


def _routing(t, e, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, 8, generator=g)
    logits = torch.randn(t, e, generator=g)
    w = [torch.randn(e, 8, 12, generator=g), torch.randn(e, 8, 12, generator=g),
         torch.randn(e, 12, 8, generator=g)]
    return x, logits, w


@pytest.mark.parametrize("impl", ["sort", "dense"])
def test_moe_counts_equal_a_plain_count(impl):
    t, e, k, cf = 40, 4, 2, 1.0
    x, logits, w = _routing(t, e, 11)
    obs.enable_tracing()
    ep_ops.moe_ffn(x, logits, *w, num_selected=k, capacity_factor=cf, impl=impl)
    cap = int(cf * t * k / e)
    _, idx, _, _ = ep_ops._gate_topk(logits, k, True)
    kept = int(ep_ops.sorted_from_topk(idx, e, cap)[2].sum())
    got = ep_ops.MOE_COUNTS.read()
    assert (got["choices"], got["kept"], got["slots"]) == (t * k, kept, e * cap)
    assert kept < t * k  # this routing drops some
    assert got["drop_pct"] == pytest.approx(100 * (1 - kept / (t * k)))
    assert got["expert_fill"] == pytest.approx(100 * kept / (e * cap))
    assert obs.REGISTRY.sources_snapshot()["moe"] == got
    assert "moe_expert_fill" in obs.prometheus_text()


def test_capacity_e_over_k_drops_nothing():
    t, e, k = 40, 4, 2
    x, logits, w = _routing(t, e, 12)
    with profile(activities=[ProfilerActivity.CPU]):  # a capture counts too
        ep_ops.moe_ffn(x, logits, *w, num_selected=k, capacity_factor=e / k)
    got = ep_ops.MOE_COUNTS.read()
    assert got["drop_pct"] == 0.0 and got["expert_fill"] == 100.0 * k / e


@pytest.mark.parametrize("remat", ["full", "none"])
def test_moe_counts_once_a_forward(remat):
    cfg, run = _step(remat)
    run()  # tracing off: nothing counted
    assert ep_ops.MOE_COUNTS.read() == {"choices": 0, "kept": 0, "slots": 0}
    obs.enable_tracing()
    run()
    got = ep_ops.MOE_COUNTS.read()
    cap = int(cfg.capacity_factor * B * S * cfg.moe_topk / cfg.moe_experts)
    assert got["choices"] == cfg.n_layers * B * S * cfg.moe_topk  # the recompute did not count
    assert got["slots"] == cfg.n_layers * cfg.moe_experts * cap


def test_moe_counts_lose_no_update_across_threads():
    counts, n_threads, n_adds = ep_ops.MoeCounts(), 16, 300
    kept = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(n_adds):
                counts.add(4, 5, kept)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    n = n_threads * n_adds
    assert counts.read() == {"choices": 4 * n, "kept": 6 * n, "slots": 5 * n,
                             "drop_pct": pytest.approx(-50.0), "expert_fill": 120.0}
