"""``spans.py`` on the CPU: a fixed event list charged kernel by kernel, and
``split.py`` around a traced run of the tiny cell. A real step's backward
nodes reaching the program's spans is tested with the program
(``tests/test_torch_train_spans.py``)."""

import contextlib
import io
import json
from collections import namedtuple
from types import SimpleNamespace

import pytest
import torch

import spans
import split
import tracekit
from test_portbench_harness import SEED, tiny_root  # noqa: F401  (a fixture)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
FWD, BWD = 1, 2  # thread ids
Kernel = namedtuple("Kernel", ["name", "device", "duration"])  # as the profiler's


def _ev(id_, name, start, end, parent=None, seq=-1, thread=FWD, fwd_thread=0, device=CPU,
        annotation=False):
    return SimpleNamespace(id=id_, name=name, time_range=SimpleNamespace(start=start, end=end),
                           cpu_parent=parent, sequence_nr=seq, thread=thread,
                           fwd_thread=fwd_thread, device_type=device,
                           is_user_annotation=annotation, kernels=[])


def _events():
    """A forward with nested spans, a backward on another thread (two nodes
    and a recompute), AdamW, and the kernels they launched."""
    ev = {}
    ev["embed"] = _ev(1, "flagship.embed", 0, 10, annotation=True)
    ev["lookup"] = _ev(2, "aten::index", 1, 5, ev["embed"], seq=7)
    ev["block"] = _ev(3, "flagship.block", 10, 40, annotation=True)
    ev["early"] = _ev(4, "aten::arange", 11, 11.5, ev["block"], seq=9)  # peeks 9, creates none
    ev["dispatch"] = _ev(5, "moe.dispatch", 12, 20, ev["block"], annotation=True)
    ev["gather"] = _ev(6, "aten::index", 13, 18, ev["dispatch"], seq=9)
    ev["residual"] = _ev(7, "aten::add", 25, 30, ev["block"], seq=10)
    ev["bw_index"] = _ev(8, spans.BACKWARD + "IndexBackward0", 50, 60, seq=9, thread=BWD,
                         fwd_thread=FWD)
    ev["node"] = _ev(9, "IndexBackward0", 50, 59, ev["bw_index"], seq=9, thread=BWD,
                     fwd_thread=FWD)
    ev["put"] = _ev(10, "aten::index_put_", 51, 58, ev["node"], thread=BWD)
    ev["bw_embed"] = _ev(11, spans.BACKWARD + "IndexBackward0", 60, 70, seq=7, thread=BWD,
                         fwd_thread=FWD)
    ev["put2"] = _ev(12, "aten::index_put_", 61, 69, ev["bw_embed"], thread=BWD)
    ev["bw_mm"] = _ev(13, spans.BACKWARD + "MmBackward0", 70, 79, seq=99, thread=BWD,
                      fwd_thread=FWD)
    ev["again"] = _ev(14, "moe.experts", 71, 75, ev["bw_mm"], thread=BWD, annotation=True)
    ev["bmm"] = _ev(15, "aten::bmm", 72, 74, ev["again"], seq=3, thread=BWD)
    ev["adamw"] = _ev(16, "adamw", 80, 90, annotation=True)
    ev["mul"] = _ev(17, "aten::mul_", 81, 85, ev["adamw"])
    kernels = [  # (linked op, start, end, bucket)
        ("lookup", 2, 4, "embed"), ("gather", 14, 17, "dispatch"), ("residual", 26, 28, "other"),
        ("put", 52, 57, "dispatch"), ("put2", 62, 68, "embed"), ("bmm", 72, 73.5, "expert"),
        ("mul", 82, 84, "adamw"), (None, 86, 87, "other"), ("mul", 88, 95, "adamw"),
    ]
    devs = []
    for i, (op, s, e, _) in enumerate(kernels):
        devs.append(_ev(100 + i, f"kernel_{i}", s, e, device=CUDA))
        if op is not None:  # the launching op holds it
            ev[op].kernels.append(Kernel(f"kernel_{i}", 0, e - s))
    # the dispatch span's shadow on the device, which the profiler links to it
    devs.append(_ev(200, "moe.dispatch", 12, 20, device=CUDA, annotation=True))
    ev["dispatch"].kernels.append(Kernel("moe.dispatch", 0, 8))
    return list(ev.values()) + devs, kernels


def test_a_fixed_event_list_is_charged_kernel_by_kernel():
    events, kernels = _events()
    events.append(_ev(300, tracekit.WINDOW_SPAN, 0, 100, annotation=True))
    trace = tracekit.Trace.from_profiler(SimpleNamespace(events=lambda: events))
    assert len(trace.kernels) == len(kernels)  # not the span's shadow
    got = spans.split_us(events, trace.kernels)
    want = dict.fromkeys(spans.BUCKETS, 0.0)
    for _, s, e, bucket in kernels:
        want[bucket] += e - s
    want["unlinked"] = 87.0 - 86.0  # the kernel no op holds, in other too
    assert got == pytest.approx(want)
    assert sum(got[b] for b in spans.BUCKETS) == pytest.approx(
        sum(e - s for _, s, e, _ in kernels))
    assert set(spans.SPANS.values()) <= set(spans.BUCKETS)


def test_split_runs_the_tiny_cell_and_adds_one_line(tiny_root):  # noqa: F811
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = split.main(["--workload", "tiny.b4-s32", "--seed", str(SEED), "--seconds", "0.3"],
                        device="cpu", root=tiny_root)
    assert rc == 0
    result, added = map(json.loads, out.getvalue().strip().splitlines()[-2:])
    assert result["correct"] is True and "breakdown" in result
    assert result["metrics"] == {"traced_steps": {"value": 3.0, "unit": "steps"}}
    assert set(added["split_ms"]) == set(spans.BUCKETS)
    assert added["kernel_ms"] == 0.0 and sum(added["split_ms"].values()) == 0.0  # no card
    assert added["unlinked_ms"] == 0.0
    assert added["traced_step_ms"] > 0
