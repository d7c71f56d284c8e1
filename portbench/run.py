"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout that holds ``uccl_tpu_torch``, on one card,
and prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit, which also end
standard error).

Everything the run needs is found by name. ``BENCHMARK.json`` pairs the cell
with a configuration (its ``file``, whose ``family`` names
``families/<family>.py``, the adapter to the program, and
``reference/<family>.py``, the plain reference) and a traffic mix
(``traffic/<traffic>.json``, read by ``traffic.py``); the cell's limits are
in ``workloads/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``'s ``read(run)``, which returns None when it finds
nothing to read.

A run: set-up draws the weights and a pool of batches on the card from the
seed, builds the program's train step and takes its first three steps on
three distinct batches, recording each step's loss, step 1's gradient (from
the optimizer's first moment) and how far the three steps moved each leaf.
That is the set-up time, ``setup_s``, from process start. The window then
runs whole steps on the next batches for ``--seconds`` and ends on a
synchronised step boundary: ``step_ms`` is its length over its steps,
``peak_gib`` the most memory allocated in it. ``--trace 1`` runs the same
window, then a few steps under ``torch.profiler`` for the per-layer
metrics. Then the program's state is freed, the reference takes the same
three steps from the same weights and batches, and ``check.py`` decides
``correct``, together with no non-finite window loss and no departure from
the float32 state and products the configuration states
(:func:`float32_departures`).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import check  # noqa: E402
import flops  # noqa: E402
import tracekit  # noqa: E402
import traffic  # noqa: E402
import weights  # noqa: E402

SETUP_STEPS = 3  # the steps the reference follows
TRACE_STEPS = 3  # steps under the profiler, after one it discards
FORBIDDEN = ("jax", "jaxlib", "flax", "uccl_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, cell: str) -> SimpleNamespace:
    """The cell's entries and files, found by name under ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(cell)
    if entry is None:
        raise SystemExit(f"portbench: no workload {cell!r} in BENCHMARK.json")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    cfg = json.loads((root / config["file"]).read_text())
    data = root / "portbench"
    per_layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return SimpleNamespace(
        name=cell, entry=entry, cfg=cfg, model=cfg["model"], optimizer=cfg["optimizer"],
        mix=json.loads((data / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((data / "workloads" / f"{cell}.json").read_text())["limits"],
        e2e=bench["end_to_end"], per_layer=per_layer, data=data)


def use_cache_dirs(root: Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Device:
    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def name(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.cuda else "cpu"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unavailable"


class Program:
    """The program's train step, its weights and optimizer state: one object,
    built once, driven by set-up and by the window alike."""

    def __init__(self, fam, cell, layout, seed, device, wrap=None):
        self.fam = fam
        self.params = weights.tree(layout, seed, device)
        step, init = fam.make_step(cell.model, cell.optimizer, device)
        self.train_step = wrap(step) if wrap is not None else step
        self.opt_state = init(self.params)

    def step(self, batch) -> torch.Tensor:
        self.params, self.opt_state, metrics = self.train_step(self.params, self.opt_state,
                                                               *batch)
        return metrics["loss"]

    def first_steps(self, batches, layout, seed, device, b1) -> dict:
        """Steps 1-3 and what the comparison reads of them (device tensors)."""
        losses, grad = [], None
        for i in range(SETUP_STEPS):
            losses.append(self.step(batches[i]).detach())
            if i == 0:  # step 1's gradient: the first moment is (1 - b1) g
                grad = weights.norms(layout, self.fam.first_moment(self.opt_state),
                                     1.0 / (1.0 - b1))
        change = weights.change_norms(layout, self.params, seed, device)
        return {"losses": losses, "grad": grad, "change": change}


def to_host(record: dict) -> dict:
    return {"losses": [float(x) for x in record["losses"]],
            "grad": {k: float(v) for k, v in record["grad"].items()},
            "change": {k: float(v) for k, v in record["change"].items()}}


def float32_departures(cell, params, opt_state) -> dict:
    """Where the program left what the configuration states in float32:
    ``state_dtype``, its floating parameter and optimizer-state tensors in
    another dtype than ``optimizer.state_dtype``; ``tf32_matmul``, 1 if
    torch lets float32 matrix products run in TF32."""
    stated = getattr(torch, cell.optimizer["state_dtype"])

    def tensors(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in tensors(v)]
        return [tree] if torch.is_tensor(tree) else []

    other = sum(t.is_floating_point() and t.dtype != stated
                for t in tensors(params) + tensors(opt_state))
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest")
    return {"state_dtype": int(other), "tf32_matmul": int(tf32)}


def reference_record(ref, cell, layout, batches, seed, device, control="") -> dict:
    """The reference's record of the same steps from the same weights."""
    params, losses, grad = ref.train(lambda: weights.tree(layout, seed, device), batches,
                                     cell.model, cell.optimizer, control=control,
                                     steps=SETUP_STEPS)
    change = {k: float(v) for k, v in weights.change_norms(layout, params, seed, device).items()}
    return {"losses": losses, "grad": grad, "change": change}


def plain(x):
    """A number for the JSON line: non-finite ones become null."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None, *, device=None, root: Path = None, wrap=None) -> int:
    """One run. ``device`` set (a test's CPU rehearsal) skips the look for a
    card; ``wrap`` wraps the program's train step (a test's planted fault)."""
    args = parse(argv)
    root = Path(root) if root is not None else HERE.parent
    cell = load_cell(root, args.workload)
    use_cache_dirs(root)
    chips = cell.entry["chips"]
    if device is None:
        if not torch.cuda.is_available():
            print("portbench: torch.cuda.is_available() is False: no card", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < chips:
            print(f"portbench: {torch.cuda.device_count()} card(s), the cell asks for {chips}",
                  file=sys.stderr)
            return 3
        device = "cuda:0"
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    if str(root) not in sys.path:
        sys.path.append(str(root))  # uccl_tpu_torch, the program
    family = cell.cfg["family"]
    fam = load_module(cell.data / "families" / f"{family}.py", f"portbench_family_{family}")
    ref = load_module(cell.data / "reference" / f"{family}.py", f"portbench_reference_{family}")
    dev = Device(device)
    seed = args.seed
    layout = fam.layout(cell.model)
    batches = traffic.pool(cell.mix, cell.model["vocab"], seed, dev.device)
    if len(batches) <= SETUP_STEPS:
        raise SystemExit(f"portbench: a pool of {len(batches)} batches; the first "
                         f"{SETUP_STEPS} steps need distinct ones and the window one more")

    prog = Program(fam, cell, layout, seed, dev.device, wrap)
    record = prog.first_steps(batches, layout, seed, dev.device, cell.optimizer["b1"])
    dev.sync()
    setup_s = time.perf_counter() - T0
    setup_peak = dev.peak()

    # the window: whole steps on the next batches, ending on a synced boundary
    dev.reset_peak()
    losses, n = [], SETUP_STEPS
    dev.sync()
    t0 = time.perf_counter()
    while True:
        losses.append(prog.step(batches[n % len(batches)]).detach())
        n += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    dev.sync()
    window_s = time.perf_counter() - t0
    steps = n - SETUP_STEPS
    window_peak = dev.peak()

    metrics, run_device, breakdown = {}, {}, None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.cuda else [])
        traces = []  # the active cycle's, read as it closes

        def keep(p):
            traces.append(tracekit.Trace.from_profiler(p))

        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=keep) as prof:
            losses.append(prog.step(batches[n % len(batches)]).detach())
            n += 1
            dev.sync()
            prof.step()  # the warm-up step's events are dropped
            before = fam.flash_launches()
            with record_function(tracekit.WINDOW_SPAN):
                for _ in range(TRACE_STEPS):
                    losses.append(prog.step(batches[n % len(batches)]).detach())
                    n += 1
                dev.sync()
            after = fam.flash_launches()
            prof.step()
        (trace,) = traces
        run = SimpleNamespace(
            model=cell.model, mix=cell.mix, family=fam, device_name=dev.name(),
            peaks=flops.peaks(dev.name()), steps=steps, window_s=window_s, trace=trace,
            trace_steps=TRACE_STEPS,
            flash_launches={k: after[k] - before.get(k, 0) for k in after})
        for m in cell.per_layer:
            reader = load_module(cell.data / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        run_device = {"busy_s": trace.busy_s, "window_s": trace.window_s}
        breakdown = {"device_ops": trace.top_kernels(10), "idle_gaps": trace.idle_gaps(10)}
    else:
        values = {"step_ms": 1e3 * window_s / steps, "peak_gib": window_peak / 2**30,
                  "setup_s": setup_s}
        for m in cell.e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    departures = float32_departures(cell, prog.params, prog.opt_state)
    finite = torch.stack(losses).float().isfinite()
    attempted = int(finite.numel())
    failed = attempted - int(finite.sum())
    prog_record = to_host(record)
    memory_peak = max(setup_peak, window_peak)
    del prog, record, losses
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()

    # the reference, on the same weights and batches, once the program is gone
    dev.reset_peak()
    t_ref = time.perf_counter()
    ref_record = reference_record(ref, cell, layout, batches, seed, dev.device)
    dev.sync()
    print(f"reference: {SETUP_STEPS} steps in {time.perf_counter() - t_ref:.2f} s, peak "
          f"{dev.peak() / 2**30:.2f} GiB", file=sys.stderr)
    correct, checks, lines = check.judge(check.gaps(prog_record, ref_record), cell.limits)
    for name, value in {"failed_steps": failed, **departures}.items():
        checks[name] = {"value": value, "limit": 0}
        lines.append(f"check {name} {value} limit 0")
        correct = correct and value == 0

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark may load neither JAX nor the "
              "JAX package", file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.cuda else "cpu", "kind": dev.name(),
                         "count": chips, "memory_peak_bytes": memory_peak, **run_device}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
