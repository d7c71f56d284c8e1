"""The readings a cell's limits are set from: ``python3 portbench/calibrate.py
--workload <cell> --seeds 12 --control 3 --faults half_batch,frozen,doubled
--fault-seeds 3``.

For each seed it takes the program's first steps and the reference's from
the same weights and batches and prints every number ``check.py`` can
compare (the lower readings come from the program's). On the first
``--control`` seeds it does the same with each control of the reference
(``reference.CONTROLS``, or those ``--controls`` names) in the program's
place, one part of the step one precision below the configuration's, and on
the first ``--fault-seeds`` seeds with each fault of ``faults.py`` planted
under the program. One JSON line a reading, then a
summary: the largest sound reading and the smallest control and fault
reading of each number. Needs the card, as a run does; ``--out`` also
writes the lines to a file.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

import check
import faults
import run
import traffic

BASE_SEED = 3_000_000_019  # above 2**31: seeds wider than 32 signed bits work


def readings(cell, fam, ref, seed, device, *, controls, fault_names) -> list:
    layout = fam.layout(cell.model)
    batches = traffic.pool(cell.mix, cell.model["vocab"], seed, device)
    want = run.reference_record(ref, cell, layout, batches, seed, device)
    _free()
    out = []
    for kind in ["program"] + list(fault_names):
        wrap = None if kind == "program" else faults.FAULTS[kind]
        prog = run.Program(fam, cell, layout, seed, device, wrap)
        got = run.to_host(prog.first_steps(batches, layout, seed, device,
                                           cell.optimizer["b1"]))
        del prog
        _free()
        out.append({"kind": kind, "seed": seed, **_plain(check.gaps(got, want))})
    for name in controls:
        got = run.reference_record(ref, cell, layout, batches, seed, device, control=name)
        _free()
        out.append({"kind": f"control_{name}", "seed": seed, **_plain(check.gaps(got, want))})
    return out


def _plain(found):
    return {k: v["value"] for k, v in found.items()} | {f"{k}_at": v["at"]
                                                        for k, v in found.items()}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None, *, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--controls", default="", help="comma-separated; default: all")
    ap.add_argument("--faults", default="half_batch,frozen,doubled",
                    help="comma-separated faults.py names")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=BASE_SEED)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = Path(root) if root is not None else run.HERE.parent
    cell = run.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate: no card", file=sys.stderr)
            return 3
        device = "cuda:0"
        print(f"card: {run.card_line()}", file=sys.stderr, flush=True)
    if str(root) not in sys.path:
        sys.path.append(str(root))
    family = cell.cfg["family"]
    fam = run.load_module(cell.data / "families" / f"{family}.py", f"portbench_family_{family}")
    ref = run.load_module(cell.data / "reference" / f"{family}.py",
                          f"portbench_reference_{family}")
    fault_names = [f for f in args.faults.split(",") if f]
    controls = [c for c in args.controls.split(",") if c] or list(ref.CONTROLS)
    lines = []
    for i in range(args.seeds):
        seed = args.base_seed + 7919 * i
        t = time.perf_counter()
        for r in readings(cell, fam, ref, seed, torch.device(device),
                          controls=controls if i < args.control else (),
                          fault_names=fault_names if i < args.fault_seeds else ()):
            r["seconds"] = time.perf_counter() - t
            lines.append(r)
            print(json.dumps(r), flush=True)
    summary = {"workload": cell.name, "limits": cell.limits}
    for name in check.NAMES:
        sound = [r[name] for r in lines if r["kind"] == "program"]
        summary[name] = {"lower": max(sound)} | {
            kind: min(r[name] for r in lines if r["kind"] == kind)
            for kind in [f"control_{c}" for c in controls] + fault_names
            if any(r["kind"] == kind for r in lines)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
