"""On the card, at each cell's own size: the control (the reference with its
products one precision below the configuration's), the reference with its
parameters held in bfloat16, and a fault planted under the program each
fail the cell's committed limits on three seeds; the program passes them.

    python -m pytest portbench/tests/test_portbench_cuda.py -m cuda

Skips without a card.
"""

import json
from pathlib import Path

import pytest
import torch

import calibrate
import check
import run

ROOT = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_and_a_fault_fail_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = run.load_cell(ROOT, cell_name)
    family = cell.cfg["family"]
    fam = run.load_module(cell.data / "families" / f"{family}.py", f"portbench_family_{family}")
    ref = run.load_module(cell.data / "reference" / f"{family}.py",
                          f"portbench_reference_{family}")
    for i in range(3):
        seed = calibrate.BASE_SEED + 104_729 * (i + 1)
        for r in calibrate.readings(cell, fam, ref, seed, torch.device("cuda:0"),
                                    controls=["products", "params"],
                                    fault_names=["half_batch"]):
            found = {name: {"value": r[name], "at": r[f"{name}_at"]} for name in check.NAMES}
            correct, _, lines = check.judge(found, cell.limits)
            assert correct == (r["kind"] == "program"), (r["kind"], seed, lines)
