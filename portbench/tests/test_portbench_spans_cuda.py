"""On the card, in each cell: the kernels that a traced run's host ops hold
(``split.py``) come to the traced steps' kernel time, at most a tenth of it
lies under no span of its own (``other``), every bucket reads some time,
and the MoE counters read as the cell's capacity implies.

    python -m pytest portbench/tests/test_portbench_spans_cuda.py -m cuda -s

Skips without a card.
"""

import json
from pathlib import Path

import pytest
import torch

import split

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2_718_281_829


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_spans_cover_the_traced_steps(cell_name, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from uccl_tpu_torch.ep.ops import MOE_COUNTS

    MOE_COUNTS.reset()  # this run's traced steps alone, not an earlier cell's
    rc = split.main(["--workload", cell_name, "--seed", str(SEED), "--seconds", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    result, added = map(json.loads, lines[-2:])
    with capsys.disabled():
        print(cell_name, json.dumps(added), json.dumps(result["metrics"]))
    assert result["correct"] is True
    kernel_ms, split_ms = added["kernel_ms"], added["split_ms"]
    # the buckets sum to kernel_ms by construction; what the launching ops
    # hold must come to it too, within 0.5%
    assert abs(added["unlinked_ms"]) <= 0.005 * kernel_ms
    assert split_ms["other"] <= 0.10 * kernel_ms
    assert all(split_ms[b] > 0 for b in split_ms)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    config = {w["name"]: w["config"] for w in BENCH["workloads"]}[cell_name]
    path = {c["name"]: c["file"] for c in BENCH["configs"]}[config]
    model = json.loads((ROOT / path).read_text())["model"]
    cf = model["capacity_factor"]
    # both cells' capacity cf T k / E is whole, so E x C slots = cf x the T x k
    # choices, and expert_fill = 100 (1 - drop) / cf
    assert metrics["expert_fill"] == pytest.approx(100.0 / cf * (1 - metrics["drop_pct"] / 100),
                                                   abs=0.01)
    if cf == model["moe_experts"] / model["moe_topk"]:  # capacity E/k: nothing drops
        assert metrics["drop_pct"] == 0.0
