"""``python -m uccl_tpu_torch.profile_ep`` at a small size on the CPU: one
JSON line per arm with every field, and the kernel wire's layer equal to the
stock wire's (the script raises otherwise). The timings themselves mean
something only on the card."""

import json

from uccl_tpu_torch import profile_ep
from uccl_tpu_torch.models import flagship


def test_one_line_per_arm_with_every_field(monkeypatch, capsys):
    small = flagship.FlagshipConfig(**{**flagship.bench_config().__dict__, "vocab": 512,
                                       "dim": 128, "n_layers": 1, "moe_ffn": 96})
    monkeypatch.setattr(flagship, "bench_config", lambda: small)
    profile_ep.main(["--device", "cpu", "--batch", "1", "--seq", "64", "--reps", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [d["arm"] for d in lines] == [name for name, _ in profile_ep.ARMS]
    for d in lines:
        assert d["bench"] == "profile_ep" and d["device"] == "cpu" and d["world"] == 4
        assert d["tokens_per_member"] == 64
        assert set(d["verbs_ms"]) == {"dispatch", "expert_gemms", "combine"}
        for key in ("layer_ms", "enqueue_ms", "layer_async_ms", "moe_ffn_ms"):
            assert d[key] > 0, key
        assert d["enqueue_ms"] <= d["layer_async_ms"]
        assert d["device_busy_ms"] == 0.0
        assert 0 < len(d["host_top_ms"]) <= profile_ep.TOP
        assert all(v >= 0 for v in d["host_top_ms"].values())
