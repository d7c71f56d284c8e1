"""The copied FLOP count and the flash kernels' least times against numbers
worked out by hand."""

import json
from pathlib import Path

import pytest

import flops

BENCH = Path(__file__).resolve().parent.parent


def _model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


def test_flagship_model_flops():
    # per layer: wq 1024*1024 + wk, wv 2*1024*256 + wo 1024*1024 + router
    # 1024*8 + 2 experts * 3 * 1024*2816 = 19,931,136; 4 layers + head
    # 1024*16384 = 96,501,760 active; causal attention 4*2*16*64*1024
    per_token = 3 * (2 * 96_501_760 + 8_388_608)
    assert per_token == 604_176_384
    assert flops.model_flops_per_token(_model("flagship-moe"), 1024) == per_token
    # 19.80 TFLOP a step at 32,768 tokens
    assert per_token * 32 * 1024 == pytest.approx(19.798e12, rel=1e-4)


def test_mixtral_model_flops():
    # per layer: wq 4096*4096 + wk, wv 2*4096*1024 + wo 4096*4096 + router
    # 4096*8 + 2 experts * 3 * 4096*14336 = 394,297,344; 2 layers + head
    # 4096*32000 = 919,666,688 active; causal attention 2*2*32*128*4096
    per_token = 3 * (2 * 919_666_688 + 67_108_864)
    assert per_token == 5_719_326_720
    assert flops.model_flops_per_token(_model("mixtral-8x7b"), 4096) == per_token
    assert per_token * 4096 == pytest.approx(23.43e12, rel=1e-3)


@pytest.mark.parametrize("kernel,ms", [("flash_fwd", 0.0174), ("flash_bwd_dq", 0.0261),
                                       ("flash_bwd_dkv", 0.0348)])
def test_flash_least_times_match_the_kernel_table(kernel, ms):
    """PERF.md's kernel table: B1-B3 at B 8, S 1024, H 16, Hkv 4, D 64, causal."""
    p = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    least = flops.flash_least_s(kernel, 8, 1024, 16, 4, 64, causal=True, itemsize=2,
                                flops_peak=p["bfloat16"], hbm=p["hbm"])
    assert least * 1e3 == pytest.approx(ms, rel=0.01)


def test_a_card_missing_from_the_table_has_no_peaks():
    assert flops.peaks("cpu") is None
