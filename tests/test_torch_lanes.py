"""The collective kernels' shared flag regions and error checks
(uccl_tpu_torch/collective/lanes.py), on the CPU.

The kernels themselves need the card (tests/test_torch_cuda_ccl.py and
test_torch_cuda_ep.py launch them and plant timeouts). Here the error words
live on the CPU and are written by hand, which is what a timed-out kernel
does to them; that drives every rule of the host side: the message, the
clearing of the word, one read per scope, nesting, and the libraries'
shared spin bound. No JAX counterpart: a Pallas semaphore has no error word.
"""

import pytest
import torch

from uccl_tpu_torch.collective import lanes, ring_ccl
from uccl_tpu_torch.ep import pallas_a2a
from uccl_tpu_torch.utils import build

CPU = torch.device("cpu")


def _regions():
    return lanes.Lanes((2, 3), ("k0", "k1"), ("w0", "w1"), "peer")


def _fail(lane, kernel=1, member=2, step=3, peer=0, channel=7, what=1):
    lane.err.copy_(torch.tensor([1, kernel, member, step, lane.cid, peer, channel, what],
                                dtype=torch.int32))


def test_a_region_per_device_and_id():
    regions = _regions()
    a = regions.get(CPU, 5)
    assert regions.get(CPU, 5) is a and regions.get(CPU, 6) is not a
    assert a.flags.shape == (2, 3) and a.flags.dtype == torch.int64
    assert a.err.shape == (8,) and not a.err.any()
    assert [a.next_epoch() for _ in range(3)] == [1, 2, 3]
    a.epoch = (1 << 31) - 1
    with pytest.raises(RuntimeError, match="epoch counter exhausted"):
        a.next_epoch()


def test_a_set_error_word_raises_names_the_wait_and_clears():
    lane = _regions().get(CPU, 5)
    lane.check("verb")  # a clear word passes
    _fail(lane)
    with pytest.raises(RuntimeError) as e:
        lane.check("verb")
    msg = str(e.value)
    for part in ("verb: kernel k1", "w1 wait", "member 2", "step 3", "collective id 5",
                 "peer 0", "channel 7"):
        assert part in msg, part
    assert not lane.err.any()
    lane.check("verb")


def test_a_scope_reads_once_at_its_end():
    regions = _regions()
    a, b = regions.get(CPU, 1), regions.get(CPU, 2)
    with pytest.raises(RuntimeError, match="second: kernel k0"):
        with lanes.one_check():
            _fail(b, kernel=0)
            b.check("second")  # noted, not read
            a.check("first")
            a.check("first again")
            assert b.err[0] == 1
    assert not b.err.any()


def test_nested_scopes_defer_to_the_outermost():
    lane = _regions().get(CPU, 3)
    with pytest.raises(RuntimeError, match="inner"):
        with lanes.one_check():
            with lanes.one_check():
                _fail(lane)
                lane.check("inner")
            assert lane.err[0] == 1  # the inner scope's end read nothing


def test_a_scope_left_by_an_exception_checks_nothing():
    lane = _regions().get(CPU, 4)
    with pytest.raises(KeyError):
        with lanes.one_check():
            _fail(lane)
            lane.check("x")
            raise KeyError("first")
    assert lane.err[0] == 1  # the word waits for the next check
    with pytest.raises(RuntimeError, match="timed out"):
        lane.check("next")


def test_check_all_takes_many_lanes_and_the_first_set_word():
    regions = _regions()
    ls = [regions.get(CPU, c) for c in range(4)]
    lanes.check_all([(lane, f"l{lane.cid}") for lane in ls])
    _fail(ls[2])
    _fail(ls[3])
    with pytest.raises(RuntimeError, match="l2: "):
        lanes.check_all([(lane, f"l{lane.cid}") for lane in ls + ls])
    assert not ls[2].err.any() and ls[3].err[0] == 1
    ls[3].err.zero_()


def test_both_libraries_share_one_spin_bound_and_their_limits():
    assert ring_ccl._REGIONS.flag_shape == (lanes.MAX_MEMBERS, 2, lanes.MAX_CHANNELS, 2)
    assert pallas_a2a._REGIONS.flag_shape == (lanes.MAX_MEMBERS, lanes.MAX_CHANNELS,
                                              lanes.MAX_MEMBERS + 1)
    assert ring_ccl.MAX_MEMBERS == pallas_a2a.MAX_MEMBERS == lanes.MAX_MEMBERS
    assert lanes.SPIN_TIMEOUT_MS.name == "SPIN_TIMEOUT_MS"
    assert not hasattr(ring_ccl, "SPIN_TIMEOUT_MS") and not hasattr(pallas_a2a,
                                                                    "SPIN_TIMEOUT_MS")
    lane = pallas_a2a._lane(CPU, 99)
    assert lane.owner is pallas_a2a._REGIONS and ring_ccl._lane(CPU, 99) is not lane


@pytest.mark.parametrize("edit", ["source", "header", "other source"])
def test_library_name_follows_its_source_and_the_shared_headers(tmp_path, monkeypatch, edit):
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("a")
    target = {"source": "a.cu", "header": "shared.cuh", "other source": "b.cu"}[edit]
    (tmp_path / target).write_text((tmp_path / target).read_text() + "// edited\n")
    assert (build.library_path("a") != before) == (edit != "other source")
