"""The port's build of the loadable NCCL-net-shaped plugin
(``uccl_tpu_torch.p2p.endpoint.net_plugin_path``).

The port builds the unchanged ``native/`` sources into its own directory
(``build/uccl_tpu_torch/native/``), the plugin beside ``libuccl_tpu.so``.
The tests dlopen that file and drive the exported ``ucclt_net_v1`` vtable
(the ctypes structures are ``tests/test_net_plugin.py``'s): identity and
properties, a loopback send/recv with a registered buffer and a flush, and
tag matching out of order. Exact bytes; no tolerance.
"""

import ctypes
import os

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

from test_net_plugin import HANDLE_BYTES, OK, NetV1, Props, _wait
from uccl_tpu_torch.p2p import endpoint


@pytest.fixture(scope="module")
def net():
    lib = ctypes.CDLL(endpoint.net_plugin_path())  # the dlopen the ABI exists for
    vt = NetV1.in_dll(lib, "ucclt_net_v1")
    assert vt.init() == OK
    yield vt
    vt.finalize()


def _pair(net):
    handle = ctypes.create_string_buffer(HANDLE_BYTES)
    lc, sc, rc = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    assert net.listen(0, handle, ctypes.byref(lc)) == OK
    assert net.connect(0, handle, ctypes.byref(sc)) == OK
    assert net.accept(lc, ctypes.byref(rc)) == OK
    return sc, rc, lc


def test_the_plugin_is_the_ports_own_build():
    path = endpoint.net_plugin_path()
    assert os.path.basename(path) == "libuccl_tpu_net.so" and os.path.isfile(path)
    assert os.path.dirname(path) == endpoint.NATIVE_BUILD_DIR
    assert os.path.isfile(os.path.join(endpoint.NATIVE_BUILD_DIR, "libuccl_tpu.so"))
    assert endpoint.net_plugin_path() == path  # fresh: nothing rebuilt


def test_identity_props_and_loopback(net):
    assert net.name == b"uccl_tpu_dcn"
    n = ctypes.c_int(0)
    assert net.devices(ctypes.byref(n)) == OK and n.value >= 1
    props = Props()
    assert net.get_properties(0, ctypes.byref(props)) == OK
    assert props.name == b"uccl_tpu_dcn" and props.port > 0

    sc, rc, lc = _pair(net)
    payload = os.urandom(100_000)
    sbuf = ctypes.create_string_buffer(payload, len(payload))
    rbuf = ctypes.create_string_buffer(len(payload))
    mh = ctypes.c_void_p()
    assert net.reg_mr(sc, sbuf, len(payload), 0, ctypes.byref(mh)) == OK
    rreq, sreq = ctypes.c_void_p(), ctypes.c_void_p()
    assert net.irecv(rc, rbuf, len(payload), 7, None, ctypes.byref(rreq)) == OK
    assert net.isend(sc, sbuf, len(payload), 7, mh, ctypes.byref(sreq)) == OK
    assert _wait(net, sreq) == (OK, len(payload))
    assert _wait(net, rreq) == (OK, len(payload))
    assert rbuf.raw[: len(payload)] == payload
    freq = ctypes.c_void_p()
    assert net.iflush(rc, rbuf, len(payload), None, ctypes.byref(freq)) == OK
    assert _wait(net, freq)[0] == OK
    assert net.dereg_mr(sc, mh) == OK
    assert net.close_send(sc) == OK and net.close_recv(rc) == OK and net.close_listen(lc) == OK


def test_tag_matching_out_of_order(net):
    sc, rc, lc = _pair(net)
    a, b = b"A" * 512, b"B" * 2048
    ra, rb = ctypes.create_string_buffer(len(a)), ctypes.create_string_buffer(len(b))
    req1, req2 = ctypes.c_void_p(), ctypes.c_void_p()
    assert net.irecv(rc, ra, len(a), 1, None, ctypes.byref(req1)) == OK
    assert net.irecv(rc, rb, len(b), 2, None, ctypes.byref(req2)) == OK
    for tag, data in ((2, b), (1, a)):  # tag 2 first
        buf = ctypes.create_string_buffer(data, len(data))
        sreq = ctypes.c_void_p()
        assert net.isend(sc, buf, len(data), tag, None, ctypes.byref(sreq)) == OK
        assert _wait(net, sreq)[0] == OK
    assert _wait(net, req2)[1] == len(b) and _wait(net, req1)[1] == len(a)
    assert ra.raw == a and rb.raw == b
    net.close_send(sc)
    net.close_recv(rc)
    net.close_listen(lc)
