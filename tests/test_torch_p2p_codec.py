"""uccl_tpu_torch.p2p's wire codecs with no ml_dtypes: the lossless codec case
for case as tests/test_lossless.py holds the JAX one, the fp8 codec as
tests/test_quant.py::TestWireCompress does, and both against the JAX
package byte for byte in both directions: the port's blob of an array equals
the JAX blob of the same array, and each package decodes the other's blob to
the same bits (fp8's saturation, inf and NaN cases included, the 128-element
group's scale too).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from uccl_tpu.p2p import compress as jcompress
from uccl_tpu.p2p import lossless as jlz
from uccl_tpu_torch.p2p import lossless as lz
from uccl_tpu_torch.p2p.compress import (compressed_bound, decode_any, decode_fp8, encode,
                                         encode_fp8, maybe_compress)


@pytest.fixture(scope="module")
def rng_():
    return np.random.default_rng(0)


# numpy dtype (what the JAX package codes) and the port's torch dtype
DTYPES = [
    (np.dtype(np.float32), torch.float32),
    (np.dtype(ml_dtypes.bfloat16), torch.bfloat16),
    (np.dtype(np.float16), torch.float16),
    (np.dtype(np.float64), torch.float64),
    (np.dtype(np.int32), torch.int32),
    (np.dtype(np.int8), torch.int8),
    (np.dtype(np.uint8), torch.uint8),
    (np.dtype(np.int64), torch.int64),
]


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) as the torch tensor of
    the same bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor, flat."""
    if isinstance(x, torch.Tensor):
        x = torch.empty(x.shape, dtype=x.dtype).copy_(x).reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def assert_same_bits_or_nan(got, want):
    """Equal bits, except that a NaN need only meet a NaN: the fp8 decode
    of a group holding a NaN is NaN, and which NaN numpy's product of two
    NaNs gives depends on its loop (either operand)."""
    got = torch.empty(got.shape, dtype=got.dtype).copy_(got).float().numpy().reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


class TestRoundTrip:
    @pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d[0]))
    def test_bit_exact(self, rng_, dtype):
        npd, td = dtype
        if npd.kind in "iu":
            a = rng_.integers(-100 if npd.kind == "i" else 0, 100, 4097).astype(npd)
        else:
            a = (rng_.standard_normal(4097) * 0.02).astype(npd)
        t = to_torch(a.reshape(17, 241))
        back = lz.decode_lossless(lz.encode_lossless(t))
        assert back.dtype == td and back.shape == t.shape
        np.testing.assert_array_equal(bits(back), bits(t))

    def test_specials_survive(self):
        a = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 448.0], np.float32)
        a = np.concatenate([a, np.frombuffer(b"\x01\x00\x80\x7f" * 4, np.float32)])
        back = lz.decode_lossless(lz.encode_lossless(a))
        np.testing.assert_array_equal(back.numpy().view(np.uint32), a.view(np.uint32))

    def test_empty_and_scalarish(self):
        for a in (np.zeros((0,), np.float32), np.ones((1,), np.float32)):
            back = lz.decode_lossless(lz.encode_lossless(a))
            np.testing.assert_array_equal(back.numpy(), a)


class TestRatio:
    def test_bf16_checkpoint_beats_1p5(self, rng_):
        w = to_torch((rng_.standard_normal(1 << 19) * 0.02).astype(ml_dtypes.bfloat16))
        assert lz.ratio(w) > 1.5

    def test_low_entropy_tensors_compress_hard(self, rng_):
        gains = to_torch((1.0 + rng_.standard_normal(1 << 15) * 0.01).astype(ml_dtypes.bfloat16))
        assert lz.ratio(gains) > 3.0
        sparse = (np.where(rng_.random(1 << 18) < 0.05, rng_.standard_normal(1 << 18), 0.0)
                  * 0.01).astype(np.float32)
        assert lz.ratio(sparse) > 5.0

    def test_incompressible_overhead_is_bounded(self, rng_):
        noise = rng_.integers(0, 256, 1 << 16).astype(np.uint8)
        assert lz.encode_lossless(noise).nbytes < noise.nbytes + 256


class TestCodecRouting:
    def test_decode_any_routes_both_magics(self, rng_):
        a = (rng_.standard_normal(2048) * 0.1).astype(np.float32)
        exact = decode_any(encode(a, "lossless"))
        np.testing.assert_array_equal(exact.numpy(), a)
        lossy = decode_any(encode_fp8(a))
        assert np.abs(lossy.numpy() - a).max() < 0.05

    def test_unknown_magic_rejected(self):
        with pytest.raises(ValueError):
            decode_any(np.zeros(64, np.uint8))

    def test_unknown_codec_rejected(self):
        with pytest.raises(ValueError, match="unknown wire codec"):
            encode(np.ones(4, np.float32), "zstd")


class TestZlibFallback:
    def test_roundtrip_without_native(self, rng_, monkeypatch):
        monkeypatch.setattr(lz, "_codec_lib", False)
        a = to_torch((rng_.standard_normal(8192) * 0.02).astype(ml_dtypes.bfloat16))
        back = lz.decode_lossless(lz.encode_lossless(a))
        np.testing.assert_array_equal(bits(back), bits(a))


class TestPurePythonRansDecode:
    def test_plane_decode_matches_native_encode(self, rng_):
        if lz._native() is None:
            pytest.skip("native codec unavailable")
        plane = (rng_.standard_normal(8192) * 3).astype(np.int8).tobytes()
        tag, data = lz._encode_plane(plane)
        if tag != lz._RANS:
            pytest.skip("plane did not take the rANS path")
        assert lz._rans_decode_py(data, len(plane)) == plane

    def test_blob_decodes_without_native(self, rng_, monkeypatch):
        if lz._native() is None:
            pytest.skip("native codec unavailable")
        a = to_torch((rng_.standard_normal(8192) * 0.02).astype(ml_dtypes.bfloat16))
        blob = lz.encode_lossless(a)
        monkeypatch.setattr(lz, "_codec_lib", False)
        np.testing.assert_array_equal(bits(lz.decode_lossless(blob)), bits(a))

    def test_corrupt_plane_rejected(self):
        with pytest.raises(ValueError):
            lz._rans_decode_py(b"\x01" + b"\x00" * 600, 64)

    def test_native_codec_is_the_ports_build(self):
        from uccl_tpu_torch.p2p import endpoint as tep

        lib = lz._native()
        if lib is None:
            pytest.skip("native codec unavailable")
        assert lib._name == tep._build_if_needed()


class TestFuzzRoundTrip:
    def test_fuzz_bit_exact(self, rng_):
        shapes = [(0,), (1,), (7,), (256,), (33, 5), (4, 3, 2, 5), (1023,)]
        dists = [
            lambda s: rng_.standard_normal(s) * 0.02,
            lambda s: rng_.standard_normal(s) * 1e8,
            lambda s: np.zeros(s),
            lambda s: rng_.integers(-3, 3, s).astype(float),
            lambda s: rng_.uniform(-1, 1, s),
        ]
        cases = 0
        for npd, td in DTYPES:
            for shape in shapes:
                for make in dists:
                    with np.errstate(over="ignore", invalid="ignore"):
                        a = np.asarray(make(shape)).astype(npd)
                    t = to_torch(a)
                    back = lz.decode_lossless(lz.encode_lossless(t))
                    assert back.dtype == td and tuple(back.shape) == shape
                    np.testing.assert_array_equal(bits(back), bits(t))
                    cases += 1
        assert cases == len(DTYPES) * len(shapes) * len(dists)

    def test_fuzz_python_decode_of_native_blobs(self, rng_, monkeypatch):
        if lz._native() is None:
            pytest.skip("native codec unavailable")
        arrays = [
            to_torch((rng_.standard_normal(4096) * 0.02).astype(ml_dtypes.bfloat16)),
            to_torch(rng_.integers(-2, 2, 2048).astype(np.int8)),
            to_torch((rng_.standard_normal(1000) * 5).astype(np.float32)),
        ]
        blobs = [lz.encode_lossless(a) for a in arrays]
        monkeypatch.setattr(lz, "_codec_lib", False)
        for a, blob in zip(arrays, blobs):
            np.testing.assert_array_equal(bits(lz.decode_lossless(blob)), bits(a))


class TestWireCompress:
    def test_roundtrip_f32(self, rng):
        x = (rng.standard_normal((3, 5, 130)) * 7).astype(np.float32)
        blob = encode_fp8(x)
        y = decode_fp8(blob)
        assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
        assert np.abs(y.numpy() - x).max() / np.abs(x).max() < 0.05
        assert blob.nbytes < x.nbytes / 3

    def test_roundtrip_bf16(self, rng):
        x = to_torch((rng.standard_normal(1000) * 3).astype(ml_dtypes.bfloat16))
        y = decode_fp8(encode_fp8(x))
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        xf = x.float()
        assert ((y.float() - xf).abs().max() / xf.abs().max()).item() < 0.07

    def test_bound_covers_blob(self, rng):
        for shape in [(7,), (129,), (4, 4, 4), (1000, 3)]:
            x = rng.standard_normal(shape).astype(np.float32)
            assert encode_fp8(x).nbytes <= compressed_bound(shape, np.float32)

    def test_threshold_policy(self, rng):
        small = rng.standard_normal(8).astype(np.float32)
        out, did = maybe_compress(small)
        assert not did and out is small
        ints = np.arange(1 << 18, dtype=np.int32)
        out, did = maybe_compress(ints)
        assert not did
        big = rng.standard_normal(1 << 18).astype(np.float32)
        out, did = maybe_compress(big)
        assert did and out.dtype == np.uint8

    def test_device_tensor_refused(self):
        with pytest.raises(ValueError, match="host"):
            encode_fp8(torch.zeros(4, device="meta"))


# -- cross-package bytes ------------------------------------------------------


def _fp8_cases():
    rng = np.random.default_rng(1)
    nans = np.array([0xFFC00000, 0x7FC00001, 0xFFC12345, 0x7F800001], np.uint32).view(np.float32)
    specials = np.array([0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-30, -1e-30, 448, 449, 464,
                         465, 479, 480, 500, 1e38, -1e38, 3.4e38, 1e-40, -1e-45], np.float32)
    return {
        "normal": rng.standard_normal((7, 300)).astype(np.float32),
        "specials": np.concatenate([specials, rng.standard_normal(200).astype(np.float32) * 100]),
        "all_nan": np.full(130, np.nan, np.float32),
        "inf_group": np.concatenate([np.full(64, np.inf, np.float32), np.ones(64, np.float32)]),
        "neg_inf_group": np.concatenate([np.full(64, -np.inf, np.float32),
                                         -np.ones(64, np.float32)]),
        "nan_payloads": np.concatenate([nans, rng.standard_normal(124).astype(np.float32)]),
        "nan_tail": np.concatenate([rng.standard_normal(124).astype(np.float32) * 1e3, nans]),
        "zeros": np.zeros((3, 128), np.float32),
        "tiny_group": (rng.standard_normal(128) * 1e-14).astype(np.float32),
        "empty": np.zeros((0,), np.float32),
        "scalar_like": np.ones((1,), np.float32) * 3,
        "f16": rng.standard_normal((3, 5, 7)).astype(np.float16),
        "f16_big": np.clip(rng.standard_normal(300) * 3e4, -65504, 65504).astype(np.float16),
    }


@pytest.mark.parametrize("name,as_bf16", [(n, False) for n in _fp8_cases()] + [
    (n, True) for n, a in _fp8_cases().items() if a.dtype == np.float32])
def test_fp8_bytes_equal_jax_both_ways(name, as_bf16):
    a = _fp8_cases()[name]
    if as_bf16:  # the bf16 variants of the f32 cases
        with np.errstate(all="ignore"):
            a = a.astype(ml_dtypes.bfloat16)
    with np.errstate(all="ignore"):
        want = jcompress.encode_fp8(a)
        got = encode_fp8(to_torch(a))
        np.testing.assert_array_equal(got, want)
        # decode each package's blob in the other: the same bits
        j_of_port, t_of_jax = jcompress.decode_fp8(got), decode_fp8(want)
    assert t_of_jax.dtype == to_torch(j_of_port[:0]).dtype
    assert tuple(t_of_jax.shape) == j_of_port.shape
    assert_same_bits_or_nan(t_of_jax, j_of_port)


@pytest.mark.parametrize("group", [32, 128, 256])
def test_fp8_group_scales_equal_jax(group):
    a = (np.random.default_rng(group).standard_normal((5, 333)) * 40).astype(np.float32)
    np.testing.assert_array_equal(encode_fp8(a, group), jcompress.encode_fp8(a, group))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d[0]))
def test_lossless_bytes_equal_jax_both_ways(dtype):
    npd, _ = dtype
    rng = np.random.default_rng(9)
    with np.errstate(all="ignore"):
        if npd.kind in "iu":
            a = rng.integers(-50 if npd.kind == "i" else 0, 50, (31, 77)).astype(npd)
        else:
            a = (rng.standard_normal((31, 77)) * 0.05).astype(npd)
    want = jlz.encode_lossless(a)
    got = lz.encode_lossless(to_torch(a))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bits(lz.decode_lossless(want)), bits(a))
    np.testing.assert_array_equal(bits(jlz.decode_lossless(got)), bits(a))
    np.testing.assert_array_equal(bits(decode_any(want)), bits(jcompress.decode_any(got)))
