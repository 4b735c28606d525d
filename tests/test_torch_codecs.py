"""The port's codecs and bit-plane carrier against the JAX package.

Every comparison is bit-exact: codes and planes as int32, decoded
floats as int32 bit patterns (so -0 != +0 and NaN payloads count).
Random inputs come from numpy seeds and go through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitslice as jbs
from repro.core import softfloat as jsf
from repro_torch.core import bitslice as tbs
from repro_torch.core import softfloat as tsf
from repro_torch.core.fpformat import HOBFLOPS_FORMATS, RNE, RTZ, FPFormat

FORMATS = ["hobflops8", "hobflops9", "hobflops16"]


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _special_f32(rng, n=4096):
    """Random f32 over many binades plus NaN, +-inf, +-0, f32
    subnormals, overflow and values on rounding ties."""
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n))
         ).astype(np.float32)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                        1e-45, -1e-45, 1e-39, -3e-39, 3e38, -3e38, 1e6,
                        -1e6, 1.0625, 1.1875, 65504.0, 2.0 ** -20],
                       np.float32)
    return np.concatenate([special, x])


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("rounding", [RNE, RTZ])
def test_encode_decode_match_jax(name, rounding):
    fmt = HOBFLOPS_FORMATS[name]
    x = _special_f32(np.random.default_rng(len(name)))
    want = np.array(jsf.encode_jnp(x, fmt, rounding))
    got = tsf.encode_torch(torch.from_numpy(x), fmt, rounding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dec_want = _bits(jsf.decode_jnp(want, fmt))
    dec_got = tsf.decode_torch(torch.from_numpy(want), fmt)
    np.testing.assert_array_equal(_bits(dec_got.numpy()), dec_want)


@pytest.mark.parametrize("name", ["hobflops8", "hobflops9"])
def test_every_code_exhaustive(name):
    """Every code word of the format: decode, and encode of the decoded
    value, agree with the JAX package bit for bit."""
    fmt = HOBFLOPS_FORMATS[name]
    codes = np.arange(1 << fmt.nbits, dtype=np.int32)
    dec_want = np.asarray(jsf.decode_jnp(codes, fmt))
    dec_got = tsf.decode_torch(torch.from_numpy(codes), fmt).numpy()
    np.testing.assert_array_equal(_bits(dec_got), _bits(dec_want))
    for rounding in (RNE, RTZ):
        np.testing.assert_array_equal(
            tsf.encode_torch(torch.from_numpy(dec_got), fmt,
                             rounding).numpy(),
            np.asarray(jsf.encode_jnp(dec_want, fmt, rounding)))


def test_numpy_oracles_are_the_references():
    """The copied numpy half is the reference's: encode/decode and the
    fp_* oracles on every hobflops8 code pair."""
    fmt = HOBFLOPS_FORMATS["hobflops8"]
    fmt_out = fmt.mult_out()
    n = 1 << fmt.nbits
    x = np.repeat(np.arange(n), n)
    y = np.tile(np.arange(n), n)
    for fn, args in ((tsf.fp_mul, (fmt, fmt_out)), (tsf.fp_add, (fmt,)),
                     (tsf.fp_max, (fmt,))):
        ref = getattr(jsf, fn.__name__)
        np.testing.assert_array_equal(fn(x, y, *args), ref(x, y, *args))
    v = np.random.default_rng(1).standard_normal(1000) * 100
    np.testing.assert_array_equal(tsf.encode(v, fmt), jsf.encode(v, fmt))
    np.testing.assert_array_equal(
        _bits(tsf.decode(np.arange(n), fmt)), _bits(jsf.decode(np.arange(n),
                                                                fmt)))


@pytest.mark.parametrize("shape,nbits", [((70,), 9), ((3, 33), 11),
                                          ((2, 4, 64), 12), ((5, 1), 10)])
def test_pack_unpack_match_jax(shape, nbits):
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(0, 1 << nbits, shape).astype(np.int32)
    want = np.asarray(jbs.pack_planes(jnp.asarray(codes), nbits))
    got = tbs.pack_planes(torch.from_numpy(codes), nbits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tbs.unpack_planes(got).numpy(),
                                  np.asarray(jbs.unpack_planes(want)))
    # Bit 31 of a lane word is the sign bit of the int32: the trap of an
    # int64 sum that does not wrap back.
    full = np.full(shape[:-1] + (32,), (1 << nbits) - 1, np.int32)
    np.testing.assert_array_equal(
        tbs.pack_planes(torch.from_numpy(full), nbits).numpy(),
        np.asarray(jbs.pack_planes(jnp.asarray(full), nbits)))


@pytest.mark.parametrize("geom", [
    dict(kh=2, kw=2, stride=2, pad_h=0, pad_w=0, fill_code=0),
    dict(kh=3, kw=3, stride=1, pad_h=2, pad_w=2, fill_code=0b1100101101),
    dict(kh=3, kw=2, stride=2, pad_h=1, pad_w=1, fill_code=0),
])
def test_window_gather_matches_jax(geom):
    rng = np.random.default_rng(5)
    shape = (2, 5, 4, 40)
    planes = rng.integers(-2**31, 2**31, (10, 2 * 5 * 4 + 3, 2),
                          dtype=np.int64).astype(np.int32)
    want, hw_want = jbs.window_gather_planes(jnp.asarray(planes), shape,
                                             **geom)
    got, hw_got = tbs.window_gather_planes(torch.from_numpy(planes), shape,
                                           **geom)
    assert hw_got == hw_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stack_split_roundtrip():
    fmt = FPFormat(5, 3)
    rng = np.random.default_rng(2)
    acts = [tbs.BitsliceActivation(
        torch.from_numpy(rng.integers(-9, 9, (fmt.nbits, b * 6 + 2, 1))
                         .astype(np.int32)), fmt, (b, 2, 3, 17))
        for b in (1, 3, 2)]
    wave = tbs.stack_activations(acts)
    assert wave.shape == (6, 2, 3, 17) and wave.planes.shape[1] == 36
    for a, back in zip(acts, tbs.split_activation(wave, [1, 3, 2])):
        assert back.shape == a.shape
        assert torch.equal(back.planes, a.planes[:, :a.n_pixels])
