"""Pallas kernels vs pure oracles: shape/dtype/format sweeps.

Each kernel runs in interpret mode (the kernel body executes as real
jax ops on CPU) and must agree with the sequential code-level oracle —
for the bitslice MAC, bit-exactly."""
import numpy as np
import pytest

from repro.core import softfloat as sf
from repro.core.fpformat import RNE, RTZ, FPFormat, StorageFormat
from repro.kernels.bitslice_mac.ops import hobflops_matmul
from repro.kernels.bitslice_mac.ref import hobflops_matmul_f64
from repro.kernels.conv2d_bitslice.ops import hobflops_conv2d, im2col
from repro.kernels.conv2d_bitslice.ref import (conv2d_f32,
                                               hobflops_conv2d_ref)
from repro.kernels.dequant_matmul.ops import dequant_matmul, pack_weights
from repro.kernels.dequant_matmul.ref import dequant_matmul_ref
from repro.quant.storage import dequantize, quantize


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("fmt,extended,rounding", [
    (FPFormat(5, 2), False, RNE),      # hobflops8
    (FPFormat(5, 3), False, RNE),      # hobflops9
    pytest.param(FPFormat(5, 3), True, RNE,     # hobflops9e
                 marks=pytest.mark.slow),
    (FPFormat(4, 3), False, RNE),      # ieee8
    (FPFormat(5, 3), False, RTZ),
])
def test_bitslice_mac_formats(fmt, extended, rounding):
    rng = np.random.default_rng(hash((fmt.w_e, fmt.w_f, extended)) % 99)
    P, C, M = 4, 8, 32
    i, w = _rand(rng, (P, C)), _rand(rng, (C, M))
    want = hobflops_matmul_f64(i, w, fmt, extended, rounding)
    got = np.asarray(hobflops_matmul(
        i, w, fmt=fmt, extended=extended, rounding=rounding,
        backend="pallas", interpret=True, p_block=4, m_block=1,
        c_block=8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P,C,M", [(1, 1, 32), (3, 5, 32), (8, 16, 64),
                                   (16, 32, 96)])
def test_bitslice_mac_shapes(P, C, M):
    fmt = FPFormat(5, 3)
    rng = np.random.default_rng(P * 100 + C)
    i, w = _rand(rng, (P, C)), _rand(rng, (C, M))
    want = hobflops_matmul_f64(i, w, fmt)
    got_j = np.asarray(hobflops_matmul(i, w, fmt=fmt, backend="jnp"))
    got_p = np.asarray(hobflops_matmul(
        i, w, fmt=fmt, backend="pallas", interpret=True,
        p_block=min(4, P), m_block=1, c_block=min(8, C)))
    np.testing.assert_array_equal(got_j, want)
    np.testing.assert_array_equal(got_p, want)


def test_bitslice_mac_zero_identity():
    """Zero-padding is the MAC identity (paper's tiling assumption)."""
    fmt = FPFormat(5, 3)
    rng = np.random.default_rng(0)
    i, w = _rand(rng, (4, 8)), _rand(rng, (8, 32))
    base = np.asarray(hobflops_matmul(i, w, fmt=fmt, backend="jnp"))
    ip = np.concatenate([i, np.zeros((4, 8), np.float32)], axis=1)
    wp = np.concatenate([w, np.zeros((8, 32), np.float32)], axis=0)
    padded = np.asarray(hobflops_matmul(ip, wp, fmt=fmt, backend="jnp"))
    np.testing.assert_array_equal(base, padded)


def test_bitslice_mac_accuracy_tracks_precision():
    rng = np.random.default_rng(5)
    i, w = _rand(rng, (8, 16)), _rand(rng, (16, 32))
    exact = i.astype(np.float64) @ w.astype(np.float64)
    errs = []
    for wf in (2, 4, 7, 10):
        fmt = FPFormat(5, wf)
        got = hobflops_matmul_f64(i, w, fmt)
        errs.append(np.abs(got - exact).max())
    assert errs[0] > errs[1] > errs[2] > errs[3]


@pytest.mark.parametrize("sfmt", [StorageFormat(5, 2), StorageFormat(5, 3),
                                  StorageFormat(4, 3), StorageFormat(8, 7)])
@pytest.mark.parametrize("MKN", [(8, 32, 64), (16, 64, 128)])
def test_dequant_matmul(sfmt, MKN):
    M, K, N = MKN
    rng = np.random.default_rng(M * K)
    x, w = _rand(rng, (M, K)), _rand(rng, (K, N))
    qt = pack_weights(w, sfmt)
    want = np.asarray(dequant_matmul_ref(x, qt.data, qt.scale, sfmt, N))
    got = np.asarray(dequant_matmul(x, qt, backend="pallas",
                                    interpret=True, bm=8, bn=32, bk=16))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dequant_matmul_footprint():
    w = np.random.default_rng(0).standard_normal((64, 128)).astype(
        np.float32)
    sfmt = StorageFormat(5, 3)   # 9 bits/weight
    qt = pack_weights(w, sfmt)
    assert qt.data.size * 4 == 64 * 128 * 9 // 8  # true bit packing


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_im2col_matches_lax_conv(stride, padding):
    rng = np.random.default_rng(2)
    img = _rand(rng, (2, 8, 8, 4))
    ker = _rand(rng, (3, 3, 4, 8), 0.4)
    pat = np.asarray(im2col(img, 3, 3, stride, padding))
    got = pat.reshape(-1, 36) @ ker.reshape(36, 8)
    want = conv2d_f32(img, ker, stride, padding).reshape(-1, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_hobflops_conv2d(relu):
    fmt = FPFormat(5, 3)
    rng = np.random.default_rng(4)
    img = _rand(rng, (1, 5, 5, 4))
    ker = _rand(rng, (3, 3, 4, 32), 0.4)
    got = np.asarray(hobflops_conv2d(img, ker, fmt=fmt, relu=relu,
                                     backend="jnp"))
    want = hobflops_conv2d_ref(img, ker, fmt, relu=relu)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_bitslice_mac_c_unroll_chain():
    """Chained-channel kernel (c_unroll > 1) stays bit-exact, including
    when c_unroll does not divide C (clamping / padding paths)."""
    fmt = FPFormat(5, 3)
    rng = np.random.default_rng(7)
    P, C, M = 8, 12, 64
    i, w = _rand(rng, (P, C)), _rand(rng, (C, M))
    want = hobflops_matmul_f64(i, w, fmt)
    for c_unroll in (1, 2, 4, 5):
        got_j = np.asarray(hobflops_matmul(
            i, w, fmt=fmt, backend="jnp", c_unroll=c_unroll))
        np.testing.assert_array_equal(got_j, want)
    got_p = np.asarray(hobflops_matmul(
        i, w, fmt=fmt, backend="pallas", interpret=True, p_block=4,
        m_block=2, c_block=4, c_unroll=4))
    np.testing.assert_array_equal(got_p, want)


def test_hobflops_conv2d_pallas_tiled():
    """Acceptance: the Pallas path with real tiling (M > 32 so the M
    grid axis is exercised with m_block > 1, C > c_unroll so the chain
    loop runs multiple steps) is bit-exact vs the jnp reference."""
    fmt = FPFormat(5, 2)
    rng = np.random.default_rng(11)
    img = _rand(rng, (1, 6, 6, 5))
    ker = _rand(rng, (3, 3, 5, 48), 0.4)   # K = 45 > c_unroll, M = 48 > 32
    want = np.asarray(hobflops_conv2d(img, ker, fmt=fmt, backend="jnp"))
    got = np.asarray(hobflops_conv2d(img, ker, fmt=fmt, backend="pallas",
                                     interpret=True))
    np.testing.assert_array_equal(got, want)


def test_derive_blocks():
    from repro.kernels.conv2d_bitslice.ops import derive_blocks
    blk = derive_blocks(36, 45, 48)
    assert blk["p_block"] == 8 and blk["m_block"] == 2
    assert blk["c_block"] == 45 and blk["c_block"] % blk["c_unroll"] == 0
    # explicit overrides win but are still clamped to the problem
    blk = derive_blocks(4, 8, 32, p_block=16, m_block=4, c_unroll=3)
    assert blk["p_block"] == 4 and blk["m_block"] == 1
    assert blk["c_block"] % blk["c_unroll"] == 0


def test_matmul_pre_encoded_weights():
    """hobflops_matmul(w_planes=...) == hobflops_matmul(w_f32) — static
    weights encoded once, bit-exact, including non-lane-multiple M."""
    from repro.kernels.bitslice_mac.ops import encode_weight_planes
    fmt = FPFormat(5, 3)
    rng = np.random.default_rng(21)
    P, C, M = 5, 12, 48
    i, w = _rand(rng, (P, C)), _rand(rng, (C, M))
    want = np.asarray(hobflops_matmul(i, w, fmt=fmt, backend="jnp"))
    wp = encode_weight_planes(w, fmt)
    got = np.asarray(hobflops_matmul(i, fmt=fmt, w_planes=wp, cout=M,
                                     backend="jnp"))
    np.testing.assert_array_equal(got, want)
    got_p = np.asarray(hobflops_matmul(
        i, fmt=fmt, w_planes=wp, cout=M, backend="pallas",
        interpret=True, p_block=4, m_block=1, c_block=4))
    np.testing.assert_array_equal(got_p, want)


def test_conv2d_pre_encoded_weights():
    """hobflops_conv2d accepts a ConvWeights in place of f32 kernels."""
    from repro.kernels.conv2d_bitslice.ops import encode_conv_weights
    fmt = FPFormat(5, 2)
    rng = np.random.default_rng(22)
    img = _rand(rng, (1, 5, 5, 4))
    ker = _rand(rng, (3, 3, 4, 8), 0.4)
    want = np.asarray(hobflops_conv2d(img, ker, fmt=fmt, relu=True,
                                      backend="jnp"))
    cw = encode_conv_weights(ker, fmt)
    got = np.asarray(hobflops_conv2d(img, cw, fmt=fmt, relu=True,
                                     backend="jnp"))
    np.testing.assert_array_equal(got, want)


def test_tune_conv_blocks_dedupe_uses_strided_patch_count():
    """Candidates that clamp to the same launch config for the *actual*
    strided Ho*Wo patch count must dedupe to one timed entry (the seed
    keyed on the unstrided B*H*W, splitting them)."""
    from repro.kernels.conv2d_bitslice.ops import tune_conv_blocks
    fmt = FPFormat(5, 2)
    rng = np.random.default_rng(23)
    img = _rand(rng, (1, 8, 8, 4))
    ker = _rand(rng, (1, 1, 4, 32), 0.4)
    # stride 2 -> P = 16; p_block 16 and 32 both clamp to 16.
    best, results = tune_conv_blocks(
        img, ker, fmt=fmt, stride=2, backend="jnp", iters=1,
        candidates=[{"p_block": 16}, {"p_block": 32}])
    assert len(results) == 1, results
    (key,) = results
    assert dict(key)["p_block"] == 16


def test_hobflops_relu_is_bitwise():
    """ReLU in the bitslice domain == ReLU on decoded values."""
    import jax.numpy as jnp
    from repro.core.bitslice import pack_planes, unpack_planes
    from repro.kernels.conv2d_bitslice.ops import hobflops_relu_planes
    fmt = FPFormat(5, 4)
    rng = np.random.default_rng(9)
    vals = rng.standard_normal(64).astype(np.float32)
    codes = sf.encode_jnp(jnp.asarray(vals), fmt)
    planes = pack_planes(codes, fmt.nbits)
    relu_planes = hobflops_relu_planes(planes, fmt)
    back = np.asarray(sf.decode_jnp(unpack_planes(relu_planes), fmt))
    want = np.asarray(sf.decode_jnp(codes, fmt))
    want = np.where(want <= 0, 0.0, want)
    np.testing.assert_array_equal(back, want)
