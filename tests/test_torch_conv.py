"""The port's single-layer conv against the JAX package.

The same numpy inputs go through the reference (``backend="jnp"``, and
once ``backend="pallas_fused", interpret=True``) and through the port on
the CPU, where the ``cuda`` and ``cuda_fused`` wrappers run their
kernels' plain versions.  Planes and codes compare bit-exactly; decoded
floats compare as int32 bit patterns, so -0 != +0.  The reference pads
rows and lane words to its TPU blocks, so its planes are cropped to the
logical ``[NOUT, P, ceil(M/32)]`` before the comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fpformat as jfp
from repro.kernels.conv2d_bitslice import ops as jconv
from repro.kernels.conv2d_bitslice import ref as jcref
from repro_torch.core.fpformat import RNE, RTZ, FPFormat
from repro_torch.kernels.bitslice_mac import ops as tmac
from repro_torch.kernels.conv2d_bitslice import ops as tconv
from repro_torch.kernels.conv2d_bitslice import ref as tcref

BACKENDS = ("torch", "cuda", "cuda_fused")


def _fmts(w_e, w_f):
    """The same format as each package's own FPFormat (the two classes
    never compare equal)."""
    return FPFormat(w_e, w_f), jfp.FPFormat(w_e, w_f)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


# ---------------------------------------------------------------------------
# kernels/conv2d_bitslice: im2col, conv_core, hobflops_conv2d, the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kh,kw,stride,padding", [
    (3, 3, 1, "SAME"), (3, 2, 2, "SAME"), (2, 2, 2, "VALID"),
    (1, 1, 1, "SAME"), (3, 3, 3, "SAME")])
def test_im2col_matches_jax(kh, kw, stride, padding):
    x = _rand(np.random.default_rng(kh * 10 + kw), (2, 5, 6, 3))
    want = np.asarray(jconv.im2col(x, kh, kw, stride, padding))
    got = tconv.im2col(torch.from_numpy(x), kh, kw, stride, padding)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert tconv.conv_out_hw(5, 6, kh, kw, stride, padding) == \
        jconv.conv_out_hw(5, 6, kh, kw, stride, padding) == want.shape[1:3]


# (w_f, rounding, extended, relu, stride, padding, image, kernel, c_unroll)
CONV_CASES = [
    (2, RNE, False, True, 1, "SAME", (1, 4, 4, 3), (3, 3, 3, 5), 1),
    (3, RTZ, False, False, 2, "VALID", (2, 5, 5, 2), (3, 3, 2, 33), 2),
    (2, RNE, True, True, 1, "SAME", (1, 3, 3, 4), (1, 1, 4, 6), 1),
]


@pytest.fixture(scope="module")
def conv_planes():
    """The reference's ``conv_core`` planes of every case, computed once
    (each case compiles a netlist scan, a few seconds apiece).  The
    reference runs chain depth 1 and the port the case's depth: depth
    never changes values."""
    out = {}
    for idx, (w_f, rounding, ext, relu, stride, pad, ishape, kshape,
              _) in enumerate(CONV_CASES):
        _, jf = _fmts(5, w_f)
        rng = np.random.default_rng(100 + idx)
        img, ker = _rand(rng, ishape), _rand(rng, kshape, 0.5)
        act = jconv.encode_activations(img, jf, rounding)
        w = jconv.encode_conv_weights(ker, jf, rounding)
        o = jconv.conv_core(act, w, stride=stride, padding=pad,
                            extended=ext, rounding=rounding, relu=relu,
                            backend="jnp", c_unroll=1)
        out[idx] = (img, ker, np.asarray(o.planes), o.shape)
    return out


@pytest.mark.parametrize("idx", range(len(CONV_CASES)))
@pytest.mark.parametrize("backend", BACKENDS)
def test_conv_core_planes_match_jax(conv_planes, idx, backend):
    w_f, rounding, ext, relu, stride, pad, _, _, k = CONV_CASES[idx]
    img, ker, want, shape = conv_planes[idx]
    tf, _ = _fmts(5, w_f)
    act = tconv.encode_activations(torch.from_numpy(img), tf, rounding)
    w = tconv.encode_conv_weights(ker, tf, rounding, device="cpu")
    out = tconv.conv_core(act, w, stride=stride, padding=pad, extended=ext,
                          rounding=rounding, relu=relu, backend=backend,
                          c_unroll=k)
    assert out.shape == shape and out.fmt == tf.mult_out(ext)
    B, Ho, Wo, M = shape
    assert out.planes.shape == (out.fmt.nbits, B * Ho * Wo, -(-M // 32))
    np.testing.assert_array_equal(out.planes.numpy(),
                                  want[:, :B * Ho * Wo, :-(-M // 32)])


def test_conv_weights_and_patch_masks_match_jax():
    tf, jf = _fmts(5, 3)
    rng = np.random.default_rng(8)
    img, ker = _rand(rng, (2, 4, 3, 5)), _rand(rng, (3, 2, 5, 40))
    tw = tconv.encode_conv_weights(ker, tf, device="cpu")
    jw = jconv.encode_conv_weights(ker, jf)
    np.testing.assert_array_equal(tw.planes.numpy(), np.asarray(jw.planes))
    assert (tw.kh, tw.kw, tw.cin, tw.cout) == (jw.kh, jw.kw, jw.cin, jw.cout)
    tact = tconv.encode_activations(torch.from_numpy(img), tf)
    jact = jconv.encode_activations(img, jf)
    np.testing.assert_array_equal(tact.planes.numpy(),
                                  np.asarray(jact.planes)[:, :24])
    np.testing.assert_array_equal(
        _bits(tconv.decode_activations(tact).numpy()),
        _bits(jconv.decode_activations(jact)))
    for stride, pad in ((1, "SAME"), (2, "VALID")):
        tm, thw = tconv.activation_patch_masks(tact, 3, 2, stride, pad)
        jm, jhw = jconv.activation_patch_masks(jact, 3, 2, stride, pad)
        assert thw == jhw
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("backend", BACKENDS)
def test_hobflops_conv2d_matches_jax_and_oracle(conv_planes, backend):
    """The one-layer entry point decodes what ``conv_core`` computed:
    bit-identical to the reference's planes decoded, and to the numpy
    code-level oracle of both packages."""
    w_f, rounding, ext, relu, stride, pad, _, _, k = CONV_CASES[0]
    img, ker, planes, shape = conv_planes[0]
    tf, jf = _fmts(5, w_f)
    got = tconv.hobflops_conv2d(img, ker, fmt=tf, stride=stride,
                                padding=pad, extended=ext, rounding=rounding,
                                relu=relu, backend=backend, device="cpu",
                                c_unroll=k)
    want = jconv.decode_activations(jconv.BitsliceActivation(
        jnp.asarray(planes), jf.mult_out(ext), shape))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    ref_t = tcref.hobflops_conv2d_ref(img, ker, tf, stride, pad, ext,
                                      rounding, relu)
    ref_j = jcref.hobflops_conv2d_ref(img, ker, jf, stride, pad, ext,
                                      rounding, relu)
    np.testing.assert_array_equal(_bits(ref_t), _bits(ref_j))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref_t))


def test_hobflops_conv2d_jit_matches_port():
    """The reference's jitted end-to-end conv (``backend="jnp"``) against
    the port's default backend, with pre-encoded weights."""
    tf, jf = _fmts(5, 2)
    rng = np.random.default_rng(21)
    img, ker = _rand(rng, (1, 3, 4, 2)), _rand(rng, (2, 2, 2, 3), 0.5)
    want = jconv.hobflops_conv2d(img, ker, fmt=jf, relu=True, c_unroll=1)
    w = tconv.encode_conv_weights(ker, tf, device="cpu")
    got = tconv.hobflops_conv2d(img, w, fmt=tf, relu=True, device="cpu",
                                c_unroll=1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fused_relu_matches_pallas_fused_interpret():
    """The fused kernel's contract, ReLU epilogue included, against the
    TPU kernel it replaces, run in interpret mode."""
    tf, jf = _fmts(5, 2)
    rng = np.random.default_rng(4)
    img, ker = _rand(rng, (1, 3, 3, 2)), _rand(rng, (3, 3, 2, 4), 0.5)
    jact = jconv.encode_activations(img, jf)
    want = jconv.conv_core(jact, jconv.encode_conv_weights(ker, jf),
                           relu=True, backend="pallas_fused",
                           interpret=True, c_unroll=1)
    tact = tconv.encode_activations(torch.from_numpy(img), tf)
    got = tconv.conv_core(tact, tconv.encode_conv_weights(ker, tf,
                                                          device="cpu"),
                          relu=True, backend="cuda_fused", c_unroll=1)
    np.testing.assert_array_equal(got.planes.numpy(),
                                  np.asarray(want.planes)[:, :9, :1])


def test_conv2d_f32_oracle_matches_jax():
    """The float oracle only: a different summation order bounds the
    agreement, so this comparison alone carries a tolerance (rtol 1e-5,
    atol 1e-6 on values of order 1)."""
    rng = np.random.default_rng(9)
    img, ker = _rand(rng, (2, 6, 5, 4)), _rand(rng, (3, 3, 4, 7))
    for stride, pad in ((1, "SAME"), (2, "SAME"), (2, "VALID")):
        np.testing.assert_allclose(
            tcref.conv2d_f32(img, ker, stride, pad).numpy(),
            np.asarray(jcref.conv2d_f32(img, ker, stride, pad)),
            rtol=1e-5, atol=1e-6)


def test_derive_blocks_hopper_defaults():
    """Hopper launch defaults of the interpreter: one warp of lane words
    per row, 32 chains a block, a 4-channel ring slot, chain depth 4 —
    each clamped to the problem."""
    blk = tconv.derive_blocks(196, 4608, 512)
    assert blk == {"p_block": 2, "m_block": 16, "c_block": 4,
                   "c_unroll": 4}
    assert tconv.derive_blocks(5, 3, 7) == {"p_block": 5, "m_block": 1,
                                            "c_block": 3, "c_unroll": 3}
    assert tconv.derive_blocks(9, 8, 2048, p_block=2)["m_block"] == 32
    assert tconv.derive_blocks(9, 8, 2048, c_unroll=1)["c_unroll"] == 1


def test_launch_blocks_keep_given_values():
    """Both kernel wrappers and ``derive_blocks`` take their launch
    parameters from one function: given values are kept (the kernels
    mask any edge), missing ones are the defaults clamped to the problem,
    and the chain depth is always clamped to [1, C]."""
    from repro_torch import _build
    from repro_torch.core.fused_backend import fused_chain_k, fused_variant
    assert _build.launch_blocks(9, 8, 6, p_block=3, m_block=32,
                                c_block=40) == {
        "p_block": 3, "m_block": 32, "c_block": 40, "c_unroll": 4}
    assert _build.launch_blocks(9, 8, 6, m_block=2)["p_block"] == 9
    assert _build.launch_blocks(9, 3, 6, c_unroll=8)["c_unroll"] == 3
    assert tconv.derive_blocks(196, 512, 512) == \
        _build.launch_blocks(196, 512, 16)
    tf, _ = _fmts(5, 3)
    assert fused_variant(tf, 4608, relu=True) == \
        (tf, fused_chain_k(tf, False, _build.CHAIN_DEPTH), False, RNE, True)
    assert fused_variant(tf, 1, c_unroll=4)[1] == 1


def test_default_device_refuses_without_card(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tf, _ = _fmts(5, 2)
    img, ker = np.zeros((1, 2, 2, 1), np.float32), \
        np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconv.hobflops_conv2d(img, ker, fmt=tf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconv.encode_conv_weights(ker, tf)


def test_unknown_backend_raises():
    tf, _ = _fmts(5, 2)
    m = torch.zeros((2, 2, tf.nbits), dtype=torch.int32)
    w = torch.zeros((2, tf.nbits, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown backend"):
        tmac.mac_planes(m, w, fmt=tf, backend="pallas")
