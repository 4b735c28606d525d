"""The port's bitslice MAC module against the JAX package.

The encoders, both kernel wrappers on CPU tensors (where they run their
kernels' plain versions) and ``hobflops_matmul`` get the same numpy
inputs as the reference's ``jnp`` path and its numpy oracles.  Planes
and codes compare bit-exactly; decoded floats compare as int32 bit
patterns, so -0 != +0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fpformat as jfp
from repro.kernels.bitslice_mac import ops as jmac
from repro.kernels.bitslice_mac import ref as jmref
from repro_torch.core.fpformat import RNE, RTZ, FPFormat
from repro_torch.core.fused_backend import fused_mac_cuda
from repro_torch.kernels.bitslice_mac import ops as tmac
from repro_torch.kernels.bitslice_mac import ref as tmref
from repro_torch.kernels.bitslice_mac.kernel import bitslice_mac_cuda

BACKENDS = ("torch", "cuda", "cuda_fused")


def _fmts(w_e, w_f):
    """The same format as each package's own FPFormat (the two classes
    never compare equal)."""
    return FPFormat(w_e, w_f), jfp.FPFormat(w_e, w_f)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.mark.parametrize("w_f,rounding", [(2, RNE), (3, RTZ)])
def test_encoders_match_jax(w_f, rounding):
    tf, jf = _fmts(5, w_f)
    rng = np.random.default_rng(w_f)
    i, w = _rand(rng, (7, 5)), _rand(rng, (5, 37))
    np.testing.assert_array_equal(
        tmac.encode_input_masks(torch.from_numpy(i), tf, rounding).numpy(),
        np.asarray(jmac.encode_input_masks(i, jf, rounding, 1, 1)))
    np.testing.assert_array_equal(
        tmac.encode_weight_planes(torch.from_numpy(w), tf, rounding).numpy(),
        np.asarray(jmac.encode_weight_planes(w, jf, rounding)))
    tm, tw = tmac.encode_inputs(torch.from_numpy(i), torch.from_numpy(w), tf,
                                rounding)
    assert tm.shape == (7, 5, tf.nbits) and tw.shape == (5, tf.nbits, 2)
    np.testing.assert_array_equal(
        _bits(tmac.hobflops_quantize(torch.from_numpy(i), tf,
                                     rounding).numpy()),
        _bits(jmac.hobflops_quantize(i, jf, rounding)))


@pytest.mark.parametrize("extended", [False, True])
def test_mac_plain_versions_match_jax(extended):
    """Both kernel wrappers on CPU tensors (their plain versions) give the
    reference's ``_bitslice_mac_jnp`` planes, ReLU epilogue included."""
    tf, jf = _fmts(5, 2)
    rng = np.random.default_rng(11 + extended)
    P, C, Mw = 6, 7, 2
    i_masks = -rng.integers(0, 2, (P, C, tf.nbits)).astype(np.int32)
    w_planes = rng.integers(-2**31, 2**31, (C, tf.nbits, Mw),
                            dtype=np.int64).astype(np.int32)
    want = np.asarray(jmac._bitslice_mac_jnp(
        jnp.asarray(i_masks), jnp.asarray(w_planes), fmt=jf,
        extended=extended, rounding=RNE, c_unroll=1))
    ti, tw = torch.from_numpy(i_masks), torch.from_numpy(w_planes)
    kw = dict(fmt=tf, extended=extended, rounding=RNE)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(
            bitslice_mac_cuda(ti, tw, c_unroll=k, **kw).numpy(), want)
        np.testing.assert_array_equal(
            fused_mac_cuda(ti, tw, c_unroll=k, **kw).numpy(), want)
    sign = tf.mult_out(extended).sign_off
    np.testing.assert_array_equal(
        fused_mac_cuda(ti, tw, c_unroll=2, relu=True, **kw).numpy(),
        want & ~want[sign][None])


@pytest.mark.parametrize("backend", BACKENDS)
def test_hobflops_matmul_matches_reference_oracle(backend):
    """Float in, float out, against the copied numpy oracle and the
    reference's own, including pre-encoded weights with a ragged M."""
    tf, jf = _fmts(5, 3)
    rng = np.random.default_rng(5)
    i, w = _rand(rng, (5, 9)), _rand(rng, (9, 35))
    want = jmref.hobflops_matmul_f64(i, w, jf)
    np.testing.assert_array_equal(
        _bits(tmref.hobflops_matmul_f64(i, w, tf)), _bits(want))
    ti, tw = torch.from_numpy(i), torch.from_numpy(w)
    got = tmac.hobflops_matmul(ti, tw, fmt=tf, backend=backend,
                               blocks={"c_unroll": 2})
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    planes = tmac.encode_weight_planes(tw, tf)
    got = tmac.hobflops_matmul(ti, fmt=tf, w_planes=planes, cout=35,
                               backend=backend, blocks={"c_unroll": 3})
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_matmul_ref_codes_match_jax():
    for rounding in (RNE, RTZ):
        tf, jf = _fmts(5, 2)
        rng = np.random.default_rng(3)
        ic = rng.integers(0, 1 << tf.nbits, (4, 6))
        wc = rng.integers(0, 1 << tf.nbits, (6, 3))
        np.testing.assert_array_equal(
            tmref.hobflops_matmul_ref(ic, wc, tf, True, rounding),
            jmref.hobflops_matmul_ref(ic, wc, jf, True, rounding))
