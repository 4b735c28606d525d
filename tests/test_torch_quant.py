"""The port's quantized weights and dequant matmul against the JAX
package.

Storage codes, bit planes, scales and dequantized weights compare bit
for bit (floats as int32 bit patterns, so -0 != +0); the dequant matmul
compares to ``rtol=atol=1e-5``, the tolerance of the reference's own
kernel test (``tests/test_kernels.py``), since the two packages sum the
float32 products in different orders.  The reference's Pallas kernel
runs in interpret mode, as its own tests run it on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.core import softfloat as jsf
from repro.core.fpformat import StorageFormat as JStorageFormat
from repro.kernels.dequant_matmul import ops as jops
from repro.kernels.dequant_matmul.ref import dequant_matmul_ref as jdq_ref
from repro.models import model_schema as jmodel_schema
from repro.models.schema import init_params as jinit_params
from repro.quant import apply as japply
from repro.quant import storage as jstorage
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import softfloat as sf
from repro_torch.core.fpformat import StorageFormat
from repro_torch.kernels.dequant_matmul import ops
from repro_torch.quant import apply, storage

# The formats of the reference's dequant matmul test.
FORMATS = [(5, 2), (5, 3), (4, 3), (8, 7)]


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _special_values(w_e: int, w_f: int) -> np.ndarray:
    """±0, ±inf, nan, overflow, underflow, ±2^-bias and its neighbours,
    f32 subnormals, and the largest finite value of the format."""
    bias = (1 << (w_e - 1)) - 1
    emax = (1 << w_e) - 1
    tiny = 2.0 ** -bias
    top = 2.0 ** (emax - bias) * (2 - 2.0 ** -w_f)
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan, 3e38, -3e38, top, -top,
            top * 1.01, -top * 1.5, tiny, -tiny, tiny * 1.0001,
            tiny * 0.9999, tiny * 0.5, -tiny * 0.5, tiny * 0.26, 1e-40,
            -1e-40, 1.0, -1.0, 1.5, 1.0 + 2.0 ** -(w_f + 1)]
    return np.array([v for v in vals if abs(v) < 3.5e38 or not
                     np.isfinite(v) or v != v], np.float64) \
        .astype(np.float32)


def _storage_inputs(w_e: int, w_f: int) -> np.ndarray:
    rng = np.random.default_rng(w_e * 100 + w_f)
    rand = [rng.standard_normal(400) * s for s in (1e-6, 1e-2, 1.0, 1e2,
                                                   1e5)]
    return np.concatenate([_special_values(w_e, w_f)] + rand) \
        .astype(np.float32)


@pytest.mark.parametrize("w_e,w_f", FORMATS)
@pytest.mark.parametrize("rounding", ["rne", "rtz"])
def test_encode_storage_matches_jax(w_e, w_f, rounding):
    x = _storage_inputs(w_e, w_f)
    want = np.asarray(jsf.encode_storage(jnp.asarray(x),
                                         JStorageFormat(w_e, w_f), rounding))
    got = sf.encode_storage(torch.from_numpy(x), StorageFormat(w_e, w_f),
                            rounding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w_e,w_f", FORMATS)
def test_decode_storage_matches_jax(w_e, w_f):
    """Every code of the format, exhaustively, in torch and in numpy."""
    sfmt = StorageFormat(w_e, w_f)
    codes = np.arange(1 << sfmt.nbits, dtype=np.int32)
    want = _bits(jsf.decode_storage(jnp.asarray(codes),
                                    JStorageFormat(w_e, w_f)))
    got = sf.decode_storage(torch.from_numpy(codes), sfmt).numpy()
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(_bits(sf.decode_storage_np(codes, sfmt)),
                                  want)
    assert _bits(got)[0] == 0                       # code 0 is +0


def _port_qt(layout, w, sfmt, scale):
    if layout == "bitplane2d":
        return ops.pack_weights(torch.from_numpy(w), sfmt)
    return storage.quantize(torch.from_numpy(w), sfmt, layout=layout,
                            scale=scale)


def _jax_qt(layout, w, jsfmt, scale):
    if layout == "bitplane2d":
        return jops.pack_weights(w, jsfmt)
    return jstorage.quantize(w, jsfmt, layout=layout, scale=scale)


@pytest.mark.parametrize("w_e,w_f", FORMATS)
@pytest.mark.parametrize("layout,shape,scale", [
    ("native", (24, 40), None), ("bitplane", (7, 9), None),
    ("bitplane2d", (16, 96), None),
    # A given scale that keeps w_e = 8 codes finite: the default one,
    # amax / 2**127, is subnormal and flushes to 0 in both packages.
    ("bitplane", (5, 32), 2.0 ** -100)])
def test_quantize_dequantize_match_jax(w_e, w_f, layout, shape, scale):
    rng = np.random.default_rng(sum(shape) + w_f)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    w.flat[:4] = [0.0, -0.0, 1e-30, -1e-40]     # ... and a subnormal
    sfmt, jsfmt = StorageFormat(w_e, w_f), JStorageFormat(w_e, w_f)
    qt = _port_qt(layout, w, sfmt, scale)
    jqt = _jax_qt(layout, w, jsfmt, scale)
    assert (qt.layout, qt.shape) == (jqt.layout, tuple(jqt.shape))
    assert qt.data.dtype == {"int8": torch.int8, "int16": torch.int16,
                             "int32": torch.int32}[str(jqt.data.dtype)]
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(jqt.data))
    np.testing.assert_array_equal(_bits(qt.scale.numpy()),
                                  _bits(jqt.scale))
    np.testing.assert_array_equal(_bits(storage.dequantize(qt).numpy()),
                                  _bits(jstorage.dequantize(jqt)))
    assert qt.nbytes_hbm() == jqt.nbytes_hbm()


def _jax_qparams_as_numpy(tree):
    """A reference tree with quantized leaves -> numpy, quantized
    leaves as ``lm_params_from_jax`` takes them."""
    if isinstance(tree, dict):
        return {k: _jax_qparams_as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, jstorage.QuantizedTensor):
        return (np.asarray(tree.data), np.asarray(tree.scale),
                (tree.sfmt.w_e, tree.sfmt.w_f), tree.layout, tree.shape)
    return np.asarray(tree)


def _assert_same_tree(got, want, path=()):
    assert type(got) is type(want) or isinstance(got, torch.Tensor), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], path + (k,))
    elif isinstance(want, storage.QuantizedTensor):
        assert (got.sfmt, got.layout, got.shape) == \
            (want.sfmt, want.layout, want.shape), path
        assert torch.equal(got.data, want.data), path
        assert torch.equal(got.scale.view(torch.int32),
                           want.scale.view(torch.int32)), path
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            path


def test_quantize_params_matches_jax():
    """The smoke qwen2 tree quantized in both packages: the same tree,
    the same codes and scales, the same footprint."""
    jcfg = jsmoke_config("qwen2-0.5b")
    jparams = jinit_params(jmodel_schema(jcfg), jax.random.PRNGKey(3))
    jq, _ = japply.quantize_params(jparams, jcfg, "hobflops9")
    dense = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    q, deq = apply.quantize_params(dense, smoke_config("qwen2-0.5b"),
                                   "hobflops9")
    want = lm_params_from_jax(_jax_qparams_as_numpy(jq), device="cpu")
    _assert_same_tree(q, want)
    assert apply.quantized_bytes(q) == japply.quantized_bytes(jq)
    wq = q["blocks"]["b0"]["attn"]["wq"]
    assert isinstance(wq, storage.QuantizedTensor) and \
        wq.data.shape[0] == 2 and wq.shape == (128, 128)
    assert deq("wq", wq.layer(1)).shape == (128, 128)
    assert deq("x", dense["final_norm"]["scale"]) is \
        dense["final_norm"]["scale"]


@pytest.mark.parametrize("w_e,w_f", FORMATS)
@pytest.mark.parametrize("MKN", [(8, 32, 64), (16, 64, 128)])
def test_dequant_matmul_matches_jax_pallas(w_e, w_f, MKN):
    M, K, N = MKN
    rng = np.random.default_rng(M * K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jqt = jops.pack_weights(w, JStorageFormat(w_e, w_f))
    want = np.asarray(jops.dequant_matmul(x, jqt, backend="pallas",
                                          interpret=True, bm=8, bn=32,
                                          bk=16))
    qt = ops.pack_weights(torch.from_numpy(w), StorageFormat(w_e, w_f))
    got = ops.dequant_matmul(torch.from_numpy(x), qt, backend="torch")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    same = ops.dequant_matmul(torch.from_numpy(x), qt)   # plain on the CPU
    assert torch.equal(same, got)


def test_dequant_matmul_ragged_matches_jax_ref():
    """M, K and N/32 that fit no tile of the reference's kernel."""
    M, K, N = 5, 40, 96
    rng = np.random.default_rng(9)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jqt = jops.pack_weights(w, JStorageFormat(5, 3))
    want = np.asarray(jdq_ref(x, jqt.data, jqt.scale, jqt.sfmt, N))
    qt = ops.pack_weights(torch.from_numpy(w), StorageFormat(5, 3))
    got = ops.dequant_matmul(torch.from_numpy(x), qt, backend="torch")
    assert got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dequant_matmul_plain_backend_refuses_other_devices():
    qt = ops.pack_weights(torch.ones(4, 32), StorageFormat(5, 3))
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.dequant_matmul(torch.ones(2, 4, device="meta"), qt,
                           backend="torch")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.dequant_matmul(torch.ones(2, 4), qt, backend="pallas")
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.pack_weights(torch.ones(4, 40), StorageFormat(5, 3))
