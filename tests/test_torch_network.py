"""The port's network path against the JAX package's ``NetworkGraph``.

The linear stack and the residual graph of ``examples/mobilenet_conv.py``
are built at tiny widths in both packages; the reference's encoded conv
weights are carried into the port by ``repro_torch.convert``, so both
run identical parameters.  Outputs compare as int32 bit patterns.  The
port runs on the CPU here, where both CUDA backends run their kernels'
plain versions.

The last tests pin the package boundary: importing every module of
``repro_torch`` loads neither ``jax`` nor anything of ``repro``, and the
entry points, left on their default device, refuse to run without a
card.
"""
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import fpformat as jfp
from repro.kernels.conv2d_bitslice import network as jnet
from repro_torch.convert import conv_weights_from_jax, graph_weights_from_jax
from repro_torch.core.fpformat import FPFormat
from repro_torch.kernels.conv2d_bitslice import network as tnet

SRC = Path(__file__).resolve().parents[1] / "src"


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _geometry(w):
    return (w.kh, w.kw, w.cin, w.cout, w.fmt.w_e, w.fmt.w_f)


# ---------------------------------------------------------------------------
# The linear stack: 3x3 conv, then two 1x1 convs, ReLU after each
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def linear_stack():
    rng = np.random.default_rng(0)
    cin, width = 3, 5
    kernels = [_rand(rng, s, 0.4) for s in
               [(3, 3, cin, width), (1, 1, width, width),
                (1, 1, width, width)]]
    img = _rand(rng, (2, 4, 4, cin))
    jf = jfp.FPFormat(5, 2)
    net = jnet.HobflopsNetwork([jnet.ConvLayerSpec(k, jf, relu=True)
                                for k in kernels])
    weights = [(np.asarray(w.planes), _geometry(w)) for w in net.weights]
    return kernels, img, weights, np.asarray(net(img))


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_fused"])
def test_linear_stack_matches_jax(linear_stack, backend):
    kernels, img, weights, want = linear_stack
    specs = [tnet.ConvLayerSpec(conv_weights_from_jax(p, *g, device="cpu"),
                                FPFormat(5, 2), relu=True)
             for p, g in weights]
    net = tnet.HobflopsNetwork(specs, backend=backend, device="cpu")
    got = net(img)
    assert tuple(got.shape) == net.out_shape(img.shape) == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(net.run_roundtrip(img).numpy()),
                                  _bits(want))


def test_linear_stack_from_f32_kernels(linear_stack):
    """Encoding the f32 kernels in the port gives the same network."""
    kernels, img, _, want = linear_stack
    net = tnet.HobflopsNetwork([tnet.ConvLayerSpec(k, FPFormat(5, 2))
                                for k in kernels], device="cpu")
    np.testing.assert_array_equal(_bits(net.run_resident(img).numpy()),
                                  _bits(want))
    assert net.macs(img.shape) == 2 * 16 * (27 * 5 + 2 * 25)


# ---------------------------------------------------------------------------
# The residual graph: maxpool, residual add, strided 3x3 at a higher
# precision, avgpool head
# ---------------------------------------------------------------------------
def _residual_graph(mod, fmt, hi, kernels, backend, **kw):
    """``examples/mobilenet_conv.py``'s residual topology in ``mod``
    (either package's ``network`` module)."""
    g = mod.NetworkGraph(fmt, backend=backend, **kw)
    one = {"c_unroll": 1}
    c1 = g.conv("c1", g.input_name, kernels["c1"], relu=True, blocks=one)
    p1 = g.maxpool2d("p1", c1, window=2)
    c2 = g.conv("c2", p1, kernels["c2"], relu=True, blocks=one)
    c3 = g.conv("c3", c2, kernels["c3"], blocks=one)
    r = g.relu("r", g.add("res", c3, p1))
    d = g.conv("d", r, kernels["d"], hi, stride=2, blocks=one)
    return g.output(g.avgpool2d("head", d, window=2))


@pytest.fixture(scope="module")
def residual_graph():
    rng = np.random.default_rng(1)
    cin, width = 3, 6
    kernels = {"c1": _rand(rng, (3, 3, cin, width), 0.4),
               "c2": _rand(rng, (1, 1, width, width), 0.4),
               "c3": _rand(rng, (1, 1, width, width), 0.4),
               "d": _rand(rng, (3, 3, width, width), 0.3)}
    img = _rand(rng, (1, 16, 16, cin))
    g = _residual_graph(jnet, jfp.FPFormat(5, 2), jfp.FPFormat(5, 4),
                        kernels, "jnp")
    weights = {n: (np.asarray(w.planes), _geometry(w))
               for n, w in g._weights.items()}
    return kernels, img, weights, g, np.asarray(g.run(img))


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_fused"])
def test_residual_graph_matches_jax(residual_graph, backend):
    _, img, weights, _, want = residual_graph
    g = _residual_graph(tnet, FPFormat(5, 2), FPFormat(5, 4),
                        graph_weights_from_jax(weights, device="cpu"),
                        backend, device="cpu")
    got = g.run(img)
    assert tuple(got.shape) == g.out_shape(img.shape) == want.shape == \
        (1, 2, 2, 6)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(g.run_roundtrip(img).numpy()),
                                  _bits(want))
    runner = g.resident_runner()
    np.testing.assert_array_equal(
        _bits(runner(torch.from_numpy(img)).numpy()), _bits(want))


def test_graph_plans_match_jax(residual_graph):
    """Shape plan, format plan, MAC count and the summary table agree
    with the reference's for the same topology."""
    kernels, img, _, jg, _ = residual_graph
    g = _residual_graph(tnet, FPFormat(5, 2), FPFormat(5, 4), kernels,
                        "cuda_fused", device="cpu")
    assert g.shape_plan(img.shape) == jg.shape_plan(img.shape)
    assert {n: (f.w_e, f.w_f) for n, f in g.format_plan().items()} == \
        {n: (f.w_e, f.w_f) for n, f in jg.format_plan().items()}
    assert g.macs(img.shape) == jg.macs(img.shape)
    assert g.summary(img.shape) == jg.summary(img.shape)
    assert g.fused_variants() == {
        (FPFormat(5, 2), 1, False, "rne", True),
        (FPFormat(5, 2), 1, False, "rne", False),
        (FPFormat(5, 4), 1, False, "rne", False)}


def test_with_precision_and_signature(residual_graph):
    kernels, img, _, jg, _ = residual_graph
    g = _residual_graph(tnet, FPFormat(5, 2), FPFormat(5, 4), kernels,
                        "cuda_fused", device="cpu")
    lo, jlo = g.with_precision(FPFormat(5, 3)), \
        jg.with_precision(jfp.FPFormat(5, 3))
    assert {n: str(f) for n, f in lo.format_plan().items()} == \
        {n: str(f) for n, f in jlo.format_plan().items()}
    assert lo.signature() != g.signature()
    same = _residual_graph(tnet, FPFormat(5, 2), FPFormat(5, 4), kernels,
                           "cuda_fused", device="cpu")
    assert same.signature() == g.signature()
    other = _residual_graph(tnet, FPFormat(5, 2), FPFormat(5, 4), kernels,
                            "cuda", device="cpu")
    assert other.signature() != g.signature()
    np.testing.assert_array_equal(_bits(lo.run(img).numpy()),
                                  _bits(lo.run_roundtrip(img).numpy()))


def test_graph_validation_errors():
    f8 = FPFormat(5, 2)
    k = np.zeros((1, 1, 4, 4), np.float32)
    g = tnet.NetworkGraph(f8, device="cpu")
    with pytest.raises(tnet.GraphValidationError, match="unknown input"):
        g.conv("c", "nope", k)
    g.conv("c", g.input_name, k)
    with pytest.raises(tnet.GraphValidationError, match="duplicate"):
        g.relu("c", "c")
    with pytest.raises(tnet.GraphValidationError, match="power of two"):
        g.avgpool2d("a", "c", window=3)
    g.conv("c2", "c", np.zeros((1, 1, 5, 4), np.float32))
    with pytest.raises(tnet.GraphValidationError, match="cin=5"):
        g.output("c2")
    g2 = tnet.NetworkGraph(f8, device="cpu")
    g2.output(g2.conv("c", g2.input_name, k))
    with pytest.raises(tnet.GraphValidationError, match="frozen"):
        g2.relu("r", "c")
    bad = tnet.NetworkGraph(f8, device="cpu")
    bad.conv("c", bad.input_name, np.zeros((3, 3, 4, 4), np.float32),
             padding="VALID")
    with pytest.raises(tnet.GraphValidationError, match="does not fit"):
        bad.shape_plan((1, 2, 2, 4))


def test_convert_rejects_wrong_geometry():
    planes = np.zeros((9, 10, 1), np.int32)     # e5m2: 10 planes
    with pytest.raises(ValueError, match="do not fit"):
        conv_weights_from_jax(planes, 3, 3, 2, 8, 5, 2, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        conv_weights_from_jax(planes, 3, 3, 1, 33, 5, 2, device="cpu")
    ok = conv_weights_from_jax(planes, 3, 3, 1, 32, 5, 2, device="cpu")
    assert ok.fmt == FPFormat(5, 2) and ok.planes.dtype == torch.int32


# ---------------------------------------------------------------------------
# Package boundary and default device
# ---------------------------------------------------------------------------
def test_import_loads_no_jax_and_no_reference():
    import repro_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.core.fused_backend.kernel" in mods
    assert {"repro_torch.quant", "repro_torch.quant.apply",
            "repro_torch.models", "repro_torch.models.transformer",
            "repro_torch.models.moe", "repro_torch.models.mamba",
            "repro_torch.configs", "repro_torch.configs.qwen2_0_5b",
            "repro_torch.serve", "repro_torch.serve.steps",
            "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.kernels.dequant_matmul",
            "repro_torch.kernels.dequant_matmul.ops",
            "repro_torch.launch.train", "repro_torch.train",
            "repro_torch.train.step", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.checkpoint",
            "repro_torch.checkpoint.store"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {['repro_torch'] + mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'repro')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f8 = FPFormat(5, 2)
    k = np.zeros((1, 1, 2, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnet.NetworkGraph(f8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnet.HobflopsNetwork([tnet.ConvLayerSpec(k, f8)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv_weights_from_jax(np.zeros((2, 10, 1), np.int32), 1, 1, 2, 2, 5, 2)
