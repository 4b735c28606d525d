"""The graph-structured bitslice-resident runner (DESIGN.md §9).

Acceptance-level checks: a residual + maxpool + mixed-precision graph
runs entirely in the plane domain, bit-exact to the per-layer
f32-boundary oracle, with exactly one entry encode and one exit decode
in the jaxpr; the pooling/add plane ops agree with their word-parallel
softfloat oracles; the validator replaces ad-hoc asserts with named
errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import softfloat as sf
from repro.core.bitslice import BitsliceActivation, pack_planes
from repro.core.fpformat import FPFormat
from repro.kernels.conv2d_bitslice.network import (ConvLayerSpec,
                                                   GraphValidationError,
                                                   HobflopsNetwork,
                                                   NetworkGraph)
from repro.kernels.conv2d_bitslice.ops import (add_activations,
                                               avgpool2d_activations,
                                               decode_activations,
                                               encode_activations,
                                               hobflops_relu_planes,
                                               maxpool2d_activations,
                                               relu_activations)

F8 = FPFormat(5, 2)    # hobflops8
F9 = FPFormat(5, 3)    # hobflops9
F11 = FPFormat(5, 5)   # hobflops11


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _residual_pool_graph(rng, fmt_lo=F8, fmt_hi=F11, cin=4, width=8,
                         backend="jnp", interpret=False):
    """The acceptance topology: conv -> maxpool -> (conv -> conv) +
    skip -> relu -> strided conv -> avgpool head, mixing two operand
    precisions."""
    g = NetworkGraph(fmt_lo, backend=backend, interpret=interpret)
    c1 = g.conv("c1", g.input_name, _rand(rng, (3, 3, cin, width), 0.4),
                relu=True)
    p1 = g.maxpool2d("p1", c1, window=2)
    c2 = g.conv("c2", p1, _rand(rng, (1, 1, width, width), 0.4),
                relu=True)
    c3 = g.conv("c3", c2, _rand(rng, (3, 3, width, width), 0.3),
                fmt_hi)                       # late layer: high precision
    res = g.add("res", c3, p1)                # skip auto-casts p1 up
    r = g.relu("r", res)
    d = g.conv("d", r, _rand(rng, (3, 3, width, width), 0.3), fmt_lo,
               stride=2)                      # strided downsample
    g.output(g.avgpool2d("head", d, window=2))
    return g


@pytest.mark.slow
def test_residual_pool_graph_bit_exact():
    """Tentpole acceptance: the branched, pooled, mixed-precision graph
    is bit-exact between the resident and f32-boundary oracle paths."""
    rng = np.random.default_rng(0)
    g = _residual_pool_graph(rng)
    img = _rand(rng, (1, 8, 8, 4))
    res = np.asarray(g.run(img))
    ref = np.asarray(g.run_roundtrip(img))
    assert res.shape == g.out_shape(img.shape)
    np.testing.assert_array_equal(res, ref)


def test_strided_graph_single_encode_decode():
    """The one-encode/one-decode invariant holds for a branched graph
    with a stride-2 conv and pooling: exactly one f32->i32 bitcast
    (entry) and one i32->f32 (exit) in the whole jaxpr."""
    from conftest import count_primitives
    rng = np.random.default_rng(1)
    g = _residual_pool_graph(rng)
    img = _rand(rng, (1, 8, 8, 4))
    jaxpr = jax.make_jaxpr(
        lambda x: g._resident_fn(x, g._weights))(img)
    assert count_primitives(jaxpr.jaxpr, "bitcast_convert_type") == 2


def test_resident_stride2_valid_graph():
    """stride=2 + padding=VALID through the resident graph path."""
    rng = np.random.default_rng(2)
    g = NetworkGraph(F9)
    c1 = g.conv("c1", g.input_name, _rand(rng, (3, 3, 4, 8), 0.4),
                stride=2, padding="VALID", relu=True)
    p = g.maxpool2d("p", c1, window=2, padding="VALID")
    g.output(p)
    img = _rand(rng, (2, 9, 9, 4))
    res = np.asarray(g.run(img))
    assert res.shape == g.out_shape(img.shape) == (2, 2, 2, 8)
    np.testing.assert_array_equal(res, np.asarray(g.run_roundtrip(img)))


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_maxpool_matches_f32(padding):
    """Plane-domain maxpool == f32 maxpool on already-quantized values
    (max only selects, never rounds).  The odd 5x5 spatial size makes
    SAME actually pad, exercising the -inf fill planes."""
    rng = np.random.default_rng(3)
    img = _rand(rng, (1, 5, 5, 5), 2.0)
    act = encode_activations(jnp.asarray(img), F9)
    q = np.asarray(decode_activations(act))           # quantized input
    out = maxpool2d_activations(act, window=2, padding=padding)
    got = np.asarray(decode_activations(out))
    pads = "VALID" if padding == "VALID" else "SAME"
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(q), -jnp.inf, jax.lax.max, (1, 2, 2, 1),
        (1, 2, 2, 1), pads))
    assert out.fmt == F9
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_window_gather_stride_gt_window(padding):
    """stride (3) > window (2): gathered windows skip pixels entirely;
    the plane-domain maxpool still equals the f32 reduce_window on
    quantized input under both paddings."""
    rng = np.random.default_rng(20)
    img = _rand(rng, (1, 7, 7, 3), 2.0)
    act = encode_activations(jnp.asarray(img), F9)
    q = np.asarray(decode_activations(act))
    out = maxpool2d_activations(act, window=2, stride=3, padding=padding)
    got = np.asarray(decode_activations(out))
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(q), -jnp.inf, jax.lax.max, (1, 2, 2, 1),
        (1, 3, 3, 1), padding))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_window_gather_window_equals_extent():
    """window == the whole input extent (global pooling): one output
    pixel; max equals the f32 global max, avg equals the pairwise
    fp_add tree + fp_scale oracle."""
    rng = np.random.default_rng(21)
    img = _rand(rng, (2, 4, 4, 3), 2.0)
    act = encode_activations(jnp.asarray(img), F9)
    q = np.asarray(decode_activations(act))
    gmax = maxpool2d_activations(act, window=4, padding="VALID")
    got = np.asarray(decode_activations(gmax))
    assert got.shape == (2, 1, 1, 3)
    np.testing.assert_array_equal(got[:, 0, 0], q.max(axis=(1, 2)))
    gavg = avgpool2d_activations(act, window=4, padding="VALID")
    codes = np.asarray(sf.encode_jnp(jnp.asarray(img), F9))
    from repro.kernels.conv2d_bitslice.ops import _fold_pairwise
    wins = [codes[:, i, j, :] for i in range(4) for j in range(4)]
    s = _fold_pairwise(wins, lambda a, b: sf.fp_add(a, b, F9))
    want = sf.decode(sf.fp_scale(s, 4, F9), F9).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(decode_activations(gavg))[:, 0, 0], want)


def test_window_gather_pad_fill_codes():
    """Direct geometry check of window_gather_planes under SAME-style
    padding: pad slots of every plane decode to exactly the fill code
    (-inf for max, +0 for avg), real slots to the source pixels."""
    from repro.core.bitslice import unpack_planes, window_gather_planes
    from repro.kernels.conv2d_bitslice.ops import neg_inf_code
    rng = np.random.default_rng(22)
    B, H, W, C = 1, 3, 3, 2
    codes = rng.integers(0, 1 << F9.nbits, (B * H * W, C)).astype(np.int32)
    planes = pack_planes(jnp.asarray(codes), F9.nbits)
    for fill in (0, neg_inf_code(F9)):
        wins, (Ho, Wo) = window_gather_planes(
            planes, (B, H, W, C), 2, 2, stride=2, pad_h=1, pad_w=1,
            fill_code=fill)
        assert (Ho, Wo) == (2, 2)
        # pad split is low-half-first: pad_h=1 -> no top pad, one
        # bottom row; reference gather over the padded code grid
        grid = np.full((H + 1, W + 1, C), fill, np.int64)
        grid[:H, :W] = codes.reshape(H, W, C)
        for k, (i, j) in enumerate((i, j) for i in range(2)
                                   for j in range(2)):
            got = np.asarray(unpack_planes(wins[k]))[:, :C]
            want = grid[i::2, j::2][:2, :2].reshape(Ho * Wo, C)
            np.testing.assert_array_equal(got, want, err_msg=f"win {k}")


def test_avgpool_same_pad_counts_include_pad():
    """avgpool SAME on an odd extent: +0 fill slots participate in the
    add tree and the divisor stays the full window area — bit-exact to
    the word-parallel oracle fold."""
    from repro.kernels.conv2d_bitslice.network import GraphNode, _oracle_pool
    rng = np.random.default_rng(23)
    img = _rand(rng, (1, 5, 5, 3), 2.0)
    act = encode_activations(jnp.asarray(img), F9)
    q = np.asarray(decode_activations(act))
    out = avgpool2d_activations(act, window=2, padding="SAME")
    got = np.asarray(decode_activations(out))
    nd = GraphNode("p", "avgpool2d", ("x",), stride=2, padding="SAME",
                   window=(2, 2))
    want = np.asarray(_oracle_pool(jnp.asarray(q), F9, nd))
    assert got.shape == (1, 3, 3, 3)
    np.testing.assert_array_equal(got, want)


def test_avgpool_matches_oracle():
    """Plane-domain avgpool == fp_add tree + fp_scale on codes."""
    rng = np.random.default_rng(4)
    img = _rand(rng, (1, 4, 4, 3), 2.0)
    act = encode_activations(jnp.asarray(img), F9)
    out = avgpool2d_activations(act, window=2)
    got = np.asarray(decode_activations(out))
    codes = np.asarray(sf.encode_jnp(jnp.asarray(img), F9))
    w = codes.reshape(1, 2, 2, 2, 2, 3)
    # same pairwise fold order as the plane path: ((w00+w01)+(w10+w11))
    s = sf.fp_add(sf.fp_add(w[:, :, 0, :, 0], w[:, :, 0, :, 1], F9),
                  sf.fp_add(w[:, :, 1, :, 0], w[:, :, 1, :, 1], F9), F9)
    want = sf.decode(sf.fp_scale(s, 2, F9), F9).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_add_activations_auto_cast():
    """Residual add across formats: the lower-precision branch is cast
    up, the sum equals the word-parallel oracle."""
    rng = np.random.default_rng(5)
    a_f = _rand(rng, (1, 2, 2, 7), 2.0)
    b_f = _rand(rng, (1, 2, 2, 7), 2.0)
    a = encode_activations(jnp.asarray(a_f), F11)
    b = encode_activations(jnp.asarray(b_f), F8)
    out = add_activations(a, b)                       # target: a.fmt
    assert out.fmt == F11 and out.shape == a.shape
    got = np.asarray(decode_activations(out))
    ca = sf.encode(a_f.astype(np.float64), F11)
    cb = sf.fp_cast(sf.encode(b_f.astype(np.float64), F8), F8, F11)
    want = sf.decode(sf.fp_add(ca, cb, F11), F11).astype(np.float32)
    np.testing.assert_array_equal(got.ravel(), want.ravel())


def test_relu_planes_exhaustive_vs_oracle():
    """Satellite: pin hobflops_relu_planes semantics (sign-set codes ->
    +0, canonical NaN propagates) against softfloat.fp_relu over every
    canonical code of a small format, plus every non-canonical sign-set
    exception code."""
    from test_softfloat import canonical_codes
    fmt = FPFormat(3, 2)
    xs = canonical_codes(fmt)
    # add the non-canonical negative NaN to pin its mapping too
    neg_nan = sf.pack(3, 1, 0, 0, fmt)
    xs = np.concatenate([xs, np.atleast_1d(neg_nan)])
    from repro.core.bitslice import pack_planes_np, unpack_planes_np
    planes = pack_planes_np(xs, fmt.nbits)
    got = unpack_planes_np(hobflops_relu_planes(planes, fmt), len(xs))
    want = sf.fp_relu(xs, fmt)
    np.testing.assert_array_equal(got, want)
    # spot-check the documented semantics
    assert sf.fp_relu(neg_nan, fmt) == 0                 # -NaN -> +0
    assert sf.fp_relu(sf.pack(2, 1, 0, 0, fmt), fmt) == 0   # -inf -> +0
    nan = sf.pack(3, 0, 0, 0, fmt)
    assert sf.fp_relu(nan, fmt) == nan                   # +NaN stays


def test_relu_activations_wrapper():
    rng = np.random.default_rng(6)
    act = encode_activations(jnp.asarray(_rand(rng, (1, 3, 3, 4))), F9)
    out = relu_activations(act)
    got = np.asarray(decode_activations(out))
    want = np.maximum(np.asarray(decode_activations(act)), 0.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_graph_pallas_interpret_matches_jnp():
    """The graph runner with the Pallas conv backend (interpret mode on
    CPU) is bit-identical to the jnp backend."""
    img = _rand(np.random.default_rng(7), (1, 6, 6, 4))
    want = np.asarray(_residual_pool_graph(
        np.random.default_rng(8)).run(img))
    got = np.asarray(_residual_pool_graph(
        np.random.default_rng(8), backend="pallas",
        interpret=True).run(img))
    np.testing.assert_array_equal(got, want)


def test_validator_unknown_input():
    g = NetworkGraph(F8)
    with pytest.raises(GraphValidationError, match="unknown input"):
        g.relu("r", "nope")


def test_validator_duplicate_name():
    g = NetworkGraph(F8)
    g.relu("r", g.input_name)
    with pytest.raises(GraphValidationError, match="duplicate"):
        g.relu("r", g.input_name)


def test_validator_channel_mismatch():
    rng = np.random.default_rng(9)
    g = NetworkGraph(F8)
    c1 = g.conv("c1", g.input_name, _rand(rng, (1, 1, 4, 8)))
    g.conv("c2", c1, _rand(rng, (1, 1, 6, 8)))      # cin 6 != cout 8
    with pytest.raises(GraphValidationError, match="c2.*8 channels"):
        g.output("c2")


def test_validator_add_shape_mismatch():
    rng = np.random.default_rng(10)
    g = NetworkGraph(F8)
    c1 = g.conv("c1", g.input_name, _rand(rng, (3, 3, 4, 8)), stride=2)
    c2 = g.conv("c2", g.input_name, _rand(rng, (3, 3, 4, 8)))
    g.add("sum", c1, c2)
    g.output("sum")
    with pytest.raises(GraphValidationError, match="branch shapes"):
        g.run(_rand(rng, (1, 8, 8, 4)))


def test_validator_conv_window_fit():
    """An ill-sized conv raises a named error from shape_plan, not a
    bare ZeroDivisionError from the tiling code."""
    rng = np.random.default_rng(12)
    g = NetworkGraph(F8)
    g.conv("c1", g.input_name, _rand(rng, (3, 3, 4, 8)), padding="VALID")
    g.output("c1")
    with pytest.raises(GraphValidationError, match="does not fit"):
        g.run(_rand(rng, (1, 2, 2, 4)))


def test_dead_branch_pruned():
    """Nodes that do not feed the output are neither traced nor shipped
    into the jitted call."""
    rng = np.random.default_rng(13)
    g = NetworkGraph(F8)
    c1 = g.conv("c1", g.input_name, _rand(rng, (1, 1, 4, 8), 0.4))
    g.conv("dead", g.input_name, _rand(rng, (3, 3, 4, 8), 0.4))
    g.output(c1)
    assert set(g._live_weights) == {"c1"}
    img = _rand(rng, (1, 4, 4, 4))
    np.testing.assert_array_equal(np.asarray(g.run(img)),
                                  np.asarray(g.run_roundtrip(img)))


def test_validator_avgpool_window_pow2():
    g = NetworkGraph(F8)
    with pytest.raises(GraphValidationError, match="power of two"):
        g.avgpool2d("p", g.input_name, window=3)


def test_validator_frozen_after_output():
    g = NetworkGraph(F8)
    g.relu("r", g.input_name)
    g.output("r")
    with pytest.raises(GraphValidationError, match="frozen"):
        g.relu("r2", "r")


def test_hobflops_network_is_linear_graph():
    """The sequential wrapper lowers onto conv0..convN nodes of a
    NetworkGraph and stays bit-exact through it."""
    rng = np.random.default_rng(11)
    img = _rand(rng, (1, 6, 6, 4))
    specs = [ConvLayerSpec(_rand(rng, (3, 3, 4, 8), 0.4), F8),
             ConvLayerSpec(_rand(rng, (1, 1, 8, 8), 0.4), F9)]
    net = HobflopsNetwork(specs)
    assert isinstance(net.graph, NetworkGraph)
    assert [n.kind for n in net.graph._nodes.values()] == \
        ["input", "conv", "conv"]
    np.testing.assert_array_equal(np.asarray(net(img)),
                                  np.asarray(net.run_roundtrip(img)))
