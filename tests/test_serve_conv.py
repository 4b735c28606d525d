"""Lane-batched serving engine (DESIGN.md §10).

Acceptance-level checks: every request served through a packed wave —
ragged final waves, heterogeneous mini-batch requests, bucket pad, and
the sharded path included — decodes bit-identical to ``graph.run`` on
that request alone; one encode + one decode per wave in the jaxpr; the
runner cache bounds compiled shapes to the bucket ladder; a seeded
``tune_conv_blocks`` disk cache is honored without running the sweep.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.bitslice import stack_activations, split_activation
from repro.core.fpformat import FPFormat
from repro.kernels.conv2d_bitslice.network import NetworkGraph
from repro.kernels.conv2d_bitslice.ops import (decode_activations,
                                               encode_activations)
from repro.serve_conv import (ConvRequest, ConvServeEngine, RunnerCache,
                              ServeError, bucket_for, bucket_sizes,
                              derive_max_batch, pack_wave,
                              tuned_conv_blocks, unpack_wave, wave_mesh,
                              wave_sharded_runner)
from repro.serve_conv.cache import TUNE_CACHE_ENV, tune_cache_path, tune_key

F8 = FPFormat(5, 2)
F9 = FPFormat(5, 3)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _graph(rng, cin=4, width=8, fmt=F8):
    """Small serving graph: 3x3 conv -> pointwise -> maxpool."""
    g = NetworkGraph(fmt)
    c1 = g.conv("c1", g.input_name, _rand(rng, (3, 3, cin, width), 0.4),
                relu=True)
    c2 = g.conv("c2", c1, _rand(rng, (1, 1, width, width), 0.4),
                relu=True)
    g.output(g.maxpool2d("head", c2, window=2))
    return g


# ---------------------------------------------------------------------------
# lanes: pack/unpack
# ---------------------------------------------------------------------------
def test_pack_unpack_roundtrip_ragged():
    """Heterogeneous request sizes pack contiguously, pad to the
    bucket, and slice back exactly (rank restored for 3-d requests)."""
    rng = np.random.default_rng(0)
    imgs = [_rand(rng, (5, 5, 3)), _rand(rng, (2, 5, 5, 3)),
            _rand(rng, (5, 5, 3))]
    batch, plan = pack_wave(imgs, bucket=8)
    assert batch.shape == (8, 5, 5, 3)
    assert plan.filled == 4 and plan.occupancy == 0.5
    np.testing.assert_array_equal(batch[4:], 0.0)
    back = unpack_wave(batch, plan)
    np.testing.assert_array_equal(back[0], imgs[0])
    np.testing.assert_array_equal(back[1], imgs[1])
    np.testing.assert_array_equal(back[2], imgs[2])
    assert back[0].shape == (5, 5, 3) and back[1].shape == (2, 5, 5, 3)


def test_pack_wave_validates_geometry():
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="geometry"):
        pack_wave([_rand(rng, (4, 4, 3)), _rand(rng, (5, 5, 3))], 4)
    with pytest.raises(ServeError, match="bucket"):
        pack_wave([_rand(rng, (3, 4, 4, 3))], 2)


def test_bucket_ladder():
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(6) == (1, 2, 4, 6)
    assert bucket_for(3, (1, 2, 4, 8)) == 4
    with pytest.raises(ValueError, match="exceed"):
        bucket_for(9, (1, 2, 4, 8))
    assert derive_max_batch((8, 8, 4)) == 64
    assert derive_max_batch((64, 64, 4)) == 1


# ---------------------------------------------------------------------------
# plane-level stack/split
# ---------------------------------------------------------------------------
def test_stack_split_activations_bit_exact():
    """Plane-level wave coalescing: stacking per-request carriers
    equals encoding the stacked batch; splitting recovers each request
    bit-exactly."""
    rng = np.random.default_rng(2)
    imgs = _rand(rng, (4, 6, 6, 5), 2.0)
    a = encode_activations(jnp.asarray(imgs[:1]), F9)
    b = encode_activations(jnp.asarray(imgs[1:]), F9)
    s = stack_activations([a, b])
    assert s.shape == (4, 6, 6, 5)
    full = encode_activations(jnp.asarray(imgs), F9)
    np.testing.assert_array_equal(np.asarray(decode_activations(s)),
                                  np.asarray(decode_activations(full)))
    pa, pb = split_activation(s, [1, 3])
    np.testing.assert_array_equal(np.asarray(decode_activations(pa)),
                                  np.asarray(decode_activations(a)))
    np.testing.assert_array_equal(np.asarray(decode_activations(pb)),
                                  np.asarray(decode_activations(b)))


# ---------------------------------------------------------------------------
# engine: wave admission + bit-exactness
# ---------------------------------------------------------------------------
def test_engine_bit_exact_vs_per_request():
    """Tentpole acceptance: 5 heterogeneous requests served over a full
    wave + a ragged final wave all decode bit-identical to graph.run on
    each request alone (bucket pad included)."""
    rng = np.random.default_rng(3)
    g = _graph(rng)
    eng = ConvServeEngine(g, (8, 8, 4), max_batch=4)
    reqs = [ConvRequest(0, _rand(rng, (8, 8, 4))),
            ConvRequest(1, _rand(rng, (2, 8, 8, 4))),
            ConvRequest(2, _rand(rng, (8, 8, 4))),        # wave 0: 4 imgs
            ConvRequest(3, _rand(rng, (8, 8, 4))),
            ConvRequest(4, _rand(rng, (2, 8, 8, 4)))]     # wave 1: ragged
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert [r.rid for r in done] == [0, 1, 2, 3, 4]
    assert eng.waves == 2 and eng.images_served == 7
    assert eng.wave_occupancy == [1.0, 0.75]        # 4/4, then 3 in a 4
    for r in done:
        batched = r.image[None] if r.image.ndim == 3 else r.image
        solo = np.asarray(g.run(batched))
        solo = solo[0] if r.image.ndim == 3 else solo
        np.testing.assert_array_equal(np.asarray(r.out), solo,
                                      err_msg=f"request {r.rid}")
        assert r.done and r.latency_s > 0
    st = eng.stats()
    assert st["images_per_s"] > 0 and st["macs_per_s"] > 0


def test_engine_one_encode_decode_per_wave():
    """A packed wave is one resident call: exactly one f32->i32 bitcast
    (entry encode) and one i32->f32 (exit decode) in the wave jaxpr."""
    from conftest import count_primitives
    rng = np.random.default_rng(4)
    g = _graph(rng)
    eng = ConvServeEngine(g, (8, 8, 4), max_batch=4)
    runner, _ = eng.executor._runner(g, (8, 8, 4), 4, None)
    jaxpr = jax.make_jaxpr(runner)(np.zeros((4, 8, 8, 4), np.float32))
    assert count_primitives(jaxpr.jaxpr, "bitcast_convert_type") == 2


def test_engine_rejects_oversized_and_misshaped():
    rng = np.random.default_rng(5)
    g = _graph(rng)
    eng = ConvServeEngine(g, (8, 8, 4), max_batch=2)
    with pytest.raises(ValueError, match="max_batch"):
        eng.submit(ConvRequest(0, _rand(rng, (3, 8, 8, 4))))
    with pytest.raises(ValueError, match="geometry"):
        eng.submit(ConvRequest(1, _rand(rng, (6, 6, 4))))


def test_runner_cache_buckets_bound_compiles():
    """Wave sizes 1/2/3/4/1 touch only buckets {1, 2, 4}: three misses,
    then hits — the compiled-program count is the bucket ladder, not
    the traffic mix."""
    rng = np.random.default_rng(6)
    g = _graph(rng)
    cache = RunnerCache()
    eng = ConvServeEngine(g, (8, 8, 4), max_batch=4, runner_cache=cache)
    for n in (1, 2, 3, 4, 1):
        for i in range(n):
            eng.submit(ConvRequest(i, _rand(rng, (8, 8, 4))))
        eng.run_wave()
    assert len(cache) == 3                       # buckets 1, 2, 4
    assert cache.misses == 3 and cache.hits == 2
    st = eng.stats()
    assert st["runner_cache"] == {"size": 3, "hits": 2, "misses": 3,
                                  "evictions": 0}


def test_runner_cache_key_separates_graphs():
    rng = np.random.default_rng(7)
    g1, g2 = _graph(rng), _graph(rng, fmt=F9)
    cache = RunnerCache()
    assert g1.signature() != g2.signature()
    assert cache.key(g1, (8, 8, 4), 2) != cache.key(g2, (8, 8, 4), 2)
    # same structure, different weight values: same compiled runner key
    g3 = _graph(np.random.default_rng(99))
    assert g1.signature() == g3.signature()


# ---------------------------------------------------------------------------
# tune persistence
# ---------------------------------------------------------------------------
def test_tune_cache_seeded_is_honored(tmp_path, monkeypatch):
    """A seeded disk cache short-circuits the sweep entirely: the
    stored blocks come back verbatim and tune_conv_blocks is never
    called."""
    rng = np.random.default_rng(8)
    img = _rand(rng, (1, 6, 6, 4))
    kern = _rand(rng, (3, 3, 4, 8), 0.3)
    path = str(tmp_path / "tune.json")
    key = tune_key(img.shape, kern, F8)
    seeded = {"p_block": 8, "m_block": 32, "c_block": 36, "c_unroll": 2}
    with open(path, "w") as f:
        json.dump({key: {"blocks": seeded, "backend": "jnp",
                         "seconds_per_call": 1.0}}, f)

    def boom(*a, **k):                            # pragma: no cover
        raise AssertionError("sweep ran despite a seeded cache")
    monkeypatch.setattr("repro.serve_conv.cache.tune_conv_blocks", boom)
    blocks, dt = tuned_conv_blocks(img, kern, fmt=F8, path=path)
    assert blocks == seeded and dt is None


def test_tune_cache_stale_backend_warns_and_retunes(tmp_path):
    """An entry without a backend tag (pre-versioning file, or a
    hand-seeded one) is stale: it is never reused silently — a warning
    fires, the sweep re-runs, and the fresh tagged winner replaces the
    entry."""
    rng = np.random.default_rng(8)
    img = _rand(rng, (1, 6, 6, 4))
    kern = _rand(rng, (1, 1, 4, 8), 0.3)
    path = str(tmp_path / "tune.json")
    cands = [{"c_unroll": 1, "m_block": 8}]
    key = tune_key(img.shape, kern, F8, candidates=cands)
    stale = {"p_block": 1, "m_block": 1, "c_block": 1, "c_unroll": 1}
    with open(path, "w") as f:
        json.dump({key: {"blocks": stale, "seconds_per_call": 1.0}}, f)
    with pytest.warns(RuntimeWarning, match="stale"):
        blocks, dt = tuned_conv_blocks(img, kern, fmt=F8, path=path,
                                       iters=1, candidates=cands)
    assert dt is not None                     # the sweep actually ran
    entry = json.load(open(path))[key]
    assert entry["backend"] == "jnp"          # replaced, now tagged
    # tagged entry is honored again on the next call
    blocks2, dt2 = tuned_conv_blocks(img, kern, fmt=F8, path=path,
                                     candidates=cands)
    assert blocks2 == blocks and dt2 is None


def test_tune_cache_miss_runs_and_persists(tmp_path):
    rng = np.random.default_rng(9)
    img = _rand(rng, (1, 6, 6, 4))
    kern = _rand(rng, (1, 1, 4, 8), 0.3)
    path = str(tmp_path / "tune.json")
    cands = [{"c_unroll": 1, "m_block": 8}]
    blocks, dt = tuned_conv_blocks(img, kern, fmt=F8, path=path, iters=1,
                                   candidates=cands)
    assert dt is not None and os.path.exists(path)
    # second call with the same candidate set: pure disk hit
    blocks2, dt2 = tuned_conv_blocks(img, kern, fmt=F8, path=path,
                                     candidates=cands)
    assert blocks2 == blocks and dt2 is None
    # a different candidate set is a different problem: no false hit
    assert tune_key(img.shape, kern, F8, candidates=cands) != \
        tune_key(img.shape, kern, F8)


def test_tune_cache_env_var_override(monkeypatch, tmp_path):
    monkeypatch.setenv(TUNE_CACHE_ENV, str(tmp_path / "env.json"))
    assert tune_cache_path() == str(tmp_path / "env.json")
    assert tune_cache_path("/explicit.json") == "/explicit.json"


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------
def test_sharded_wave_bit_exact_single_device():
    """The shard_map path (1-device CPU mesh) equals the unsharded wave
    bit-for-bit, end to end through the engine."""
    rng = np.random.default_rng(10)
    g = _graph(rng)
    imgs = _rand(rng, (4, 8, 8, 4))
    runner = wave_sharded_runner(g, wave_mesh())
    np.testing.assert_array_equal(np.asarray(runner(imgs)),
                                  np.asarray(g.run(imgs)))
    eng = ConvServeEngine(g, (8, 8, 4), max_batch=4, mesh=wave_mesh())
    for i in range(4):
        eng.submit(ConvRequest(i, imgs[i]))
    done = eng.run()
    for i, r in enumerate(done):
        np.testing.assert_array_equal(np.asarray(r.out),
                                      np.asarray(g.run(imgs[i:i + 1]))[0])


_MULTIDEV_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax
from repro.core.fpformat import FPFormat
from repro.kernels.conv2d_bitslice.network import NetworkGraph
from repro.serve_conv import wave_mesh, wave_sharded_runner

assert len(jax.devices()) == 2
rng = np.random.default_rng(0)
g = NetworkGraph(FPFormat(5, 2))
c1 = g.conv("c1", g.input_name,
            (rng.standard_normal((3, 3, 3, 4)) * 0.4).astype(np.float32),
            relu=True)
g.output(c1)
imgs = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
got = np.asarray(wave_sharded_runner(g, wave_mesh())(imgs))
np.testing.assert_array_equal(got, np.asarray(g.run(imgs)))
print("MULTIDEV-OK")
"""


@pytest.mark.timeout(75)
def test_sharded_wave_bit_exact_two_devices():
    """A real 2-device split of the wave batch (forced host devices in
    a subprocess: the in-process device set must stay 1) is bit-exact
    vs single-device."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", _MULTIDEV_SCRIPT],
                         capture_output=True, text=True, env=env,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "MULTIDEV-OK" in out.stdout


# ---------------------------------------------------------------------------
# summary / signature satellites
# ---------------------------------------------------------------------------
def test_summary_snapshot():
    """NetworkGraph.summary emits the exact per-node table the engine
    logs at startup."""
    rng = np.random.default_rng(11)
    g = _graph(rng)
    expected = "\n".join([
        "node   op         format    out shape  MACs",
        "-------------------------------------------",
        "input  input      e5f2/10b  1x8x8x4    -",
        "c1     conv       e5f3/11b  1x8x8x8    18,432",
        "c2     conv       e5f3/11b  1x8x8x8    4,096",
        "head   maxpool2d  e5f3/11b  1x4x4x8    -",
        "total                                  22,528",
    ])
    assert g.summary((1, 8, 8, 4)) == expected


def test_signature_ignores_pruned_dead_branches():
    """Two graphs whose live node sets match share a signature (and
    therefore a RunnerCache entry) even when one carried a dead branch
    that output() pruned from the compiled runner."""
    def build(dead):
        rng = np.random.default_rng(14)
        g = NetworkGraph(F8)
        c1 = g.conv("c1", g.input_name, _rand(rng, (1, 1, 4, 8), 0.4))
        if dead:
            g.conv("dead", g.input_name, _rand(rng, (3, 3, 4, 8), 0.4))
        return g.output(c1)
    assert build(False).signature() == build(True).signature()


def test_conv_launch_blocks_threaded_and_bit_exact():
    """A tune_conv_blocks winner pinned via conv(blocks=...) reaches
    the kernel launch of both runners: outputs stay bit-exact (launch
    geometry never changes values) and the compiled structure —
    signature — reflects the override."""
    def build(blocks):
        rng = np.random.default_rng(15)
        g = NetworkGraph(F8)
        c1 = g.conv("c1", g.input_name, _rand(rng, (3, 3, 4, 8), 0.4),
                    relu=True, blocks=blocks)
        return g.output(c1)
    img = _rand(np.random.default_rng(16), (1, 6, 6, 4))
    base, tuned = build(None), build({"c_unroll": 2, "m_block": 8})
    assert base.signature() != tuned.signature()
    assert tuned._nodes["c1"].blocks == (("c_unroll", 2), ("m_block", 8))
    want = np.asarray(base.run(img))
    np.testing.assert_array_equal(np.asarray(tuned.run(img)), want)
    np.testing.assert_array_equal(np.asarray(tuned.run_roundtrip(img)),
                                  want)
    from repro.kernels.conv2d_bitslice.network import GraphValidationError
    with pytest.raises(GraphValidationError, match="unknown launch"):
        build({"bogus": 1})


def test_signature_stability_and_sensitivity():
    rng = np.random.default_rng(12)
    g = _graph(rng)
    assert g.signature() == g.signature()
    # strided variant differs structurally
    g2 = NetworkGraph(F8)
    c1 = g2.conv("c1", g2.input_name, _rand(rng, (3, 3, 4, 8), 0.4),
                 relu=True, stride=2)
    c2 = g2.conv("c2", c1, _rand(rng, (1, 1, 8, 8), 0.4), relu=True)
    g2.output(g2.maxpool2d("head", c2, window=2))
    assert g.signature() != g2.signature()
