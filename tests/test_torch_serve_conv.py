"""The port's lane-batched serving engine against the JAX package's.

One scripted queue goes through the reference ``repro.serve_conv``
engine and through ``repro_torch.serve_conv`` on the CPU, where the
``cuda_fused`` wrapper runs its kernel's plain version: mixed singles
and mini-batches, a ragged wave closed by its deadline, bucket pad, a
full wave, an expired request, a rejected payload, one injected
transient wave error, an overload burst with a shed request, and the
recovery — all on a fake clock.  Both engines serve the same graphs
(the reference's encoded weights carried across by
``repro_torch.convert``); their per-request tags, output bit patterns
and non-time counters must be equal, and every port response must equal
the reference's ``graph.run`` on that request alone.  No tolerance:
HOBFLOPS arithmetic is integer logic, floats compare as int32 bits.

The rest replays ``tests/test_serve_conv.py``'s scenarios on the port:
packing, buckets, runner cache, tune caches (the port's own file and
variable), sharding over a list of devices, the card-memory
``derive_max_batch`` and the entry points' refusal without a card.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import repro.serve_conv as jserve
from repro.core import fpformat as jfp
from repro.kernels.conv2d_bitslice import network as jnet
import repro_torch.serve_conv as tserve
from repro_torch.convert import conv_weights_from_jax, graph_weights_from_jax
from repro_torch.core.fpformat import FPFormat
from repro_torch.kernels.conv2d_bitslice import network as tnet
from repro_torch.kernels.conv2d_bitslice import ops as tconv
from repro_torch.serve_conv import (ConvRequest, ConvServeEngine,
                                    RunnerCache, ServeError,
                                    WaveShardingError, bucket_for,
                                    bucket_sizes, derive_max_batch,
                                    pack_wave, tuned_conv_blocks,
                                    unpack_wave, wave_mesh,
                                    wave_sharded_runner)
from repro_torch.serve_conv import engine as tengine
from repro_torch.serve_conv.cache import (TUNE_CACHE_ENV, tune_cache_path,
                                          tune_key)

F8, F9 = FPFormat(5, 2), FPFormat(5, 3)
HWC = (6, 6, 4)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _geometry(w):
    return (w.kh, w.kw, w.cin, w.cout, w.fmt.w_e, w.fmt.w_f)


def _graph(mod, fmt, kernels, **kw):
    """``tests/test_serve_faults.py``'s serving graph in either package:
    3x3 conv with ReLU, then a 2x2 maxpool head.  Chain depth 1 keeps
    each of the reference's compiles to a few seconds (values never
    depend on it)."""
    g = mod.NetworkGraph(fmt, **kw)
    c1 = g.conv("c1", g.input_name, kernels, relu=True,
                blocks={"c_unroll": 1})
    return g.output(g.maxpool2d("head", c1, window=2))


def _solo(graph, image):
    """``graph.run`` on one request alone, rank restored."""
    batched = image[None] if image.ndim == 3 else image
    out = np.asarray(graph.run(batched))
    return out[0] if image.ndim == 3 else out


# ---------------------------------------------------------------------------
# The scripted queue, through either package's engine
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float):
        self.now += s


# rid -> image shape: singles and mini-batches of 2 and 4 (the degraded
# variant serves only shapes 1 and 4: each new shape is a reference
# compile)
SHAPES = {0: HWC, 1: (2,) + HWC, 2: (4,) + HWC, 3: HWC, 4: HWC, 5: HWC,
          6: HWC, 7: (2,) + HWC, 8: (2,) + HWC, 9: HWC, 10: HWC,
          11: (4,) + HWC, 12: (4,) + HWC, 13: HWC, 14: HWC, 15: HWC,
          16: HWC}


def _script(S, g, g8, images):
    """Drive one engine of package ``S`` through the scripted queue;
    returns ``(engine, {rid: request}, submit/step events)``."""
    clock = FakeClock()
    faults = S.FaultInjector(S.FaultPlan(), seed=0)
    policy = S.ServePolicy(wave_deadline_ms=10.0, max_queue_images=12,
                           max_wave_retries=2, retry_backoff_s=1e-4,
                           degrade_queue_factor=1.0, degrade_patience=2,
                           recover_patience=2)
    eng = S.ConvServeEngine(g, HWC, max_batch=4, clock=clock,
                            policy=policy, faults=faults)
    assert eng.register_degraded(g8, "hobflops8") == 1
    reqs, events = {}, []

    def submit(rid, **kw):
        reqs[rid] = r = S.ConvRequest(rid, images[rid], **kw)
        try:
            eng.submit(r)
            events.append((rid, "queued"))
        except S.ServeError as e:
            events.append((rid, type(e).__name__))

    def step():
        events.append(("step", [r.rid for r in eng.step()]))

    submit(0)                   # 1 + 2 images: not full, not yet aged
    submit(1)
    step()
    clock.advance(0.012)
    step()                      # deadline: ragged wave, bucket 4, 1 pad
    submit(2)                   # 4 images: full, closes at once
    step()
    submit(3, deadline_ms=5.0)  # will age out while queued
    clock.advance(0.006)
    submit(4)                   # NaN payload: rejected at submit
    submit(5)
    clock.advance(0.011)
    step()                      # 3 expires; 5 alone in bucket 1
    faults.plan.wave_errors = 1
    submit(6)
    submit(7)
    clock.advance(0.011)
    step()                      # injected error, retried: attempts 2
    for rid in range(8, 14):    # burst: 12 images queued, 13 shed
        submit(rid)
    for _ in range(4):
        step()                  # hot, hot -> degraded waves
    for rid in (14, 15, 16):    # light traffic: cold, cold -> recover
        submit(rid)
        clock.advance(0.011)
        step()
    return eng, reqs, events


def _images():
    rng = np.random.default_rng(20)
    images = {rid: _rand(rng, shape) for rid, shape in SHAPES.items()}
    images[4] = np.full(HWC, np.nan, np.float32)
    return images


NON_TIME_STATS = ("waves", "waves_failed", "images_served",
                  "requests_served", "requests_failed", "requests_expired",
                  "requests_rejected", "requests_shed", "queued_images",
                  "max_batch", "buckets", "mean_occupancy", "wave_retries",
                  "wave_exec_failures", "runner_cache", "degradation",
                  "heartbeat")
TAGS = ("status", "wave", "level", "precision", "attempts", "degraded")


@pytest.fixture(scope="module")
def reference():
    """Everything JAX: the reference graphs (F9 and its F8 variant), the
    scripted queue through the reference engine, and each served
    request's ``graph.run`` alone at its precision."""
    rng = np.random.default_rng(0)
    k = _rand(rng, (3, 3, 4, 4), 0.4)
    jg = _graph(jnet, jfp.FPFormat(5, 3), k)
    jg8 = jg.with_precision(jfp.FPFormat(5, 2))
    images = _images()
    eng, reqs, events = _script(jserve, jg, jg8, images)
    solo = {rid: _solo(jg8 if r.degraded else jg, r.image)
            for rid, r in reqs.items() if r.status == "served"}
    weights = {name: {n: (np.asarray(w.planes), _geometry(w))
                      for n, w in g._weights.items()}
               for name, g in (("full", jg), ("degraded", jg8))}
    return types.SimpleNamespace(
        kernels=k, images=images, reqs=reqs, events=events,
        stats=eng.stats(), solo=solo, weights=weights)


@pytest.fixture(scope="module")
def port(reference):
    g = _graph(tnet, F9, graph_weights_from_jax(
        reference.weights["full"], device="cpu")["c1"], device="cpu")
    g8 = _graph(tnet, F8, graph_weights_from_jax(
        reference.weights["degraded"], device="cpu")["c1"], device="cpu")
    eng, reqs, events = _script(tserve, g, g8, reference.images)
    return types.SimpleNamespace(engine=eng, reqs=reqs, events=events,
                                 stats=eng.stats())


def test_script_covers_every_path(port):
    """The script really takes each path it is meant to: a padded
    ragged wave, a retried wave, expiry, rejection, shedding, degraded
    waves and the recovery."""
    st, reqs = port.stats, port.reqs
    assert st["wave_exec_failures"] == 1 and st["waves_failed"] == 0
    assert (st["requests_expired"], st["requests_rejected"],
            st["requests_shed"]) == (1, 1, 1)
    assert reqs[6].attempts == 2
    assert st["degradation"]["activations"] == 1
    assert {r.precision for r in reqs.values()} >= {"full", "hobflops8"}
    assert reqs[14].precision == "hobflops8" and reqs[15].precision == "full"
    assert 0.75 in port.engine.wave_occupancy      # 3 images in bucket 4
    assert st["queued_images"] == 0


def test_engine_tags_match_reference(reference, port):
    assert port.events == reference.events
    for rid, want in reference.reqs.items():
        got = port.reqs[rid]
        assert [getattr(got, t) for t in TAGS] == \
            [getattr(want, t) for t in TAGS], rid


def test_engine_outputs_match_reference_bits(reference, port):
    for rid, want in reference.reqs.items():
        got = port.reqs[rid]
        if want.out is None:
            assert got.out is None, rid
            continue
        assert got.out.shape == np.asarray(want.out).shape, rid
        np.testing.assert_array_equal(_bits(got.out), _bits(want.out),
                                      err_msg=f"request {rid}")


def test_engine_counters_match_reference(reference, port):
    for key in NON_TIME_STATS:
        assert port.stats[key] == reference.stats[key], key


def test_responses_equal_reference_solo_run(reference, port):
    """Every port response equals the reference ``graph.run`` on that
    request alone, at the precision it was served at."""
    assert set(reference.solo) == {rid for rid, r in port.reqs.items()
                                   if r.status == "served"}
    for rid, want in reference.solo.items():
        np.testing.assert_array_equal(_bits(port.reqs[rid].out),
                                      _bits(want), err_msg=f"request {rid}")


def test_port_variant_encodes_as_reference_variant(reference):
    """The port's own ``with_precision`` from the f32 kernels encodes
    the same F8 planes as the reference's variant carried across."""
    g8 = _graph(tnet, F9, reference.kernels, device="cpu") \
        .with_precision(F8)
    want = graph_weights_from_jax(reference.weights["degraded"],
                                  device="cpu")["c1"]
    assert torch.equal(g8._weights["c1"].planes, want.planes)
    assert g8.signature() == _graph(tnet, F8, want, device="cpu").signature()


# ---------------------------------------------------------------------------
# lanes: pack/unpack
# ---------------------------------------------------------------------------
def test_pack_unpack_roundtrip_ragged():
    """Heterogeneous request sizes (numpy and tensor payloads) pack
    contiguously, pad to the bucket, and slice back exactly (rank
    restored for 3-d requests)."""
    rng = np.random.default_rng(0)
    imgs = [_rand(rng, (5, 5, 3)), torch.from_numpy(_rand(rng, (2, 5, 5, 3))),
            _rand(rng, (5, 5, 3))]
    batch, plan = pack_wave(imgs, bucket=8)
    assert batch.shape == (8, 5, 5, 3) and batch.dtype == np.float32
    assert plan.filled == 4 and plan.occupancy == 0.5
    np.testing.assert_array_equal(batch[4:], 0.0)
    back = unpack_wave(batch, plan)
    np.testing.assert_array_equal(back[0], imgs[0])
    np.testing.assert_array_equal(back[1], imgs[1].numpy())
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


# ---------------------------------------------------------------------------
# derive_max_batch: the wave's memory against the device's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("image_bytes,budget,want", [
    (100, 99, 1),               # not even one image fits: still 1
    (100, 100, 1),
    (100, 399, 2),              # 3 fit: the largest power of two is 2
    (100, 400, 4),
    (100, 6399, 32),
    (100, 10 ** 9, 64),         # clamped to the cap
])
def test_max_batch_for_budget(image_bytes, budget, want):
    assert tengine.max_batch_for(image_bytes, budget) == want
    assert tengine.max_batch_for(image_bytes, budget, cap=16) == \
        min(want, 16)


def test_derive_max_batch_h100_figure():
    """The MobileNets 14x14x512 hobflops9 stack (weights all zero
    codes: the count depends on shapes only; hobflops9 is e5m3, 11 bit
    planes): 61,816,832 B an image, and on an H100 80GB's ~80 GB the
    cap of 64 — a pure function of the byte count, no card needed."""
    zero = {n: conv_weights_from_jax(np.zeros((kh * kh * 512, 11, 16),
                                              np.int32), kh, kh, 512, 512,
                                     5, 3, device="cpu")
            for n, kh in (("c0", 3), ("c1", 1), ("c2", 1))}
    g = tnet.NetworkGraph(F9, device="cpu")
    src = g.input_name
    for name in ("c0", "c1", "c2"):
        src = g.conv(name, src, zero[name], relu=True)
    g.output(src)
    per_image = tengine.wave_bytes(g, (14, 14, 512))
    assert per_image == 196 * 4608 * 11 * 4 + 5 * 196 * 512 * 11 * 4 == \
        61_816_832
    assert g.macs((1, 14, 14, 512)) == 565_182_464
    budget = int(tengine.MEM_SHARE * 80e9)
    assert tengine.max_batch_for(per_image, budget) == 64
    # the TPU rule the port replaced would have stopped at 4
    assert tengine.max_batch_for(per_image, 4 * per_image) == 4


def test_derive_max_batch_on_cpu_budget():
    rng = np.random.default_rng(2)
    g = _graph(tnet, F8, _rand(rng, (3, 3, 4, 8), 0.4), device="cpu")
    per_image = tengine.wave_bytes(g, (8, 8, 4))
    assert per_image == 64 * 36 * 10 * 4 + 5 * 64 * 4 * 10 * 4
    assert derive_max_batch(g, (8, 8, 4)) == 64
    # 256x256: 146,800,640 B an image, 7 in the CPU's 1 GiB
    assert derive_max_batch(g, (256, 256, 4)) == 4


# ---------------------------------------------------------------------------
# runner cache
# ---------------------------------------------------------------------------
def test_runner_cache_buckets_bound_builds():
    """Wave sizes 1/2/3/4/1 touch only buckets {1, 2, 4}: three misses,
    then hits — the runner count is the bucket ladder, not the traffic
    mix — and every answer is the request's ``graph.run`` alone."""
    rng = np.random.default_rng(6)
    g = _graph(tnet, F8, _rand(rng, (3, 3, 4, 4), 0.4), device="cpu")
    pool = [_rand(rng, HWC) for _ in range(4)]
    want = [_solo(g, img) for img in pool]
    cache = RunnerCache()
    eng = ConvServeEngine(g, HWC, max_batch=4, runner_cache=cache)
    for n in (1, 2, 3, 4, 1):
        reqs = [ConvRequest(i, pool[i]) for i in range(n)]
        for r in reqs:
            eng.submit(r)
        eng.run_wave()
        for i, r in enumerate(reqs):
            np.testing.assert_array_equal(_bits(r.out), _bits(want[i]))
    assert len(cache) == 3 and cache.misses == 3 and cache.hits == 2
    assert eng.stats()["runner_cache"] == {"size": 3, "hits": 2,
                                           "misses": 3, "evictions": 0}
    assert eng.wave_occupancy == [1.0, 1.0, 0.75, 1.0, 1.0]


def test_runner_cache_key_separates_graphs():
    rng = np.random.default_rng(7)
    k = _rand(rng, (3, 3, 4, 4), 0.4)
    g1, g2 = _graph(tnet, F8, k, device="cpu"), \
        _graph(tnet, F9, k, device="cpu")
    cache = RunnerCache()
    assert g1.signature() != g2.signature()
    assert cache.key(g1, HWC, 2) != cache.key(g2, HWC, 2)
    assert cache.key(g1, HWC, 2) != cache.key(g1, HWC, 2, "wave2")
    # same structure, different weight values: same runner key
    g3 = _graph(tnet, F8, _rand(rng, (3, 3, 4, 4)), device="cpu")
    assert g1.signature() == g3.signature()


# ---------------------------------------------------------------------------
# tune_conv_blocks and its disk cache
# ---------------------------------------------------------------------------
CANDS = [{"c_unroll": 1, "m_block": 8}]


def _tune_problem(kh):
    rng = np.random.default_rng(8)
    return _rand(rng, (1, 6, 6, 4)), _rand(rng, (kh, kh, 4, 8), 0.3)


def test_tune_cache_seeded_is_honored(tmp_path, monkeypatch):
    """A seeded disk cache short-circuits the sweep entirely: the stored
    blocks come back verbatim and tune_conv_blocks is never called."""
    img, kern = _tune_problem(3)
    path = str(tmp_path / "tune.json")
    key = tune_key(img.shape, kern, F8, device="cpu")
    seeded = {"p_block": 8, "m_block": 32, "c_block": 36, "c_unroll": 2}
    with open(path, "w") as f:
        json.dump({key: {"blocks": seeded, "backend": "cuda_fused",
                         "seconds_per_call": 1.0}}, f)

    def boom(*a, **k):                            # pragma: no cover
        raise AssertionError("sweep ran despite a seeded cache")
    monkeypatch.setattr("repro_torch.serve_conv.cache.tune_conv_blocks",
                        boom)
    blocks, dt = tuned_conv_blocks(img, kern, fmt=F8, device="cpu",
                                   path=path)
    assert blocks == seeded and dt is None


def test_tune_cache_stale_backend_warns_and_retunes(tmp_path):
    """An entry without a backend tag, or tagged for the other kernel,
    is stale: a warning fires, the sweep re-runs, and the fresh tagged
    winner replaces the entry, honored on the next call."""
    img, kern = _tune_problem(1)
    path = str(tmp_path / "tune.json")
    key = tune_key(img.shape, kern, F8, device="cpu", candidates=CANDS)
    stale = {"p_block": 1, "m_block": 1, "c_block": 1, "c_unroll": 1}
    for entry in ({"blocks": stale, "seconds_per_call": 1.0},
                  {"blocks": stale, "backend": "cuda",
                   "seconds_per_call": 1.0}):
        with open(path, "w") as f:
            json.dump({key: entry}, f)
        with pytest.warns(RuntimeWarning, match="stale"):
            blocks, dt = tuned_conv_blocks(img, kern, fmt=F8, device="cpu",
                                           path=path, iters=1,
                                           candidates=CANDS)
        assert dt is not None and blocks == CANDS[0]
        assert json.load(open(path))[key]["backend"] == "cuda_fused"
    blocks2, dt2 = tuned_conv_blocks(img, kern, fmt=F8, device="cpu",
                                     path=path, candidates=CANDS)
    assert blocks2 == blocks and dt2 is None


def test_tune_cache_miss_runs_and_persists(tmp_path):
    img, kern = _tune_problem(1)
    path = str(tmp_path / "tune.json")
    blocks, dt = tuned_conv_blocks(img, kern, fmt=F8, device="cpu",
                                   path=path, iters=1, candidates=CANDS)
    assert dt is not None and os.path.exists(path)
    blocks2, dt2 = tuned_conv_blocks(img, kern, fmt=F8, device="cpu",
                                     path=path, candidates=CANDS)
    assert blocks2 == blocks and dt2 is None
    # a different candidate set, backend or device is another problem
    key = tune_key(img.shape, kern, F8, device="cpu", candidates=CANDS)
    assert key != tune_key(img.shape, kern, F8, device="cpu")
    assert key != tune_key(img.shape, kern, F8, backend="cuda",
                           device="cpu", candidates=CANDS)
    assert key != tune_key(img.shape, kern, F8, candidates=CANDS)


def test_tune_cache_env_var_override(monkeypatch, tmp_path):
    """The port has its own default file and variable: the JAX
    package's never answer for it."""
    monkeypatch.delenv(TUNE_CACHE_ENV, raising=False)
    monkeypatch.setenv("HOBFLOPS_TUNE_CACHE", str(tmp_path / "jax.json"))
    assert tune_cache_path() == ".hobflops_tune_torch.json"
    monkeypatch.setenv(TUNE_CACHE_ENV, str(tmp_path / "env.json"))
    assert TUNE_CACHE_ENV == "HOBFLOPS_TORCH_TUNE_CACHE"
    assert tune_cache_path() == str(tmp_path / "env.json")
    assert tune_cache_path("/explicit.json") == "/explicit.json"


def test_tune_conv_blocks_dedupes_resolved_candidates():
    """Candidates that resolve to one launch are timed once; every
    backend's default candidates are distinct dicts of launch keys."""
    img, kern = _tune_problem(1)
    # one lane word (cout 8): m_block 1 is the default, p_block follows
    cands = [{"c_unroll": 1}, {"c_unroll": 1, "m_block": 1},
             {"c_unroll": 1, "m_block": 8}]
    best, results = tconv.tune_conv_blocks(img, kern, fmt=F8, device="cpu",
                                           iters=1, candidates=cands)
    assert len(results) == 2 and best in (cands[0], cands[2])
    for backend in ("cuda_fused", "cuda", "torch"):
        cands = tconv.default_tune_candidates(backend)
        assert len({repr(sorted(c.items())) for c in cands}) == len(cands)
        assert all(set(c) <= {"p_block", "m_block", "c_block", "c_unroll"}
                   for c in cands)


# ---------------------------------------------------------------------------
# sharding over a list of devices
# ---------------------------------------------------------------------------
def test_sharded_wave_bit_exact_over_two_devices():
    """A wave split over ``["cpu", "cpu"]`` equals the unsharded wave
    bit-for-bit, directly and end to end through the engine."""
    rng = np.random.default_rng(10)
    g = _graph(tnet, F8, _rand(rng, (3, 3, 4, 4), 0.4), device="cpu")
    imgs = _rand(rng, (4,) + HWC)
    mesh = wave_mesh(["cpu", "cpu"])
    assert mesh == [torch.device("cpu")] * 2
    want = g.run(imgs).numpy()
    runner = wave_sharded_runner(g, mesh)
    np.testing.assert_array_equal(_bits(runner(imgs).numpy()), _bits(want))
    eng = ConvServeEngine(g, HWC, max_batch=4, mesh=["cpu", "cpu"])
    assert eng.buckets == (2, 4)
    for i in range(3):
        eng.submit(ConvRequest(i, imgs[i]))
    done = eng.run()
    for i, r in enumerate(done):
        np.testing.assert_array_equal(_bits(r.out), _bits(want[i]))
    with pytest.raises(WaveShardingError, match="does not divide"):
        runner(imgs[:3])
    with pytest.raises(ValueError, match="divide over"):
        ConvServeEngine(g, HWC, max_batch=3, mesh=["cpu", "cpu"])


# ---------------------------------------------------------------------------
# no card: the entry points refuse
# ---------------------------------------------------------------------------
def test_entry_points_refuse_without_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(11)
    k = _rand(rng, (3, 3, 4, 4), 0.4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConvServeEngine(_graph(tnet, F9, k), HWC)
    img, kern = _tune_problem(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuned_conv_blocks(img, kern, fmt=F8, path=str(tmp_path / "t.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconv.tune_conv_blocks(img, kern, fmt=F8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wave_mesh()
    g = _graph(tnet, F9, k, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        derive_max_batch(g, HWC, "cuda")
