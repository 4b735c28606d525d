"""Serving robustness: fault injection, SLO admission, overload control
(DESIGN.md §11).

Acceptance-level checks: every injected failure mode — runner compile
failure, transient wave-execution error, artificial straggler,
corrupted runner-cache entry, corrupted tune-cache file — recovers
with *zero wrong answers*: every completed response stays bit-identical
to ``graph.run`` on that request alone at the precision it was served
at, and degraded responses are explicitly tagged.  Plus the admission
SLO: a lone request is served within ``wave_deadline_ms`` instead of
waiting for a full bucket, bad payloads are rejected at ``submit()``
with typed errors before they can poison a wave, a bounded queue sheds
with ``QueueFullError``, and a failed wave quarantines only its own
requests.

All chaos is deterministic (counter budgets + the fixed
``HOBFLOPS_CHAOS_SEED``); the CI chaos job replays this file with the
seed pinned.
"""
import json

import numpy as np
import pytest

from repro.core.fpformat import FPFormat
from repro.ft.heartbeat import stale_hosts
from repro.ft.straggler import StragglerMonitor
from repro.kernels.conv2d_bitslice.network import NetworkGraph
from repro.serve_conv import (ConvRequest, ConvServeEngine,
                              DeadlineExceededError, FaultInjector,
                              FaultPlan, QueueFullError,
                              RequestValidationError, ServePolicy,
                              WaveExecutionError, corrupt_runner_cache,
                              corrupt_tune_cache, load_tune_cache,
                              tuned_conv_blocks)
from repro.serve_conv.cache import tune_key

F8 = FPFormat(5, 2)
F9 = FPFormat(5, 3)
HWC = (6, 6, 4)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    """One primary graph (F9) + its with_precision(F8) degraded
    variant, shared across the module so jit compiles amortize."""
    rng = np.random.default_rng(0)
    g = NetworkGraph(F9)
    c1 = g.conv("c1", g.input_name, _rand(rng, (3, 3, 4, 4), 0.4),
                relu=True)
    g.output(g.maxpool2d("head", c1, window=2))
    return g, g.with_precision(F8)


class FakeClock:
    """Deterministic engine clock for deadline/latency tests."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float):
        self.now += s


def _assert_bit_exact(req, graph):
    """A served request's output equals graph.run on it alone."""
    batched = req.image[None] if req.image.ndim == 3 else req.image
    solo = np.asarray(graph.run(batched))
    solo = solo[0] if req.image.ndim == 3 else solo
    np.testing.assert_array_equal(np.asarray(req.out), solo,
                                  err_msg=f"request {req.rid}")


# ---------------------------------------------------------------------------
# Admission: validation, bounded queue, deadlines
# ---------------------------------------------------------------------------
def test_submit_rejects_bad_payloads_without_poisoning(graphs):
    """Wrong rank/geometry, int dtype, and NaN/Inf payloads raise
    typed RequestValidationError at submit() — the queue stays clean
    and a subsequent good request is served bit-exactly."""
    g, _ = graphs
    rng = np.random.default_rng(1)
    eng = ConvServeEngine(g, HWC, max_batch=4)
    bad = [
        (_rand(rng, (6, 6)), "rank"),                     # rank 2
        (_rand(rng, (5, 5, 4)), "geometry"),              # wrong HxW
        (rng.integers(0, 9, (6, 6, 4)), "float"),         # int dtype
        (np.full((6, 6, 4), np.nan, np.float32), "non-finite"),
        (np.r_[np.inf, np.zeros(6 * 6 * 4 - 1)]
         .reshape(6, 6, 4).astype(np.float32), "non-finite"),
        (_rand(rng, (9, 6, 6, 4)), "max_batch"),          # oversized
    ]
    for i, (img, match) in enumerate(bad):
        with pytest.raises(RequestValidationError, match=match):
            eng.submit(ConvRequest(i, img))
    assert eng.pending_images() == 0
    assert eng.stats()["requests_rejected"] == len(bad)
    ok = ConvRequest(99, _rand(rng, HWC))
    eng.submit(ok)
    done = eng.run()
    assert [r.rid for r in done] == [99]
    _assert_bit_exact(ok, g)


def test_bounded_queue_sheds_with_typed_error(graphs):
    g, _ = graphs
    rng = np.random.default_rng(2)
    eng = ConvServeEngine(g, HWC, max_batch=4,
                          policy=ServePolicy(max_queue_images=2))
    eng.submit(ConvRequest(0, _rand(rng, HWC)))
    eng.submit(ConvRequest(1, _rand(rng, HWC)))
    with pytest.raises(QueueFullError, match="max_queue_images"):
        eng.submit(ConvRequest(2, _rand(rng, HWC)))
    assert eng.pending_images() == 2
    assert eng.stats()["requests_shed"] == 1
    done = eng.run()                  # the queue itself still serves
    assert len(done) == 2
    for r in done:
        _assert_bit_exact(r, g)


@pytest.mark.timeout(60)
def test_wave_deadline_serves_lone_request(graphs):
    """Satellite acceptance: with wave_deadline_ms, a lone queued
    request is served once the deadline lapses instead of waiting
    (forever) for a full max_batch bucket."""
    g, _ = graphs
    rng = np.random.default_rng(3)
    clock = FakeClock()
    eng = ConvServeEngine(g, HWC, max_batch=8, clock=clock,
                          policy=ServePolicy(wave_deadline_ms=50.0))
    req = ConvRequest(0, _rand(rng, HWC))
    eng.submit(req)
    assert eng.step() == []                 # t=0: not full, not aged
    clock.advance(0.020)
    assert eng.step() == []                 # t=20ms: still young
    assert not eng.wave_ready()
    assert eng.next_deadline() == pytest.approx(0.050)
    clock.advance(0.035)                    # t=55ms: deadline lapsed
    done = eng.step()
    assert [r.rid for r in done] == [0] and eng.waves == 1
    _assert_bit_exact(req, g)
    # queue wait component of the tracked latency is the 55ms it aged
    assert req.e2e_latency_s >= 0.055


@pytest.mark.timeout(60)
def test_wave_deadline_full_bucket_closes_immediately(graphs):
    """The other edge of deadline-or-full: a full wave never waits for
    the deadline."""
    g, _ = graphs
    rng = np.random.default_rng(4)
    clock = FakeClock()
    eng = ConvServeEngine(g, HWC, max_batch=2, clock=clock,
                          policy=ServePolicy(wave_deadline_ms=1e6))
    for i in range(2):
        eng.submit(ConvRequest(i, _rand(rng, HWC)))
    done = eng.step()                       # t=0, deadline far away
    assert len(done) == 2
    for r in done:
        _assert_bit_exact(r, g)


@pytest.mark.timeout(60)
def test_per_request_deadline_expires_stale_requests(graphs):
    g, _ = graphs
    rng = np.random.default_rng(5)
    clock = FakeClock()
    eng = ConvServeEngine(g, HWC, max_batch=4, clock=clock,
                          policy=ServePolicy(request_timeout_ms=100.0))
    stale = ConvRequest(0, _rand(rng, HWC))
    eng.submit(stale)
    clock.advance(0.2)                      # ages past its deadline
    fresh = ConvRequest(1, _rand(rng, HWC))
    eng.submit(fresh)
    done = eng.run()
    assert [r.rid for r in done] == [1]
    _assert_bit_exact(fresh, g)
    assert stale.status == "expired" and stale.out is None
    assert isinstance(stale.error, DeadlineExceededError)
    assert eng.stats()["requests_expired"] == 1
    # per-request override beats the policy default
    slow_ok = ConvRequest(2, _rand(rng, HWC), deadline_ms=1e6)
    eng.submit(slow_ok)
    clock.advance(0.2)
    assert [r.rid for r in eng.run()] == [2]


# ---------------------------------------------------------------------------
# Fault injection: every mode recovers with zero wrong answers
# ---------------------------------------------------------------------------
def test_injected_compile_failure_recovers(graphs):
    g, _ = graphs
    rng = np.random.default_rng(6)
    faults = FaultInjector(FaultPlan(compile_failures=1))
    eng = ConvServeEngine(g, HWC, max_batch=4, faults=faults,
                          policy=ServePolicy(retry_backoff_s=1e-4))
    reqs = [ConvRequest(i, _rand(rng, HWC)) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 3 and faults.injected_compile_failures == 1
    assert eng.executor.retries >= 1
    for r in done:
        _assert_bit_exact(r, g)
        assert r.status == "served"
    assert done[0].attempts == 2            # failed build + clean retry


def test_transient_wave_error_recovers(graphs):
    g, _ = graphs
    rng = np.random.default_rng(7)
    faults = FaultInjector(FaultPlan(wave_errors=1))
    eng = ConvServeEngine(g, HWC, max_batch=4, faults=faults,
                          policy=ServePolicy(retry_backoff_s=1e-4))
    reqs = [ConvRequest(i, _rand(rng, (2,) + HWC)) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 2 and faults.injected_wave_errors == 1
    assert eng.stats()["wave_exec_failures"] == 1
    assert eng.stats()["waves_failed"] == 0      # retry healed it
    for r in done:
        _assert_bit_exact(r, g)


def test_exhausted_retries_quarantine_only_their_wave(graphs):
    """A wave that fails its whole retry budget marks its own requests
    failed (typed WaveExecutionError) — and the engine keeps serving:
    the next wave completes bit-exactly."""
    g, _ = graphs
    rng = np.random.default_rng(8)
    policy = ServePolicy(max_wave_retries=1, retry_backoff_s=1e-4)
    faults = FaultInjector(FaultPlan(wave_errors=2))   # = retry budget
    eng = ConvServeEngine(g, HWC, max_batch=4, faults=faults,
                          policy=policy)
    doomed = [ConvRequest(i, _rand(rng, HWC)) for i in range(2)]
    for r in doomed:
        eng.submit(r)
    assert eng.run_wave() == []
    for r in doomed:
        assert r.status == "failed" and r.out is None
        assert isinstance(r.error, WaveExecutionError)
        assert r.error.attempts == 2
    st = eng.stats()
    assert st["waves_failed"] == 1 and st["requests_failed"] == 2
    ok = ConvRequest(9, _rand(rng, HWC))
    eng.submit(ok)                    # budget exhausted: engine heals
    assert [r.rid for r in eng.run()] == [9]
    _assert_bit_exact(ok, g)


def test_corrupted_runner_cache_entry_evicted_and_rebuilt(graphs):
    """A poisoned cached runner (always raises) can only be cured by
    eviction + rebuild — the engine does exactly that and the answers
    stay bit-exact."""
    g, _ = graphs
    rng = np.random.default_rng(9)
    eng = ConvServeEngine(g, HWC, max_batch=4,
                          policy=ServePolicy(retry_backoff_s=1e-4))
    warm = ConvRequest(0, _rand(rng, HWC))
    eng.submit(warm)
    eng.run()                               # bucket-1 runner now cached
    corrupted = corrupt_runner_cache(eng.cache)
    assert len(corrupted) == 1
    req = ConvRequest(1, _rand(rng, HWC))
    eng.submit(req)
    done = eng.run()
    assert [r.rid for r in done] == [1]
    _assert_bit_exact(req, g)
    st = eng.stats()
    assert st["runner_cache"]["evictions"] >= 1
    assert st["waves_failed"] == 0


def test_straggler_waves_flagged_in_stats(graphs):
    """Artificially slow waves of one bucket class are flagged by the
    wired StragglerMonitor — and still answer bit-exactly."""
    g, _ = graphs
    rng = np.random.default_rng(10)
    faults = FaultInjector(FaultPlan())
    eng = ConvServeEngine(g, HWC, max_batch=4, faults=faults)

    def serve(n):
        reqs = [ConvRequest(i, _rand(rng, HWC)) for i in range(n)]
        for r in reqs:
            eng.submit(r)
        for r in eng.run():
            _assert_bit_exact(r, g)

    serve(1)                        # warm both buckets: compile time
    serve(4)                        # must not pollute the slow-EMA
    fresh = StragglerMonitor()
    eng.straggler = eng.executor.straggler = fresh
    faults.plan.straggle_waves, faults.plan.straggle_s = 3, 0.05
    for _ in range(3):
        serve(1)                    # straggled bucket-1 waves
    assert faults.injected_straggles == 3
    for _ in range(3):
        serve(4)                    # fast bucket-4 waves
    st = eng.stats()
    assert st["stragglers"] == ["bucket1"]
    assert fresh.ema("bucket1") > fresh.ema("bucket4")
    assert st["straggler_fleet"]["hosts"] == 2


def test_corrupted_tune_cache_warns_ignores_rebuilds(tmp_path):
    """Satellite: a truncated tune-cache JSON degrades to 'no cache'
    with a warning; the next save rewrites a valid file atomically."""
    rng = np.random.default_rng(11)
    img = _rand(rng, (1, 6, 6, 4))
    kern = _rand(rng, (1, 1, 4, 8), 0.3)
    path = str(tmp_path / "tune.json")
    cands = [{"c_unroll": 1, "m_block": 8}]
    blocks, _ = tuned_conv_blocks(img, kern, fmt=F8, path=path, iters=1,
                                  candidates=cands)
    corrupt_tune_cache(path)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert load_tune_cache(path) == {}
    # miss again (cache unusable), sweep re-runs, file rebuilt
    with pytest.warns(RuntimeWarning, match="corrupt"):
        blocks2, dt2 = tuned_conv_blocks(img, kern, fmt=F8, path=path,
                                         iters=1, candidates=cands)
    assert blocks2 == blocks and dt2 is not None
    rebuilt = load_tune_cache(path)          # clean: no warning
    assert tune_key(img.shape, kern, F8, candidates=cands) in rebuilt
    with open(path) as f:
        json.load(f)                         # valid JSON on disk
    # non-dict top level is corrupt too
    (tmp_path / "t2.json").write_text("[1, 2, 3]")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert load_tune_cache(str(tmp_path / "t2.json")) == {}


# ---------------------------------------------------------------------------
# Precision-degrading overload control
# ---------------------------------------------------------------------------
@pytest.mark.timeout(150)
def test_overload_degrades_tags_and_recovers(graphs):
    """Sustained queue pressure routes waves to the registered
    cheaper-precision variant; every degraded response is tagged and
    bit-identical to the degraded graph's own run; pressure relief
    steps back up to full precision."""
    g, g8 = graphs
    rng = np.random.default_rng(12)
    policy = ServePolicy(degrade_queue_factor=1.0, degrade_patience=2,
                         recover_patience=2)
    eng = ConvServeEngine(g, HWC, max_batch=2, policy=policy)
    assert eng.register_degraded(g8, "hobflops8") == 1
    reqs = [ConvRequest(i, _rand(rng, HWC)) for i in range(10)]
    for r in reqs:
        eng.submit(r)                   # pressure: 5 waves of backlog
    done = eng.run()
    assert len(done) == 10
    by_level = {}
    for r in done:
        by_level.setdefault(r.precision, []).append(r)
        assert (r.level > 0) == r.degraded
        # bit-exact AT THE PRECISION IT WAS SERVED AT
        _assert_bit_exact(r, g if r.level == 0 else g8)
    assert set(by_level) == {"full", "hobflops8"}
    # wave 1 observes hot streak 1, wave 2 hits degrade_patience=2 and
    # is already served degraded: 2 full images, then 8 at hobflops8
    assert [r.precision for r in done[:2]] == ["full"] * 2
    assert all(r.precision == "hobflops8" for r in done[2:])
    st = eng.stats()["degradation"]
    assert st["activations"] == 1 and st["level"] == 1
    assert st["images_by_level"] == {"full": 2, "hobflops8": 8}
    # degraded codes really differ from full-precision codes
    assert not np.array_equal(np.asarray(done[-1].out),
                              np.asarray(g.run(done[-1].image[None]))[0])
    # light traffic: two cold observations recover full precision
    for i in range(2):
        eng.submit(ConvRequest(100 + i, _rand(rng, HWC)))
        for r in eng.run():
            _assert_bit_exact(r, g8 if r.degraded else g)
    assert eng.controller.level == 0
    late = ConvRequest(200, _rand(rng, HWC))
    eng.submit(late)
    assert eng.run()[0].precision == "full"
    _assert_bit_exact(late, g)


def test_degraded_variant_must_match_geometry(graphs):
    g, _ = graphs
    rng = np.random.default_rng(13)
    other = NetworkGraph(F8)
    c1 = other.conv("c1", other.input_name,
                    _rand(rng, (3, 3, 4, 7), 0.4))   # 7 != 4 channels
    other.output(c1)
    eng = ConvServeEngine(g, HWC, max_batch=2)
    with pytest.raises(ValueError, match="geometry"):
        eng.register_degraded(other)


def test_with_precision_preserves_structure(graphs):
    g, g8 = graphs
    assert g8._nodes.keys() == g._nodes.keys()
    assert g8.input_fmt == F8
    assert g8._nodes["c1"].precision == F8
    assert g8.out_shape((1,) + HWC) == g.out_shape((1,) + HWC)
    assert g8.signature() != g.signature()
    # idempotent at the same format: same compiled structure
    assert g.with_precision(F9).signature() == g.signature()


# ---------------------------------------------------------------------------
# Heartbeat liveness
# ---------------------------------------------------------------------------
def test_heartbeat_feeds_engine_liveness(graphs, tmp_path):
    g, _ = graphs
    rng = np.random.default_rng(14)
    eng = ConvServeEngine(g, HWC, max_batch=2,
                          heartbeat_dir=str(tmp_path), heartbeat_host="s0")
    for i in range(3):
        eng.submit(ConvRequest(i, _rand(rng, HWC)))
    eng.run()
    st = eng.stats()
    assert st["heartbeat"]["host"] == "s0"
    assert st["heartbeat"]["step"] == eng.waves
    assert eng.heartbeat.age_s() < 60
    assert stale_hosts(str(tmp_path), timeout_s=60) == []
