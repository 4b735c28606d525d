"""Serving robustness of the port's engine: the scenarios of
``tests/test_serve_faults.py`` replayed on ``repro_torch.serve_conv``.

Every injected failure mode — runner build failure (injected, or a
kernel build error raised by the build itself), transient wave error,
artificial straggler, corrupted runner-cache entry, corrupted tune-cache
file — recovers with zero wrong answers: each served response is
bit-identical (int32 patterns) to ``graph.run`` on that request alone at
the precision it was served at.  Plus admission: bad payloads, numpy or
tensor, are rejected at ``submit()`` before they can poison a wave; a
bounded queue sheds with ``QueueFullError``; waves close on deadline or
fullness; stale requests expire; a failed wave quarantines only its own
requests.  The port runs on the CPU here, where ``cuda_fused`` runs its
kernel's plain version.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch._build import KernelBuildError
from repro_torch.core.fpformat import FPFormat
from repro_torch.ft.heartbeat import stale_hosts
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.kernels.conv2d_bitslice.network import NetworkGraph
from repro_torch.serve_conv import (ConvRequest, ConvServeEngine,
                                    DeadlineExceededError, FaultInjector,
                                    FaultPlan, QueueFullError,
                                    RequestValidationError, ServePolicy,
                                    WaveExecutionError, corrupt_runner_cache,
                                    corrupt_tune_cache, load_tune_cache,
                                    tuned_conv_blocks)
from repro_torch.serve_conv.cache import tune_key

F8 = FPFormat(5, 2)
F9 = FPFormat(5, 3)
HWC = (6, 6, 4)
FAST = ServePolicy(retry_backoff_s=1e-4)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.fixture(scope="module")
def graphs():
    """One primary graph (F9) + its with_precision(F8) degraded
    variant, on the CPU, shared across the module."""
    rng = np.random.default_rng(0)
    g = NetworkGraph(F9, device="cpu")
    c1 = g.conv("c1", g.input_name, _rand(rng, (3, 3, 4, 4), 0.4),
                relu=True, blocks={"c_unroll": 1})
    g.output(g.maxpool2d("head", c1, window=2))
    return g, g.with_precision(F8)


@pytest.fixture(scope="module")
def pool():
    """Request images reused across tests, so each one's solo run is
    computed once (``_assert_bit_exact``'s memo)."""
    rng = np.random.default_rng(1)
    return [_rand(rng, HWC) for _ in range(6)] + \
        [_rand(rng, (2,) + HWC) for _ in range(2)]


_SOLO: dict = {}


def _assert_bit_exact(req, graph):
    """A served request's output equals graph.run on it alone."""
    image = np.asarray(req.image)
    key = (id(graph), image.tobytes(), image.shape)
    if key not in _SOLO:
        batched = image[None] if image.ndim == 3 else image
        solo = graph.run(batched).numpy()
        _SOLO[key] = solo[0] if image.ndim == 3 else solo
    assert req.status == "served", (req.rid, req.status)
    np.testing.assert_array_equal(_bits(req.out), _bits(_SOLO[key]),
                                  err_msg=f"request {req.rid}")


class FakeClock:
    """Deterministic engine clock for deadline/latency tests."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float):
        self.now += s


# ---------------------------------------------------------------------------
# Admission: validation, bounded queue, deadlines
# ---------------------------------------------------------------------------
_BAD = [   # (case, the error's words, payload from a generator)
    ("rank", "rank", lambda r: _rand(r, (6, 6))),
    ("geometry", "geometry", lambda r: _rand(r, (5, 5, 4))),
    ("int", "float", lambda r: r.integers(0, 9, (6, 6, 4))),
    ("nan", "non-finite", lambda r: np.full((6, 6, 4), np.nan, np.float32)),
    ("inf", "non-finite", lambda r: np.r_[np.inf, np.zeros(6 * 6 * 4 - 1)]
     .reshape(6, 6, 4).astype(np.float32)),
    ("oversized", "max_batch", lambda r: _rand(r, (9, 6, 6, 4))),
    ("int tensor", "float",
     lambda r: torch.zeros((6, 6, 4), dtype=torch.int32)),
    ("inf tensor", "non-finite",
     lambda r: torch.full((2, 6, 6, 4), float("inf"))),
]


@pytest.mark.parametrize("match,payload", [c[1:] for c in _BAD],
                         ids=[c[0] for c in _BAD])
def test_submit_rejects_bad_payload_without_poisoning(graphs, pool, match,
                                                      payload):
    """Wrong rank/geometry, int dtype, NaN/Inf and oversized payloads,
    as numpy arrays or tensors, raise a typed RequestValidationError at
    submit() — the queue stays clean and the next good request is
    served bit-exactly."""
    g, _ = graphs
    eng = ConvServeEngine(g, HWC, max_batch=4)
    bad = ConvRequest(0, payload(np.random.default_rng(1)))
    with pytest.raises(RequestValidationError, match=match):
        eng.submit(bad)
    assert bad.status == "rejected" and eng.pending_images() == 0
    assert eng.stats()["requests_rejected"] == 1
    ok = ConvRequest(99, torch.from_numpy(pool[0]))   # tensors serve too
    eng.submit(ok)
    assert [r.rid for r in eng.run()] == [99]
    _assert_bit_exact(ok, g)


def test_bounded_queue_sheds_with_typed_error(graphs, pool):
    g, _ = graphs
    eng = ConvServeEngine(g, HWC, max_batch=4,
                          policy=ServePolicy(max_queue_images=2))
    eng.submit(ConvRequest(0, pool[0]))
    eng.submit(ConvRequest(1, pool[1]))
    shed = ConvRequest(2, pool[2])
    with pytest.raises(QueueFullError, match="max_queue_images"):
        eng.submit(shed)
    assert shed.status == "shed" and eng.pending_images() == 2
    assert eng.stats()["requests_shed"] == 1
    done = eng.run()                  # the queue itself still serves
    assert len(done) == 2
    for r in done:
        _assert_bit_exact(r, g)


@pytest.mark.timeout(30)
@pytest.mark.parametrize("case", ["lone request at its deadline",
                                  "full bucket at once"])
def test_wave_closes_on_deadline_or_full(graphs, pool, case):
    """With ``wave_deadline_ms`` a lone queued request is served once
    the deadline lapses instead of waiting for a full bucket; a full
    wave never waits for the deadline."""
    g, _ = graphs
    clock = FakeClock()
    if case.startswith("lone"):
        eng = ConvServeEngine(g, HWC, max_batch=8, clock=clock,
                              policy=ServePolicy(wave_deadline_ms=50.0))
        req = ConvRequest(0, pool[3])
        eng.submit(req)
        assert eng.step() == []             # t=0: not full, not aged
        clock.advance(0.020)
        assert eng.step() == []             # t=20ms: still young
        assert not eng.wave_ready()
        assert eng.next_deadline() == pytest.approx(0.050)
        clock.advance(0.035)                # t=55ms: deadline lapsed
        assert [r.rid for r in eng.step()] == [0] and eng.waves == 1
        _assert_bit_exact(req, g)
        assert req.e2e_latency_s >= 0.055   # the 55 ms it queued
    else:
        eng = ConvServeEngine(g, HWC, max_batch=2, clock=clock,
                              policy=ServePolicy(wave_deadline_ms=1e6))
        for i in range(2):
            eng.submit(ConvRequest(i, pool[i]))
        done = eng.step()                   # t=0, deadline far away
        assert len(done) == 2
        for r in done:
            _assert_bit_exact(r, g)


@pytest.mark.timeout(30)
def test_per_request_deadline_expires_stale_requests(graphs, pool):
    g, _ = graphs
    clock = FakeClock()
    eng = ConvServeEngine(g, HWC, max_batch=4, clock=clock,
                          policy=ServePolicy(request_timeout_ms=100.0))
    stale = ConvRequest(0, pool[0])
    eng.submit(stale)
    clock.advance(0.2)                      # ages past its deadline
    fresh = ConvRequest(1, pool[1])
    eng.submit(fresh)
    assert [r.rid for r in eng.run()] == [1]
    _assert_bit_exact(fresh, g)
    assert stale.status == "expired" and stale.out is None
    assert isinstance(stale.error, DeadlineExceededError)
    assert eng.stats()["requests_expired"] == 1
    # per-request override beats the policy default
    slow_ok = ConvRequest(2, pool[2], deadline_ms=1e6)
    eng.submit(slow_ok)
    clock.advance(0.2)
    assert [r.rid for r in eng.run()] == [2]


# ---------------------------------------------------------------------------
# Fault injection: every mode recovers with zero wrong answers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan,attempts", [
    (FaultPlan(compile_failures=1), 2),     # failed build, clean retry
    (FaultPlan(wave_errors=1), 2),          # transient execution error
    (FaultPlan(compile_failures=1, wave_errors=1), 3),
])
def test_injected_fault_recovers(graphs, pool, plan, attempts):
    g, _ = graphs
    faults = FaultInjector(FaultPlan(**vars(plan)))
    eng = ConvServeEngine(g, HWC, max_batch=4, faults=faults, policy=FAST)
    reqs = [ConvRequest(0, pool[6]), ConvRequest(1, pool[0])]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 2
    assert faults.injected_compile_failures == plan.compile_failures
    assert faults.injected_wave_errors == plan.wave_errors
    st = eng.stats()
    assert st["wave_retries"] == st["wave_exec_failures"] == attempts - 1
    assert st["waves_failed"] == 0               # retry healed it
    for r in done:
        _assert_bit_exact(r, g)
        assert r.attempts == attempts


def test_kernel_build_failure_is_a_wave_failure(graphs, pool, monkeypatch):
    """A kernel that fails to build fails the runner build: retried,
    and past the retry budget a quarantine carrying the build error —
    never a wave served some other way."""
    g, _ = graphs
    calls = []

    def failing_build(graph, devices):
        calls.append(graph)
        raise KernelBuildError("nvcc exited 1")
    monkeypatch.setattr("repro_torch.serve_conv.cache.build_kernels_for",
                        failing_build)
    eng = ConvServeEngine(g, HWC, max_batch=4,
                          policy=ServePolicy(max_wave_retries=1,
                                             retry_backoff_s=1e-4))
    req = ConvRequest(0, pool[0])
    eng.submit(req)
    assert eng.run() == [] and len(calls) == 2
    assert req.status == "failed" and req.out is None
    assert isinstance(req.error, WaveExecutionError)
    assert isinstance(req.error.__cause__, KernelBuildError)
    assert eng.stats()["runner_cache"]["size"] == 0


def test_exhausted_retries_quarantine_only_their_wave(graphs, pool):
    """A wave that fails its whole retry budget marks its own requests
    failed (typed WaveExecutionError) — and the engine keeps serving:
    the next wave completes bit-exactly."""
    g, _ = graphs
    policy = ServePolicy(max_wave_retries=1, retry_backoff_s=1e-4)
    faults = FaultInjector(FaultPlan(wave_errors=2))   # = retry budget
    eng = ConvServeEngine(g, HWC, max_batch=4, faults=faults,
                          policy=policy)
    doomed = [ConvRequest(i, pool[i]) for i in range(2)]
    for r in doomed:
        eng.submit(r)
    assert eng.run_wave() == []
    for r in doomed:
        assert r.status == "failed" and r.out is None
        assert isinstance(r.error, WaveExecutionError)
        assert r.error.attempts == 2
    st = eng.stats()
    assert st["waves_failed"] == 1 and st["requests_failed"] == 2
    assert eng.quarantined == doomed
    ok = ConvRequest(9, pool[2])
    eng.submit(ok)                    # budget exhausted: engine heals
    assert [r.rid for r in eng.run()] == [9]
    _assert_bit_exact(ok, g)


def test_corrupted_runner_cache_entry_evicted_and_rebuilt(graphs, pool):
    """A poisoned cached runner (always raises) can only be cured by
    eviction + rebuild — the engine does exactly that and the answers
    stay bit-exact."""
    g, _ = graphs
    eng = ConvServeEngine(g, HWC, max_batch=4, policy=FAST)
    eng.submit(ConvRequest(0, pool[0]))
    eng.run()                               # bucket-1 runner now cached
    assert len(corrupt_runner_cache(eng.cache)) == 1
    req = ConvRequest(1, pool[1])
    eng.submit(req)
    assert [r.rid for r in eng.run()] == [1]
    _assert_bit_exact(req, g)
    st = eng.stats()
    assert st["runner_cache"]["evictions"] >= 1
    assert st["waves_failed"] == 0 and req.attempts == 2


class VirtualTime:
    """The engine module's ``time``, with sleeps that advance the clock
    the executor reads instead of waiting: a straggle is then as long
    as asked, however loaded the machine is."""

    def __init__(self):
        self.offset = 0.0

    def perf_counter(self) -> float:
        return time.perf_counter() + self.offset

    def sleep(self, s: float):
        self.offset += s


def test_straggler_waves_flagged_in_stats(graphs, pool, monkeypatch):
    """Artificially slow waves of one bucket class are flagged by the
    wired StragglerMonitor — and still answer bit-exactly."""
    g, _ = graphs
    vt = VirtualTime()
    monkeypatch.setattr("repro_torch.serve_conv.engine.time", vt)
    faults = FaultInjector(FaultPlan(), sleep=vt.sleep)
    eng = ConvServeEngine(g, HWC, max_batch=4, faults=faults)

    def serve(n):
        reqs = [ConvRequest(i, pool[i]) for i in range(n)]
        for r in reqs:
            eng.submit(r)
        for r in eng.run():
            _assert_bit_exact(r, g)

    serve(1)                        # first builds of both buckets must
    serve(4)                        # not pollute the slow-EMA
    fresh = StragglerMonitor()
    eng.straggler = eng.executor.straggler = fresh
    faults.plan.straggle_waves, faults.plan.straggle_s = 3, 10.0
    for _ in range(3):
        serve(1)                    # straggled bucket-1 waves
    assert faults.injected_straggles == 3
    for _ in range(3):
        serve(4)                    # fast bucket-4 waves
    st = eng.stats()
    assert st["stragglers"] == ["bucket1"]
    assert fresh.ema("bucket1") > fresh.ema("bucket4") + 5.0
    assert st["straggler_fleet"]["hosts"] == 2


def test_corrupted_tune_cache_warns_ignores_rebuilds(tmp_path):
    """A truncated tune-cache JSON degrades to 'no cache' with a
    warning; the next save rewrites a valid file atomically."""
    rng = np.random.default_rng(11)
    img = _rand(rng, (1, 6, 6, 4))
    kern = _rand(rng, (1, 1, 4, 8), 0.3)
    path = str(tmp_path / "tune.json")
    cands = [{"c_unroll": 1, "m_block": 8}]
    kw = dict(fmt=F8, device="cpu", path=path, iters=1, candidates=cands)
    blocks, _ = tuned_conv_blocks(img, kern, **kw)
    corrupt_tune_cache(path)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert load_tune_cache(path) == {}
    # miss again (cache unusable), sweep re-runs, file rebuilt
    with pytest.warns(RuntimeWarning, match="corrupt"):
        blocks2, dt2 = tuned_conv_blocks(img, kern, **kw)
    assert blocks2 == blocks and dt2 is not None
    rebuilt = load_tune_cache(path)          # clean: no warning
    assert tune_key(img.shape, kern, F8, device="cpu",
                    candidates=cands) in rebuilt
    with open(path) as f:
        json.load(f)                         # valid JSON on disk
    # non-dict top level is corrupt too
    (tmp_path / "t2.json").write_text("[1, 2, 3]")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert load_tune_cache(str(tmp_path / "t2.json")) == {}


# ---------------------------------------------------------------------------
# Precision-degrading overload control
# ---------------------------------------------------------------------------
@pytest.mark.timeout(40)
def test_overload_degrades_tags_and_recovers(graphs, pool):
    """Sustained queue pressure routes waves to the registered
    cheaper-precision variant; every degraded response is tagged and
    bit-identical to the degraded graph's own run; pressure relief
    steps back up to full precision."""
    g, g8 = graphs
    policy = ServePolicy(degrade_queue_factor=1.0, degrade_patience=2,
                         recover_patience=2)
    eng = ConvServeEngine(g, HWC, max_batch=2, policy=policy)
    assert eng.register_degraded(g8, "hobflops8") == 1
    assert eng.variants == ("full", "hobflops8")
    reqs = [ConvRequest(i, pool[i % 6]) for i in range(10)]
    for r in reqs:
        eng.submit(r)                   # pressure: 5 waves of backlog
    done = eng.run()
    assert len(done) == 10
    for r in done:
        assert (r.level > 0) == r.degraded
        # bit-exact AT THE PRECISION IT WAS SERVED AT
        _assert_bit_exact(r, g if r.level == 0 else g8)
    # wave 1 observes hot streak 1, wave 2 hits degrade_patience=2 and
    # is already served degraded: 2 full images, then 8 at hobflops8
    assert [r.precision for r in done] == ["full"] * 2 + ["hobflops8"] * 8
    st = eng.stats()["degradation"]
    assert st["activations"] == 1 and st["level"] == 1
    assert st["images_by_level"] == {"full": 2, "hobflops8": 8}
    # degraded codes really differ from full-precision codes
    assert not np.array_equal(_bits(done[-1].out),
                              _bits(g.run(done[-1].image[None])[0]))
    # light traffic: two cold observations recover full precision
    for i in range(2):
        eng.submit(ConvRequest(100 + i, pool[i]))
        for r in eng.run():
            _assert_bit_exact(r, g8 if r.degraded else g)
    assert eng.controller.level == 0
    late = ConvRequest(200, pool[2])
    eng.submit(late)
    assert eng.run()[0].precision == "full"
    _assert_bit_exact(late, g)


def test_degraded_variant_must_match_geometry(graphs):
    g, _ = graphs
    rng = np.random.default_rng(13)
    other = NetworkGraph(F8, device="cpu")
    c1 = other.conv("c1", other.input_name,
                    _rand(rng, (3, 3, 4, 7), 0.4))   # 7 != 4 channels
    other.output(c1)
    eng = ConvServeEngine(g, HWC, max_batch=2)
    with pytest.raises(ValueError, match="geometry"):
        eng.register_degraded(other)


# ---------------------------------------------------------------------------
# Heartbeat liveness
# ---------------------------------------------------------------------------
def test_heartbeat_feeds_engine_liveness(graphs, pool, tmp_path):
    g, _ = graphs
    eng = ConvServeEngine(g, HWC, max_batch=2,
                          heartbeat_dir=str(tmp_path), heartbeat_host="s0")
    assert eng.device == torch.device("cpu")
    for i in range(3):
        eng.submit(ConvRequest(i, pool[i]))
    eng.run()
    st = eng.stats()
    assert st["heartbeat"]["host"] == "s0"
    assert st["heartbeat"]["step"] == eng.waves == 2
    assert eng.heartbeat.age_s() < 60
    assert stale_hosts(str(tmp_path), timeout_s=60) == []
