"""SLO-aware lane-batched inference engine for HOBFLOPS graphs.

The transformer engine (``serve/engine.py``, DESIGN.md §6) batches
requests into decode *slots* of a lockstep wave; the CNN engine here
exploits the HOBFLOPS-specific fact that the bitslice carrier's
pixel-row axis *is* the batch axis (DESIGN.md §10): N queued images
coalesce into one ``[N,H,W,C]`` wave that runs through the resident
graph as one call on the graph's device — one activation encode, one
decode, one ``fused_mac`` launch a conv, and every plane netlist
sweeping all N requests' rows at once.

This module is the robust rebuild of that engine (DESIGN.md §11),
split into three cooperating pieces:

* :class:`WaveScheduler` — admission.  A bounded queue with typed
  load-shedding (``QueueFullError``), per-request deadlines (aged-out
  requests are expired at admission, never packed), and
  *deadline-or-full* wave closing: a wave closes when it fills
  ``max_batch`` **or** when the oldest queued request has waited
  ``wave_deadline_ms`` — the throughput/latency dial.  Without a
  deadline the legacy drain behaviour is preserved.
* :class:`WaveExecutor` — execution.  Builds runners (kernels built
  with ``nvcc`` on the card) through the :class:`RunnerCache`, executes
  waves with bounded retry-with-backoff, evicts possibly-bad cached
  runners before every retry (the only cure for a corrupted cache
  entry), validates the output shape (a garbage-shaped result is a
  failure, not an answer), and feeds per-bucket wave times to a
  :class:`~repro_torch.ft.straggler.StragglerMonitor`.  All chaos seams
  (``faults.py``) thread through here.
* :class:`ConvServeEngine` — the composition.  Validates requests at
  ``submit()`` with the typed taxonomy (``errors.py``), runs the
  stepped admission loop, routes overloaded waves to pre-registered
  cheaper-precision graph variants under the
  :class:`~repro_torch.serve_conv.policy.OverloadController` hysteresis
  ladder, quarantines the requests of a wave that failed its whole
  retry budget (the engine keeps serving), tracks p50/p99 end-to-end
  latency, and beats a :class:`~repro_torch.ft.heartbeat.Heartbeat` for
  external liveness probes.

Every *served* response — full precision or degraded, retried or not —
remains bit-identical to ``graph.run`` on that request alone **at the
precision it was served at**, and carries that precision as an
explicit tag (``req.precision``/``req.level``).

The engine runs on the graph's device: the card unless the graph was
built with ``device="cpu"``, where the kernels' plain versions run.  A
wave's packing, unpacking and responses stay numpy on the host.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch._build import resolve_device, synchronize
from repro_torch.ft.heartbeat import Heartbeat
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.kernels.conv2d_bitslice.network import NetworkGraph
from repro_torch.serve_conv.cache import (RunnerCache, bucket_for,
                                          bucket_sizes, build_runner)
from repro_torch.serve_conv.errors import (DeadlineExceededError,
                                           QueueFullError,
                                           WaveExecutionError,
                                           validate_request_image)
from repro_torch.serve_conv.lanes import (pack_wave, request_images,
                                          unpack_wave)
from repro_torch.serve_conv.policy import OverloadController, ServePolicy
from repro_torch.serve_conv.sharding import (mesh_size, wave_mesh,
                                             wave_sharded_runner)


@dataclasses.dataclass
class ConvRequest:
    """One queued inference request: a single [H,W,C] image or a
    [B,H,W,C] mini-batch (heterogeneous counts mix freely in a wave).

    Lifecycle fields the engine fills in: ``status`` moves through
    ``queued -> served | failed | expired``; ``error`` holds the typed
    reason for the two failure states; ``precision``/``level``/
    ``degraded`` tag which registered graph variant served it (level 0
    = full precision); ``latency_s`` is the wave execution time it rode
    in and ``e2e_latency_s`` adds its queue wait."""
    rid: int
    image: np.ndarray
    out: np.ndarray | None = None
    done: bool = False
    wave: int | None = None          # which wave served it
    latency_s: float | None = None   # wave execution time it rode in
    deadline_ms: float | None = None  # per-request deadline override
    submitted_at: float | None = None
    status: str = "queued"
    error: Exception | None = None
    precision: str | None = None     # label of the variant that served it
    level: int | None = None         # ladder level (0 = full precision)
    degraded: bool = False
    attempts: int = 0                # wave executions it took
    e2e_latency_s: float | None = None


# The wave budget: this share of the card's free memory, or this many
# bytes on the CPU.
MEM_SHARE = 0.5
CPU_WAVE_BUDGET = 1 << 30
# The im2col's intermediates (``activation_patch_masks``), each the size
# of one conv's per-pixel input masks [H*W, Cin, nbits] int32: the shift,
# the bit mask, the negation, the NHWC copy and the padded copy.
IM2COL_COPIES = 5


def wave_bytes(graph: NetworkGraph, hwc) -> int:
    """Peak bytes one image adds to a wave: over the live convs, the
    largest of ``i_masks`` ``[Ho*Wo, kh*kw*Cin, nbits]`` int32 (the MAC
    kernel's input, ``ops.activation_patch_masks``) plus
    :data:`IM2COL_COPIES` intermediates the size of the conv's per-pixel
    masks ``[H*W, Cin, nbits]`` int32.  The 3x3 512->512 hobflops9 conv
    (e5m3: 11 planes) at 14x14: 196 x 4608 x 11 x 4 = 39,739,392 B plus
    5 x 196 x 512 x 11 x 4 = 22,077,440 B, 61,816,832 B an image.
    Activations between layers and the output planes are smaller by a
    factor of kh*kw*nbits or more, and are left out."""
    shapes = graph.shape_plan((1,) + tuple(hwc))
    peak = 0
    for nd in graph._live_nodes:
        if nd.kind != "conv":
            continue
        w = graph._weights[nd.name]
        _, h, wd, _ = shapes[nd.inputs[0]]
        _, ho, wo, _ = shapes[nd.name]
        nb = nd.precision.nbits
        i_masks = ho * wo * w.kh * w.kw * w.cin * nb * 4
        peak = max(peak, i_masks + IM2COL_COPIES * h * wd * w.cin * nb * 4)
    return peak


def max_batch_for(image_bytes: int, budget_bytes: int, cap: int = 64) -> int:
    """The largest power of two ``b`` with ``b * image_bytes <=
    budget_bytes``, clamped to ``[1, cap]``."""
    b = 1
    while b * 2 <= cap and b * 2 * image_bytes <= budget_bytes:
        b *= 2
    return b


def derive_max_batch(graph: NetworkGraph, hwc, device=None,
                     cap: int = 64) -> int:
    """Wave admission budget from what a wave costs in memory: the
    largest power of two whose wave (:func:`wave_bytes` an image) stays
    within :data:`MEM_SHARE` of the free memory of ``device`` (the
    graph's by default; ``torch.cuda.mem_get_info``) — or within
    :data:`CPU_WAVE_BUDGET` on the CPU — clamped to ``[1, cap]``.

    At the MobileNets 14x14x512 stage in hobflops9 (3x3 512->512, then
    two 1x1 512->512) an image costs 61,816,832 B; half the ~79 GB an
    H100 80GB has free holds ~640 images, so ``max_batch`` is the cap,
    64 (a 3.96 GB wave).  The reference's TPU rule (``p_block * 512``
    carrier rows) would give 4 with the port's ``p_block`` of 2."""
    device = resolve_device(device if device is not None
                            else graph.device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = int(MEM_SHARE * free)
    else:
        budget = CPU_WAVE_BUDGET
    return max_batch_for(wave_bytes(graph, hwc), budget, cap)


# ---------------------------------------------------------------------------
# Scheduler: bounded queue + deadline-or-full wave closing
# ---------------------------------------------------------------------------
class WaveScheduler:
    """Admission state: the bounded request queue and the wave-closing
    decision.  Pure bookkeeping — no torch, no execution — so the
    policy is testable with a fake clock."""

    def __init__(self, max_batch: int, policy: ServePolicy):
        self.max_batch = max_batch
        self.policy = policy
        self.queue: deque[ConvRequest] = deque()
        self.queued_images = 0

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, req: ConvRequest, n_images: int, now: float):
        """Enqueue or shed: a bounded queue rejects with a typed
        :class:`QueueFullError` instead of growing without limit."""
        cap = self.policy.max_queue_images
        if cap is not None and self.queued_images + n_images > cap:
            raise QueueFullError(
                f"queue holds {self.queued_images} images; request "
                f"{req.rid} (+{n_images}) exceeds max_queue_images "
                f"{cap}")
        req.submitted_at = now
        req.status = "queued"
        self.queue.append(req)
        self.queued_images += n_images

    def pressure(self) -> float:
        """Backlog in waves: queued images / max_batch — the overload
        controller's input signal."""
        return self.queued_images / self.max_batch

    def _deadline_ms(self, req: ConvRequest) -> float | None:
        return req.deadline_ms if req.deadline_ms is not None \
            else self.policy.request_timeout_ms

    def expire(self, now: float) -> list[ConvRequest]:
        """Sweep out requests whose per-request deadline has passed —
        they are marked ``expired`` with a typed error and never reach
        a wave (serving them late helps no one and steals lanes)."""
        expired = []
        keep = deque()
        for req in self.queue:
            dl = self._deadline_ms(req)
            if dl is not None and (now - req.submitted_at) * 1e3 > dl:
                req.status = "expired"
                req.error = DeadlineExceededError(
                    f"request {req.rid} waited "
                    f"{(now - req.submitted_at) * 1e3:.1f}ms > deadline "
                    f"{dl:.1f}ms")
                self.queued_images -= request_images(req.image)
                expired.append(req)
            else:
                keep.append(req)
        self.queue = keep
        return expired

    def oldest_wait_ms(self, now: float) -> float | None:
        if not self.queue:
            return None
        return (now - self.queue[0].submitted_at) * 1e3

    def next_deadline(self) -> float | None:
        """Absolute clock time at which the oldest queued request
        forces the wave closed (None: empty queue or no deadline
        policy).  Lets a driving loop sleep exactly until the next
        admission event instead of polling."""
        if not self.queue or self.policy.wave_deadline_ms is None:
            return None
        return self.queue[0].submitted_at \
            + self.policy.wave_deadline_ms / 1e3

    def wave_ready(self, now: float) -> bool:
        """Deadline-or-full: the wave closes when queued images fill
        ``max_batch`` or the oldest request has waited
        ``wave_deadline_ms``.  With no deadline configured any
        non-empty queue is ready (legacy drain behaviour)."""
        if not self.queue:
            return False
        if self.policy.wave_deadline_ms is None:
            return True
        if self.queued_images >= self.max_batch:
            return True
        return self.oldest_wait_ms(now) >= self.policy.wave_deadline_ms

    def take(self) -> list[ConvRequest]:
        """Pop whole requests while the wave stays within max_batch."""
        wave, filled = [], 0
        while self.queue:
            n = request_images(self.queue[0].image)
            if wave and filled + n > self.max_batch:
                break
            wave.append(self.queue.popleft())
            filled += n
        self.queued_images -= filled
        return wave


# ---------------------------------------------------------------------------
# Executor: build + run waves with retry/backoff, eviction, chaos seams
# ---------------------------------------------------------------------------
class WaveExecutor:
    """Owns everything between "here is a packed wave" and "here is
    its output on the host": runner build through the cache, bounded
    retry-with-backoff, bad-runner eviction, output-shape validation,
    and straggler observation.  Raises :class:`WaveExecutionError`
    only after the whole retry budget is spent.  Every exception of an
    attempt is a failure of that attempt, a kernel build or launch
    error included: it is retried, never served by a plain version."""

    def __init__(self, cache: RunnerCache, policy: ServePolicy, *,
                 faults=None, straggler: StragglerMonitor | None = None,
                 sleep=time.sleep):
        self.cache = cache
        self.policy = policy
        self.faults = faults
        self.straggler = straggler
        self._sleep = sleep
        self.retries = 0            # re-executions after a failure
        self.failures = 0           # failed executions (incl. retried)

    def _runner(self, graph: NetworkGraph, hwc, bucket: int, mesh):
        variant = "local" if mesh is None else f"wave{mesh_size(mesh)}"

        def build():
            if self.faults is not None:
                self.faults.on_build()
            if mesh is None:
                return build_runner(graph)
            return wave_sharded_runner(graph, mesh)

        fn = self.cache.get(graph, hwc, bucket, build=build,
                            variant=variant)
        key = self.cache.key(graph, hwc, bucket, variant)
        return fn, key

    def execute(self, graph: NetworkGraph, hwc, bucket: int, batch,
                out_shape, mesh=None):
        """Run one packed wave; returns ``(out, seconds, attempts)``
        with ``out`` a numpy array.

        Each attempt rebuilds/refetches the runner (so an injected or
        real kernel build failure is retried too), executes, waits for
        the device (``seconds`` spans the copy of the wave to the
        device, the call and that wait), validates the output shape and
        copies the output to the host.  Any failure evicts the cached
        runner for this key — a corrupted cache entry can only be cured
        by rebuild — then backs off exponentially before the next try.
        """
        devices = [graph.device] if mesh is None else list(mesh)
        delay = self.policy.retry_backoff_s
        budget = self.policy.max_wave_retries + 1
        last: Exception | None = None
        for attempt in range(1, budget + 1):
            try:
                fn, key = self._runner(graph, hwc, bucket, mesh)
                if self.faults is not None:
                    fn = self.faults.wrap_runner(fn)
                t0 = time.perf_counter()
                out = fn(batch)
                for d in devices:
                    synchronize(d)
                dt = time.perf_counter() - t0
                if tuple(out.shape) != tuple(out_shape):
                    raise RuntimeError(
                        f"wave output shape {tuple(out.shape)} != expected "
                        f"{tuple(out_shape)} (corrupted runner?)")
                out = out.cpu().numpy()
                if self.straggler is not None:
                    self.straggler.observe(f"bucket{bucket}", dt)
                return out, dt, attempt
            except Exception as e:  # noqa: BLE001 — the executor is the
                # translation boundary: unknown infrastructure errors
                # (and injected chaos) become the typed taxonomy here.
                last = e
                self.failures += 1
                self.cache.evict(
                    self.cache.key(graph, hwc, bucket,
                                   "local" if mesh is None
                                   else f"wave{mesh_size(mesh)}"))
                if attempt < budget:
                    self.retries += 1
                    self._sleep(delay)
                    delay *= self.policy.backoff_multiplier
        raise WaveExecutionError(
            f"wave failed after {budget} attempt(s): {last!r}",
            attempts=budget) from last


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class ConvServeEngine:
    """SLO-aware wave-scheduled serving of a frozen
    :class:`NetworkGraph` (plus optional cheaper-precision variants)
    at one input geometry, on the graph's device.

    >>> eng = ConvServeEngine(graph, (H, W, C),
    ...                       policy=ServePolicy(wave_deadline_ms=5.0))
    >>> eng.register_degraded(graph.with_precision(fmt8), "hobflops8")
    >>> eng.submit(ConvRequest(0, img))
    >>> done = eng.run()          # or eng.step() in a serving loop
    >>> eng.stats()["p99_latency_ms"], done[0].precision

    Every served request's output is bit-identical to ``graph.run`` on
    that request alone *at the precision it was served at* — packing,
    bucket pad, sharding, retries, and degradation never change a
    single code (tests assert it).  ``max_batch`` defaults to
    :func:`derive_max_batch` on the graph's device; ``mesh`` is a list
    of devices (:func:`~repro_torch.serve_conv.sharding.wave_mesh`)."""

    def __init__(self, graph: NetworkGraph, hwc, *,
                 max_batch: int | None = None,
                 mesh=None, runner_cache: RunnerCache | None = None,
                 policy: ServePolicy | None = None, faults=None,
                 heartbeat_dir: str | None = None,
                 heartbeat_host: str = "serve0",
                 clock=time.monotonic, verbose: bool = False):
        assert graph._out is not None, "freeze the graph (output()) first"
        self.graph = graph
        self.hwc = tuple(hwc)
        self.policy = policy or ServePolicy()
        self.clock = clock
        h, w, c = self.hwc
        self.device = resolve_device(graph.device)
        self.max_batch = max_batch or derive_max_batch(graph, self.hwc,
                                                       self.device)
        self.mesh = None if mesh is None else wave_mesh(mesh)
        if mesh is not None:
            n = mesh_size(self.mesh)
            if self.max_batch % n:
                raise ValueError(
                    f"max_batch {self.max_batch} must divide over the "
                    f"{n}-device wave mesh")
            self.buckets = tuple(n * b
                                 for b in bucket_sizes(self.max_batch // n))
        else:
            self.buckets = bucket_sizes(self.max_batch)
        # explicit None check: a fresh shared cache is empty == falsy
        self.cache = RunnerCache() if runner_cache is None else runner_cache
        self.scheduler = WaveScheduler(self.max_batch, self.policy)
        self.straggler = StragglerMonitor()
        self.executor = WaveExecutor(self.cache, self.policy,
                                     faults=faults,
                                     straggler=self.straggler)
        self.heartbeat = (Heartbeat(heartbeat_dir, host=heartbeat_host)
                          if heartbeat_dir else None)
        self.macs_per_image = graph.macs((1,) + self.hwc)
        # precision ladder: level 0 is the full-precision graph; higher
        # levels are pre-registered cheaper variants (register_degraded)
        self._variants: list[tuple[str, NetworkGraph, int]] = [
            ("full", graph, self.macs_per_image)]
        self.controller = OverloadController(1, self.policy)
        # counters
        self.waves = 0
        self.waves_failed = 0
        self.images_served = 0
        self.requests_served = 0
        self.requests_failed = 0
        self.requests_expired = 0
        self.requests_rejected = 0
        self.requests_shed = 0
        self.wave_seconds: list[float] = []
        self.wave_occupancy: list[float] = []
        self.request_latencies: list[float] = []
        self.images_by_level: dict[str, int] = {}
        self.quarantined: list[ConvRequest] = []
        self.expired: list[ConvRequest] = []
        if verbose:
            print(f"ConvServeEngine: graph {graph.signature()} @ "
                  f"{h}x{w}x{c}, max_batch {self.max_batch}, buckets "
                  f"{self.buckets}, {self.macs_per_image:,} MACs/image")
            print(graph.summary((1,) + self.hwc))

    # -- precision ladder --------------------------------------------------
    def register_degraded(self, graph: NetworkGraph,
                          label: str | None = None) -> int:
        """Append a cheaper-precision variant to the degradation
        ladder (level ``len-1``); registration order is full precision
        first, cheapest last.  The variant must be frozen and must
        produce the same output geometry as the primary graph for this
        engine's HxWxC — degradation changes codes, never shapes.
        Returns the variant's ladder level."""
        assert graph._out is not None, "freeze the variant (output()) first"
        want = self.graph.out_shape((1,) + self.hwc)
        got = graph.out_shape((1,) + self.hwc)
        if want != got:
            raise ValueError(
                f"degraded variant output shape {got} != primary "
                f"{want} at {self.hwc} — a variant may change "
                f"precision, not geometry")
        level = len(self._variants)
        label = label or f"degraded{level}"
        self._variants.append((label, graph,
                               graph.macs((1,) + self.hwc)))
        # fresh controller sized to the new ladder (registration
        # happens at setup time, before traffic)
        self.controller = OverloadController(len(self._variants),
                                             self.policy)
        return level

    @property
    def variants(self) -> tuple[str, ...]:
        return tuple(label for label, _, _ in self._variants)

    # -- admission ---------------------------------------------------------
    def submit(self, req: ConvRequest):
        """Validate then enqueue.  Unservable payloads raise
        :class:`RequestValidationError` and a full queue raises
        :class:`QueueFullError` — in both cases the request never
        enters the queue and can never poison a wave."""
        try:
            n = validate_request_image(req.image, self.hwc,
                                       max_images=self.max_batch)
        except Exception:
            self.requests_rejected += 1
            req.status = "rejected"
            raise
        try:
            self.scheduler.submit(req, n, self.clock())
        except QueueFullError:
            self.requests_shed += 1
            req.status = "shed"
            raise

    def pending_images(self) -> int:
        return self.scheduler.queued_images

    def wave_ready(self) -> bool:
        return self.scheduler.wave_ready(self.clock())

    def next_deadline(self) -> float | None:
        return self.scheduler.next_deadline()

    # -- one admission step ------------------------------------------------
    def step(self, force: bool = False) -> list[ConvRequest]:
        """One pass of the admission loop: expire aged-out requests,
        decide whether a wave should close (deadline-or-full; ``force``
        closes any non-empty queue — the drain path), pick the
        precision level under current pressure, execute, and either
        complete or quarantine the wave.  Returns the requests *served*
        by this step (empty when no wave closed or the wave failed)."""
        now = self.clock()
        for req in self.scheduler.expire(now):
            self.requests_expired += 1
            self.expired.append(req)
        if not self.scheduler.queue:
            return []
        if not (force or self.scheduler.wave_ready(now)):
            return []
        level = self.controller.observe(self.scheduler.pressure())
        label, graph, macs_img = self._variants[level]
        wave = self.scheduler.take()
        filled = sum(request_images(r.image) for r in wave)
        bucket = bucket_for(filled, self.buckets)
        batch, plan = pack_wave([r.image for r in wave], bucket,
                                hwc=self.hwc)
        out_shape = graph.out_shape((bucket,) + self.hwc)
        try:
            out, dt, attempts = self.executor.execute(
                graph, self.hwc, bucket, batch, out_shape,
                mesh=self.mesh)
        except WaveExecutionError as e:
            # Quarantine: only this wave's requests fail; the engine
            # keeps admitting and serving subsequent waves.
            for req in wave:
                req.status = "failed"
                req.error = e
                req.done = False
            self.requests_failed += len(wave)
            self.waves_failed += 1
            self.quarantined.extend(wave)
            if self.heartbeat is not None:
                self.heartbeat.beat(self.waves, step_time_s=None)
            return []
        for req, res in zip(wave, unpack_wave(out, plan)):
            req.out = res
            req.done = True
            req.status = "served"
            req.wave = self.waves
            req.latency_s = dt
            req.precision = label
            req.level = level
            req.degraded = level > 0
            req.attempts = attempts
            # queue wait (engine clock) + execution (wall clock): the
            # end-to-end latency the p50/p99 SLO tracks
            req.e2e_latency_s = (now - req.submitted_at) + dt
            self.request_latencies.append(req.e2e_latency_s)
        self.waves += 1
        self.images_served += plan.filled
        self.requests_served += len(wave)
        self.wave_seconds.append(dt)
        self.wave_occupancy.append(plan.occupancy)
        self.images_by_level[label] = \
            self.images_by_level.get(label, 0) + plan.filled
        if self.heartbeat is not None:
            self.heartbeat.beat(self.waves, step_time_s=dt)
        return wave

    def run_wave(self) -> list[ConvRequest]:
        """Close and execute one wave from whatever is queued (legacy
        immediate-drain entrypoint)."""
        return self.step(force=True)

    def run(self) -> list[ConvRequest]:
        """Drain the queue; returns *served* requests in wave order
        (quarantined/expired requests are in ``self.quarantined`` /
        ``self.expired`` with their typed errors)."""
        finished: list[ConvRequest] = []
        while self.scheduler.queue:
            finished.extend(self.step(force=True))
        return finished

    # -- counters ----------------------------------------------------------
    def stats(self) -> dict:
        total_s = sum(self.wave_seconds)
        lat = np.asarray(self.request_latencies, np.float64)
        hb = None
        if self.heartbeat is not None:
            rec = self.heartbeat.last()
            hb = {"host": self.heartbeat.host,
                  "step": rec["step"] if rec else None,
                  "path": str(self.heartbeat.path)}
        return {
            "waves": self.waves,
            "waves_failed": self.waves_failed,
            "images_served": self.images_served,
            "requests_served": self.requests_served,
            "requests_failed": self.requests_failed,
            "requests_expired": self.requests_expired,
            "requests_rejected": self.requests_rejected,
            "requests_shed": self.requests_shed,
            "queued_images": self.scheduler.queued_images,
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "images_per_s": self.images_served / total_s if total_s else 0.0,
            "macs_per_s": (self.images_served * self.macs_per_image
                           / total_s if total_s else 0.0),
            "mean_wave_s": total_s / self.waves if self.waves else 0.0,
            "mean_occupancy": (sum(self.wave_occupancy)
                               / len(self.wave_occupancy)
                               if self.wave_occupancy else 0.0),
            "p50_latency_ms": (float(np.percentile(lat, 50)) * 1e3
                               if lat.size else None),
            "p99_latency_ms": (float(np.percentile(lat, 99)) * 1e3
                               if lat.size else None),
            "wave_retries": self.executor.retries,
            "wave_exec_failures": self.executor.failures,
            "runner_cache": {"size": len(self.cache),
                             "hits": self.cache.hits,
                             "misses": self.cache.misses,
                             "evictions": self.cache.evictions},
            "degradation": {**self.controller.stats(),
                            "variants": list(self.variants),
                            "images_by_level": dict(self.images_by_level)},
            "stragglers": self.straggler.stragglers(),
            "straggler_fleet": self.straggler.fleet_summary(),
            "heartbeat": hb,
        }
