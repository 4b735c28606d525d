"""A HOBFLOPS CNN stack served through the program's lane-batched engine
(``repro_torch.serve_conv.ConvServeEngine`` over a frozen
``NetworkGraph``), driven by client traffic on the host.

Traffic (the mix): ``arrivals`` is ``closed`` (``clients`` each keep one
request in flight and send the next as the reply comes back) or
``poisson`` (``rate`` requests a second from the seed, plus
``burst_requests`` at once every ``burst_every_s``, if given); each
request is one image drawn from a pool of ``pool`` images made from the
seed.  Latency runs from the client's send (for ``poisson``, the time it
was due) to the reply on the host.

The window starts and ends on a wave boundary.  Afterwards one response
a lane position of the wave (``max_batch`` of them, each drawn from the
seed among the requests served at that position in the window) is held
bit for bit (int32 patterns) to the plain reference
(``reference/conv.py``) run on the card, as are the failed requests: a
request that fails, expires or is refused never answers.
"""
from __future__ import annotations

import contextlib
import gc
import heapq
import math
import random
import time

import numpy as np
import torch

from . import inputs
from .core import Check, Outcome, Run
from .trace import span, traced


class Closed:
    def __init__(self, mix, rng):
        self.mix, self.rng = mix, rng
        self.pending = [(0.0, c) for c in range(mix["clients"])]

    def due(self, now):
        out = []
        while self.pending and self.pending[0][0] <= now:
            t, c = heapq.heappop(self.pending)
            out.append((c, now))
        return out

    def next_due(self):
        return self.pending[0][0] if self.pending else None

    def on_reply(self, client, now):
        heapq.heappush(self.pending, (now, client))


class Poisson:
    def __init__(self, mix, rng, start):
        self.mix, self.rng = mix, rng
        self.t = start
        self.burst_at = start + mix.get("burst_every_s", math.inf)

    def due(self, now):
        out = []
        while self.t <= now:
            out.append((None, self.t))
            self.t += self.rng.expovariate(self.mix["rate"])
        while self.burst_at <= now:
            out += [(None, self.burst_at)] * self.mix["burst_requests"]
            self.burst_at += self.mix["burst_every_s"]
        return out

    def next_due(self):
        return min(self.t, self.burst_at)

    def on_reply(self, client, now):
        pass


def build(cfg, device, seed, control: bool):
    from repro_torch.core.fpformat import parse_format
    from repro_torch.kernels.conv2d_bitslice.network import NetworkGraph
    from repro_torch.serve_conv import ConvServeEngine, ServePolicy
    kernels = inputs.conv_kernels(cfg["layers"], device, seed)
    g = NetworkGraph(parse_format(cfg["format"]), backend=cfg["backend"],
                     device=device)
    src = g.input_name
    for i, (k, spec) in enumerate(zip(kernels, cfg["layers"])):
        src = g.conv(f"conv{i}", src, k.cpu().numpy(),
                     stride=spec.get("stride", 1),
                     relu=spec.get("relu", True))
    g.output(src)
    if control:
        g = g.with_precision(parse_format(cfg["control_format"]))
    eng = ConvServeEngine(
        g, tuple(cfg["input_hwc"]), max_batch=cfg["max_batch"],
        policy=ServePolicy(wave_deadline_ms=cfg["wave_deadline_ms"]))
    return eng, kernels


class Loop:
    """The serving loop: submit what is due, step the engine, reply."""

    def __init__(self, eng, traffic, pool, mix, rng, trace: bool):
        self.eng, self.traffic, self.pool = eng, traffic, pool
        self.mix, self.rng, self.trace = mix, rng, trace
        self.rid = 0
        self.sent = {}              # rid -> (client, send time, pool index)
        self.record = None          # called with (lane, latency, pool
                                    # index, req)

    def submit(self, now):
        from repro_torch.serve_conv import ConvRequest
        for client, t in self.traffic.due(now):
            idx = self.rng.randrange(len(self.pool))
            self.sent[self.rid] = (client, t, idx)
            with span("submit", self.trace):
                self.eng.submit(ConvRequest(self.rid, self.pool[idx]))
            self.rid += 1

    def wave(self) -> float:
        """Runs until one wave is served; returns the reply time."""
        clock = self.eng.clock
        while True:
            self.submit(clock())
            with span("wave", self.trace):
                done = self.eng.step()
            if done:
                break
            nxt = [t for t in (self.eng.next_deadline(),
                               self.traffic.next_due()) if t is not None]
            if nxt:
                time.sleep(max(0.0, min(nxt) - clock()))
        now = clock()
        with span("reply", self.trace):
            for lane, req in enumerate(done):
                client, t, idx = self.sent.pop(req.rid)
                if self.record is not None:
                    self.record(lane, now - t, idx, req)
                self.traffic.on_reply(client, now)
        return now


def failures(eng) -> int:
    return len(eng.quarantined) + len(eng.expired) \
        + eng.requests_rejected + eng.requests_shed


def run(r: Run) -> Outcome:
    cfg, mix, dev = r.cfg, r.mix, r.device
    eng, kernels = build(cfg, dev, r.seed, r.control)
    if r.fault is not None:
        r.fault(eng)
    hwc = tuple(cfg["input_hwc"])
    pool = inputs.image_pool(mix["pool"], hwc, dev, r.seed).cpu().numpy()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    rng = random.Random(inputs.sub_seed(r.seed, "traffic"))
    start = eng.clock()
    traffic = (Closed(mix, rng) if mix["arrivals"] == "closed"
               else Poisson(mix, rng, start))
    loop = Loop(eng, traffic, pool, mix, rng, r.trace)
    for _ in range(mix["warmup_waves"]):
        loop.wave()
    setup_s = time.perf_counter() - r.t0

    lat = []
    kept, seen = {}, {}             # lane -> (pool index, response), count
    pick = random.Random(inputs.sub_seed(r.seed, "check"))

    def record(lane, latency, idx, req):
        """A reservoir of one response a lane position."""
        lat.append(latency)
        seen[lane] = seen.get(lane, 0) + 1
        if pick.randrange(seen[lane]) == 0:
            kept[lane] = (idx, np.array(req.out))

    loop.record = record
    failed0 = failures(eng)
    t_out: dict = {}
    length = min(r.seconds, mix["trace_seconds"]) if r.trace else r.seconds
    ctx = traced(t_out) if r.trace else contextlib.nullcontext()
    with ctx:
        t_start = eng.clock()
        t_end = t_start
        waves = 0
        while t_end - t_start < length:
            t_end = loop.wave()
            waves += 1
    window_s = t_end - t_start
    failed = failures(eng) - failed0
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    mem_peak = max(before, peak) if cuda else 0
    del eng, loop, traffic
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, ctrl = compare(cfg, kernels, pool, list(kept.values()),
                           failed, dev)
    metrics = {"setup_s": setup_s, "peak_gb": peak / 1e9}
    if lat and window_s > 0:
        metrics["conv_images_per_s"] = len(lat) / window_s
        metrics["conv_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    counters = {"images": len(lat), "requests": len(lat), "waves": waves,
                "window_s": window_s}
    return Outcome(metrics, counters, checks, len(lat) + failed, failed,
                   mem_peak, t_out.get("trace"),
                   ctrl if r.control else None)


def compare(cfg, kernels, pool, kept, failed, dev):
    """The sampled responses against the plain reference, bit for bit."""
    from reference import conv as ref
    from reference.softfloat import fmt_named
    idx = sorted({i for i, _ in kept})
    step = cfg["check_chunk"]
    want = {}
    for a in range(0, len(idx), step):
        part = idx[a:a + step]
        imgs = torch.as_tensor(np.stack([pool[i] for i in part]),
                               device=dev)
        out = ref.stack_forward(imgs, kernels, cfg["layers"],
                                fmt_named(cfg["format"]))
        for i, o in zip(part, out.cpu().numpy()):
            want[i] = o
    off = total = 0
    for i, got in kept:
        w = want[i]
        total += w.size
        off += (w.size if got.shape != w.shape else
                int((got.view(np.int32) != w.view(np.int32)).sum()))
    checks = [Check("conv_bits_off", off, 0, off == 0 and bool(kept)),
              Check("conv_failed", failed, 0, failed == 0)]
    return checks, {"conv_bits_off": off, "conv_compared": total}
