"""The device trace of a traced window, reduced to what the per-layer
readers read.

A traced run wraps its window in ``torch.profiler`` (CPU and CUDA
activities) and in a ``perfbench.window`` span.  The reduction takes
every device event (kernels, copies, sets; the profiler's own
annotations left out), merges their intervals into the time some
operation ran, and keeps, by name: each kernel's device time and count,
each ``perfbench.*`` span's device time (the operations inside its
device-side annotation) and the idle gaps between device work, each
named after the innermost host event open at the gap's middle.

The arithmetic follows ``chip_smoke.py``'s ``trace_requests`` (device
time by kernel group over a synchronised host window), with busy time
taken as the union of device intervals rather than their sum.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

WINDOW_SPAN = "perfbench.window"
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float                    # the traced window, device clock
    busy_s: float                      # union of device intervals in it
    kernels: dict                      # name -> [seconds, count]
    spans: dict                        # span name -> device seconds
    gaps: list                         # [[host event name, seconds], ...]

    def device_ops(self) -> list:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[name[:160], s] for name, (s, _) in top]

    def kernel_s(self, pred) -> float:
        return sum(s for n, (s, _) in self.kernels.items() if pred(n))


def span(name: str, on: bool):
    """A ``perfbench.<name>`` host span around a call into the program,
    recorded in a traced run (nothing in an untraced one)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function("perfbench." + name)


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body; ``out["trace"]`` receives the :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            yield
            sync()
        host_s = time.perf_counter() - t0
    out["trace"] = reduce(prof.events(), host_s)


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("perfbench."))


def span_device_s(events, dev) -> dict:
    """Each ``perfbench.*`` span's name -> device seconds of the
    operations that ran inside the span's device-side annotation (the
    interval from the first to the last operation launched under it; one
    stream, so nothing else runs there)."""
    ivs: dict = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name.startswith("perfbench."):
            ivs.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    out = {}
    for name, iv in ivs.items():
        iv.sort()
        starts = [a for a, _ in iv]
        total = 0.0
        for s, t, _ in dev:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and t <= iv[i][1]:
                total += t - s
        out[name] = total / 1e6
    return out


def reduce(events, host_s: float) -> Trace:
    cpu = torch.autograd.DeviceType.CPU
    win = [e for e in events if e.name == WINDOW_SPAN
           and e.device_type == cpu]
    if win:
        w0, w1 = win[0].time_range.start, win[0].time_range.end
    else:                                 # pragma: no cover
        w0, w1 = float("-inf"), float("inf")
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if _is_device(e)), key=lambda t: t[0])
    kernels: dict = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) / 1e6
        k[1] += 1
    merged: list = []
    for s, t, _ in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    window = (w1 - w0) / 1e6 if win else host_s
    spans = span_device_s(events, dev)
    holes = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a and a > float("-inf"):
            holes.append((b - a, (a + b) / 2))
    holes.sort(reverse=True)
    host = [e for e in events if e.device_type == cpu
            and e.name != WINDOW_SPAN]
    gaps = []
    for length, mid in holes[:TOP]:
        inner = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        name = min(inner, key=lambda e: e.time_range.end
                   - e.time_range.start).name if inner else "none"
        gaps.append([name[:160], length / 1e6])
    return Trace(window, busy, kernels, spans, gaps)
