"""Straggler detection from per-host step times.

A host is a straggler when its step-time EMA exceeds ``factor`` x the
fleet median.  Mitigation is the supervisor's call: at small excess it
logs; at persistent excess it excludes the host and triggers an elastic
re-mesh (checkpoint restore re-shards, see repro.checkpoint) — the same
path as a hard failure, which keeps the recovery machinery singular.

The serving engine reuses the same monitor with a different notion of
"host": each batch *bucket* is one observed population of wave times,
so a bucket whose waves run anomalously slow (an artificial straggler
in the chaos tests, a pathological shape in production) surfaces in
``ConvServeEngine.stats()["stragglers"]`` without any serving-specific
detection code.
"""
from __future__ import annotations

import dataclasses
import statistics


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 1.5
    ema_alpha: float = 0.3
    min_samples: int = 3
    _ema: dict = dataclasses.field(default_factory=dict)
    _count: dict = dataclasses.field(default_factory=dict)

    def observe(self, host: str, step_time_s: float):
        prev = self._ema.get(host)
        self._ema[host] = (step_time_s if prev is None else
                           self.ema_alpha * step_time_s
                           + (1 - self.ema_alpha) * prev)
        self._count[host] = self._count.get(host, 0) + 1

    def stragglers(self) -> list[str]:
        ready = {h: v for h, v in self._ema.items()
                 if self._count.get(h, 0) >= self.min_samples}
        if len(ready) < 2:
            return []
        med = statistics.median(ready.values())
        return sorted(h for h, v in ready.items()
                      if v > self.factor * med)

    def ema(self, host: str) -> float | None:
        """The step-time EMA observed for one host (None if never
        observed)."""
        return self._ema.get(host)

    def fleet_summary(self) -> dict:
        if not self._ema:
            return {}
        vals = list(self._ema.values())
        return {"median_s": statistics.median(vals),
                "max_s": max(vals), "hosts": len(vals)}
