"""Admission policy and precision-degrading overload control.

The HOBFLOPS pitch is that precision is a *dial* (hobflops9 runs far
cheaper than hobflops16), and the related work (Fixflow, arXiv
2302.09564; Lai et al., arXiv 1703.03073) frames precision as an
accuracy/cost trade-off to be managed — which makes precision the
natural graceful-degradation axis for an overloaded serving engine:
when the queue backs up, *shed precision before shedding requests*.

Two pieces:

* :class:`ServePolicy` — the engine's declarative knobs: how long a
  partial wave may wait (``wave_deadline_ms``), how deep the queue may
  grow (``max_queue_images``), the default per-request deadline, the
  wave retry budget, and the overload thresholds.
* :class:`OverloadController` — a hysteresis ladder over registered
  precision levels (0 = full precision, rising = cheaper).  Pressure
  is the queued backlog measured in waves (``queued images /
  max_batch``).  Sustained pressure above ``degrade_queue_factor`` for
  ``degrade_patience`` consecutive observations steps one level down
  the ladder; sustained pressure at or below ``recover_queue_factor``
  for ``recover_patience`` observations steps back up.  Patience on
  both edges prevents flapping on a single bursty wave; the recover
  threshold sits below the degrade threshold for the same reason.

Degraded waves run a *pre-registered* cheaper-precision
``NetworkGraph`` variant (built with the §9 mixed-precision machinery,
e.g. ``NetworkGraph.with_precision``) — and remain bit-identical to
``graph.run`` *at that precision*, so the repo's cross-cutting
bit-exactness invariant survives overload: every response is tagged
with the precision level that served it and is exactly what that
graph would have produced for the request alone.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Declarative serving-robustness knobs for :class:`ConvServeEngine`.

    ``wave_deadline_ms``
        Close a partially-filled wave once the *oldest* queued request
        has waited this long (the classic throughput/latency dial).
        ``None`` keeps the legacy behaviour: any non-empty queue is
        ready, and waves close on fullness or drain.
    ``max_queue_images``
        Bounded queue: ``submit()`` raises :class:`QueueFullError` once
        this many images are queued.  ``None`` = unbounded.
    ``request_timeout_ms``
        Default per-request deadline (a request's own ``deadline_ms``
        overrides it).  Requests that age past it while queued are
        marked with :class:`DeadlineExceededError` and dropped at
        admission.  ``None`` = no deadline.
    ``max_wave_retries`` / ``retry_backoff_s`` / ``backoff_multiplier``
        A failed wave execution is retried up to ``max_wave_retries``
        times with exponential backoff, evicting the (possibly bad)
        cached runner before each retry.  Only after the budget is
        exhausted are the wave's requests quarantined.
    ``degrade_queue_factor`` / ``recover_queue_factor``
        Overload thresholds in units of waves of backlog (queued
        images / max_batch).  ``degrade_queue_factor=None`` disables
        overload control even when degraded variants are registered.
        ``recover_queue_factor`` defaults to half the degrade factor.
    ``degrade_patience`` / ``recover_patience``
        Consecutive pressure observations (one per admission attempt)
        required to move down / up the precision ladder.
    """
    wave_deadline_ms: float | None = None
    max_queue_images: int | None = None
    request_timeout_ms: float | None = None
    max_wave_retries: int = 2
    retry_backoff_s: float = 0.01
    backoff_multiplier: float = 2.0
    degrade_queue_factor: float | None = 2.0
    recover_queue_factor: float | None = None
    degrade_patience: int = 3
    recover_patience: int = 3

    def recover_threshold(self) -> float:
        if self.recover_queue_factor is not None:
            return self.recover_queue_factor
        return (self.degrade_queue_factor or 0.0) / 2.0


class OverloadController:
    """Hysteresis ladder over precision levels ``0 .. levels-1``.

    ``observe(pressure)`` is called once per admission attempt and
    returns the level the next wave should serve at.  ``activations``
    counts downward steps (degradations) for the stats surface and the
    load benchmark; ``transitions`` records ``(wave_index_hint,
    from_level, to_level)`` tuples for post-hoc inspection.
    """

    def __init__(self, levels: int, policy: ServePolicy):
        assert levels >= 1
        self.levels = levels
        self.policy = policy
        self.level = 0
        self.activations = 0
        self.transitions: list[tuple[int, int, int]] = []
        self._hot = 0
        self._cold = 0
        self._observations = 0

    def observe(self, pressure: float) -> int:
        """Update the hot/cold streaks with one pressure sample and
        return the (possibly changed) serving level."""
        self._observations += 1
        if self.policy.degrade_queue_factor is None or self.levels == 1:
            return self.level
        if pressure > self.policy.degrade_queue_factor:
            self._hot += 1
            self._cold = 0
        elif pressure <= self.policy.recover_threshold():
            self._cold += 1
            self._hot = 0
        else:                       # between thresholds: streaks decay
            self._hot = 0
            self._cold = 0
        if self._hot >= self.policy.degrade_patience \
                and self.level < self.levels - 1:
            self.transitions.append((self._observations, self.level,
                                     self.level + 1))
            self.level += 1
            self.activations += 1
            self._hot = 0
        elif self._cold >= self.policy.recover_patience and self.level > 0:
            self.transitions.append((self._observations, self.level,
                                     self.level - 1))
            self.level -= 1
            self._cold = 0
        return self.level

    def stats(self) -> dict:
        return {"level": self.level, "levels": self.levels,
                "activations": self.activations,
                "transitions": len(self.transitions)}
