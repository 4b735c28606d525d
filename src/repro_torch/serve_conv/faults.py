"""Fault injection for the serving path (chaos layer).

A robustness claim that was never exercised is a guess.  This module
injects the failure modes the engine promises to survive, at the same
seams where the real ones occur, so ``tests/test_torch_serve_faults.py``
and ``chip_smoke.py`` can prove the self-healing loop end-to-end:

* **Runner compile failures** — ``on_build`` raises
  :class:`InjectedCompileError` for the next ``compile_failures``
  runner builds, standing in for a kernel build (``nvcc``) error.  The
  executor's retry loop must rebuild and the request must still be
  answered bit-exactly.
* **Transient wave-execution errors** — ``wrap_runner`` raises
  :class:`InjectedWaveError` for the next ``wave_errors`` wave
  executions (a transient device/launch failure).  The retry loop must
  re-execute the identical wave.
* **Artificial stragglers** — the next ``straggle_waves`` wave
  executions sleep ``straggle_s`` before running, so the
  :class:`~repro_torch.ft.straggler.StragglerMonitor` wired into the engine
  sees a genuinely slow wave class and flags it in ``stats()``.
* **Corrupted runner-cache entries** — :func:`corrupt_runner_cache`
  replaces cached compiled runners with poison callables that always
  raise, standing in for a cache entry gone stale/invalid underneath a
  live engine.  The engine must *evict* the bad entry (not just retry
  it) and rebuild.
* **Corrupted tune cache** — :func:`corrupt_tune_cache` truncates the
  ``tuned_conv_blocks`` JSON file mid-token; ``load_tune_cache`` must
  warn, ignore, and let the next save rebuild the file atomically.

All injection is deterministic: counters tick down in call order, and
the only randomness (picking which cache entries to poison) draws from
a seeded generator (``HOBFLOPS_CHAOS_SEED``, default 0) so the CI
chaos job replays identically.

Injected errors deliberately do **not** subclass ``ServeError``: from
the engine's perspective they are the *unknown* failures robustness is
for, and the executor must translate them into the typed taxonomy.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

CHAOS_SEED_ENV = "HOBFLOPS_CHAOS_SEED"


def chaos_seed(default: int = 0) -> int:
    """The fixed chaos seed: ``HOBFLOPS_CHAOS_SEED`` env override (the
    CI chaos job pins it) else ``default``."""
    try:
        return int(os.environ.get(CHAOS_SEED_ENV, default))
    except ValueError:
        return default


class InjectedFault(RuntimeError):
    """Marker base for chaos-injected failures (NOT a ServeError: the
    engine must treat these as unknown infrastructure errors)."""


class InjectedCompileError(InjectedFault):
    """Stands in for a kernel build failure during runner build."""


class InjectedWaveError(InjectedFault):
    """Stands in for a transient device error during wave execution."""


@dataclasses.dataclass
class FaultPlan:
    """Mutable injection budget; counters tick down as faults fire.
    A test (or the chaos job) sets the budget, runs traffic, and then
    asserts both that the faults fired (counters at zero, injector
    tallies up) and that every answer stayed bit-exact."""
    compile_failures: int = 0     # next N runner builds raise
    wave_errors: int = 0          # next N wave executions raise
    straggle_waves: int = 0       # next N wave executions sleep first
    straggle_s: float = 0.05


class FaultInjector:
    """The chaos seams the executor threads its build/execute calls
    through.  With an all-zero :class:`FaultPlan` every hook is a
    no-op, so production engines simply pass ``faults=None``."""

    def __init__(self, plan: FaultPlan | None = None, *,
                 seed: int | None = None, sleep=time.sleep):
        self.plan = plan or FaultPlan()
        self.rng = np.random.default_rng(
            chaos_seed() if seed is None else seed)
        self._sleep = sleep
        self.injected_compile_failures = 0
        self.injected_wave_errors = 0
        self.injected_straggles = 0

    # -- seams -------------------------------------------------------------
    def on_build(self):
        """Called by the executor immediately before a runner build."""
        if self.plan.compile_failures > 0:
            self.plan.compile_failures -= 1
            self.injected_compile_failures += 1
            raise InjectedCompileError(
                "injected: runner compile failure")

    def wrap_runner(self, fn):
        """Wrap a compiled wave runner with the wave-level faults
        (straggle, then transient error) — checked per *execution*, so
        a retried wave re-rolls against the remaining budget."""
        def chaotic_runner(batch):
            if self.plan.straggle_waves > 0:
                self.plan.straggle_waves -= 1
                self.injected_straggles += 1
                self._sleep(self.plan.straggle_s)
            if self.plan.wave_errors > 0:
                self.plan.wave_errors -= 1
                self.injected_wave_errors += 1
                raise InjectedWaveError(
                    "injected: transient wave-execution error")
            return fn(batch)
        return chaotic_runner


# ---------------------------------------------------------------------------
# Cache corruption (operate on state, not call seams)
# ---------------------------------------------------------------------------
def corrupt_runner_cache(cache, n: int | None = None,
                         seed: int | None = None) -> list:
    """Replace ``n`` random cached runners (all by default) with poison
    callables that raise :class:`InjectedWaveError` on every call —
    retrying the same entry can never succeed; only eviction + rebuild
    recovers.  Returns the corrupted keys."""
    keys = list(cache.keys())
    rng = np.random.default_rng(chaos_seed() if seed is None else seed)
    if n is not None and n < len(keys):
        keys = [keys[i] for i in
                sorted(rng.choice(len(keys), size=n, replace=False))]

    def poisoned(batch):
        raise InjectedWaveError("injected: corrupted runner-cache entry")

    for k in keys:
        cache.replace(k, poisoned)
    return keys


def corrupt_tune_cache(path: str) -> str:
    """Truncate the tune-cache JSON file mid-token (the torn-write /
    bad-disk case ``load_tune_cache`` must tolerate)."""
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[:max(1, len(text) // 2)].rstrip("}\n ") + '"trunc')
    return path
