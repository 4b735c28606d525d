"""Supervisor: failure detection -> elastic re-mesh -> restart plan.

The supervisor never touches training state.  It watches heartbeats,
decides *when* to act and *what mesh comes next*; recovery itself is
just "restart the launcher with the new mesh and restore the latest
checkpoint" — the checkpoint layer re-shards to whatever mesh it is
handed (see repro.checkpoint.store), so failure, stragglers, shrink and
grow all share one code path.

``plan_remesh`` is a pure function so the policy is unit-testable: given
surviving host count and per-host chip count it returns the largest
(pods, data, model) grid that preserves the model axis (TP degree is a
property of the model, not the fleet) and keeps the data axis a
power-of-two divisor of the surviving chips.
"""
from __future__ import annotations

import dataclasses
import time

from .heartbeat import read_heartbeats, stale_hosts
from .straggler import StragglerMonitor


def plan_remesh(alive_chips: int, model_parallel: int,
                chips_per_pod: int = 256) -> tuple[int, int, int] | None:
    """-> (pods, data, model) or None if not enough chips for one TP
    group.  Greedy: keep TP, maximize whole pods, then the data axis."""
    if alive_chips < model_parallel:
        return None
    pods = max(alive_chips // chips_per_pod, 1)
    while pods > 1 and alive_chips // pods < model_parallel:
        pods -= 1
    per_pod = alive_chips // pods
    data = per_pod // model_parallel
    # largest power of two <= data (torus-friendly, divides batches)
    data = 1 << (data.bit_length() - 1) if data else 0
    if data == 0:
        return None
    return (pods, data, model_parallel)


@dataclasses.dataclass
class Supervisor:
    heartbeat_dir: str
    expected_hosts: list[str]
    chips_per_host: int = 4
    model_parallel: int = 16
    timeout_s: float = 60.0
    straggler_factor: float = 1.5
    monitor: StragglerMonitor = None  # type: ignore

    def __post_init__(self):
        if self.monitor is None:
            self.monitor = StragglerMonitor(factor=self.straggler_factor)

    def poll(self, now: float | None = None) -> dict:
        """One supervision round.  Returns an action dict:
        {action: "none"|"remesh", dead: [...], stragglers: [...],
         new_mesh: (pods, data, model) | None}."""
        now = now if now is not None else time.time()
        beats = read_heartbeats(self.heartbeat_dir)
        dead = [h for h in self.expected_hosts if h not in beats]
        dead += stale_hosts(self.heartbeat_dir, self.timeout_s, now)
        dead = sorted(set(dead))
        for host, rec in beats.items():
            if rec.get("step_time_s"):
                self.monitor.observe(host, rec["step_time_s"])
        stragglers = [h for h in self.monitor.stragglers()
                      if h not in dead]
        excluded = sorted(set(dead) | set(stragglers))
        if not excluded:
            return {"action": "none", "dead": [], "stragglers": [],
                    "new_mesh": None}
        alive = [h for h in self.expected_hosts if h not in excluded]
        new_mesh = plan_remesh(len(alive) * self.chips_per_host,
                               self.model_parallel)
        return {"action": "remesh" if new_mesh else "halt",
                "dead": dead, "stragglers": stragglers,
                "alive_hosts": alive, "new_mesh": new_mesh}
