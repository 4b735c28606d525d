"""Per-host heartbeat files: liveness without a coordinator.

Each host writes ``hb_<host>.json`` (step, wall time, step-time EMA)
every step; any reader — the supervisor, a peer, an external watchdog —
decides liveness from file mtimes alone.  On a real cluster the
directory lives on the shared checkpoint filesystem; no extra service
is needed, which matters at 1000+ nodes where "the monitoring system is
down" must not take training with it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time


@dataclasses.dataclass
class Heartbeat:
    directory: str
    host: str = "host0"

    def __post_init__(self):
        pathlib.Path(self.directory).mkdir(parents=True, exist_ok=True)

    @property
    def path(self) -> pathlib.Path:
        return pathlib.Path(self.directory) / f"hb_{self.host}.json"

    def beat(self, step: int, step_time_s: float | None = None,
             now: float | None = None):
        rec = {"host": self.host, "step": step,
               "time": now if now is not None else time.time(),
               "step_time_s": step_time_s}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(rec))
        tmp.rename(self.path)

    def last(self) -> dict | None:
        """This host's most recent beat record (None if never beaten
        or the file is torn) — the serve engine surfaces it through
        ``stats()`` so an external probe and the engine agree on what
        liveness means."""
        try:
            return json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return None

    def age_s(self, now: float | None = None) -> float | None:
        """Seconds since the last beat (None if never beaten)."""
        rec = self.last()
        if rec is None:
            return None
        return (now if now is not None else time.time()) - rec["time"]


def read_heartbeats(directory) -> dict[str, dict]:
    out = {}
    d = pathlib.Path(directory)
    if not d.exists():
        return out
    for p in d.glob("hb_*.json"):
        try:
            rec = json.loads(p.read_text())
            out[rec["host"]] = rec
        except (json.JSONDecodeError, KeyError):
            continue  # torn write: treat as missing this round
    return out


def stale_hosts(directory, timeout_s: float,
                now: float | None = None) -> list[str]:
    """Hosts whose last beat is older than timeout_s."""
    now = now if now is not None else time.time()
    beats = read_heartbeats(directory)
    return sorted(h for h, rec in beats.items()
                  if now - rec["time"] > timeout_s)
