"""What every cell shares: the manifest (``BENCHMARK.json``), the files a
cell names, the run's request and outcome, the per-layer readers and
the guard against the JAX package.

A cell names a configuration and a traffic mix.  The configuration's
``system`` names the module of this package that serves it
(``conv_serve``, ``lm_decode``); the mix is data that module's
generator reads.  A per-layer metric ``<name>`` is read by
``perfbench/metrics/<name>.py``'s ``read(ctx)``, which returns a number
or None (nothing to read in this run)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable

BENCH = Path(__file__).resolve().parents[1]        # perfbench/
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")     # whole top-level names


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(*parts, bench: Path = BENCH) -> dict:
    with open(bench.joinpath(*parts)) as f:
        return json.load(f)


def cell(man: dict, name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """-> (the cell's entry, its configuration, its mix)."""
    for w in man["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    mix = load_json("mixes", w["traffic"] + ".json", bench=root / "perfbench")
    return w, cfg, mix


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str, bench: Path = BENCH) -> Callable:
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counts(name: str) -> dict:
    return load_json("counts", name + ".json")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a system module is asked to do."""
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                        # the process's start, perf_counter
    control: bool = False            # serve the control in the
                                     # program's place (not a benchmark run)
    fault: Callable | None = None    # plants a fault in the system (tests)


@dataclasses.dataclass
class Check:
    """One number compared with its limit; ``ok`` when within it."""
    name: str
    value: float
    limit: float
    ok: bool


@dataclasses.dataclass
class Outcome:
    metrics: dict                    # end-to-end metric -> value
    counters: dict                   # what the readers read beside the trace
    checks: list                     # [Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None             # trace.Trace of a traced run
    control: dict | None = None      # the control's readings (--control)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


@dataclasses.dataclass
class Context:
    """What a per-layer reader sees."""
    workload: str
    cfg: dict
    mix: dict
    trace: object
    counters: dict
    counts: Callable = counts


def per_layer(man: dict, workload: str, ctx: Context,
              bench: Path = BENCH) -> dict:
    out = {}
    for m in man["per_layer"]:
        if not applies(m, workload):
            continue
        v = reader(m["name"], bench)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def system(name: str):
    return importlib.import_module(f"harness.{name}")
