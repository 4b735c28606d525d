#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine, from
the root of a checkout: set-up (inputs drawn from ``--seed``, the
program built and warmed at the cell's shapes), a window of ``--seconds``
(``--trace 1``: a shorter traced one, for the per-layer metrics), then
the check of what the window served against the plain reference.  The
last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the checks are also the last lines on standard error.  Exits
non-zero and prints no result without a card, with fewer cards than the
cell asks for, if the run fails, or if a module of the JAX package
(``repro``) or of JAX is loaded.

``--control 1`` serves the cell's control in the program's place (the
configuration's lower precision) and prints the control's readings; the
benchmark's runs never pass it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"


def steady_heap() -> None:
    """Keep freed host blocks of up to 32 MiB in the process's heap.

    A conv wave's host buffers (25.7 MB each, allocated afresh every
    wave) are otherwise handed back to the system and faulted in again
    on the next wave, at a cost that differs from process to process:
    under glibc's default, adaptive thresholds the rate spreads between
    runs of one seed.  Other C libraries keep their own policy."""
    import ctypes
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return
    mallopt(-3, 32 << 20)          # M_MMAP_THRESHOLD
    mallopt(-1, (1 << 31) - 1)     # M_TRIM_THRESHOLD


def set_environment() -> None:
    """Every cache a run may write lives at a fixed path in the
    checkout; no library is let load JAX."""
    steady_heap()
    os.environ["HOBFLOPS_TORCH_TUNE_CACHE"] = str(CACHE / "tune.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    for k, v in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0")):
        os.environ[k] = v
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    from harness import core
    man = core.manifest()
    work, cfg, mix = core.cell(man, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"perfbench: {work['name']} needs {work['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    run = core.Run(cfg, mix, args.seed, args.seconds, bool(args.trace), dev,
                   T0, control=bool(args.control))
    out = core.system(cfg["system"]).run(run)

    loaded = core.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    return report(man, work, cfg, mix, args, out, dev)


def report(man, work, cfg, mix, args, out, dev) -> int:
    import torch

    from harness import core
    if args.trace:
        ctx = core.Context(work["name"], cfg, mix, out.trace, out.counters)
        metrics = core.per_layer(man, work["name"], ctx)
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in man["end_to_end"]
                   if core.applies(m, work["name"])
                   and m["name"] in out.metrics}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": work["chips"],
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.device_ops(),
                             "idle_gaps": out.trace.gaps}
    if out.control is not None:
        line["control"] = out.control
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:              # noqa: BLE001 — no result on a failure
        traceback.print_exc()
        sys.exit(1)
