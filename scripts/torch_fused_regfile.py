#!/usr/bin/env python3
"""Register file and time of the port's fused MAC kernel per chain depth,
on one card.

Builds the fused kernel (``src/repro_torch/csrc/fused_mac.cuh`` with the
emitted bodies: the add-only chain the chain warps run and the
multiplier the producer warps run ahead) for several formats at chain
depths 1-4, one ``nvcc`` per format started together, and prints for
each variant the chain body's peak live slots and gate count and what
``-Xptxas -v`` reports for the kernel: registers per thread and spill
bytes.  Then it times every variant with CUDA events on both conv layers
of the MobileNets 14x14x512 stage at batch 1 — the 3x3 512->512 layer
(P=196, C=4608, Mw=16) and the 1x1 512->512 layer (C=512) — in rounds
over the depths (median and range of the rounds), and weighs them as a
request of the stack does: one 3x3 and two 1x1 launches.  It checks
that every depth of a format gives the same planes.  ``fused_chain_k``'s
depth policy is chosen from this table.  Last, for hobflops9 at the
policy's depth, it times the 3x3 layer at batch 1 and 4 (P=196, 784)
over the producer warps a chain warp (``_build.FUSED_PRODUCERS``) and
the ring slot's channels (``c_block``), the launch defaults of
``_build.launch_blocks``.

Run from the repository root on a machine with a card:
``python3 scripts/torch_fused_regfile.py``.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import nvidia_smi, ptxas_report, time_cuda  # noqa: E402

FORMATS = {"hobflops8": (5, 2), "hobflops9": (5, 3), "hobflops11": (5, 5),
           "hobflops16": (5, 10)}
# (name, C, launches of the layer in one request of the stack)
LAYERS = (("3x3", 4608, 1), ("1x1", 512, 2))
P, MW = 196, 16
REPS, ROUNDS = 20, 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_regfile: no CUDA device available",
              file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch.core.fpformat import RNE, FPFormat
    from repro_torch.core.fused_backend import kernel as fused

    card = nvidia_smi("name,power.limit")
    print(card)
    # Every depth is built and launched as asked: the wrapper's depth
    # policy is set aside for the sweep.
    policy = fused.fused_chain_k
    fused.fused_chain_k = lambda fmt, extended, requested, rounding: \
        requested
    variants = {name: [(FPFormat(*we_wf), k, False, RNE, False)
                       for k in (1, 2, 3, 4)]
                for name, we_wf in FORMATS.items()}
    libs = _build.build([fused.build_job(vs) for vs in variants.values()])
    regs = {}
    for lib, vs in zip(libs, variants.values()):
        fused.load(lib, vs)
        regs.update(ptxas_report(lib.ptxas_log))

    rng = np.random.default_rng(args.seed)
    rows = []
    for name, vs in variants.items():
        fmt = vs[0][0]
        ms = {}                              # (layer, k) -> per-round ms
        for layer, C, _ in LAYERS:
            i_masks = torch.as_tensor(
                -rng.integers(0, 2, (P, C, fmt.nbits)).astype(np.int32),
                device="cuda")
            w_planes = torch.as_tensor(
                rng.integers(-2**31, 2**31, (C, fmt.nbits, MW),
                             dtype=np.int64).astype(np.int32),
                device="cuda")
            launches = {v[1]: functools.partial(
                fused.fused_mac_cuda, i_masks, w_planes, fmt=fmt,
                c_unroll=v[1]) for v in vs}
            outs = {k: fn() for k, fn in launches.items()}
            if not all(torch.equal(o, outs[1]) for o in outs.values()):
                print(f"{name} {layer}: chain depth changed the planes",
                      file=sys.stderr)
                return 1
            # Rounds over every depth in turn, so drift hits all alike.
            for _ in range(ROUNDS):
                for k, fn in launches.items():
                    ms.setdefault((layer, k), []).append(
                        time_cuda(fn, REPS))
        for _, k, *_ in vs:
            lowered = fused.fused_add_lowered(fmt, k, False, RNE)
            tag = "Add_" + fused.variant_tag(fmt, k, False, RNE, False)
            rep = next(r for ent, r in regs.items() if tag in ent)
            row = {"format": name, "k": k, "live_slots": lowered.nslots,
                   "gates": lowered.gate_count(), **rep}
            for layer, _, _ in LAYERS:
                t = sorted(ms[(layer, k)])
                row[layer] = {"median": t[len(t) // 2], "min": t[0],
                              "max": t[-1]}
            row["request_ms"] = sum(n * row[layer]["median"]
                                    for layer, _, n in LAYERS)
            rows.append(row)
            print(f"{name:11s} k={k} live slots {lowered.nslots:4d} gates "
                  f"{lowered.gate_count():5d} regs {rep.get('regs')} "
                  f"spill st/ld {rep.get('spill_stores')}/"
                  f"{rep.get('spill_loads')} B  " + "  ".join(
                      f"{layer} {row[layer]['median']:.4f} "
                      f"[{row[layer]['min']:.4f}, {row[layer]['max']:.4f}]"
                      for layer, _, _ in LAYERS)
                  + f"  3x3 + 2 x 1x1 {row['request_ms']:.4f} ms")
        best = min((r for r in rows if r["format"] == name),
                   key=lambda r: r["request_ms"])
        print(f"{name:11s} fastest request at k={best['k']}; "
              f"fused_chain_k picks k={policy(fmt)}")
    fused.fused_chain_k = policy
    fmt = FPFormat(*FORMATS["hobflops9"])
    launch_rows = []
    for p in (196, 784):
        i_masks = torch.as_tensor(
            -rng.integers(0, 2, (p, 4608, fmt.nbits)).astype(np.int32),
            device="cuda")
        w_planes = torch.as_tensor(
            rng.integers(-2**31, 2**31, (4608, fmt.nbits, MW),
                         dtype=np.int64).astype(np.int32), device="cuda")
        ms = {}
        for _ in range(ROUNDS):
            for pw in (2, 3, 4):
                for cb in (8, 16):
                    _build.FUSED_PRODUCERS = pw
                    ms.setdefault((pw, cb), []).append(time_cuda(
                        lambda: fused.fused_mac_cuda(
                            i_masks, w_planes, fmt=fmt, c_block=cb), REPS))
        for (pw, cb), t in sorted(ms.items()):
            t = sorted(t)
            launch_rows.append({"P": p, "producers": pw, "c_block": cb,
                                "median": t[len(t) // 2], "min": t[0],
                                "max": t[-1]})
            print(f"hobflops9 3x3 P={p} producers {pw} c_block {cb:2d}: "
                  f"{t[len(t) // 2]:.4f} ms [{t[0]:.4f}, {t[-1]:.4f}]")
    print(card)
    print(json.dumps({"card": card, "shape": {"P": P, "Mw": MW},
                      "layers": LAYERS, "rounds": ROUNDS, "reps": REPS,
                      "rows": rows, "launch": launch_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
