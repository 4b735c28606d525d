#!/usr/bin/env python3
"""Where the dequant matmul's tensor-core route spends its time, on one
card.

Builds ``src/repro_torch/csrc/dequant_matmul.cu`` and, at qwen2-0.5b's
four quantized projection shapes (K, N) = (896, 896), (896, 128),
(896, 4864) and (4864, 896) with hobflops9 planes:

1. **split against walk**: the route with each block owning one K chunk
   (and the chunk-sum kernel after) and with each block walking every
   chunk, at the n width the wrapper picks, for M = 4 to 512.  Both
   must give the same bits (the order of summation depends on K alone).
   Each point is the median of 20 launches after 3 warm-ups
   (``chip_smoke``'s ``median_device_ms``), taken in rounds over the two,
   so drift hits both alike; the script prints the median and range of
   the rounds, and the layer's sum (2 wq/wo + 2 wk/wv + 2 w_gate/w_up +
   w_down) split and walked.  The wrapper's ``SMALL_M`` is read from it.
2. **the call's kernels**: at M = 512 and 4 (the smoke's points), 20
   calls of the entry point under ``torch.profiler``: device time a call
   of the x split, the main kernel and the chunk sum, beside the
   event-timed call.
3. **code width**: the main kernel's device time at wq/wo, M = 512
   (walked) and w_down, M = 4 (split) for StorageFormats of 8, 9, 12 and
   16 bits, against the decode's integer operations a weight
   (2 nbits + 6).

Run from the repository root on a machine with a card:
``python3 scripts/torch_dequant_probe.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (dq_decode_ops, device_time_us,  # noqa: E402
                        median_device_ms, nvidia_smi, ptxas_report)

SHAPES = {"wq/wo": (896, 896), "wk/wv": (896, 128),
          "w_gate/w_up": (896, 4864), "w_down": (4864, 896)}
LAYER = {"wq/wo": 2, "wk/wv": 2, "w_gate/w_up": 2, "w_down": 1}
ROWS = (4, 8, 16, 32, 64, 128, 256, 512)
ROUNDS = 3
TRACED = 20
KERNELS = ("split_x_kernel", "dequant_tc_kernel", "chunk_sum_kernel")


def traced_ms(fn) -> dict:
    """Device ms a call of each of the route's kernels, over ``TRACED``
    calls of ``fn`` under ``torch.profiler`` after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in KERNELS}
    for e in prof.key_averages():
        for k in KERNELS:
            if k in e.key:
                out[k] += device_time_us(e) / 1e3 / TRACED
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dequant_probe: no CUDA device available",
              file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch.core.fpformat import StorageFormat
    from repro_torch.kernels.dequant_matmul import kernel as dq
    from repro_torch.kernels.dequant_matmul.ops import (dequant_matmul,
                                                        pack_weights)

    card = nvidia_smi("name,power.limit")
    print(card)
    lib = _build.build([dq.build_job()])[0]
    dq.load(lib)
    for entry, rep in ptxas_report(lib.ptxas_log).items():
        print(f"ptxas {entry}: {rep.get('regs')} registers, {rep['smem']} B"
              f" static shared, spill stores/loads {rep.get('spill_stores')}"
              f"/{rep.get('spill_loads')} B")

    dev = torch.device("cuda")
    hf9 = StorageFormat(5, 3)
    gen = torch.Generator().manual_seed(args.seed)
    weights = {name: torch.randn((K, N), generator=gen) * 0.03
               for name, (K, N) in SHAPES.items()}
    packed = {name: pack_weights(w, hf9) for name, w in weights.items()}
    packed = {name: (qt.data.to(dev), qt.scale.to(dev), qt)
              for name, qt in packed.items()}
    report = {"card": card, "format": "hobflops9", "rounds": ROUNDS,
              "small_m": dq.SMALL_M, "sweep": [], "kernels": [],
              "widths": []}

    # -- 1. split against walk ---------------------------------------
    print("1. split against walk (ms: median [min, max] of the rounds)")
    for M in ROWS:
        for name, (K, N) in SHAPES.items():
            planes, scale, _ = packed[name]
            x = torch.randn((M, K), generator=gen).to(dev)
            nw = dq.plan(M, K, hf9)["n_width"]
            outs = {s: torch.empty((M, N), device=dev) for s in (1, 0)}

            def run(s):
                dq.launch_tc(x, planes, scale, outs[s], hf9, nw, bool(s))

            for s in outs:
                run(s)
            torch.cuda.synchronize()
            if not torch.equal(outs[1].view(torch.int32),
                               outs[0].view(torch.int32)):
                print(f"{name} M={M}: split and walk gave different bits",
                      file=sys.stderr)
                return 1
            ms = {s: [] for s in outs}
            for _ in range(ROUNDS):
                for s in outs:
                    ms[s].append(median_device_ms(lambda: run(s)))
            row = {"shape": name, "K": K, "N": N, "M": M, "n_width": nw}
            for s, key in ((1, "split"), (0, "walk")):
                v = sorted(ms[s])
                row[key] = {"median": v[len(v) // 2], "min": v[0],
                            "max": v[-1]}
            report["sweep"].append(row)
            print(f"  {name:11s} M={M:3d} n={nw:2d}  " + "  ".join(
                f"{k} {row[k]['median']:.4f} [{row[k]['min']:.4f}, "
                f"{row[k]['max']:.4f}]" for k in ("split", "walk")))
        layer = {k: sum(LAYER[r["shape"]] * r[k]["median"]
                        for r in report["sweep"] if r["M"] == M)
                 for k in ("split", "walk")}
        print(f"  layer M={M:3d}: split {layer['split']:.4f} ms, walk "
              f"{layer['walk']:.4f} ms, split / walk "
              f"{layer['split'] / layer['walk']:.3f} (wrapper: "
              f"{'split' if dq.tile_for(M) == dq.TILE_M8 else 'walk'})")

    # -- 2. the call's kernels ----------------------------------------
    print("2. the call's kernels (profiler device ms a call; event-timed "
          "call)")
    for M in (512, 4):
        for name, (K, N) in SHAPES.items():
            _, _, qt = packed[name]
            qg = type(qt)(packed[name][0], packed[name][1], qt.sfmt,
                          qt.layout, qt.shape)
            x = torch.randn((M, K), generator=gen).to(dev)
            per = traced_ms(lambda: dequant_matmul(x, qg))
            call = median_device_ms(lambda: dequant_matmul(x, qg))
            report["kernels"].append({"shape": name, "M": M, "call_ms": call,
                                      **per})
            print(f"  {name:11s} M={M:3d}: call {call:.4f} ms; "
                  + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
                  + f"; kernels {sum(per.values()) / call:.3f} of the call")

    # -- 3. code width ------------------------------------------------
    print("3. code width (main kernel, profiler device ms a call)")
    for sfmt in (StorageFormat(5, 2), hf9, StorageFormat(5, 6),
                 StorageFormat(5, 10)):
        for name, M in (("wq/wo", 512), ("w_down", 4)):
            qt = pack_weights(weights[name], sfmt)
            planes, scale = qt.data.to(dev), qt.scale.to(dev)
            K, N = SHAPES[name]
            x = torch.randn((M, K), generator=gen).to(dev)
            p = dq.plan(M, K, sfmt)
            out = torch.empty((M, N), device=dev)
            main_ms = traced_ms(lambda: dq.launch_tc(
                x, planes, scale, out, sfmt, p["n_width"], p["split"])
            )["dequant_tc_kernel"]
            ops = dq_decode_ops(sfmt.nbits)
            report["widths"].append({"nbits": sfmt.nbits, "shape": name,
                                     "M": M, "main_ms": main_ms,
                                     "decode_ops": ops})
            print(f"  nbits {sfmt.nbits:2d} ({ops} ops a weight) {name} "
                  f"M={M}: {main_ms:.4f} ms")
    print(card)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
