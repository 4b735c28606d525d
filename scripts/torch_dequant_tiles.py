#!/usr/bin/env python3
"""Time of the dequant matmul's two tile configurations per row count,
on one card.

Builds ``src/repro_torch/csrc/dequant_matmul.cu`` and times both of its
tile configurations — the 64x64 output tile and the 8x32 tile — at
qwen2-0.5b's four quantized projection shapes (K, N) = (896, 896),
(896, 128), (896, 4864) and (4864, 896), hobflops9 planes, for row
counts from a decode step's few rows to a prefill's 512.  Each point is
the median of 20 launches after 3 warm-ups (``chip_smoke``'s
``median_device_ms``), taken in rounds over the two tiles, so drift hits
both alike; the script prints the median and range of the rounds and the
ratio.  It checks that both tiles give the same bits at every point.
The wrapper's row threshold ``SMALL_M`` is chosen from this table.

Run from the repository root on a machine with a card:
``python3 scripts/torch_dequant_tiles.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import median_device_ms, nvidia_smi, ptxas_report  # noqa: E402

SHAPES = {"wq/wo": (896, 896), "wk/wv": (896, 128),
          "w_gate/w_up": (896, 4864), "w_down": (4864, 896)}
ROWS = (1, 4, 8, 16, 24, 32, 64, 128, 512)
ROUNDS = 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dequant_tiles: no CUDA device available",
              file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch.core.fpformat import StorageFormat
    from repro_torch.kernels.dequant_matmul import kernel as dq
    from repro_torch.kernels.dequant_matmul.ops import pack_weights

    card = nvidia_smi("name,power.limit")
    print(card)
    lib = _build.build([dq.build_job()])[0]
    dq.load(lib)
    for entry, rep in ptxas_report(lib.ptxas_log).items():
        print(f"ptxas {entry}: {rep.get('regs')} registers, {rep['smem']} B"
              f" static shared, spill stores/loads {rep.get('spill_stores')}"
              f"/{rep.get('spill_loads')} B")

    dev = torch.device("cuda")
    sfmt = StorageFormat(5, 3)                                  # hobflops9
    gen = torch.Generator().manual_seed(args.seed)
    tiles = {"64x64": dq.TILE_M64, "8x32": dq.TILE_M8}
    rows = []
    for name, (K, N) in SHAPES.items():
        qt = pack_weights(torch.randn((K, N), generator=gen) * 0.03, sfmt)
        planes, scale = qt.data.to(dev), qt.scale.to(dev)
        for M in ROWS:
            x = torch.randn((M, K), generator=gen).to(dev)
            outs = {t: torch.empty((M, N), device=dev) for t in tiles}

            def run(t):
                dq.launch(x, planes, scale, outs[t], sfmt, tiles[t])

            for t in tiles:
                run(t)
            torch.cuda.synchronize()
            if not torch.equal(outs["64x64"].view(torch.int32),
                               outs["8x32"].view(torch.int32)):
                print(f"{name} M={M}: the tiles gave different bits",
                      file=sys.stderr)
                return 1
            ms = {t: [] for t in tiles}
            for _ in range(ROUNDS):
                for t in tiles:
                    ms[t].append(median_device_ms(lambda: run(t)))
            row = {"shape": name, "K": K, "N": N, "M": M}
            for t in tiles:
                s = sorted(ms[t])
                row[t] = {"median": s[len(s) // 2], "min": s[0],
                          "max": s[-1]}
            row["ratio_64_over_8"] = row["64x64"]["median"] / \
                row["8x32"]["median"]
            rows.append(row)
            print(f"{name:11s} K={K:4d} N={N:4d} M={M:3d}  " + "  ".join(
                f"{t} {row[t]['median']:.4f} [{row[t]['min']:.4f}, "
                f"{row[t]['max']:.4f}]" for t in tiles)
                + f"  64x64 / 8x32 {row['ratio_64_over_8']:.3f}  "
                f"(wrapper takes "
                f"{'8x32' if dq.tile_for(M) == dq.TILE_M8 else '64x64'})")
    print(card)
    print(json.dumps({"card": card, "format": "hobflops9", "rounds": ROUNDS,
                      "small_m": dq.SMALL_M, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
