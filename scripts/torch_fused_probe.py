#!/usr/bin/env python3
"""Where a fused MAC chain step's cycles go, on one card.

Three readings for the port's fused MAC kernel
(``src/repro_torch/csrc/fused_mac.cuh`` with the emitted chain body):

1. **LOP3 latency and issue rate.** A one-block microbenchmark times,
   with ``clock64()``, a chain of 512 dependent ``lop3.b32`` (the
   dependent-LOP3 latency L) and 8 independent chains of 512 (one warp's
   issue interval), for 1, 4 and 8 warps a block (``chip_smoke``'s
   ``lop3_readings``, which prints L too).
2. **The body's SASS.** ``cuobjdump -sass`` of the built kernel: the
   instructions of each fused kernel by opcode, against the gate count
   of its emitted body (does each LUT3 become one ``LOP3``?).
3. **Where a step's cycles go.** The measurement-only probe
   instantiation of the kernel (``fused_source(..., probe=True)``)
   stamps ``clock64()`` in every warp: a chain warp's waits on its ring
   and its add-only chain body, a producer warp's staging, multiplies
   and waits; at the MobileNets 14x14x512 stage's two conv layers at
   batch 1 (3x3: P=196, C=4608, Mw=16; 1x1: C=512) in hobflops9 with the
   wrapper's default blocks and chain depth, checked against the plain
   version on 64 channels and timed with CUDA events.  The cycles a MAC
   step are set against the two floors of one chain warp: the LOP3
   issue floor and the latency floor (the accumulator path's gate depth
   a step x L).

The SM clock is read with ``nvidia-smi`` right after the probes.

Run from the repository root on a machine with a card:
``python3 scripts/torch_fused_probe.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (acc_depth, lop3_readings, nvidia_smi,  # noqa: E402
                        time_cuda)

def sass_census(so: Path) -> dict[str, Counter]:
    """``{kernel name: Counter(opcode)}`` from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                     r"(\.[A-Z0-9_.]+)?", ln)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_probe: no CUDA device available", file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch.core.fpformat import HOBFLOPS_FORMATS, RNE
    from repro_torch.core.fused_backend import kernel as fused

    card = nvidia_smi("name,power.limit")
    print(card)
    lop3 = lop3_readings(_build)
    for key, val in lop3.items():
        print(f"lop3 {key}: {val:.2f} cycles a LOP3 a warp")
    L = lop3["dependent_1w"]

    fmt = HOBFLOPS_FORMATS["hobflops9"]
    variant = fused.fused_variant(fmt, 4608, relu=True)
    k = variant[1]
    tag = fused.variant_tag(*variant)
    lib = _build.build([fused.build_job([variant], probe=True)])[0]
    argt = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    launch = _build.bind(lib.lib, f"fused_mac_{tag}", argt)
    probe_fn = _build.bind(lib.lib, f"fused_mac_probe_{tag}",
                           argt + [ctypes.c_void_p])
    body = fused.fused_add_lowered(fmt, k, False, RNE)
    mul = fused.fused_mul_lowered(fmt, False, RNE)
    depth = acc_depth(body.graph)
    ops = next(o for n, o in sass_census(lib.path).items()
               if "fused_mac_kernel" in n and "ELb0EEv" in n)
    print(f"add-only chain body k={k}: {body.gate_count()} gates, "
          f"accumulator path {depth} deep ({depth / k:.1f} a step); "
          f"multiplier {mul.gate_count()} gates; kernel SASS "
          f"{sum(ops.values())} instructions, {ops['LOP3']} LOP3, "
          f"{ops['LDS']} LDS, {ops['STS']} STS; top {ops.most_common(6)}")

    rng = np.random.default_rng(args.seed)
    P, Mw = 196, 16
    rows = []
    for layer, C in (("3x3", 4608), ("1x1", 512)):
        i_masks = torch.as_tensor(
            -rng.integers(0, 2, (P, C, fmt.nbits)).astype(np.int32),
            device="cuda")
        w_planes = torch.as_tensor(
            rng.integers(-2**31, 2**31, (C, fmt.nbits, Mw),
                         dtype=np.int64).astype(np.int32), device="cuda")
        blk = _build.launch_blocks(P, C, Mw, kernel="fused_mac")
        tp, tw = blk["p_block"], blk["m_block"]
        ct = fused.ring_slot(blk["c_block"], k, fmt.nbits,
                             fmt.mult_out().nbits, tp, tw)
        pw = _build.FUSED_PRODUCERS
        grid = (-(-Mw // tw)) * (-(-P // tp))
        nw = fused.block_threads(tp, tw) // 32
        ncw = -(-tp * tw // 32)
        want = fused._fused_mac_torch(i_masks[:, :64], w_planes[:64],
                                      fmt=fmt, extended=False, rounding=RNE,
                                      k=k, relu=True)
        out = torch.empty((fmt.mult_out().nbits, P, Mw),
                          dtype=torch.int32, device="cuda")
        small = torch.empty_like(out)
        _build.check(launch(_build.ptr(i_masks[:, :64].contiguous()),
                            _build.ptr(w_planes[:64].contiguous()),
                            _build.ptr(small), P, 64, Mw, tp, tw, ct, pw,
                            _build.stream_ptr()), "fused_mac")
        probe = torch.zeros(grid * nw * 4, dtype=torch.int64,
                            device="cuda")
        _build.check(probe_fn(_build.ptr(i_masks), _build.ptr(w_planes),
                              _build.ptr(out), P, C, Mw, tp, tw, ct, pw,
                              _build.stream_ptr(), _build.ptr(probe)),
                     "fused_mac probe")
        torch.cuda.synchronize()
        if not torch.equal(small, want):
            print(f"{layer}: kernel != plain version",
                  file=sys.stderr)
            return 1

        def run():
            _build.check(launch(_build.ptr(i_masks),
                                _build.ptr(w_planes), _build.ptr(out),
                                P, C, Mw, tp, tw, ct, pw,
                                _build.stream_ptr()), "fused_mac")
        ms = time_cuda(run, 20)
        pr = probe.view(grid, nw, 4).double()
        ch, pd = pr[:, :ncw], pr[:, ncw:]
        T = pr[0, 0, 3].item()
        row = {"layer": layer, "C": C, "ms": ms,
               "blocks": grid, "c_tile": ct, "producer_warps": pw,
               "chain_wait_a_mac": ch[..., 0].mean().item() / C,
               "chain_body_a_mac": ch[..., 1].mean().item() / C,
               "producer_wait_a_mac": pd[..., 0].mean().item() / C,
               "producer_mul_a_mac": pd[..., 1].mean().item() / C,
               "producer_stage_a_mac": pd[..., 2].mean().item() / C,
               "tiles": T}
        row["cycles_a_mac"] = row["chain_wait_a_mac"] + \
            row["chain_body_a_mac"]
        rows.append(row)
        print(f"{layer} C={C}: {ms:.4f} ms, {grid} blocks of "
              f"{32 * nw} threads, C tile {ct}; a MAC step: chain warp "
              f"{row['cycles_a_mac']:.0f} cycles (body "
              f"{row['chain_body_a_mac']:.0f}, waiting "
              f"{row['chain_wait_a_mac']:.0f}); producer staging "
              f"{row['producer_stage_a_mac']:.0f}, multiplies "
              f"{row['producer_mul_a_mac']:.0f}, waiting "
              f"{row['producer_wait_a_mac']:.0f}")
    clock = float(nvidia_smi("clocks.sm").split()[0])
    print(f"clocks.sm after the probes: {clock:.0f} MHz")
    issue = lop3["ilp8_1w"]
    print(f"floors of one chain warp a MAC step: issue "
          f"{body.gate_count() / k:.0f} LOP3 x {issue:.2f} = "
          f"{body.gate_count() / k * issue:.0f} cycles (one LOP3 a gate); "
          f"latency {depth / k:.1f} gates x L {L:.2f} = "
          f"{depth / k * L:.0f} cycles")
    print(card)
    print(json.dumps({"card": card, "clock_mhz": clock, "lop3": lop3,
                      "k": k, "gates": body.gate_count(),
                      "mul_gates": mul.gate_count(), "acc_depth": depth,
                      "sass": dict(ops), "layers": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
