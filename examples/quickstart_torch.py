"""Quickstart on the PyTorch/CUDA port: the HOBFLOPS flow end to end.

1. Pick a custom FP format (here HOBFLOPS9 = e5m3, MS-FP9-shaped).
2. Generate the gate-level MAC circuit (the in-repo FloPoCo analogue).
3. Technology-map it against the four cell libraries and compare gate
   counts (the paper's synthesis-area experiment).
4. Run a GEMM through the bitslice-parallel MAC and compare against
   both the exact-semantics oracle (bit for bit) and plain f64.

The port's counterpart of ``examples/quickstart.py``.  The GEMM runs on
the card by default, through the fused MAC kernel (``--backend
cuda_fused``) or the netlist interpreter (``--backend cuda``);
``--device cpu`` runs their plain versions on the CPU.  Exits non-zero
unless the GEMM equals the oracle bit for bit.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch._build import resolve_device
from repro_torch.core.fpcore import build_mac
from repro_torch.core.fpformat import HOBFLOPS_FORMATS
from repro_torch.core.opt import CELL_LIBS, tech_map
from repro_torch.kernels.bitslice_mac.ops import hobflops_matmul
from repro_torch.kernels.bitslice_mac.ref import hobflops_matmul_f64


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda_fused",
                    choices=["cuda_fused", "cuda"])
    args = ap.parse_args()
    device = resolve_device(args.device)
    fmt = HOBFLOPS_FORMATS["hobflops9"]
    print(f"format: hobflops9 = {fmt} "
          f"({fmt.nbits} bits incl. FloPoCo exception field)")

    g = build_mac(fmt)
    print(f"\nMAC circuit: {g.live_gate_count()} raw gates, "
          f"depth {g.depth()}")
    print("tech-mapped gate counts (paper Table 1 libraries + TPU):")
    for lib in ("avx2", "neon", "avx512", "tpu_vpu"):
        mapped = tech_map(g, CELL_LIBS[lib]())
        print(f"  {lib:8s}: {mapped.live_gate_count():4d} ops "
              f"({mapped.op_histogram()})")

    rng = np.random.default_rng(0)
    P, C, M = 8, 16, 64
    a = rng.standard_normal((P, C)).astype(np.float32)
    b = rng.standard_normal((C, M)).astype(np.float32)

    out = hobflops_matmul(torch.from_numpy(a).to(device),
                          torch.from_numpy(b).to(device), fmt=fmt,
                          backend=args.backend).cpu().numpy()
    oracle = hobflops_matmul_f64(a, b, fmt)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    same = np.array_equal(out.view(np.int32),
                          oracle.astype(np.float32).view(np.int32))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu, plain version")
    print(f"\nGEMM [{P}x{C}] @ [{C}x{M}] in bitslice HOBFLOPS9 "
          f"({args.backend} on {where}):")
    print(f"  bit-exact vs oracle : {same}")
    print(f"  max |err| vs f64    : {np.abs(out - exact).max():.4f} "
          f"(9-bit arithmetic quantization)")
    print(f"  f64 magnitude scale : {np.abs(exact).max():.4f}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
