"""The paper's own experiment, grown to real network topology.

Two demos, both computed end-to-end in HOBFLOPS bitslice arithmetic
with activations resident in the plane domain (one encode at the
input, one decode at the output — DESIGN.md §8-§9):

* the original MobileNets-style linear stack (3x3 conv + two pointwise
  convs, ReLU between) through :class:`HobflopsNetwork`;
* a graph topology through :class:`NetworkGraph`: 3x3 conv -> 2x2
  maxpool -> residual pointwise block (skip merged by an in-domain
  ``build_add``) -> strided 3x3 downsample at a *higher* per-layer
  precision (the paper's mixed-precision prototyping pitch) -> 2x2
  avgpool head (add-tree + ``build_scale``, no divider).

The same graphs chained through per-layer f32 boundaries and the
word-parallel softfloat oracles are bit-exact — run with ``--check``.

The port's counterpart of ``examples/mobilenet_conv.py``: it runs on the
card by default (the fused MAC kernel, ``--backend cuda_fused``, or the
netlist interpreter, ``--backend cuda``); ``--device cpu`` runs their
plain versions on the CPU.  Times include the first call's kernel build.

Run: PYTHONPATH=src python examples/mobilenet_conv_torch.py [--fmt hobflops9] [--check]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch._build import resolve_device, synchronize
from repro_torch.core.fpformat import HOBFLOPS_FORMATS
from repro_torch.kernels.conv2d_bitslice.network import (ConvLayerSpec,
                                                         HobflopsNetwork,
                                                         NetworkGraph)
from repro_torch.kernels.conv2d_bitslice.ref import conv2d_f32


def bits(t) -> np.ndarray:
    """A float32 tensor's int32 bit patterns, on the host."""
    return t.detach().cpu().numpy().view(np.int32)


def run_linear_stack(args, fmt, rng):
    img = rng.standard_normal((1, args.hw, args.hw, args.cin)) \
        .astype(np.float32)
    shapes = [(3, 3, args.cin, args.width),
              (1, 1, args.width, args.width),
              (1, 1, args.width, args.width)]
    kernels = [(rng.standard_normal(s) * 0.2).astype(np.float32)
               for s in shapes]
    net = HobflopsNetwork([ConvLayerSpec(k, fmt, relu=True)
                           for k in kernels], backend=args.backend,
                          device=args.device)
    x = torch.from_numpy(img).to(args.device)

    t0 = time.time()
    out_t = net(x)
    synchronize(args.device)
    dt = time.time() - t0
    out = out_t.cpu().numpy()

    f32 = x
    for k in kernels:
        f32 = torch.clamp(conv2d_f32(f32, k), min=0.0)
    f32 = f32.cpu().numpy()
    print(f"{len(kernels)}-layer stack @ {args.hw}x{args.hw}x{args.cin} "
          f"in {args.fmt} (bitslice-resident, incl. kernel build): {dt:.2f}s")
    print(f"  MACs: {net.macs(img.shape):,}  (1 activation encode, "
          f"1 decode, {len(kernels) - 1} in-domain casts)")
    print(f"  rel err vs f32 conv+relu chain: "
          f"{np.abs(out - f32).max() / np.abs(f32).max():.4f}")
    if args.check:
        rt = net.run_roundtrip(x)
        if not (bits(out_t) == bits(rt)).all():
            raise SystemExit("resident != per-layer roundtrip")
        print("  bit-exact vs per-layer decode/re-encode path: OK")


def run_residual_graph(args, fmt, rng):
    """Residual + strided-downsample + pooled-head topology, mixing the
    base format with a higher-precision late layer."""
    from repro_torch.core.fpformat import FPFormat
    hi = FPFormat(fmt.w_e, fmt.w_f + 2)    # always above the body fmt
    c = args.cin
    img = rng.standard_normal((1, args.hw, args.hw, c)) \
        .astype(np.float32)

    def k(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    g = NetworkGraph(fmt, backend=args.backend, device=args.device)
    c1 = g.conv("c1", g.input_name, k(3, 3, c, args.width), relu=True)
    p1 = g.maxpool2d("p1", c1, window=2)
    c2 = g.conv("c2", p1, k(1, 1, args.width, args.width), relu=True)
    c3 = g.conv("c3", c2, k(1, 1, args.width, args.width))
    res = g.relu("r", g.add("res", c3, p1))     # skip merged in-domain
    d = g.conv("d", res, k(3, 3, args.width, args.width), hi, stride=2)
    g.output(g.avgpool2d("head", d, window=2))

    x = torch.from_numpy(img).to(args.device)
    t0 = time.time()
    out = g.run(x)
    synchronize(args.device)
    dt = time.time() - t0
    shapes = g.shape_plan(img.shape)
    fmts = g.format_plan()
    print(f"\nresidual_pool graph @ {args.hw}x{args.hw}x{c} "
          f"({args.fmt} body, {fmts['d']} downsample) "
          f"(bitslice-resident, incl. kernel build): {dt:.2f}s")
    print(f"  MACs: {g.macs(img.shape):,}  out {shapes['head']}")
    print("  nodes: " + " -> ".join(
        f"{name}[{node.kind},{fmts[name]}]"
        for name, node in g._nodes.items()))
    if args.check:
        rt = g.run_roundtrip(x)
        if not (bits(out) == bits(rt)).all():
            raise SystemExit("graph resident != per-layer oracle")
        print("  bit-exact vs per-layer f32-boundary oracle: OK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", default="hobflops9",
                    choices=sorted(HOBFLOPS_FORMATS))
    ap.add_argument("--hw", type=int, default=14)
    ap.add_argument("--cin", type=int, default=16)
    ap.add_argument("--width", type=int, default=16,
                    help="channel width of the stack")
    ap.add_argument("--check", action="store_true",
                    help="verify bit-exactness vs the per-layer path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda_fused",
                    choices=["cuda_fused", "cuda"])
    args = ap.parse_args()
    args.device = resolve_device(args.device)
    print(f"backend {args.backend} on "
          f"{torch.cuda.get_device_name(args.device) if args.device.type == 'cuda' else 'cpu, plain versions'}")
    fmt = HOBFLOPS_FORMATS[args.fmt]
    rng = np.random.default_rng(0)
    run_linear_stack(args, fmt, rng)
    run_residual_graph(args, fmt, rng)


if __name__ == "__main__":
    main()
