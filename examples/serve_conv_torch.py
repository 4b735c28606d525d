"""Lane-batched serving demo on the PyTorch/CUDA port: many requests
through one wave.

The port's counterpart of ``examples/serve_conv.py``.  Builds a small
HOBFLOPS graph (3x3 conv -> pointwise -> maxpool) on ``--device``
(default ``cuda``), prints its per-node summary, then serves a queue of
heterogeneous requests (single images and small mini-batches) through
:class:`repro_torch.serve_conv.ConvServeEngine` — each wave one resident
call on the device, one encode, one decode, one MAC kernel launch a
conv, results sliced back per request bit-exactly (checked against
per-request ``graph.run`` with ``--check``).

Launch blocks come from the ``tuned_conv_blocks`` disk cache
(``.hobflops_tune_torch.json`` by default, ``HOBFLOPS_TORCH_TUNE_CACHE``
to override), so a second run of this example skips the sweep.

With ``--overload`` the demo also floods a small-bucket engine that has
a cheaper-precision variant registered (DESIGN.md §11): sustained queue
pressure steps the precision ladder down, each response is tagged with
the precision that served it, and pressure relief steps back up —
precision is shed before requests are.

Run: PYTHONPATH=src python examples/serve_conv_torch.py [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np

from repro_torch.core.fpformat import HOBFLOPS_FORMATS
from repro_torch.kernels.conv2d_bitslice.network import NetworkGraph
from repro_torch.serve_conv import (ConvRequest, ConvServeEngine, ServePolicy,
                                    tuned_conv_blocks)


def solo(graph, image):
    """``graph.run`` on one request alone, as numpy, rank restored."""
    batched = image[None] if image.ndim == 3 else image
    out = graph.run(batched).cpu().numpy()
    return out[0] if image.ndim == 3 else out


def overload_demo(g, hwc, rng, degrade_fmt):
    """Flood a tiny-bucket engine so the precision ladder engages."""
    g_cheap = g.with_precision(HOBFLOPS_FORMATS[degrade_fmt])
    eng = ConvServeEngine(
        g, hwc, max_batch=2,
        policy=ServePolicy(degrade_queue_factor=1.0, degrade_patience=2,
                           recover_patience=1))
    eng.register_degraded(g_cheap, degrade_fmt)
    for i in range(10):
        eng.submit(ConvRequest(i, rng.standard_normal(hwc)
                               .astype(np.float32)))
    done = eng.run()
    print(f"overload: {' '.join(f'{r.rid}:{r.precision}' for r in done)}")
    st = eng.stats()["degradation"]
    print(f"  activations={st['activations']} "
          f"images_by_level={st['images_by_level']}")
    # relief: one lightly-loaded wave steps back to full precision
    eng.submit(ConvRequest(99, rng.standard_normal(hwc).astype(np.float32)))
    eng.run()
    eng.submit(ConvRequest(100, rng.standard_normal(hwc).astype(np.float32)))
    last = eng.run()[0]
    print(f"  after relief: request {last.rid} served at "
          f"{last.precision!r} (level {last.level})")
    for r in done + [last]:
        graph = g if r.level == 0 else g_cheap
        assert (r.out.view(np.int32) ==
                solo(graph, r.image).view(np.int32)).all(), r.rid
    print("  every response bit-exact at its served precision")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", default="hobflops8",
                    choices=sorted(HOBFLOPS_FORMATS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--hw", type=int, default=8)
    ap.add_argument("--cin", type=int, default=8)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--check", action="store_true",
                    help="verify each request vs per-request graph.run")
    ap.add_argument("--overload", action="store_true",
                    help="demo the precision-degradation ladder")
    args = ap.parse_args()

    fmt = HOBFLOPS_FORMATS[args.fmt]
    rng = np.random.default_rng(0)
    k1 = (rng.standard_normal((3, 3, args.cin, args.cin)) * 0.3) \
        .astype(np.float32)
    k2 = (rng.standard_normal((1, 1, args.cin, args.cin)) * 0.3) \
        .astype(np.float32)

    hwc = (args.hw, args.hw, args.cin)
    img1 = rng.standard_normal((1,) + hwc).astype(np.float32)
    t0 = time.time()
    blocks, _ = tuned_conv_blocks(
        img1, k1, fmt=fmt, device=args.device, iters=1,
        candidates=[{"c_unroll": 2, "m_block": m} for m in (8, 32)])
    print(f"launch blocks {blocks} ({time.time() - t0:.2f}s — cached "
          f"runs skip the sweep)")

    # build the graph WITH the tuned launch blocks: both runners thread
    # them into the kernel launch (NetworkGraph.conv(blocks=...))
    g = NetworkGraph(fmt, device=args.device)
    c1 = g.conv("c1", g.input_name, k1, relu=True, blocks=blocks)
    c2 = g.conv("c2", c1, k2, relu=True, blocks=blocks)
    g.output(g.maxpool2d("head", c2, window=2))

    eng = ConvServeEngine(g, hwc, verbose=True)
    # heterogeneous queue: single images and small mini-batches
    pattern = [1, 1, 2, 1, 3, 1, 2, 1, 1, 4]
    sizes = [pattern[i % len(pattern)] for i in range(args.requests)]
    for i, b in enumerate(sizes):
        shape = hwc if b == 1 and i % 2 == 0 else (b,) + hwc
        eng.submit(ConvRequest(
            i, rng.standard_normal(shape).astype(np.float32)))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    st = eng.stats()
    print(f"served {st['requests_served']} requests "
          f"({st['images_served']} images) on {eng.device} in {dt:.2f}s "
          f"(incl. kernel builds) over {st['waves']} waves, mean "
          f"occupancy {st['mean_occupancy']:.2f}")
    print(f"steady-state: {st['images_per_s']:.1f} images/s, "
          f"{st['macs_per_s']:.3e} MACs/s, runner cache "
          f"{st['runner_cache']}")

    if args.check:
        for r in done:
            assert (r.out.view(np.int32) ==
                    solo(g, r.image).view(np.int32)).all(), r.rid
        print(f"bit-exact vs per-request graph.run: "
              f"all {len(done)} requests OK")

    if args.overload:
        degrade = "hobflops8" if args.fmt != "hobflops8" else "hobflops9"
        overload_demo(g, hwc, rng, degrade)


if __name__ == "__main__":
    main()
