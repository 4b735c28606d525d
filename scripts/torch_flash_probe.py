#!/usr/bin/env python3
"""Where the blockwise attention backward spends its time, on one card.

Builds ``src/repro_torch/csrc/flash_attention.cu`` once for each dK/dV
split (``FLASH_SPLIT_TILES``: query tiles a dK/dV block walks before the
next block takes over; "none" is one block a key tile walking them all)
and, at ``chip_smoke.py`` step 8's attention (batch 2, sequence 4096, 14
query heads over 2 kv heads, head 64, bf16, causal):

1. holds each build's dq, dk, dv to the plain version within 2^-7 of the
   largest value (``chip_smoke.FLASH_TOL``);
2. times each build's backward call (median of 20 launches after 3
   warm-ups, ``chip_smoke.median_device_ms``) in ``ROUNDS`` rounds over
   the builds, alternating their order, so drift hits all alike; prints
   the median and range of the rounds;
3. traces 10 calls of the forward and of each build's backward under
   ``torch.profiler``: device ms a call of each kernel (forward, Dv pass,
   dK/dV, split sum, dQ) and its registers and shared memory from
   ``-Xptxas -v``.

The last line is one JSON object with every reading.  Run from the
repository root on a machine with a card:
``python3 scripts/torch_flash_probe.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import (FLASH_SHAPE, FLASH_TOL, device_time_us,  # noqa: E402
                        median_device_ms, nvidia_smi, ptxas_report)

SPLITS = {"none": 1 << 20, "64": 64, "32": 32, "16": 16}
ROUNDS = 3
TRACED = 10
KERNELS = ("flash_fwd_kernel", "flash_bwd_dot_kernel",
           "flash_bwd_dkdv_kernel", "flash_bwd_sum_kernel",
           "flash_bwd_dq_kernel")


def traced_ms(fn) -> dict:
    """Device ms a call of each attention kernel over ``TRACED`` calls
    of ``fn`` under ``torch.profiler``, after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = next((k for k in KERNELS if k in e.key), None)
        if name and e.device_type == torch.autograd.DeviceType.CUDA:
            out[name] = out.get(name, 0.0) + device_time_us(e) / 1e3 / TRACED
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_probe: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                         flash_fwd_ref)

    card = nvidia_smi("name,power.limit")
    print(card)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    libs = dict(zip(SPLITS, _build.build(
        [(f"flash_attention_split_{k}",
          f"#define FLASH_SPLIT_TILES {n}\n{source}")
         for k, n in SPLITS.items()])))
    for k, lib in libs.items():
        rep = {e.split("flash_")[-1][:24]: (r.get("regs"), r["smem"])
               for e, r in ptxas_report(lib.ptxas_log).items()
               if "ILi64E" in e or "dot" in e or "sum" in e}
        print(f"split {k}: registers, static shared by kernel (D 64): {rep}")

    dev = torch.device("cuda")
    B, S, Hq, Hkv, D = FLASH_SHAPE
    G = Hq // Hkv
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    draw = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v, do = (draw(B, S, Hkv, G, D), draw(B, S, Hkv, D),
                   draw(B, S, Hkv, D), draw(B, S, Hkv, G, D))
    kw = dict(causal=True, q_block=512, kv_block=512)
    fa.load(libs["32"])
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    ro, rl = flash_fwd_ref(q, k, v, **kw)
    want = flash_bwd_ref(do, q, k, v, ro, rl, **kw)
    errs = {}
    for name, lib in libs.items():
        fa.load(lib)
        got = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
        torch.cuda.synchronize()
        errs[name] = []
        for g, w in zip(got, want):
            top = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            if err > FLASH_TOL * top:
                print(f"split {name}: {err:.3e} against the plain version's "
                      f"largest {top:.3e}", file=sys.stderr)
                return 1
            errs[name].append(err)
    print(f"each build's dq, dk, dv within {FLASH_TOL} of the plain "
          f"version's largest value; max abs err {errs}")

    times = {name: [] for name in libs}
    order = list(libs)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            fa.load(libs[name])
            times[name].append(median_device_ms(
                lambda: fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)))
    traced = {"forward": traced_ms(lambda: fa.flash_fwd_cuda(q, k, v, **kw))}
    for name, lib in libs.items():
        fa.load(lib)
        traced[name] = traced_ms(
            lambda: fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw))
    print(f"backward at B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, "
          f"causal ({card}); median ms of {ROUNDS} rounds [range]:")
    for name in libs:
        ts = times[name]
        print(f"    split {name:>4s}: {statistics.median(ts):.3f} ms "
              f"[{min(ts):.3f}, {max(ts):.3f}]; traced kernels "
              + ", ".join(f"{k.removeprefix('flash_').removesuffix('_kernel')}"
                          f" {ms:.3f}" for k, ms in traced[name].items()))
    print(f"    forward: traced {traced['forward']}")
    fa.load(libs["32"])
    print(json.dumps({"card": card, "shape": FLASH_SHAPE,
                      "bwd_ms": {n: times[n] for n in libs},
                      "traced_ms": traced, "max_abs_err": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
