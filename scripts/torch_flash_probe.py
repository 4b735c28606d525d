#!/usr/bin/env python3
"""Where the blockwise attention backward spends its time, on one card.

Builds ``src/repro_torch/csrc/flash_attention.cu`` once for each dK/dV
run length of the bf16 (tensor-core) route (``FLASH_TC_SPLIT_TILES``:
query tiles a dK/dV block walks before the next block takes over;
"none" is one block a key tile walking them all) and, by editing the
source's text (``VARIANTS``), for other counts of consumer warpgroups in
a forward, dQ and dK/dV block (the source's ``Tc::WF``, ``WQ``, ``WK``
at D <= 64), and, at ``chip_smoke.py`` step 8's attention (batch 2,
sequence 4096, 14 query heads over 2 kv heads, head 64, bf16, causal):

1. holds each build's o, dq, dk, dv to the plain version within 2^-7 of
   the largest value (``chip_smoke.FLASH_TOL``) and with at most
   ``chip_smoke.FLASH_BITS_OFF`` of each one's elements not bit-equal to
   the plain version's;
2. times each build's forward and backward call (median of 20 launches
   after 3 warm-ups, ``chip_smoke.median_device_ms``) in ``ROUNDS``
   rounds over the builds, alternating their order, so drift hits all
   alike; prints the median and range of the rounds;
3. traces 10 calls of each build's forward and backward under
   ``torch.profiler``: device ms a call of each kernel (forward, Dv pass,
   dK/dV, run sum, dQ) and the tensor-core kernels' registers and shared
   memory from ``-Xptxas -v``.

Beside them it times ablations, builds of the default source with a part
of the work cut out (``ABLATIONS``; their results are wrong by design:
the checks of step 1 are printed for them, not required), to show what
bounds the dK/dV kernel: its copies alone, its products and softmax
alone (on whatever the ring holds), and dK/dV without the dK products;
and what the checks see of the split: one bf16 half-product for each
split product instead of three ("hi only": P and dS rounded to bf16),
and two ("hi mid": no lo term).

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
from chip_smoke import (FLASH_BITS_OFF, FLASH_SHAPE,  # noqa: E402
                        FLASH_TOL, device_time_us, median_device_ms,
                        nvidia_smi, ptxas_report)

# Builds: dK/dV run lengths (FLASH_TC_SPLIT_TILES).  "run 32" is the
# source as it stands.
BUILDS = {"run none": {"FLASH_TC_SPLIT_TILES": 1 << 20},
          "run 64": {"FLASH_TC_SPLIT_TILES": 64},
          "run 32": {},
          "run 16": {"FLASH_TC_SPLIT_TILES": 16},
          "run 8": {"FLASH_TC_SPLIT_TILES": 8}}
DEFAULT = "run 32"


def _wg(kernel: str, now: int, to: int) -> list[tuple[str, str]]:
    line = f"static constexpr int {kernel} = D <= 64 ? {{}} : D <= 128"
    return [(line.format(now), line.format(to))]


# Variants, checked as the builds are: a kernel's consumer warpgroups a
# block at D <= 64, as (text of the source, its replacement) pairs.
VARIANTS = {"fwd wg 1": _wg("WF", 3, 1), "fwd wg 2": _wg("WF", 3, 2),
            "dq wg 2": _wg("WQ", 1, 2), "dq wg 3": _wg("WQ", 1, 3),
            "dkdv wg 1": _wg("WK", 3, 1), "dkdv wg 2": _wg("WK", 3, 2)}
# Ablations, in the same form.
ABLATIONS = {
    "dkdv copies only": [("      if (active && t >= qtw0) {",
                          "      if (false) {")],
    "dkdv math only": [
        ("          cp_async16(qd + swz(row, c), q + at, ok);\n"
         "          cp_async16(dd + swz(row, c), dout + at, ok);",
         "          (void)at;"),
        ("          cp_async4(Ls + s * R + row, lse + at, ok);\n"
         "          cp_async4(Ds + s * R + row, dvec + at, ok);",
         "          (void)at;")],
    "hi only": [("      mma_rs(acc[nb], c[1], d);\n"
                 "      mma_rs(acc[nb], c[2], d);", "")],
    "hi mid": [("      mma_rs(acc[nb], c[2], d);", "")],
    "dkdv no dK": [("        split_mma<1>(dk, dpt, qa + cz * BLK);", "")],
}
ROUNDS = 3
TRACED = 10
KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dot_kernel",
           "flash_bwd_dkdv_tc_kernel", "flash_bwd_sum_kernel",
           "flash_bwd_dq_tc_kernel")


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
    texts = {k: "".join(f"#define {m} {n}\n" for m, n in d.items()) + source
             for k, d in BUILDS.items()}
    for k, edits in {**VARIANTS, **ABLATIONS}.items():
        texts[k] = source
        for old, new in edits:
            assert old in source, (k, old)
            texts[k] = texts[k].replace(old, new)
    libs = dict(zip(texts, _build.build(
        [(f"flash_attention_{k.replace(' ', '_')}", t)
         for k, t in texts.items()])))
    for k, lib in libs.items():
        rep = {e.split("flash_")[-1][:24]: (r.get("regs"), r["smem"])
               for e, r in ptxas_report(lib.ptxas_log).items()
               if "tc_kernelILi64E" in e}
        print(f"{k}: registers, static shared by kernel (D 64): {rep}")

    dev = torch.device("cuda")
    B, S, Hq, Hkv, D = FLASH_SHAPE
    G = Hq // Hkv
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    draw = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v, do = (draw(B, S, Hkv, G, D), draw(B, S, Hkv, D),
                   draw(B, S, Hkv, D), draw(B, S, Hkv, G, D))
    kw = dict(causal=True, q_block=512, kv_block=512)
    ro, rl = flash_fwd_ref(q, k, v, **kw)
    want = (ro, *flash_bwd_ref(do, q, k, v, ro, rl, **kw))
    fa.load(libs[DEFAULT])
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    as16 = lambda t: t.contiguous().view(torch.int16)
    errs, bits_off, failed = {}, {}, []
    print(f"o, dq, dk, dv against the plain version: max abs err / largest "
          f"value (bound {FLASH_TOL}), share of elements not bit-equal "
          f"(bound {FLASH_BITS_OFF}):")
    for name, lib in libs.items():
        fa.load(lib)
        got = (fa.flash_fwd_cuda(q, k, v, **kw)[0],
               *fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw))
        torch.cuda.synchronize()
        errs[name], bits_off[name] = [], []
        for g, w in zip(got, want):
            top = float(w.float().abs().max())
            errs[name].append(float((g.float() - w.float()).abs().max())
                              / top)
            bits_off[name].append(float((as16(g) != as16(w)).float().mean()))
        ok = (max(errs[name]) <= FLASH_TOL
              and max(bits_off[name]) <= FLASH_BITS_OFF)
        print(f"    {name:>19s}: "
              + ", ".join(f"{n} {e:.3e} / {b:.4%}" for n, e, b in zip(
                  ("o", "dq", "dk", "dv"), errs[name], bits_off[name]))
              + (": within" if ok else ": FAILS")
              + (" (ablation)" if name in ABLATIONS else ""))
        if not ok and name not in ABLATIONS:
            failed.append(name)
    if failed:
        print(f"builds failing the checks: {failed}", file=sys.stderr)
        return 1

    times = {name: {"fwd": [], "bwd": []} for name in libs}
    order = list(libs)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            fa.load(libs[name])
            times[name]["fwd"].append(median_device_ms(
                lambda: fa.flash_fwd_cuda(q, k, v, **kw)))
            times[name]["bwd"].append(median_device_ms(
                lambda: fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)))
    traced = {}
    for name, lib in libs.items():
        fa.load(lib)
        traced[name] = traced_ms(lambda: (
            fa.flash_fwd_cuda(q, k, v, **kw),
            fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)))
    print(f"B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, causal ({card}); "
          f"median ms of {ROUNDS} rounds [range]:")
    for name in libs:
        f, b = times[name]["fwd"], times[name]["bwd"]
        print(f"    {name:>19s}: forward {statistics.median(f):.3f} ms "
              f"[{min(f):.3f}, {max(f):.3f}], backward "
              f"{statistics.median(b):.3f} ms [{min(b):.3f}, {max(b):.3f}]; "
              f"traced kernels "
              + ", ".join(f"{k.removeprefix('flash_').removesuffix('_kernel')}"
                          f" {ms:.3f}" for k, ms in traced[name].items()))
    fa.load(libs[DEFAULT])
    print(json.dumps({"card": card, "shape": FLASH_SHAPE, "ms": times,
                      "traced_ms": traced, "err_of_largest": errs,
                      "bits_off": bits_off}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
