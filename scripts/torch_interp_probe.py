#!/usr/bin/env python3
"""Where the netlist interpreter's time goes, on one card.

Readings for the port's interpreter kernel
(``src/repro_torch/csrc/bitslice_mac.cu`` with the program loop of
``csrc/bitslice_interp.cuh``), at the MobileNets 14x14x512 stage's two
conv layers (3x3: P=196, C=4608, Mw=16; 1x1: C=512) in hobflops9:

1. **A run-time LUT3 by each method.**  A one-block microbenchmark times,
   with ``clock64()``, 2048 LUT3s whose truth tables are read from shared
   memory (one ahead, as the kernel reads its program): the kernel's
   branch-free mux tree of seven ``lop3`` over the table's masks
   (``bsi::lut_mux``), a warp-uniform 256-way ``switch`` of ``lop3``
   immediates (defined in the microbenchmark's source) and the 8-minterm
   loop (``bsi::lop3_c``) — a dependent chain (cycles a LUT3 of latency)
   and 8 independent chains (issue) — beside a fixed-immediate ``lop3``
   (``chip_smoke``'s ``lop3_readings``).
2. **Registers, spills and SASS.**  ``-Xptxas -v`` of the build and a
   census of the production kernel's SASS by ``cuobjdump -sass``.
3. **The kernel by cell library.**  The kernel running ``avx512``
   programs (LUT3 cells) against ``tpu_vpu`` ones (two-input cells,
   twice the gates), timed at both layers at batch 1 and checked against
   the default's planes.
4. **Where a MAC step's cycles go.**  The probe instantiation (built with
   ``BSM_PROBE``) stamps ``clock64()`` in each warp's lane 0 after each
   phase of its slots, once the phase's results are in registers, so the
   phases run one after another: program fetch, operand loads,
   evaluation, stores (the wait for the group's other lanes falls in the
   next fetch); and
   per chain step the ring waits and the input and output copies; for
   the producer warps the multiplier's phases, their waits, staging and
   product copies.  A serialised account: its sum is above the
   pipelined kernel's own cycles, which are printed beside it.
5. **Launch defaults.**  A sweep of chains a block (``p_block x
   m_block``: 8 chains, 8 lanes a pair, are one chain warp), ring slot
   channels (``c_block``), producer warps a chain warp and lanes a pair
   of chains at both layers, batch 1 and 4; ``_build.launch_blocks``'
   interpreter defaults and ``_build.INTERP_PRODUCERS`` cite it.

The last line is one JSON object with every reading.  The SM clock is
read with ``nvidia-smi`` after the timings.

Run from the repository root on a machine with a card:
``python3 scripts/torch_interp_probe.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (lop3_readings, nvidia_smi,  # noqa: E402
                        ptxas_report, time_cuda)
from torch_fused_probe import sass_census  # noqa: E402

METHODS = ("mux", "switch", "minterm")     # LUT_BENCH's method codes
LAYERS = (("3x3", 4608), ("1x1", 512))
HW, MW = 14, 16
REPS = 10
LUT_N = 2048

LUT_BENCH = r"""
#include "bitslice_interp.cuh"
enum { LUT_MUX = 0, LUT_SWITCH = 1, LUT_MINTERM = 2 };

// A warp-uniform 256-way switch of lop3 immediates.
__device__ __forceinline__ uint32_t lut_switch(uint32_t imm, uint32_t a,
                                               uint32_t b, uint32_t c) {
  switch (imm & 255u) {
#define BSI_C1(i) \
  case (i):       \
    return bsi::lop3<(i)>(a, b, c);
#define BSI_C4(i) BSI_C1(i) BSI_C1((i) + 1) BSI_C1((i) + 2) BSI_C1((i) + 3)
#define BSI_C16(i) BSI_C4(i) BSI_C4((i) + 4) BSI_C4((i) + 8) BSI_C4((i) + 12)
#define BSI_C64(i) \
  BSI_C16(i) BSI_C16((i) + 16) BSI_C16((i) + 32) BSI_C16((i) + 48)
    BSI_C64(0) BSI_C64(64) BSI_C64(128) BSI_C64(192)
  }
  return 0u;
}

template <int LUT, int ILP>
__global__ void lut_bench(const uint32_t* __restrict__ imms, uint32_t* out,
                          long long* cyc) {
  __shared__ uint32_t imm_s[%N% + 1];
  __shared__ uint4 masks[512];
  for (int i = threadIdx.x; i <= %N%; i += blockDim.x)
    imm_s[i] = imms[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    bsi::mask_row(masks, i);
  __syncthreads();
  uint32_t x[ILP];
  for (int j = 0; j < ILP; ++j) x[j] = threadIdx.x * 0x9E3779B9u + j;
  const uint32_t y = 0x12345678u ^ threadIdx.x, z = 0x0F0F0F0Fu + threadIdx.x;
  uint32_t imm = imm_s[0];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < %N%; ++i) {
    const uint32_t next = imm_s[i + 1];
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      if constexpr (LUT == LUT_MUX)
        x[j] = bsi::lut_mux(masks[imm], masks[256 + imm], y, z, x[j]);
      else if constexpr (LUT == LUT_SWITCH)
        x[j] = lut_switch(imm, y, z, x[j]);
      else
        x[j] = bsi::lop3_c(y, z, x[j], imm);
    }
    imm = next;
  }
  const long long t1 = clock64();
  uint32_t r = 0;
  for (int j = 0; j < ILP; ++j) r ^= x[j];
  out[threadIdx.x] = r;
  if ((threadIdx.x & 31) == 0) cyc[threadIdx.x / 32] = t1 - t0;
}
extern "C" int lut_bench_launch(const uint32_t* imms, uint32_t* out,
                                long long* cyc, int method, int ilp) {
#define BSI_L(M)                                                   \
  if (method == M) {                                               \
    if (ilp == 1) lut_bench<M, 1><<<1, 32>>>(imms, out, cyc);      \
    else lut_bench<M, 8><<<1, 32>>>(imms, out, cyc);               \
  }
  BSI_L(LUT_MUX) BSI_L(LUT_SWITCH) BSI_L(LUT_MINTERM)
#undef BSI_L
  return (int)cudaGetLastError();
}
""".replace("%N%", str(LUT_N))


def lut_readings(_build, lib) -> dict:
    """Cycles a run-time LUT3 by method: dependent (ILP 1) and issue (8
    independent chains), the truth tables random."""
    fn = _build.bind(lib.lib, "lut_bench_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
    rng = np.random.default_rng(5)
    imms = torch.as_tensor(rng.integers(0, 256, LUT_N + 1)
                           .astype(np.int32), device="cuda")
    out = torch.empty(32, dtype=torch.int32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    res = {}
    for code, name in enumerate(METHODS):
        for ilp in (1, 8):
            for _ in range(3):                      # warm, keep the last
                _build.check(fn(_build.ptr(imms), _build.ptr(out),
                                _build.ptr(cyc), code, ilp), "lut_bench")
                torch.cuda.synchronize()
            res[f"{name}_{'dependent' if ilp == 1 else 'ilp8'}"] = \
                cyc.item() / (LUT_N * ilp)
    return res


def operands(rng, fmt, P, C):
    i_masks = torch.as_tensor(
        -rng.integers(0, 2, (P, C, fmt.nbits)).astype(np.int32),
        device="cuda")
    w_planes = torch.as_tensor(
        rng.integers(-2**31, 2**31, (C, fmt.nbits, MW),
                     dtype=np.int64).astype(np.int32), device="cuda")
    return i_masks, w_planes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_interp_probe: no CUDA device available",
              file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch.core.fpformat import HOBFLOPS_FORMATS, RNE
    from repro_torch.kernels.bitslice_mac import kernel as interp

    card = nvidia_smi("name,power.limit")
    print(card)
    fmt = HOBFLOPS_FORMATS["hobflops9"]
    kern, bench = _build.build([interp.build_job("#define BSM_PROBE 1"),
                                ("lut_bench", LUT_BENCH)])
    result = {"card": card}

    lop3 = lop3_readings(_build)
    luts = lut_readings(_build, bench)
    result["lop3"], result["lut3"] = lop3, luts
    print(f"fixed-immediate lop3: dependent {lop3['dependent_1w']:.2f}, "
          f"issue {lop3['ilp8_1w']:.2f} cycles")
    for key, val in luts.items():
        print(f"run-time LUT3 {key}: {val:.2f} cycles")

    regs = {}
    for entry, rep in ptxas_report(kern.ptxas_log).items():
        if "bitslice_mac_kernel" in entry:
            regs[entry] = rep
            print(f"ptxas {entry}: {rep.get('regs')} registers, "
                  f"spill stores/loads {rep.get('spill_stores')}/"
                  f"{rep.get('spill_loads')} B")
    result["ptxas"] = regs
    sass = next(ops for n, ops in sass_census(kern.path).items()
                if "bitslice_mac_kernel" in n and "Lb0E" in n)
    result["sass"] = dict(sass)
    print(f"SASS (kernel): {sum(sass.values())} instructions, "
          f"{sass['LOP3']} LOP3, {sass['LDS']} LDS, {sass['STS']} STS, "
          f"{sass['BRX']} BRX; top {sass.most_common(8)}")

    rng = np.random.default_rng(args.seed)
    entry = interp.bind(kern)
    probe = interp.bind(kern, probe=True)
    blk = _build.launch_blocks(HW * HW, 4608, MW)
    k = blk["c_unroll"]
    progs = {lib: interp.device_programs(fmt, k, False, RNE, lib, "cuda")
             for lib in ("avx512", "tpu_vpu")}
    for lib, pr in progs.items():
        print(f"{lib} programs, k={k}: add {pr.add.n} gates in "
              f"{pr.add.groups} groups, {pr.add.nrows} rows; mul "
              f"{pr.mul.n} gates in {pr.mul.groups} groups, "
              f"{pr.mul.nrows} rows; {pr.program_bytes} B")
    result["programs"] = {lib: dict(add_gates=pr.add.n,
                                    add_groups=pr.add.groups,
                                    add_rows=pr.add.nrows,
                                    mul_gates=pr.mul.n,
                                    mul_groups=pr.mul.groups,
                                    mul_rows=pr.mul.nrows,
                                    bytes=pr.program_bytes)
                          for lib, pr in progs.items()}

    def run(fn, ops, pr, p_block, m_block, c_block, pw, out, cnt=None,
            gs=None):
        interp.launch(fn, *ops, out, pr, k, p_block, m_block, c_block, pw,
                      cnt, gs)

    layers = {}
    for batch in (1, 4):
        for name, C in LAYERS:
            layers[(name, batch)] = operands(rng, fmt, batch * HW * HW, C)
    nout = fmt.mult_out().nbits

    def new_out(ops):
        return torch.empty((nout, ops[0].shape[0], MW), dtype=torch.int32,
                           device="cuda")

    dflt = dict(p_block=blk["p_block"], m_block=blk["m_block"],
                c_block=blk["c_block"], pw=_build.INTERP_PRODUCERS)
    want = {}
    for key, ops in layers.items():
        want[key] = new_out(ops)
        run(entry, ops, progs["avx512"], **dflt, out=want[key])
    for name, C in LAYERS:      # the default build against its plain version
        ops = layers[(name, 1)]
        small = (ops[0][:, :64].contiguous(), ops[1][:64].contiguous())
        got = new_out(ops)
        run(entry, small, progs["avx512"], **dflt, out=got)
        ref = interp._bitslice_mac_torch(*small, fmt=fmt, extended=False,
                                         rounding=RNE, c_unroll=k)
        if not torch.equal(got, ref):
            print(f"{name}: kernel != plain version", file=sys.stderr)
            return 1

    # 3. the kernel by cell library, batch 1
    result["variants"] = []
    for lib in progs:
        row = {"lib": lib}
        for name, C in LAYERS:
            ops = layers[(name, 1)]
            out = new_out(ops)
            ms = time_cuda(lambda: run(entry, ops, progs[lib], **dflt,
                                       out=out), REPS)
            if not torch.equal(out, want[(name, 1)]):
                print(f"{lib} {name}: planes differ", file=sys.stderr)
                return 1
            row[name] = ms
        result["variants"].append(row)
        print(f"{lib:8s} programs: 3x3 {row['3x3']:.3f} ms, "
              f"1x1 {row['1x1']:.3f} ms")

    # 4. the probe's account, batch 1
    result["probe"] = []
    for name, C in LAYERS:
        ops = layers[(name, 1)]
        tp, tw, pw = dflt["p_block"], dflt["m_block"], dflt["pw"]
        grid = -(-(HW * HW) // tp) * -(-MW // tw)
        gs = interp.lanes_a_pair(tp, tw, pw)
        ncw = interp.block_threads(tp, tw, 0, gs) // 32
        nw = ncw * (1 + pw)
        cnt = torch.zeros(grid * nw * 8, dtype=torch.int64, device="cuda")
        out = new_out(ops)
        run(probe, ops, progs["avx512"], **dflt, out=out, cnt=cnt)
        torch.cuda.synchronize()
        if not torch.equal(out, want[(name, 1)]):
            print(f"probe {name}: planes differ", file=sys.stderr)
            return 1
        c = cnt.view(grid, nw, 8).double()
        ch, pd = c[:, :ncw].mean((0, 1)), c[:, ncw:].mean((0, 1))
        row = {"layer": name, "C": C,
               "chain_a_mac": {"fetch": ch[0] / C, "loads": ch[1] / C,
                               "eval": ch[2] / C, "stores": ch[3] / C,
                               "ring_wait": ch[4] / C, "copies": ch[5] / C},
               "producer_a_mac": {"fetch": pd[0] / C, "loads": pd[1] / C,
                                  "eval": pd[2] / C, "stores": pd[3] / C,
                                  "waits": pd[4] / C, "staging": pd[5] / C,
                                  "copies": pd[6] / C},
               "chain_steps": ch[7].item(), "producer_channels":
               pd[7].item() * pw}
        row = json.loads(json.dumps(row, default=float))
        row["chain_total_a_mac"] = sum(row["chain_a_mac"].values())
        row["producer_total_a_mac"] = sum(row["producer_a_mac"].values())
        result["probe"].append(row)
        print(f"probe {name}: chain warp a MAC step "
              f"{row['chain_total_a_mac']:.0f} cycles serialised "
              + ", ".join(f"{k_} {v:.0f}" for k_, v in
                          row["chain_a_mac"].items())
              + f"; producer warps a MAC {row['producer_total_a_mac']:.0f} "
              + ", ".join(f"{k_} {v:.0f}" for k_, v in
                          row["producer_a_mac"].items()))

    # 5. launch defaults
    result["sweep"] = []
    configs = [dict(p_block=p, m_block=m, c_block=c, pw=pw, gs=gs)
               for p, m in ((1, 8), (1, 16), (2, 16))
               for c in (4, 8) for pw in (1, 2) for gs in (8,)]
    configs += [dict(p_block=p, m_block=m, c_block=8, pw=1, gs=gs)
                for p, m in ((1, 16), (2, 16), (4, 16)) for gs in (4, 2)]
    for cfg in configs:
        row = dict(cfg)
        for (name, batch), ops in layers.items():
            out = new_out(ops)
            try:
                ms = time_cuda(lambda: run(entry, ops,
                                           progs["avx512"], **cfg, out=out),
                               REPS)
            except ValueError as e:     # does not fit a block
                print(f"sweep {cfg}: {e}")
                row = None
                break
            if not torch.equal(out, want[(name, batch)]):
                print(f"sweep {cfg} {name} b{batch}: planes differ",
                      file=sys.stderr)
                return 1
            row[f"{name}_b{batch}"] = ms
        if row is None:
            continue
        row["stack_b1"] = row["3x3_b1"] + 2 * row["1x1_b1"]
        row["stack_b4"] = row["3x3_b4"] + 2 * row["1x1_b4"]
        result["sweep"].append(row)
        print(f"sweep p_block {cfg['p_block']} m_block {cfg['m_block']} "
              f"c_block {cfg['c_block']} producers {cfg['pw']} lanes a pair "
              f"{cfg['gs']}: 3x3 b1 {row['3x3_b1']:.3f} b4 "
              f"{row['3x3_b4']:.3f}; 1x1 b1 {row['1x1_b1']:.3f} b4 "
              f"{row['1x1_b4']:.3f}; stack b1 {row['stack_b1']:.3f} b4 "
              f"{row['stack_b4']:.3f} ms")
    clock = float(nvidia_smi("clocks.sm").split()[0])
    result["clock_mhz"] = clock
    for v in result["variants"]:
        v["cycles_a_mac_3x3"] = v["3x3"] * clock * 1e3 / 4608
    print(f"clocks.sm after the timings: {clock:.0f} MHz; default kernel "
          f"{result['variants'][0]['cycles_a_mac_3x3']:.0f} cycles a MAC "
          f"step at 3x3")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
