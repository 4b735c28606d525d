// The netlist interpreter's program format, gate evaluators and program
// loop, shared by the CUDA kernel (bitslice_mac.cu) and by host C++.
//
// Plain C++ over uint32_t: nvcc builds it into the kernel, and the CPU
// tests build it with g++ and run it against eval_netlist (the inline PTX
// below has a C twin for the host).  The encoder is
// repro_torch/kernels/bitslice_mac/program.py, which documents the format
// and the schedule; the two must agree on every constant here.
//
// A program runs over a file of rows, one 32-bit lane word a row for
// each of the WD lane words of a warp (row r of word q at r * WD + q),
// each lane running two adjacent words:
// row 0 holds 0, row 1 all ones, rows 2.. the program's input buses,
// then temporaries.  Every gate is a LUT3 over three rows,
// written to a fourth, 8 bytes:
//   x = a | b << 12 | imm << 24      (imm: PTX lop3.b32 truth table)
//   y = c | d << 12 | 1 << 24        (an empty slot is all zero)
// Gates come in groups of GROUP_MAX slots that read nothing written in
// their own group and write nothing the group reads, so a group's slots
// run in any order: the kernel gives each pair of lane words GS lanes
// (GS divides GROUP_MAX, WD = 64 / GS), lane s of a pair runs slots s,
// s + GS, ... of every group on both words, and the warp syncs once a
// group.

#pragma once
#include <cstdint>

#ifdef __CUDACC__
#define BSI_FN __host__ __device__ __forceinline__
#define BSI_UNROLL _Pragma("unroll")
#else
#define BSI_FN inline
#define BSI_UNROLL
#if !defined(BSI_NO_VECTOR_TYPES)
struct alignas(8) uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
#endif
#endif

namespace bsi {

constexpr int ROW_BITS = 12;
constexpr uint32_t ROW_MASK = (1u << ROW_BITS) - 1u;
constexpr int GROUP_MAX = 8;   // slots a group: lanes a word pair at most
constexpr int ZERO_ROW = 0, ONES_ROW = 1, FIRST_INPUT_ROW = 2;

// lop3.b32 semantics in C: bit i of imm is the output for the inputs
// a, b, c with (a << 2) | (b << 1) | c == i (the host twin of lop3).
BSI_FN uint32_t lop3_c(uint32_t a, uint32_t b, uint32_t c, uint32_t imm) {
  uint32_t r = 0u;
  BSI_UNROLL
  for (int i = 0; i < 8; ++i)
    if ((imm >> i) & 1u)
      r |= ((i & 4) ? a : ~a) & ((i & 2) ? b : ~b) & ((i & 1) ? c : ~c);
  return r;
}

template <int IMM>
BSI_FN uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(IMM));
  return d;
#else
  return lop3_c(a, b, c, IMM);
#endif
}

// s ? x : y, one lop3.
BSI_FN uint32_t sel(uint32_t s, uint32_t x, uint32_t y) {
  return lop3<0xCA>(s, x, y);
}

// The mask-table row of imm: word i is all ones where bit i of imm is
// set.  lo holds words 0-3, hi words 4-7.
BSI_FN void lut_masks(uint32_t imm, uint4& lo, uint4& hi) {
  lo.x = 0u - (imm & 1u);
  lo.y = 0u - ((imm >> 1) & 1u);
  lo.z = 0u - ((imm >> 2) & 1u);
  lo.w = 0u - ((imm >> 3) & 1u);
  hi.x = 0u - ((imm >> 4) & 1u);
  hi.y = 0u - ((imm >> 5) & 1u);
  hi.z = 0u - ((imm >> 6) & 1u);
  hi.w = 0u - ((imm >> 7) & 1u);
}

// Row imm of the mask table: its words 0-3 at masks[imm], 4-7 at
// masks[256 + imm], so the 16-byte halves of different truth tables
// spread over all eight 16-byte bank groups.
BSI_FN void mask_row(uint4* masks, uint32_t imm) {
  lut_masks(imm, masks[imm], masks[256 + imm]);
}

// The kernel's run-time LUT3, branch-free: seven lop3 muxes over the
// eight truth-table masks, c selecting first, so only three of them wait
// on the last operand (scripts/torch_interp_probe.py times it against a
// 256-way switch of lop3 immediates and the 8-minterm loop of lop3_c).
BSI_FN uint32_t lut_mux(const uint4& lo, const uint4& hi, uint32_t a,
                        uint32_t b, uint32_t c) {
  const uint32_t u0 = sel(c, lo.y, lo.x), u1 = sel(c, lo.w, lo.z);
  const uint32_t u2 = sel(c, hi.y, hi.x), u3 = sel(c, hi.w, hi.z);
  return sel(a, sel(b, u3, u2), sel(b, u1, u0));
}

// Fields of one gate.
BSI_FN uint32_t row_a(uint2 w) { return w.x & ROW_MASK; }
BSI_FN uint32_t row_b(uint2 w) { return (w.x >> ROW_BITS) & ROW_MASK; }
BSI_FN uint32_t imm_of(uint2 w) { return w.x >> 24; }
BSI_FN uint32_t row_c(uint2 w) { return w.y & ROW_MASK; }
BSI_FN uint32_t row_d(uint2 w) { return (w.y >> ROW_BITS) & ROW_MASK; }
BSI_FN bool valid(uint2 w) { return (w.y >> 24) != 0u; }

// Probe hooks: NoProbe compiles to nothing.  A probe with SERIAL set is
// told, after each phase of a gate, a word that depends on all the
// phase's results, so the phases run one after another.
enum { PH_FETCH = 0, PH_LOADS = 1, PH_EVAL = 2, PH_STORES = 3 };
struct NoProbe {
  static constexpr bool SERIAL = false;
  BSI_FN void mark(int, uint32_t) {}
};

// One slot of a group for a lane's two lane words: the gate w over the
// file (f: the lane's two words of row 0, row r at f + r * WD), `masks`
// the mask table (mask_row).  An empty slot does nothing.
template <int WD, class Probe>
BSI_FN void run_gate(uint2 w, uint32_t* __restrict__ f,
                     const uint4* __restrict__ masks, Probe& pr) {
  if (!valid(w)) return;
  const uint2 a = *reinterpret_cast<const uint2*>(f + row_a(w) * WD);
  const uint2 b = *reinterpret_cast<const uint2*>(f + row_b(w) * WD);
  const uint2 c = *reinterpret_cast<const uint2*>(f + row_c(w) * WD);
  if constexpr (Probe::SERIAL) pr.mark(PH_LOADS, a.x ^ b.x ^ c.x ^ a.y ^
                                                     b.y ^ c.y);
  const uint32_t imm = imm_of(w);
  const uint4 lo = masks[imm], hi = masks[256 + imm];
  uint2 v;
  v.x = lut_mux(lo, hi, a.x, b.x, c.x);
  v.y = lut_mux(lo, hi, a.y, b.y, c.y);
  if constexpr (Probe::SERIAL) pr.mark(PH_EVAL, v.x ^ v.y);
  *reinterpret_cast<uint2*>(f + row_d(w) * WD) = v;
  if constexpr (Probe::SERIAL) pr.mark(PH_STORES, 0u);
}

}  // namespace bsi
