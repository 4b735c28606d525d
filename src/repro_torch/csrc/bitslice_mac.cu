// Bitslice-parallel HOBFLOPS MAC (GEMM form) as a netlist interpreter.
//
// Replaces the TPU kernel bitslice_mac_pallas
// (src/repro/kernels/bitslice_mac/kernel.py, body _mac_kernel).
//
// What it computes: out[NOUT, P, Mw] int32 bit planes of
//   O[p, 32*w + j] = fold_c add(mul(I[p, c], W[c, 32*w + j]), acc),  acc0 = +0
// folding the C input channels in channel order, k channels a chain
// step.  i_masks [P, C, NIN] holds each IFM bit broadcast to a 0/-1 word;
// w_planes [C, NIN, Mw] holds the weights bitsliced along M.
//
// The netlists arrive as programs (repro_torch/kernels/bitslice_mac/
// program.py; format, evaluators and the program loop in
// bitslice_interp.cuh): the multiplier (build_mul_step) and the k-step
// add-only chain (build_add_chain), the netlists of fused_mac.cuh, split
// as fused_mac splits them and so bit-exact to the MAC chain.  One build
// runs every format, chain depth, rounding and cell library, and no
// program is capped but by shared memory, which the wrapper checks.
//
// What bounds it on the H100: each (row, lane word) accumulator folds its
// C channels in order, so a batch-1 layer has only P x Mw chains (3136
// at 14x14x512), and an interpreted gate is a chain of dependent
// shared-memory accesses: operand loads, a run-time LUT3, a store the
// next gate may load.  One lane a lane word, interpreting gate after
// gate, is bound by one warp's issue (scripts/torch_interp_probe.py).
// The design puts many gates of a chain in flight at once and keeps each
// short:
//
// * Lanes across gates: the netlist is levelized into groups of up to 8
//   gates that neither read what the group writes nor write what it
//   reads; each pair of adjacent lane words gets GS lanes (8 unless the
//   block's chains need fewer), lane s running slots s, s + GS, ... of
//   every group on both words with 64-bit loads and stores (one decode
//   and one mask-table read for two words), so a warp covers 64 / GS
//   lane words and syncs once a group.
// * Both programs staged once a block into shared memory by cp.async,
//   8 bytes a gate, each lane reading its next slot while it runs this
//   one.
// * The run-time LUT3: seven lop3 muxes over the truth table's masks,
//   read from a 256-row table in shared memory (the cheapest of the
//   methods scripts/torch_interp_probe.py times).
// * Multiply ahead, as fused_mac does: producer warps stage C tiles of
//   weight and IFM-mask words with cp.async (zero past C, P and Mw: +0,
//   the MAC identity) and interpret the multiplier into a ring of product
//   planes under mbarriers; the chain warps interpret the add-only chain.
//
// Shared memory: the barriers, the programs, the mask table, two raw C
// tiles, the product ring, a file of rows for each chain warp and each
// producer warp.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "bitslice_interp.cuh"
#include "fused_mac.cuh"   // hf:: mbarriers, cp.async, the producer barrier

namespace {

constexpr int S = hf::STAGES;        // ring slots of products
constexpr int MAX_THREADS = 1024;    // __launch_bounds__: 64 registers
constexpr int PROBE_WORDS = 8;       // probe counters a warp

// Byte offsets of the parts of a block's shared memory (mirrored by
// repro_torch/kernels/bitslice_mac/kernel.py::smem_bytes).  A block's
// chains (lane words) are padded to whole chain warps: nch of them.
struct Layout {
  size_t blob, masks, raw, ring, cfile, pfile, total;
};

__host__ __device__ inline int padded_chains(int tp, int tw, int gs) {
  const int wd = 64 / gs;
  return (tp * tw + wd - 1) / wd * wd;
}

__host__ __device__ inline Layout layout(int blob_words, int add_rows,
                                         int mul_rows, int nin, int nout,
                                         int tp, int tw, int ct, int pw,
                                         int gs) {
  const size_t nch = padded_chains(tp, tw, gs);
  Layout L;
  size_t o = 16 * S;                                  // full[S], empty[S]
  L.blob = o;  o += 4 * (size_t)blob_words;           // a multiple of 16
  L.masks = o; o += 256 * 8 * 4;
  L.raw = o;   o += 4 * 2 * (size_t)(tw + tp) * (ct * nin + 1);
  L.ring = o;  o += 4 * S * (size_t)ct * nout * nch;
  L.cfile = o; o += 4 * (size_t)add_rows * nch;
  L.pfile = o; o += 4 * (size_t)pw * mul_rows * nch;
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   hf::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Copy C tile t (channels t*ct ...) into a raw slot, as fused_mac.cuh's
// hf::stage_tile does for a compile-time NIN: row tx < tw holds lane word
// w0 + tx of the channels' weight planes, row tw + ty the masks of IFM row
// p0 + ty, column c*nin + b; zero past C, P and Mw.
__device__ __forceinline__ void stage_tile(
    uint32_t* raw, const int32_t* __restrict__ i_masks,
    const int32_t* __restrict__ w_planes, int nin, int t, int ct, int pitch,
    int P, int C, int Mw, int p0, int w0, int tp, int tw, int i, int n) {
  const int W = ct * nin, c0n = t * ct * nin, Cn = C * nin;
  {  // weights: element e -> (column e / tw, row e % tw)
    int r = i / tw, q = i % tw;
    const int dr = n / tw, dq = n % tw;
    for (; r < W; r += dr, q += dq) {
      if (q >= tw) { q -= tw; ++r; if (r >= W) break; }
      const bool ok = c0n + r < Cn && w0 + q < Mw;
      hf::cp_async4(raw + q * pitch + r,
                    ok ? w_planes + (size_t)(c0n + r) * Mw + w0 + q
                       : w_planes,
                    ok);
    }
  }
  {  // masks: element e -> (row e / W, column e % W)
    int q = i / W, r = i % W;
    const int dq = n / W, dr = n % W;
    for (; q < tp; q += dq, r += dr) {
      if (r >= W) { r -= W; ++q; if (q >= tp) break; }
      const bool ok = p0 + q < P && c0n + r < Cn;
      hf::cp_async4(raw + (tw + q) * pitch + r,
                    ok ? i_masks + (size_t)(p0 + q) * Cn + c0n + r
                       : i_masks,
                    ok);
    }
  }
}

// The probe instantiation's counters (scripts/torch_interp_probe.py):
// clock64() after each phase of a group, once that phase's results are
// in registers (the clock read is predicated on a test of them).
struct ClockProbe {
  static constexpr bool SERIAL = true;
  long long t = 0;
  unsigned long long acc[PROBE_WORDS] = {};
  __device__ __forceinline__ static long long clock_after(uint32_t dep) {
    long long now;
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.u32 p, %1, 0x5a5a5a5a;\n"
        "@p mov.u64 %0, %%clock64;\n"
        "@!p mov.u64 %0, 0;\n}\n"
        : "=l"(now)
        : "r"(dep)
        : "memory");
    return now;
  }
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void mark(int phase, uint32_t dep) {
    const long long now = clock_after(dep);
    acc[phase] += (unsigned long long)(now - t);
    t = now;
  }
};

struct Args {
  const int32_t* i_masks;
  const int32_t* w_planes;
  int32_t* out;
  const int32_t* blob;                  // programs and output rows
  int blob_words, add_groups, add_rows, mul_off, mul_groups, mul_rows,
      aout_off, mout_off;
  int nin, nout, k, P, C, Mw, tp, tw, ct, pw;
  unsigned long long* probe;            // PROBE_WORDS a warp
};

// Run a program's groups: this lane's slots of each (the next group's
// read while this one runs), the warp synced after every group.
template <int GS, class Probe>
__device__ __forceinline__ void run_program(const uint2* __restrict__ prog,
                                            int groups, int slot,
                                            uint32_t* __restrict__ f,
                                            const uint4* __restrict__ masks,
                                            Probe& pr) {
  constexpr int G = bsi::GROUP_MAX, N = G / GS, WD = 64 / GS;
  uint2 w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = prog[slot + j * GS];
  for (int g = 0; g < groups; ++g) {
    uint2 next[N];
#pragma unroll
    for (int j = 0; j < N; ++j) next[j] = prog[(g + 1) * G + slot + j * GS];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (Probe::SERIAL) pr.mark(bsi::PH_FETCH, w[j].x ^ w[j].y);
      bsi::run_gate<WD>(w[j], f, masks, pr);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < N; ++j) w[j] = next[j];
  }
}

// Chain warps: counters 0-3 the program's phases, 4 ring waits, 5 the
// step's input and output copies, 7 chain steps.  Producer warps: 0-3 the
// multiplier's phases, 4 waits (tile landed, barrier, empty slot), 5
// staging issue, 6 product copies, 7 channels.  Each warp's lane 0.
template <bool PROBE, int GS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    bitslice_mac_kernel(const Args A) {
  using Probe = typename std::conditional<PROBE, ClockProbe,
                                          bsi::NoProbe>::type;
  constexpr int WD = 64 / GS;                // lane words a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(A.blob_words, A.add_rows, A.mul_rows, A.nin,
                          A.nout, A.tp, A.tw, A.ct, A.pw, GS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  const uint32_t* blob = reinterpret_cast<const uint32_t*>(smem + L.blob);
  uint4* masks = reinterpret_cast<uint4*>(smem + L.masks);
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + L.raw);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + L.ring);
  const int nin = A.nin, nout = A.nout, k = A.k, C = A.C, ct = A.ct;
  const int tp = A.tp, tw = A.tw;
  const int nch = padded_chains(tp, tw, GS); // chains, whole warps
  const int nl = nch / WD * 32, np = A.pw * nl;   // chain, producer
  const int nthr = nl + np;
  const int tid = threadIdx.x, lane = tid & 31;
  // Lanes slot-major: lane s * (32 / GS) + q runs slot s of word pair q,
  // so a half-warp's 64-bit loads read whole rows, four rows at GS = 8.
  const int slot = lane / (32 / GS);         // this lane's first slot
  const int w0 = blockIdx.x * tw, p0 = blockIdx.y * tp;
  const int T = (C + ct - 1) / ct;
  const int pitch = ct * nin + 1;            // raw row, padded a word
  const int raw_words = (tw + tp) * pitch;

  // Stage both programs, build the mask table, clear this word's file.
  for (int i = tid; i < A.blob_words / 4; i += nthr)
    cp_async16(smem + L.blob + 16 * i, A.blob + 4 * i);
  hf::cp_async_commit();
  for (int i = tid; i < 256; i += nthr)
    bsi::mask_row(masks, i);
  const bool chain = tid < nl;
  // This lane's chains (two adjacent lane words of the block) and its
  // file: warp wi of the chain warps, or of one producer group, serves
  // chains wi*WD ...
  const int wi = (chain ? tid : (tid - nl) % nl) / 32;
  const int ch = wi * WD + 2 * (lane % (32 / GS));
  uint32_t* f = chain
      ? reinterpret_cast<uint32_t*>(smem + L.cfile) + wi * A.add_rows * WD +
            2 * (lane % (32 / GS))
      : reinterpret_cast<uint32_t*>(smem + L.pfile) +
            ((tid - nl) / 32) * A.mul_rows * WD + 2 * (lane % (32 / GS));
  auto row = [&](int r) { return reinterpret_cast<uint2*>(f + r * WD); };
  if (slot == 0) {
    *row(bsi::ZERO_ROW) = make_uint2(0u, 0u);
    *row(bsi::ONES_ROW) = make_uint2(~0u, ~0u);
  }
  if (chain)   // the accumulator rows: +0
    for (int b = slot; b < nout; b += GS)
      *row(bsi::FIRST_INPUT_ROW + b) = make_uint2(0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hf::mbar_init(&full[s], np);
      hf::mbar_init(&empty[s], nl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  hf::cp_async_wait<0>();
  __syncthreads();

  // Padded chains run chain 0.
  const int cl0 = ch < tp * tw ? ch : 0, cl1 = ch + 1 < tp * tw ? ch + 1 : 0;
  const int ty0 = cl0 / tw, tx0 = cl0 % tw, ty1 = cl1 / tw, tx1 = cl1 % tw;
  Probe pr;
  unsigned long long extra[3] = {0, 0, 0};   // probe: waits, copies, stage
  long long steps = 0;
  if constexpr (PROBE) pr.start();

  if (chain) {
    // ---- chain warps: fold the C channels in order, k a step ---------
    const uint2* prog = reinterpret_cast<const uint2*>(blob);
    const uint32_t* aout = blob + A.aout_off;
    const int in_row = bsi::FIRST_INPUT_ROW + nout;   // p0 bit 0
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      long long c0 = 0;
      if constexpr (PROBE) c0 = clock64();
      hf::mbar_wait(&full[s], (t / S) & 1);
      if constexpr (PROBE) extra[0] += clock64() - c0;
      const int cend = min(ct, (C - t * ct + k - 1) / k * k);
      // ring slot s: [channel][bit][chain]
      const uint32_t* rs = ring + (size_t)s * ct * nout * nch + ch;
      for (int cc = 0; cc < cend; cc += k) {
        if constexpr (PROBE) c0 = clock64();
        const uint32_t* src = rs + (size_t)cc * nout * nch;
        for (int i = slot; i < k * nout; i += GS)
          *row(in_row + i) = *reinterpret_cast<const uint2*>(src + i * nch);
        __syncwarp();
        if constexpr (PROBE) {
          extra[1] += ClockProbe::clock_after(f[in_row * WD]) - c0;
          pr.start();
        }
        run_program<GS>(prog, A.add_groups, slot, f, masks, pr);
        if constexpr (PROBE) c0 = clock64();
        for (int b = slot; b < nout; b += GS)
          *row(bsi::FIRST_INPUT_ROW + b) = *row(aout[b]);
        __syncwarp();
        if constexpr (PROBE) {
          extra[1] += ClockProbe::clock_after(f[bsi::FIRST_INPUT_ROW * WD]) -
                      c0;
          ++steps;
        }
      }
      hf::mbar_arrive(&empty[s]);
    }
    for (int e = 0; e < 2; ++e) {
      const int p = p0 + (e ? ty1 : ty0), w = w0 + (e ? tx1 : tx0);
      if (ch + e < tp * tw && p < A.P && w < A.Mw) {
        for (int b = slot; b < nout; b += GS)
          A.out[((size_t)b * A.P + p) * A.Mw + w] =
              (int32_t)f[(bsi::FIRST_INPUT_ROW + b) * WD + e];
      }
    }
  } else {
    // ---- producer warps: stage C tiles and multiply ahead ------------
    const int i = tid - nl;
    const int g = i / nl;                  // channel group
    const uint2* prog = reinterpret_cast<const uint2*>(blob + A.mul_off);
    const uint32_t* mout = blob + A.mout_off;
    const int y_row = bsi::FIRST_INPUT_ROW + nin;
    stage_tile(raw, A.i_masks, A.w_planes, nin, 0, ct, pitch, A.P, C, A.Mw,
               p0, w0, tp, tw, i, np);
    hf::cp_async_commit();
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      const uint32_t* rs = raw + (t & 1) * raw_words;
      long long c0 = 0;
      if constexpr (PROBE) c0 = clock64();
      if (t + 1 < T)
        stage_tile(raw + ((t + 1) & 1) * raw_words, A.i_masks, A.w_planes,
                   nin, t + 1, ct, pitch, A.P, C, A.Mw, p0, w0, tp, tw, i,
                   np);
      hf::cp_async_commit();
      if constexpr (PROBE) {
        extra[2] += clock64() - c0;
        c0 = clock64();
      }
      hf::cp_async_wait<1>();     // tile t landed (this thread's part)
      hf::producer_sync(np);      // ... and every producer's
      hf::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
      if constexpr (PROBE) extra[0] += clock64() - c0;
      // Products of every channel the chain reads: up to the tile's end
      // rounded up to the chain depth (zero words past C).
      const int cend = min(ct, (C - t * ct + k - 1) / k * k);
      const uint32_t* xw0 = rs + tx0 * pitch;
      const uint32_t* xw1 = rs + tx1 * pitch;
      const uint32_t* yi0 = rs + (tw + ty0) * pitch;
      const uint32_t* yi1 = rs + (tw + ty1) * pitch;
      uint32_t* pp = ring + (size_t)s * ct * nout * nch + ch;
      for (int c = g; c < cend; c += A.pw) {
        for (int b = slot; b < nin; b += GS) {
          const int e = c * nin + b;
          *row(bsi::FIRST_INPUT_ROW + b) = make_uint2(xw0[e], xw1[e]);
          *row(y_row + b) = make_uint2(yi0[e], yi1[e]);
        }
        __syncwarp();
        if constexpr (PROBE) pr.start();
        run_program<GS>(prog, A.mul_groups, slot, f, masks, pr);
        if constexpr (PROBE) c0 = clock64();
        for (int b = slot; b < nout; b += GS)
          *reinterpret_cast<uint2*>(pp + ((size_t)c * nout + b) * nch) =
              *row(mout[b]);
        if constexpr (PROBE) {
          extra[1] += clock64() - c0;
          ++steps;
        }
      }
      hf::mbar_arrive(&full[s]);
      hf::producer_sync(np);      // every producer is done with rs
    }
  }
  if constexpr (PROBE) {
    if (lane == 0) {
      const int nw = nthr / 32;
      unsigned long long* o =
          A.probe + ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * nw +
                     tid / 32) * PROBE_WORDS;
      for (int j = 0; j < 4; ++j) o[j] = pr.acc[j];
      o[4] = extra[0];
      o[5] = chain ? extra[1] : extra[2];
      o[6] = chain ? 0ull : extra[1];
      o[7] = (unsigned long long)steps;
    }
  }
}

template <bool PROBE, int GS>
int launch_gs(const Args& a, void* stream) {
  const Layout L = layout(a.blob_words, a.add_rows, a.mul_rows, a.nin,
                          a.nout, a.tp, a.tw, a.ct, a.pw, GS);
  cudaError_t err = cudaFuncSetAttribute(
      bitslice_mac_kernel<PROBE, GS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int threads =
      (1 + a.pw) * padded_chains(a.tp, a.tw, GS) / (64 / GS) * 32;
  const dim3 grid((a.Mw + a.tw - 1) / a.tw, (a.P + a.tp - 1) / a.tp);
  bitslice_mac_kernel<PROBE, GS>
      <<<grid, threads, L.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// gs: lanes a chain, 1, 2, 4 or 8 (the wrapper picks it).
template <bool PROBE>
int launch(const Args& a, int gs, void* stream) {
  switch (gs) {
    case 8: return launch_gs<PROBE, 8>(a, stream);
    case 4: return launch_gs<PROBE, 4>(a, stream);
    case 2: return launch_gs<PROBE, 2>(a, stream);
    case 1: return launch_gs<PROBE, 1>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const int32_t* i_masks, const int32_t* w_planes,
               int32_t* out, const int32_t* blob, const int32_t* meta,
               int nin, int nout, int k, int P, int C, int Mw, int tp, int tw,
               int ct, int pw, unsigned long long* probe) {
  // meta: blob_words, add_groups, add_rows, mul_off, mul_groups,
  // mul_rows, aout_off, mout_off (repro_torch/kernels/bitslice_mac/
  // kernel.py).
  return Args{i_masks, w_planes, out,     blob,    meta[0], meta[1],
              meta[2], meta[3],  meta[4], meta[5], meta[6], meta[7],
              nin,     nout,     k,       P,       C,       Mw,
              tp,      tw,       ct,      pw,      probe};
}

}  // namespace

extern "C" size_t bitslice_mac_smem_bytes(const int32_t* meta, int nin,
                                          int nout, int tp, int tw, int ct,
                                          int pw, int gs) {
  return layout(meta[0], meta[2], meta[5], nin, nout, tp, tw, ct, pw, gs)
      .total;
}

// meta is a host array of the 8 program counts and offsets; blob is the
// programs on the card.
extern "C" int bitslice_mac_launch(const int32_t* i_masks,
                                   const int32_t* w_planes, int32_t* out,
                                   const int32_t* blob, const int32_t* meta,
                                   int nin, int nout, int k, int P, int C,
                                   int Mw, int tp, int tw, int ct, int pw,
                                   int gs, void* stream) {
  return launch<false>(
      make_args(i_masks, w_planes, out, blob, meta, nin, nout, k, P, C, Mw,
                tp, tw, ct, pw, nullptr),
      gs, stream);
}

#ifdef BSM_PROBE
// The measurement-only entry (built by scripts/torch_interp_probe.py):
// probe holds PROBE_WORDS counters a warp.
extern "C" int bitslice_mac_probe(const int32_t* i_masks,
                                  const int32_t* w_planes, int32_t* out,
                                  const int32_t* blob, const int32_t* meta,
                                  int nin, int nout, int k, int P, int C,
                                  int Mw, int tp, int tw, int ct, int pw,
                                  int gs, void* stream,
                                  unsigned long long* probe) {
  return launch<true>(
      make_args(i_masks, w_planes, out, blob, meta, nin, nout, k, P, C, Mw,
                tp, tw, ct, pw, probe),
      gs, stream);
}
#endif
