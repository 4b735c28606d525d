// Fused bitslice-parallel HOBFLOPS MAC: the MAC chain netlist as
// generated straight-line code, one kernel launch per conv layer.
//
// Replaces the TPU kernel fused_mac_pallas
// (src/repro/core/pallas_backend/kernel.py, body _fused_mac_kernel).
//
// Same contract as bitslice_mac.cu: i_masks [P, C, NIN] in {0, -1},
// w_planes [C, NIN, Mw] -> out [NOUT, P, Mw], the C channels folded in
// channel order from a +0 accumulator, plus the optional ReLU epilogue
// acc & ~acc[SIGN_OFF] once the reduction is complete.
//
// Bodies are emitted by repro_torch/core/fused_backend/emitter.py as
// structs with a static run(...): every register-file slot a local
// uint32_t, every gate one HF_LOP3 (one lop3.b32 with the gate's truth
// table), the accumulator a local array indexed by constants, so a chain
// step lives in registers.
//
// What bounds it on the H100: each (row, lane word) accumulator folds
// its C channels in order, so a batch-1 layer has only P x Mw chains
// (3136 at 14x14x512: 98 warps) and each chain is one warp's serial
// run of LOP3s.  One warp issues a LOP3 every 2 cycles (16 lanes of
// logic a scheduler) and waits 4.2 cycles on a dependent one
// (scripts/torch_fused_probe.py), so a step costs at least its LOP3s x 2
// cycles on the warp's scheduler, well above the accumulator path's
// depth x 4.2 cycles.  The design takes everything else off that
// scheduler:
//
// * Warp specialisation.  A block holds ceil(tp * tw / 32) chain warps
//   (one thread a (row, lane word) chain) and pw times as many producer
//   warps (one producer warp stages too slowly to keep a chain warp fed:
//   its 4-byte cp.asyncs wait on memory).
//   The chain warps never wait on a global load or on __syncthreads:
//   they wait on "full" mbarriers of a ring of C tiles and release
//   them on "empty" ones.
// * Asynchronous staging.  Producer threads copy each C tile's weight
//   and IFM mask words with cp.async (zero-filled past C, P and Mw, the
//   MAC identity) into a ring slot, transposed to one odd-pitch row a
//   lane word / IFM row so every warp read is conflict-free; the index
//   walk is hoisted (no runtime division per element).
// * Multiply ahead.  The product of channel c does not depend on the
//   accumulator: producer threads run the multiplier netlist on the
//   staged tile into product planes, a second ring (producer group g of
//   pw takes channels g, g + pw, ...), and the chain warps run the
//   add-only chain (repro_torch/core/fused_backend/netlists.py,
//   bit-exact to the MAC chain), a quarter fewer LOP3s a step than the
//   whole MAC chain.
// * One chain warp a block by default (_build.launch_blocks), so a
//   batch-1 layer spreads over 98 SMs instead of 49.

#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define HF_INLINE __device__ __forceinline__

template <int IMM>
HF_INLINE uint32_t hf_lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(IMM));
  return d;
}
#define HF_LOP3(a, b, c, imm) hf_lop3<(imm)>((a), (b), (c))

namespace hf {

constexpr int STAGES = 3;          // ring slots of C tiles

HF_INLINE uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

HF_INLINE void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

HF_INLINE void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

HF_INLINE void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

HF_INLINE void cp_async4(uint32_t* dst, const int32_t* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

HF_INLINE void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
HF_INLINE void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Barrier 1 over the producer threads alone.
HF_INLINE void producer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// Copy C tile t (channels t*ct ...) into a raw slot: row tx < tw holds
// lane word w0 + tx of channels' weight planes, row tw + ty the masks of
// IFM row p0 + ty, column c*NIN + b; zero past C, P and Mw.  Thread i of
// n walks the elements i, i + n, ... with its (row, column) advanced by
// precomputed steps.
template <int NIN>
HF_INLINE void stage_tile(uint32_t* raw, const int32_t* __restrict__ i_masks,
                          const int32_t* __restrict__ w_planes, int t,
                          int ct, int pitch, int P, int C, int Mw, int p0,
                          int w0, int tp, int tw, int i, int n) {
  const int W = ct * NIN, c0n = t * ct * NIN, Cn = C * NIN;
  {  // weights: element e -> (column e / tw, row e % tw)
    int r = i / tw, q = i % tw;
    const int dr = n / tw, dq = n % tw;
    for (; r < W; r += dr, q += dq) {
      if (q >= tw) { q -= tw; ++r; if (r >= W) break; }
      const bool ok = c0n + r < Cn && w0 + q < Mw;
      cp_async4(raw + q * pitch + r,
                ok ? w_planes + (size_t)(c0n + r) * Mw + w0 + q : w_planes,
                ok);
    }
  }
  {  // masks: element e -> (row e / W, column e % W)
    int q = i / W, r = i % W;
    const int dq = n / W, dr = n % W;
    for (; q < tp; q += dq, r += dr) {
      if (r >= W) { r -= W; ++q; if (q >= tp) break; }
      const bool ok = p0 + q < P && c0n + r < Cn;
      cp_async4(raw + (tw + q) * pitch + r,
                ok ? i_masks + (size_t)(p0 + q) * Cn + c0n + r : i_masks, ok);
    }
  }
}

}  // namespace hf

// Chain is the add-only chain the chain warps run over products, Mul
// the multiplier the producers run ahead.  PROBE instantiations (built
// only by scripts/torch_fused_probe.py) stamp clock64() in lane 0 of
// every warp and write 4 words a warp:
// chain warps [full-barrier wait, chain body, 0, tiles], producer warps
// [ring waits, multiplies, staging issue, tiles].
template <class Chain, class Mul, bool RELU, bool PROBE>
__global__ void fused_mac_kernel(const int32_t* __restrict__ i_masks,
                                 const int32_t* __restrict__ w_planes,
                                 int32_t* __restrict__ out, int P, int C,
                                 int Mw, int tp, int tw, int ct, int pw,
                                 unsigned long long* __restrict__ probe) {
  constexpr int NIN = Mul::NIN, NOUT = Chain::NOUT, K = Chain::K;
  constexpr int S = hf::STAGES;
  extern __shared__ uint64_t smem64[];
  const int nl = (tp * tw + 31) / 32 * 32;   // chain threads
  const int np = pw * nl;                    // producer threads
  const int pitch = ct * NIN + 1;            // raw row, padded a word
  const int ppitch = ct * NOUT + 1;          // product row, padded a word
  const int raw_words = (tw + tp) * pitch;
  uint64_t* full = smem64;
  uint64_t* empty = full + S;
  uint32_t* raw = reinterpret_cast<uint32_t*>(empty + S);
  uint32_t* prod = raw + 2 * raw_words;
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * tw, p0 = blockIdx.y * tp;
  const int T = (C + ct - 1) / ct;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hf::mbar_init(&full[s], np);
      hf::mbar_init(&empty[s], nl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  unsigned long long pa = 0, pb = 0, pc = 0;

  if (tid < nl) {
    // ---- chain warps: fold the C channels in order -------------------
    const int lane = tid < tp * tw ? tid : 0;
    const int ty = lane / tw, tx = lane % tw;
    uint32_t acc[NOUT];
#pragma unroll
    for (int b = 0; b < NOUT; ++b) acc[b] = 0u;  // +0
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      long long t0 = 0, t1 = 0;
      if (PROBE) t0 = clock64();
      hf::mbar_wait(&full[s], (t / S) & 1);
      if (PROBE) t1 = clock64();
      const int cend = min(ct, C - t * ct);
      const uint32_t* pp = prod + (s * nl + tid) * ppitch;
#pragma unroll 1
      for (int cc = 0; cc < cend; cc += K) Chain::run(pp + cc * NOUT, acc);
      hf::mbar_arrive(&empty[s]);
      if (PROBE) {
        pa += t1 - t0;
        pb += clock64() - t1;
      }
    }
    if (RELU) {
      const uint32_t sg = acc[Chain::SIGN_OFF];
#pragma unroll
      for (int b = 0; b < NOUT; ++b) acc[b] &= ~sg;
    }
    const int p = p0 + ty, w = w0 + tx;
    if (tid < tp * tw && p < P && w < Mw) {
#pragma unroll
      for (int b = 0; b < NOUT; ++b)
        out[((size_t)b * P + p) * Mw + w] = (int32_t)acc[b];
    }
  } else {
    // ---- producer warps: stage C tiles and multiply ahead -------------
    const int i = tid - nl;
    const int g = i / nl, li = i % nl;      // channel group, lane
    const int lane = li < tp * tw ? li : 0;
    const int ty = lane / tw, tx = lane % tw;
    hf::stage_tile<NIN>(raw, i_masks, w_planes, 0, ct, pitch, P, C, Mw,
                        p0, w0, tp, tw, i, np);
    hf::cp_async_commit();
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      uint32_t* rs = raw + (t & 1) * raw_words;
      long long t0 = 0, t1 = 0, t2 = 0;
      if (PROBE) t0 = clock64();
      if (t + 1 < T)
        hf::stage_tile<NIN>(raw + ((t + 1) & 1) * raw_words, i_masks,
                            w_planes, t + 1, ct, pitch, P, C, Mw, p0, w0,
                            tp, tw, i, np);
      hf::cp_async_commit();
      if (PROBE) t1 = clock64();
      hf::cp_async_wait<1>();     // tile t landed (this thread's part)
      hf::producer_sync(np);      // ... and every producer's
      hf::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
      if (PROBE) t2 = clock64();
      // Products of every channel the chain reads: up to the tile's
      // end rounded up to the chain depth (zero words past C).
      const int cend = min(ct, (C - t * ct + K - 1) / K * K);
      const uint32_t* xw = rs + tx * pitch;
      const uint32_t* yi = rs + (tw + ty) * pitch;
      uint32_t* pp = prod + (s * nl + li) * ppitch;
#pragma unroll 1
      for (int c = g; c < cend; c += pw)
        Mul::run(xw + c * NIN, yi + c * NIN, pp + c * NOUT);
      hf::mbar_arrive(&full[s]);
      hf::producer_sync(np);      // every producer is done with rs
      if (PROBE) {
        pa += t2 - t1;
        pb += clock64() - t2;
        pc += t1 - t0;
      }
    }
  }
  if (PROBE && (tid & 31) == 0) {
    const int nw = (nl + np) / 32;
    const size_t wi =
        ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * nw + tid / 32) * 4;
    probe[wi] = pa;
    probe[wi + 1] = pb;
    probe[wi + 2] = pc;
    probe[wi + 3] = (unsigned long long)T;
  }
}

// Dynamic shared memory of one block (mirrored by
// repro_torch/core/fused_backend/kernel.py::smem_bytes).
inline size_t fused_mac_smem_bytes(int nin, int nout, int tp, int tw,
                                   int ct) {
  const size_t nl = (size_t)(tp * tw + 31) / 32 * 32;
  const size_t raw = (size_t)(tw + tp) * (ct * nin + 1);
  return 16 * hf::STAGES +
         4 * (2 * raw + hf::STAGES * nl * (ct * nout + 1));
}

template <class Chain, class Mul, bool RELU, bool PROBE>
int fused_mac_launch_t(const int32_t* i_masks, const int32_t* w_planes,
                       int32_t* out, int P, int C, int Mw, int tp, int tw,
                       int ct, int pw, void* stream,
                       unsigned long long* probe) {
  const size_t smem =
      fused_mac_smem_bytes(Mul::NIN, Chain::NOUT, tp, tw, ct);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mac_kernel<Chain, Mul, RELU, PROBE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (1 + pw) * ((tp * tw + 31) / 32 * 32);
  const dim3 grid((Mw + tw - 1) / tw, (P + tp - 1) / tp);
  fused_mac_kernel<Chain, Mul, RELU, PROBE>
      <<<grid, threads, smem, (cudaStream_t)stream>>>(
          i_masks, w_planes, out, P, C, Mw, tp, tw, ct, pw, probe);
  return (int)cudaGetLastError();
}

// One C entry per (generated bodies, epilogue) variant: CHAIN the
// add-only chain, MUL the multiplier.
#define HF_DEFINE_FUSED_LAUNCH(NAME, CHAIN, MUL, RELU)                        \
  extern "C" int NAME(const int32_t* i_masks, const int32_t* w_planes,      \
                      int32_t* out, int P, int C, int Mw, int tp, int tw,   \
                      int ct, int pw, void* stream) {                       \
    return fused_mac_launch_t<CHAIN, MUL, RELU, false>(                     \
        i_masks, w_planes, out, P, C, Mw, tp, tw, ct, pw, stream, nullptr); \
  }

// The measurement-only entry of a variant: probe holds 4 words a warp.
#define HF_DEFINE_FUSED_PROBE(NAME, CHAIN, MUL, RELU)                         \
  extern "C" int NAME(const int32_t* i_masks, const int32_t* w_planes,      \
                      int32_t* out, int P, int C, int Mw, int tp, int tw,   \
                      int ct, int pw, void* stream,                         \
                      unsigned long long* probe) {                          \
    return fused_mac_launch_t<CHAIN, MUL, RELU, true>(                      \
        i_masks, w_planes, out, P, C, Mw, tp, tw, ct, pw, stream, probe);   \
  }
