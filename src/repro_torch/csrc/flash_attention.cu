// Blockwise (flash) attention, forward and backward, on Hopper tensor
// cores for bf16 inputs and in float32 FFMA for float32 inputs.
//
// Replaces no TPU kernel: the reference computes this function with jnp,
// in two nested lax.scans (src/repro/models/attention.py:77, _flash),
// which XLA compiles into a few fused loops on the TPU.  In PyTorch a
// loop over blocks launches some ten ops a block pair and, under
// autograd, keeps every block's probabilities for the backward: the
// [S, S] memory the blockwise form exists to avoid.  So on the card the
// scan is one fused kernel for the forward and four for the backward.
//
// What it computes.  q [B, Sq, Hkv, G, D], k and v [B, Sk, Hkv, D]
// (bf16 or f32; G query heads share a kv head).  For each (b, kv head)
// the G * Sq query rows r = t * G + g (position t + q_offset) attend to
// the Sk keys:
//   s = D^-0.5 (q . k),  -1e30 where causal and key > position,
//   o = softmax(s) v  (in q's type),  lse = max + log(sum)  (f32).
// The backward recomputes each tile's probabilities from lse:
//   Dv = rowsum(dO * o);  p = exp(s - lse);  dS = p * (dO . v - Dv);
//   dq = D^-0.5 dS k,  dk = D^-0.5 dS^T q,  dv = p^T dO,
// dk and dv summed over the G query heads of their kv head.  The
// reference computes _flash in float32, so every product here is a
// float32 product of the inputs, exactly, on either route.
//
// Two routes, chosen by the inputs' dtype in flash_fwd_launch and
// flash_bwd_launch (both routes always build; neither stands in for the
// other when a launch fails):
//
// bf16 inputs: tensor cores.  A bf16 x bf16 product is exact in f32
// (8 + 8 significant bits).  q.k^T and dO.v^T have two bf16 operands:
// one wgmma.mma_async ...f32.bf16.bf16 each, accumulated in f32.  P.v,
// P^T.dO, dS.k and dS^T.q have one f32 operand (P or dS), split exactly
// into three bf16 values, hi = bf16(x), mid = bf16(x - hi),
// lo = x - hi - mid (each subtraction exact; lo is bf16 unless x is
// below ~2^-100, where its last bits are subnormal and add nothing next
// to a row's largest p = 1): three wgmmas reproduce the f32 products.
// The sums are not the FFMA route's: besides their order, wgmma adds a
// step's products into the f32 accumulator without IEEE round-to-nearest
// at each addition.  So the bf16 outputs are held to the plain version
// by the share of elements whose bits differ (chip_smoke.py step 10a);
// one bf16 term a split product ("hi only") fails that check, two (no
// lo) pass it (PERF.md §6).  Per 64-row x 64-key tile pair the design
// issues these bf16 half-products (each 2 * 64 * 64 * D FLOPs): forward
// 4 (S, 3 for P.v);
// backward 13 (dK/dV kernel: S^T, dP^T, 3 for dV, 3 for dK; dQ kernel:
// S, dP, 3 for dQ); for D >= 128 the dK/dV kernel recomputes S^T and
// dP^T once for each 64 columns of dk, dv it owns.  No product on this
// route is an FFMA or a library call.
//   Blocks: forward and dQ, W warpgroups of 64 query rows and one
// producer warp; dK/dV, W warpgroups of 64 keys and no producer warp
// (at 168 registers a thread, 12 warps fill an SM's register file, so a
// producer warp would cost a third warpgroup).  W is 3 (forward), 1
// (dQ) and 3 (dK/dV) for D <= 64, 2 for D = 128 and 1 for D = 256
// (dK/dV then owns 64 columns of dk, dv a block).  Tiles sit in shared
// memory as rows of 128 bytes, 64 bf16 columns a block, 16-byte chunks
// swizzled by row (the SW128 layout wgmma reads, K-major for q.k^T and
// MN-major, by the descriptor's transpose, for P.v); head sizes below 64
// are padded to 64 columns, of which the products use D.  k and v tiles
// arrive by TMA (cp.async.bulk.tensor over the [B, Sk, Hkv * D] view,
// 64 x 64 boxes, rows past Sk zero-filled): in the forward and dQ into a
// ring of 2-3 stages, counted on full / empty mbarriers; in dK/dV once.
// q's rows r = t * G + g form no TMA box when 64 is not a multiple of
// G, so q (and dO) tiles are loaded with 16-byte loads (forward, dQ:
// once a block) or by every thread's cp.async with zero fill, ST - 1
// tiles ahead (dK/dV, a ring of q, dO, lse and Dv tiles).  The online
// softmax (m, l) lives in registers: the accumulator layout gives each
// row's 64 keys to the 4 lanes of a quad, so row reductions take two
// shuffles, and the S accumulator is the A operand of P.v as it stands
// (register A, no shared-memory round trip).
// Split groups are issued three wgmmas per 16-key step with a rolling
// wait, so two steps' A registers are live at a time.
//
// f32 inputs: FFMA (the CPU-compute checks and float32 serving prefill
// reach it).  T = 64 rows (32 for D = 256) by T keys, 256 threads as
// 16 x 16; a thread owns rows ty + 16 i and keys tx + 16 j, and the
// online softmax, k then v staged in one shared buffer.  A thread's 4 x 4
// register tile does 16 FFMAs for two 16-byte shared loads, which caps
// it near 0.4 of the FFMA peak (PERF.md §6).
//
// Both routes: key tiles wholly above the diagonal are skipped (every
// row's first tile holds key 0, so m is finite after it and a masked
// term, exp(-1e30 - m), is 0); rows and keys past the ends load as 0 and
// are masked, so any Sq and Sk run; the forward and dQ launch their
// heavier tiles (the last query tiles) first.  Backward: a Dv pass (one
// warp a row), then dK/dV (one block a key tile and run of query tiles
// from the diagonal on, each writing f32 partial sums that a small
// kernel adds in run order) and dQ (one block a query tile, walking the
// key tiles up to the diagonal).  No atomics: each output is summed in a
// fixed order, so two calls give the same bits.
//
// What bounds it on the H100.  bf16 route: the half-products the
// function needs (forward 4, backward 11: the dQ kernel's S and dP are
// the design's recompute), at 4096 bf16 FLOPs a clock an SM (989
// TFLOP/s at the data sheet's 1830 MHz, 1070 at 1980 MHz); the exps, one
// a score element forward and backward, at 16 a clock an SM (132 SMs);
// the bytes (q, k, v, o, dO and the gradients read or written once) at
// 3.35 TB/s, a few percent of the others for S >= 1024.  Between the
// products each tile pair spends some ten FP32 operations an element on
// scaling, masking, exp and the split, on the same warps that issue the
// wgmmas.  f32 route: the products, 4 B Sq Sk Hq D FLOPs forward
// (halved when causal), at 66.9 TFLOP/s f32 FFMA.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct Dims {
  int B, Sq, Sk, Hkv, G;
  int causal, q_offset;
  float scale;
};

__host__ __device__ constexpr int tile_of(int D) { return D <= 128 ? 64 : 32; }

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ float load1(const void* base, long idx, bool bf) {
  if (bf)
    return __uint_as_float(
        static_cast<uint32_t>(static_cast<const uint16_t*>(base)[idx]) << 16);
  return static_cast<const float*>(base)[idx];
}

__device__ __forceinline__ void store1(void* base, long idx, float x,
                                       bool bf) {
  if (bf)
    static_cast<uint16_t*>(base)[idx] = static_cast<uint16_t>(bf16_bits(x));
  else
    static_cast<float*>(base)[idx] = x;
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element offset of query-side row r (t = r / G, g = r % G) of (b, h),
// in units of D; the same index without D addresses lse and Dv.
__device__ __forceinline__ long q_row(const Dims& p, int b, int h, int r) {
  const int t = r / p.G, g = r - t * p.G;
  return ((static_cast<long>(b) * p.Sq + t) * p.Hkv + h) * p.G + g;
}
__device__ __forceinline__ long k_row(const Dims& p, int b, int h, int n) {
  return (static_cast<long>(b) * p.Sk + n) * p.Hkv + h;
}

// T query-side rows from r0 into dst [T][D + 4], times mul; 0 past the end.
template <int D, int T>
__device__ __forceinline__ void load_q_rows(float* dst, const float* src,
                                            const Dims& p, int b, int h,
                                            int r0, float mul) {
  constexpr int V = D / 4, LD = D + 4;
  const int nrows = p.Sq * p.G;
  for (int idx = threadIdx.x; idx < T * V; idx += THREADS) {
    const int row = idx / V, c = (idx - row * V) * 4, r = r0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      x = *reinterpret_cast<const float4*>(src + q_row(p, b, h, r) * D + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + row * LD + c) = x;
  }
}

// T key rows from n0 into dst [T][D + 4]; 0 past Sk.
template <int D, int T>
__device__ __forceinline__ void load_k_rows(float* dst, const float* src,
                                            const Dims& p, int b, int h,
                                            int n0) {
  constexpr int V = D / 4, LD = D + 4;
  for (int idx = threadIdx.x; idx < T * V; idx += THREADS) {
    const int row = idx / V, c = (idx - row * V) * 4, n = n0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < p.Sk)
      x = *reinterpret_cast<const float4*>(src + k_row(p, b, h, n) * D + c);
    *reinterpret_cast<float4*>(dst + row * LD + c) = x;
  }
}

// s[i][j] += A[ty + 16 i] . Bm[tx + 16 j] over D (rows of stride D + 4).
template <int D, int TM>
__device__ __forceinline__ void tile_dot(float (&s)[TM][TM],
                                         const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 a[TM], bv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < TM; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        s[i][j] = fmaf(a[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, bv[j].w, s[i][j]);
      }
  }
}

// The D / 16 columns a thread owns: VW consecutive ones in each of NC
// chunks; logical column e = q * VW + w is d = q * 16 * VW + tx * VW + w.
template <int D>
struct Cols {
  static constexpr int DC = D / 16;
  static constexpr int VW = DC % 4 == 0 ? 4 : DC % 2 == 0 ? 2 : 1;
  static constexpr int NC = DC / VW;
  static __device__ __forceinline__ int d(int e, int tx) {
    return (e / VW) * 16 * VW + tx * VW + e % VW;
  }
};

// acc[i][e] += sum_n P[ty + 16 i][n] M[n][d(e)], P [T][T + 4], M [T][D + 4].
template <int D, int T, int TM>
__device__ __forceinline__ void tile_pm(float (&acc)[TM][D / 16],
                                        const float* P, const float* M,
                                        int ty, int tx) {
  using C = Cols<D>;
  constexpr int LD = D + 4, LP = T + 4;
#pragma unroll 2
  for (int n = 0; n < T; n += 4) {
    float4 pr[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      pr[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LP + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* row = M + (n + u) * LD + tx * C::VW;
      float mv[C::DC];
#pragma unroll
      for (int q = 0; q < C::NC; ++q) {
        const float* at = row + q * 16 * C::VW;
        if constexpr (C::VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(at);
          mv[4 * q] = t.x; mv[4 * q + 1] = t.y;
          mv[4 * q + 2] = t.z; mv[4 * q + 3] = t.w;
        } else if constexpr (C::VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(at);
          mv[2 * q] = t.x; mv[2 * q + 1] = t.y;
        } else {
          mv[q] = *at;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float pv = lane4(pr[i], u);
#pragma unroll
        for (int e = 0; e < C::DC; ++e) acc[i][e] = fmaf(pv, mv[e], acc[i][e]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Dims p) {
  constexpr int T = tile_of(D), TM = T / 16, DC = D / 16, LD = D + 4,
                LP = T + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + T * LD;
  float* Ps = KVs + T * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / p.Hkv, h = blockIdx.x - b * p.Hkv;
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = qt * T, nrows = p.Sq * p.G;
  const int nkt = (p.Sk + T - 1) / T;

  load_q_rows<D, T>(Qs, q, p, b, h, r0, p.scale);
  int pos[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    pos[i] = min(r0 + ty + 16 * i, nrows - 1) / p.G + p.q_offset;
  int kt_end = nkt;
  if (p.causal) {
    const int last = (min(r0 + T, nrows) - 1) / p.G + p.q_offset;
    kt_end = min(nkt, last / T + 1);
  }

  float m[TM], l[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int n0 = kt * T;
    __syncthreads();  // the last tile's P and V are read
    load_k_rows<D, T>(KVs, k, p, b, h, n0);
    __syncthreads();
    float s[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[i][j] = 0.f;
    tile_dot<D, TM>(s, Qs, KVs, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int key = n0 + tx + 16 * j;
        if (key >= p.Sk || (p.causal && key > pos[i])) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum16(sum);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[i][e] *= corr;
    }
    __syncthreads();  // every thread has read K
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) Ps[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
    load_k_rows<D, T>(KVs, v, p, b, h, n0);
    __syncthreads();
    tile_pm<D, T, TM>(acc, Ps, KVs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    const long row = q_row(p, b, h, r);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DC; ++e)
      o[row * D + Cols<D>::d(e, tx)] = acc[i][e] / den;
    if (tx == 0) lse[row] = m[i] + logf(l[i]);
  }
}

// Dv[row] = sum_d dO[row][d] o[row][d]: one warp a row.
__global__ void flash_bwd_dot_kernel(const void* __restrict__ o,
                                     const void* __restrict__ dout,
                                     float* __restrict__ dvec, long rows,
                                     int D, int bf) {
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) +
                   threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s = fmaf(load1(dout, row * D + d, bf), load1(o, row * D + d, bf), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dvec[row] = s;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ dq,
                        Dims p) {
  constexpr int T = tile_of(D), TM = T / 16, DC = D / 16, LD = D + 4,
                LP = T + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + T * LD;
  float* Ks = dOs + T * LD;
  float* Vs = Ks + T * LD;
  float* Ps = Vs + T * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / p.Hkv, h = blockIdx.x - b * p.Hkv;
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = qt * T, nrows = p.Sq * p.G;
  const int nkt = (p.Sk + T - 1) / T;

  load_q_rows<D, T>(Qs, q, p, b, h, r0, p.scale);
  load_q_rows<D, T>(dOs, dout, p, b, h, r0, 1.f);
  int pos[TM];
  float lr[TM], dr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = min(r0 + ty + 16 * i, nrows - 1);
    pos[i] = r / p.G + p.q_offset;
    const long row = q_row(p, b, h, r);
    lr[i] = lse[row];
    dr[i] = dvec[row];
  }
  int kt_end = nkt;
  if (p.causal) {
    const int last = (min(r0 + T, nrows) - 1) / p.G + p.q_offset;
    kt_end = min(nkt, last / T + 1);
  }
  float acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int n0 = kt * T;
    __syncthreads();  // the last tile's dS and K are read
    load_k_rows<D, T>(Ks, k, p, b, h, n0);
    load_k_rows<D, T>(Vs, v, p, b, h, n0);
    __syncthreads();
    float s[TM][TM], dp[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D, TM>(s, Qs, Ks, ty, tx);
    tile_dot<D, TM>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int key = n0 + tx + 16 * j;
        const bool ok = key < p.Sk && !(p.causal && key > pos[i]);
        const float pr = ok ? expf(s[i][j] - lr[i]) : 0.f;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = pr * (dp[i][j] - dr[i]);
      }
    __syncthreads();
    tile_pm<D, T, TM>(acc, Ps, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    const long row = q_row(p, b, h, r);
#pragma unroll
    for (int e = 0; e < DC; ++e)
      dq[row * D + Cols<D>::d(e, tx)] = acc[i][e] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          float* __restrict__ part, int split_tiles,
                          Dims p) {
  constexpr int T = tile_of(D), TM = T / 16, DC = D / 16, LD = D + 4,
                LP = T + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* dOs = Qs + T * LD;
  float* Ps = dOs + T * LD;
  float* dSs = Ps + T * LP;
  float* Ls = dSs + T * LP;
  float* Ds = Ls + T;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / p.Hkv, h = blockIdx.x - b * p.Hkv;
  const int kt = blockIdx.y, n0 = kt * T;
  const int nrows = p.Sq * p.G, nqt = (nrows + T - 1) / T;

  int qt0 = 0;
  if (p.causal) {
    const long rmin = static_cast<long>(max(0, n0 - p.q_offset)) * p.G;
    qt0 = static_cast<int>(min(rmin, static_cast<long>(nrows)) / T);
  }
  // This block's share of the query tiles: split blockIdx.z of
  // split_tiles tiles.
  const int qt_begin = max(qt0, static_cast<int>(blockIdx.z) * split_tiles);
  const int qt_stop =
      min(nqt, (static_cast<int>(blockIdx.z) + 1) * split_tiles);
  if (qt_begin < qt_stop) {
    load_k_rows<D, T>(Ks, k, p, b, h, n0);
    load_k_rows<D, T>(Vs, v, p, b, h, n0);
  }
  float ak[TM][DC], av[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) ak[i][e] = av[i][e] = 0.f;

  for (int qt = qt_begin; qt < qt_stop; ++qt) {
    const int r0 = qt * T;
    __syncthreads();  // the last tile's P, dS, q and dO are read
    load_q_rows<D, T>(Qs, q, p, b, h, r0, p.scale);
    load_q_rows<D, T>(dOs, dout, p, b, h, r0, 1.f);
    if (threadIdx.x < T) {
      const int r = r0 + threadIdx.x;
      const bool in = r < nrows;
      const long row = in ? q_row(p, b, h, r) : 0;
      Ls[threadIdx.x] = in ? lse[row] : 0.f;
      Ds[threadIdx.x] = in ? dvec[row] : 0.f;
    }
    __syncthreads();
    float s[TM][TM], dp[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D, TM>(s, Ks, Qs, ty, tx);   // s^T [key][row]
    tile_dot<D, TM>(dp, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int key = n0 + ty + 16 * i, c = tx + 16 * j, r = r0 + c;
        const bool ok = r < nrows && key < p.Sk &&
                        !(p.causal && key > r / p.G + p.q_offset);
        const float pr = ok ? expf(s[i][j] - Ls[c]) : 0.f;
        Ps[(ty + 16 * i) * LP + c] = pr;
        dSs[(ty + 16 * i) * LP + c] = pr * (dp[i][j] - Ds[c]);
      }
    __syncthreads();
    tile_pm<D, T, TM>(av, Ps, dOs, ty, tx);
    tile_pm<D, T, TM>(ak, dSs, Qs, ty, tx);
  }

  const long n_el = static_cast<long>(p.B) * p.Sk * p.Hkv * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= p.Sk) continue;
    const long row = k_row(p, b, h, n);
#pragma unroll
    for (int e = 0; e < DC; ++e) {
      // f32 partial sums [split][dk, dv][B, Sk, Hkv, D]
      const long at = row * D + Cols<D>::d(e, tx);
      part[2L * blockIdx.z * n_el + at] = ak[i][e];
      part[(2L * blockIdx.z + 1) * n_el + at] = av[i][e];
    }
  }
}

// dk, dv = the splits' partial sums added in split order.
__global__ void flash_bwd_sum_kernel(const float* __restrict__ part,
                                     void* __restrict__ dk,
                                     void* __restrict__ dv, long n_el,
                                     int nsplit, int bf) {
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_el; i += static_cast<long>(gridDim.x) * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      a += part[2L * s * n_el + i];
      c += part[(2L * s + 1) * n_el + i];
    }
    store1(dk, i, a, bf);
    store1(dv, i, c, bf);
  }
}

template <int D>
constexpr int fwd_smem() {
  return (2 * tile_of(D) * (D + 4) + tile_of(D) * (tile_of(D) + 4)) * 4;
}
template <int D>
constexpr int dq_smem() {
  return (4 * tile_of(D) * (D + 4) + tile_of(D) * (tile_of(D) + 4)) * 4;
}
template <int D>
constexpr int dkdv_smem() {
  return (4 * tile_of(D) * (D + 4) + 2 * tile_of(D) * (tile_of(D) + 4) +
          2 * tile_of(D)) * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Dims& p, cudaStream_t s) {
  constexpr int T = tile_of(D);
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, fwd_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.B * p.Hkv, (p.Sq * p.G + T - 1) / T);
  flash_fwd_kernel<D><<<grid, THREADS, fwd_smem<D>(), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, p);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV splits a key tile's query tiles into runs of SPLIT_TILES, one
// block each: the causal triangle's first key tiles would otherwise walk
// every query tile alone while the last walk a few.  (FFMA route; the
// bf16 route's run is FLASH_TC_SPLIT_TILES.)
constexpr int SPLIT_TILES = 32;

int nsplit_of(int Sq, int G, int D) {
  const long nqt = (static_cast<long>(Sq) * G + tile_of(D) - 1) / tile_of(D);
  return static_cast<int>((nqt + SPLIT_TILES - 1) / SPLIT_TILES);
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma with exact split products, a TMA-fed k/v ring
// ---------------------------------------------------------------------------
constexpr int R = 64;              // rows of a tile (wgmma's M), keys a tile
constexpr int BLK = R * 128;       // bytes of one [64][64] bf16 column block

// FLASH_TC_SPLIT_TILES: query tiles of a dK/dV run on this route, the
// fastest in scripts/torch_flash_probe.py's sweep (PERF.md §6).
#ifndef FLASH_TC_SPLIT_TILES
#define FLASH_TC_SPLIT_TILES 32
#endif
constexpr int TC_SPLIT_TILES = FLASH_TC_SPLIT_TILES;

template <int D>
struct Tc {
  static constexpr int DP = D < 64 ? 64 : D;   // columns in shared memory
  static constexpr int NB = DP / 64;           // 128-byte column blocks
  static constexpr int TILE = NB * BLK;        // bytes of a [64][DP] tile
  static constexpr int CH = DP / 8;            // 16-byte chunks a row
  // Consumer warpgroups of a forward (WF), dQ (WQ) and dK/dV (WK) block:
  // for D <= 64 the fastest of 1-3 at step 8's attention (PERF.md §6).
  static constexpr int WF = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int WQ = D <= 64 ? 1 : D <= 128 ? 2 : 1;
  static constexpr int WK = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int ST = D <= 64 ? 3 : 2;   // ring stages
  static constexpr int NCH = D <= 64 ? 1 : D / 64;   // dK/dV column chunks
  static constexpr int THREADS_F = WF * 128 + 32;
  static constexpr int THREADS_Q = WQ * 128 + 32;
  static constexpr int THREADS_K = WK * 128;   // no producer warp
  static constexpr int FWD_SMEM = 1024 + (WF + 2 * ST) * TILE + 16 * ST;
  static constexpr int DQ_SMEM = 1024 + (2 * WQ + 2 * ST) * TILE + 16 * ST;
  static constexpr int DKDV_SMEM =
      1024 + (2 * WK + 2 * ST) * TILE + 512 * ST + 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Byte offset of 16-byte chunk c of row r in a [64][DP] SW128 tile.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * BLK + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
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

// One 64 x 64 box of a [B, Sk, Hkv * D] bf16 view: columns c0.., keys
// c1.., batch c2, landing swizzled (SW128) at dst.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, int c2,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier 1 + wg over consumer warpgroup wg (immediate ids).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;" ::: "memory");
  else if (wg == 1)
    asm volatile("bar.sync 2, 128;" ::: "memory");
  else
    asm volatile("bar.sync 3, 128;" ::: "memory");
}

// wgmma descriptors of SW128 tiles (rows of 128 bytes, 8-row groups
// 1024 bytes apart): K-major (the 16 K values of a step lie along a
// row; LBO unused) and MN-major (the N values lie along a row, 64 a
// column block BLK bytes apart; the K values are rows).
__device__ __forceinline__ uint64_t desc_k(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(BLK >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}
// K step kk (16 columns) of a K-major tile; K step kk (16 rows) and
// column block nb of an MN-major one.
__device__ __forceinline__ uint32_t kstep(int kk) {
  return (kk >> 2) * BLK + (kk & 3) * 32;
}
__device__ __forceinline__ uint32_t mnstep(int kk, int nb) {
  return kk * 16 * 128 + nb * BLK;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep registers an in-flight wgmma reads or writes where they are.
template <int N>
__device__ __forceinline__ void fence_f(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_u(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define FA_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FA_OUT32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major;
// acc = 0 starts the sum.
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_OUT32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B, m64n64k16, A from registers (the m16n8k16 fragment of each
// warp's 16 rows), B MN-major from shared memory.
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// bf16x2 of (lo, hi), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The exact split of (x, y): x = hi + mid + lo, each a bf16, packed as
// bf16x2 (x low).  __fsub_rn keeps the compiler from fusing a product
// that fed x into the subtraction.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float rx = __fsub_rn(x, bf16_lo(hi)), ry = __fsub_rn(y, bf16_hi(hi));
  mid = pack_bf16(rx, ry);
  lo = pack_bf16(__fsub_rn(rx, bf16_lo(mid)), __fsub_rn(ry, bf16_hi(mid)));
}

// acc[nb] += A B over 64 K values: A the f32 accumulator a[32] of a
// previous wgmma (rows x 64 K), split into hi / mid / lo register
// fragments; B an MN-major tile at b (K rows, NB column blocks).  Three
// wgmmas a 16-K step and column block, one commit group a step; step
// kk - 1's fragments stay live until its group has finished.
template <int NB>
__device__ __forceinline__ void split_mma(float (&acc)[NB][32],
                                          const float* a, uint32_t b) {
  uint32_t x[2][3][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t(&c)[3][4] = x[kk & 1];
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split3(a[8 * kk + 2 * f], a[8 * kk + 2 * f + 1], c[0][f], c[1][f],
             c[2][f]);
    fence_u<12>(&c[0][0]);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint64_t d = desc_mn(b + mnstep(kk, nb));
      mma_rs(acc[nb], c[0], d);
      mma_rs(acc[nb], c[1], d);
      mma_rs(acc[nb], c[2], d);
    }
    wg_commit();
    if (kk > 0) {
      wg_wait<1>();
      fence_u<12>(&x[(kk - 1) & 1][0][0]);
    }
  }
  wg_wait<0>();
  fence_u<12>(&x[1][0][0]);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_f<32>(acc[nb]);
}

// s = A B^T over the head size (K-major tiles at a and b; D / 16 steps),
// issued without waiting.
template <int D>
__device__ __forceinline__ void dot_tiles(float* s, uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss(s, desc_k(a + kstep(kk)), desc_k(b + kstep(kk)), kk);
}

// 64 query-side rows from r0 into a swizzled tile, 16-byte loads by the
// 128 threads of a warpgroup; 0 past the rows and past D.
template <int D>
__device__ __forceinline__ void load_rows_tc(uint8_t* tile,
                                             const uint16_t* src,
                                             const Dims& p, int b, int h,
                                             int r0, int tid) {
  constexpr int CH = Tc<D>::CH;
  const int nrows = p.Sq * p.G;
  for (int idx = tid; idx < R * CH; idx += 128) {
    const int row = idx / CH, c = idx - row * CH, r = r0 + row;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && c * 8 < D)
      x = *reinterpret_cast<const uint4*>(src + q_row(p, b, h, r) * D +
                                          c * 8);
    *reinterpret_cast<uint4*>(tile + swz(row, c)) = x;
  }
}

// Key tiles a run of query rows up to row_end (exclusive) walks.
__device__ __forceinline__ int tiles_to(const Dims& p, int row_end,
                                        int nkt) {
  if (!p.causal) return nkt;
  const int last = (row_end - 1) / p.G + p.q_offset;
  return min(nkt, last / R + 1);
}

// The producer of the forward and dQ: thread 0 of the last warp fills
// the k/v ring by TMA, tile t into stage t % ST.
template <int D>
__device__ __forceinline__ void kv_producer(const CUtensorMap* tmk,
                                            const CUtensorMap* tmv,
                                            uint8_t* Ks, uint8_t* Vs,
                                            uint64_t* full, uint64_t* empty,
                                            int b, int h, int nt) {
  using C = Tc<D>;
  for (int t = 0; t < nt; ++t) {
    const int s = t % C::ST;
    if (t >= C::ST) mbar_wait(&empty[s], ((t / C::ST) + 1) & 1);
    mbar_expect_tx(&full[s], 2 * C::TILE);
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      tma_box(Ks + s * C::TILE + j * BLK, tmk, h * D + 64 * j, t * R, b,
              &full[s]);
      tma_box(Vs + s * C::TILE + j * BLK, tmv, h * D + 64 * j, t * R, b,
              &full[s]);
    }
  }
}

// Store a warpgroup's [64][DP] accumulator rows (times mul) in bf16:
// row ra + 8 i of the thread, columns nb * 64 + 8 j + 2 tg (+1) < D.
template <int D, int NB>
__device__ __forceinline__ void store_rows_bf16(uint16_t* dst,
                                                const float (&acc)[NB][32],
                                                const float (&mul)[2],
                                                const Dims& p, int b, int h,
                                                int ra, int tg) {
  const int nrows = p.Sq * p.G;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= nrows) continue;
    uint16_t* row = dst + q_row(p, b, h, r) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + 8 * j + 2 * tg;
        if (col < D)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16(acc[nb][4 * j + 2 * i] * mul[i],
                        acc[nb][4 * j + 2 * i + 1] * mul[i]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS_F, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const uint16_t* __restrict__ q,
                        uint16_t* __restrict__ o, float* __restrict__ lse,
                        Dims p) {
  using C = Tc<D>;
  constexpr int W = C::WF, ST = C::ST, NB = C::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + W * C::TILE;
  uint8_t* Vs = Ks + ST * C::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + ST * C::TILE);
  uint64_t* empty = full + ST;
  const int b = blockIdx.x / p.Hkv, h = blockIdx.x - b * p.Hkv;
  const int bt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int nrows = p.Sq * p.G, rb0 = bt * W * R;
  const int nkt = (p.Sk + R - 1) / R;
  const int nt = tiles_to(p, min(rb0 + W * R, nrows), nkt);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == W) {
    if (threadIdx.x == W * 128)
      kv_producer<D>(&tmk, &tmv, Ks, Vs, full, empty, b, h, nt);
    return;
  }
  const int tid = threadIdx.x & 127, lane = tid & 31, tg = lane & 3;
  const int r0 = rb0 + wg * R, ra = r0 + (tid >> 5) * 16 + (lane >> 2);
  uint8_t* Qw = Qs + wg * C::TILE;
  load_rows_tc<D>(Qw, q, p, b, h, r0, tid);
  proxy_fence();
  wg_sync(wg);
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    pos[i] = min(ra + 8 * i, nrows - 1) / p.G + p.q_offset;
  const int my_nt = r0 < nrows ? tiles_to(p, min(r0 + R, nrows), nkt) : 0;
  float acc[NB][32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  const uint32_t qa = smem_u32(Qw);
  for (int t = 0; t < nt; ++t) {
    const int s = t % ST;
    mbar_wait(&full[s], (t / ST) & 1);
    if (t < my_nt) {
      float sc[32];
      wg_fence();
      dot_tiles<D>(sc, qa, smem_u32(Ks + s * C::TILE));
      wg_commit();
      wg_wait<0>();
      fence_f<32>(sc);
      const int n0 = t * R;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e, key = n0 + 8 * j + 2 * tg + e;
            float x = sc[idx] * p.scale;
            if (key >= p.Sk || (p.causal && key > pos[i])) x = NEG_INF;
            sc[idx] = x;
            mx[i] = fmaxf(mx[i], x);
          }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - mn);
        m[i] = mn;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e;
            sc[idx] = expf(sc[idx] - m[i]);
            sum[i] += sc[idx];
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[nb][4 * j + 2 * i] *= corr[i];
            acc[nb][4 * j + 2 * i + 1] *= corr[i];
          }
      split_mma<NB>(acc, sc, smem_u32(Vs + s * C::TILE));
    }
    mbar_arrive(&empty[s]);
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  store_rows_bf16<D, NB>(o, acc, inv, p, b, h, ra, tg);
  if (tg == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (ra + 8 * i < nrows)
        lse[q_row(p, b, h, ra + 8 * i)] = m[i] + logf(l[i]);
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS_Q, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv,
                           const uint16_t* __restrict__ q,
                           const uint16_t* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           uint16_t* __restrict__ dq, Dims p) {
  using C = Tc<D>;
  constexpr int W = C::WQ, ST = C::ST, NB = C::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + W * C::TILE;
  uint8_t* Ks = dOs + W * C::TILE;
  uint8_t* Vs = Ks + ST * C::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + ST * C::TILE);
  uint64_t* empty = full + ST;
  const int b = blockIdx.x / p.Hkv, h = blockIdx.x - b * p.Hkv;
  const int bt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int nrows = p.Sq * p.G, rb0 = bt * W * R;
  const int nkt = (p.Sk + R - 1) / R;
  const int nt = tiles_to(p, min(rb0 + W * R, nrows), nkt);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == W) {
    if (threadIdx.x == W * 128)
      kv_producer<D>(&tmk, &tmv, Ks, Vs, full, empty, b, h, nt);
    return;
  }
  const int tid = threadIdx.x & 127, lane = tid & 31, tg = lane & 3;
  const int r0 = rb0 + wg * R, ra = r0 + (tid >> 5) * 16 + (lane >> 2);
  uint8_t* Qw = Qs + wg * C::TILE;
  uint8_t* dOw = dOs + wg * C::TILE;
  load_rows_tc<D>(Qw, q, p, b, h, r0, tid);
  load_rows_tc<D>(dOw, dout, p, b, h, r0, tid);
  proxy_fence();
  wg_sync(wg);
  int pos[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = min(ra + 8 * i, nrows - 1);
    pos[i] = r / p.G + p.q_offset;
    const long row = q_row(p, b, h, r);
    lr[i] = lse[row];
    dr[i] = dvec[row];
  }
  const int my_nt = r0 < nrows ? tiles_to(p, min(r0 + R, nrows), nkt) : 0;
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  const uint32_t qa = smem_u32(Qw), da = smem_u32(dOw);
  for (int t = 0; t < nt; ++t) {
    const int s = t % ST;
    mbar_wait(&full[s], (t / ST) & 1);
    if (t < my_nt) {
      const uint32_t ka = smem_u32(Ks + s * C::TILE);
      float sc[32], dp[32];
      wg_fence();
      dot_tiles<D>(sc, qa, ka);
      dot_tiles<D>(dp, da, smem_u32(Vs + s * C::TILE));
      wg_commit();
      wg_wait<0>();
      fence_f<32>(sc);
      fence_f<32>(dp);
      const int n0 = t * R;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e, key = n0 + 8 * j + 2 * tg + e;
            const bool ok = key < p.Sk && !(p.causal && key > pos[i]);
            const float pr = ok ? expf(sc[idx] * p.scale - lr[i]) : 0.f;
            sc[idx] = pr * (dp[idx] - dr[i]);
          }
      split_mma<NB>(acc, sc, ka);
    }
    mbar_arrive(&empty[s]);
  }
  const float mul[2] = {p.scale, p.scale};
  store_rows_bf16<D, NB>(dq, acc, mul, p, b, h, ra, tg);
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS_K, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const uint16_t* __restrict__ q,
                             const uint16_t* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             float* __restrict__ part, int split_tiles,
                             Dims p) {
  using C = Tc<D>;
  constexpr int W = C::WK, ST = C::ST, CH = C::CH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Kw = align1024(smem_raw);
  uint8_t* Vw = Kw + W * C::TILE;
  uint8_t* Qt = Vw + W * C::TILE;      // ring: q tiles
  uint8_t* dOt = Qt + ST * C::TILE;    // ring: dO tiles
  float* Ls = reinterpret_cast<float*>(dOt + ST * C::TILE);   // [ST][64]
  float* Ds = Ls + ST * R;                                    // [ST][64]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(Ds + ST * R);
  const int b = blockIdx.x / p.Hkv, h = blockIdx.x - b * p.Hkv;
  const int k0 = blockIdx.y * W * R;
  const int cz = blockIdx.z % C::NCH, z = blockIdx.z / C::NCH;
  const int nrows = p.Sq * p.G, nqt = (nrows + R - 1) / R;
  // The first query tile with a row at or past a key's position.
  auto first_qt = [&](int n) {
    if (!p.causal) return 0;
    const long rmin = static_cast<long>(max(0, n - p.q_offset)) * p.G;
    return static_cast<int>(min(rmin, static_cast<long>(nrows)) / R);
  };
  const int qt_begin = max(first_qt(k0), z * split_tiles);
  const int qt_stop = min(nqt, (z + 1) * split_tiles);
  const int ntq = max(0, qt_stop - qt_begin);
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, lane = tid & 31, tg = lane & 3;
  const int kw0 = k0 + wg * R, na = kw0 + (tid >> 5) * 16 + (lane >> 2);
  float dk[1][32], dv[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[0][i] = dv[0][i] = 0.f;

  if (ntq > 0) {
    // k, v of the block by TMA; the q, dO, lse and Dv of query tile i by
    // every thread's cp.async into ring stage i % ST, zero past the rows
    // and past D, ST - 1 tiles ahead of the one in use.
    if (threadIdx.x == 0) {
      mbar_init(kvbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(kvbar, 2 * W * C::TILE);
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int j = 0; j < C::NB; ++j) {
          tma_box(Kw + w * C::TILE + j * BLK, &tmk, h * D + 64 * j,
                  k0 + w * R, b, kvbar);
          tma_box(Vw + w * C::TILE + j * BLK, &tmv, h * D + 64 * j,
                  k0 + w * R, b, kvbar);
        }
    }
    auto fetch = [&](int i) {
      if (i < ntq) {
        const int s = i % ST, r0 = (qt_begin + i) * R;
        uint8_t* qd = Qt + s * C::TILE;
        uint8_t* dd = dOt + s * C::TILE;
        for (int idx = threadIdx.x; idx < R * CH; idx += W * 128) {
          const int row = idx / CH, c = idx - row * CH, r = r0 + row;
          const bool ok = r < nrows && c * 8 < D;
          const long at = ok ? q_row(p, b, h, r) * D + c * 8 : 0;
          cp_async16(qd + swz(row, c), q + at, ok);
          cp_async16(dd + swz(row, c), dout + at, ok);
        }
        for (int row = threadIdx.x; row < R; row += W * 128) {
          const int r = r0 + row;
          const bool ok = r < nrows;
          const long at = ok ? q_row(p, b, h, r) : 0;
          cp_async4(Ls + s * R + row, lse + at, ok);
          cp_async4(Ds + s * R + row, dvec + at, ok);
        }
      }
      cp_async_commit();
    };
    for (int i = 0; i < ST - 1; ++i) fetch(i);
    const bool active = kw0 < p.Sk;
    const int qtw0 = first_qt(kw0);
    // Key n is masked for row r when r < G (n - q_offset).
    long lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = static_cast<long>(na + 8 * i - p.q_offset) * p.G;
    const uint32_t ka = smem_u32(Kw + wg * C::TILE),
                   va = smem_u32(Vw + wg * C::TILE);
    __syncthreads();  // kvbar initialised
    mbar_wait(kvbar, 0);
    for (int i = 0; i < ntq; ++i) {
      const int s = i % ST, t = qt_begin + i;
      // Tile i has landed (every thread's copies) and every warpgroup
      // is done with tile i - 1, whose stage takes tile i + ST - 1.
      cp_async_wait<ST - 2>();
      proxy_fence();
      __syncthreads();
      fetch(i + ST - 1);
      if (active && t >= qtw0) {
        const uint32_t qa = smem_u32(Qt + s * C::TILE),
                       da = smem_u32(dOt + s * C::TILE);
        const float* ls = Ls + s * R;
        const float* ds = Ds + s * R;
        float st[32], dpt[32];
        wg_fence();
        dot_tiles<D>(st, ka, qa);    // s^T [key][row]
        dot_tiles<D>(dpt, va, da);   // dP^T
        wg_commit();
        wg_wait<0>();
        fence_f<32>(st);
        fence_f<32>(dpt);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * j + 2 * i2 + e, c = 8 * j + 2 * tg + e;
              const int r = t * R + c, n = na + 8 * i2;
              const bool ok = r < nrows && n < p.Sk &&
                              !(p.causal && r < lim[i2]);
              const float pr = ok ? expf(st[idx] * p.scale - ls[c]) : 0.f;
              st[idx] = pr;
              dpt[idx] = pr * (dpt[idx] - ds[c]);
            }
        split_mma<1>(dv, st, da + cz * BLK);
        split_mma<1>(dk, dpt, qa + cz * BLK);
      }
    }
    cp_async_wait<0>();
  }
  // Partial sums [split][dk, dv][B, Sk, Hkv, D] in f32, dk times scale;
  // a run with no query tile writes zeros.
  const long n_el = static_cast<long>(p.B) * p.Sk * p.Hkv * D;
  float* pk = part + 2L * z * n_el;
  float* pv = pk + n_el;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = na + 8 * i;
    if (n >= p.Sk) continue;
    const long row = k_row(p, b, h, n) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cz * 64 + 8 * j + 2 * tg;
      if (col < D) {
        *reinterpret_cast<float2*>(pk + row + col) =
            make_float2(dk[0][4 * j + 2 * i] * p.scale,
                        dk[0][4 * j + 2 * i + 1] * p.scale);
        *reinterpret_cast<float2*>(pv + row + col) =
            make_float2(dv[0][4 * j + 2 * i], dv[0][4 * j + 2 * i + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query (nothing links libcuda by hand).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The [B, Sk, Hkv * D] bf16 view of k or v, 64 x 64 boxes, SW128; keys
// past Sk and columns past Hkv * D read as 0.
int kv_map(CUtensorMap* map, const void* kv, const Dims& p, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.Hkv) * D,
                              static_cast<cuuint64_t>(p.Sk),
                              static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, R, 1}, step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(kv), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse,
           const Dims& p, cudaStream_t s) {
  using C = Tc<D>;
  CUtensorMap mk, mv;
  int e = kv_map(&mk, k, p, D);
  if (e == 0) e = kv_map(&mv, v, p, D);
  if (e != 0) return e;
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<D>, C::FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hkv, (p.Sq * p.G + C::WF * R - 1) / (C::WF * R));
  flash_fwd_tc_kernel<D><<<grid, C::THREADS_F, C::FWD_SMEM, s>>>(
      mk, mv, static_cast<const uint16_t*>(q), static_cast<uint16_t*>(o),
      lse, p);
  return static_cast<int>(cudaGetLastError());
}

int nsplit_tc(int Sq, int G) {
  const long nqt = (static_cast<long>(Sq) * G + R - 1) / R;
  return static_cast<int>((nqt + TC_SPLIT_TILES - 1) / TC_SPLIT_TILES);
}

// The backward on either route: the Dv pass, dK/dV over runs of query
// tiles, the runs' sum, dQ; *launched counts the kernels launched.
template <int D>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* dvec, void* dq, void* dk,
        void* dv, float* part, const Dims& p, bool tc, cudaStream_t s,
        int* launched) {
  using C = Tc<D>;
  constexpr int T = tile_of(D);
  CUtensorMap mk, mv;
  int e = tc ? kv_map(&mk, k, p, D) : 0;
  if (e == 0 && tc) e = kv_map(&mv, v, p, D);
  if (e != 0) return e;
  cudaError_t err =
      tc ? allow_smem(flash_bwd_dq_tc_kernel<D>, C::DQ_SMEM)
         : allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (err == cudaSuccess)
    err = tc ? allow_smem(flash_bwd_dkdv_tc_kernel<D>, C::DKDV_SMEM)
             : allow_smem(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const long rows = static_cast<long>(p.B) * p.Sq * p.Hkv * p.G;
  flash_bwd_dot_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      o, dout, dvec, rows, D, tc);
  ++*launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nsplit = tc ? nsplit_tc(p.Sq, p.G) : nsplit_of(p.Sq, p.G, D);
  if (tc) {
    const dim3 gk(p.B * p.Hkv, (p.Sk + C::WK * R - 1) / (C::WK * R),
                  nsplit * C::NCH);
    flash_bwd_dkdv_tc_kernel<D><<<gk, C::THREADS_K, C::DKDV_SMEM, s>>>(
        mk, mv, static_cast<const uint16_t*>(q),
        static_cast<const uint16_t*>(dout), lse, dvec, part, TC_SPLIT_TILES,
        p);
  } else {
    const dim3 gk(p.B * p.Hkv, (p.Sk + T - 1) / T, nsplit);
    flash_bwd_dkdv_kernel<D><<<gk, THREADS, dkdv_smem<D>(), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dvec, part, SPLIT_TILES, p);
  }
  ++*launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n_el = static_cast<long>(p.B) * p.Sk * p.Hkv * D;
  const long blocks = (n_el + 255) / 256;
  flash_bwd_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                         256, 0, s>>>(part, dk, dv, n_el, nsplit, tc);
  ++*launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tc) {
    const dim3 gq(p.B * p.Hkv, (p.Sq * p.G + C::WQ * R - 1) / (C::WQ * R));
    flash_bwd_dq_tc_kernel<D><<<gq, C::THREADS_Q, C::DQ_SMEM, s>>>(
        mk, mv, static_cast<const uint16_t*>(q),
        static_cast<const uint16_t*>(dout), lse, dvec,
        static_cast<uint16_t*>(dq), p);
  } else {
    const dim3 gq(p.B * p.Hkv, (p.Sq * p.G + T - 1) / T);
    flash_bwd_dq_kernel<D><<<gq, THREADS, dq_smem<D>(), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dvec, static_cast<float*>(dq), p);
  }
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

Dims dims(int B, int Sq, int Sk, int Hkv, int G, int causal, int q_offset,
          float scale) {
  return Dims{B, Sq, Sk, Hkv, G, causal, q_offset, scale};
}

bool valid(int B, int Sq, int Sk, int Hkv, int G, int D, int q_offset) {
  const int T = tile_of(D);
  return B >= 1 && Sq >= 1 && Sk >= 1 && Hkv >= 1 && G >= 1 &&
         q_offset >= 0 && static_cast<long>(B) * Hkv <= 0x7fffffffL &&
         static_cast<long>(Sq) * G <= 0x7fffffffL &&
         (static_cast<long>(Sq) * G + T - 1) / T <= 65535 &&
         (Sk + T - 1) / T <= 65535;
}

}  // namespace

// o (q's type) and lse (f32, [B, Sq, Hkv, G]) from q, k, v, by the
// route of the dtype (bf16 != 0: tensor cores, scale applied to the f32
// scores; else FFMA, q multiplied by scale); scale is D^-0.5, rounded
// to f32 by the caller.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or head size (16, 32, 64, 128, 256) it does not take.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, int B, int Sq, int Sk,
                                int Hkv, int G, int D, int causal,
                                int q_offset, int bf16, float scale,
                                void* stream) {
  if (!valid(B, Sq, Sk, Hkv, G, D, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims p = dims(B, Sq, Sk, Hkv, G, causal, q_offset, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) switch (D) {
    case 16: return fwd_tc<16>(q, k, v, o, lse, p, s);
    case 32: return fwd_tc<32>(q, k, v, o, lse, p, s);
    case 64: return fwd_tc<64>(q, k, v, o, lse, p, s);
    case 128: return fwd_tc<128>(q, k, v, o, lse, p, s);
    case 256: return fwd_tc<256>(q, k, v, o, lse, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 16: return fwd<16>(q, k, v, o, lse, p, s);
    case 32: return fwd<32>(q, k, v, o, lse, p, s);
    case 64: return fwd<64>(q, k, v, o, lse, p, s);
    case 128: return fwd<128>(q, k, v, o, lse, p, s);
    case 256: return fwd<256>(q, k, v, o, lse, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32 floats of the dK/dV partial sums flash_bwd_launch needs as part
// on the route of the inputs' dtype (bf16 != 0: tensor cores).
extern "C" long flash_bwd_workspace(int B, int Sq, int Sk, int Hkv, int G,
                                    int D, int bf16) {
  return 2L * (bf16 ? nsplit_tc(Sq, G) : nsplit_of(Sq, G, D)) * B * Sk *
         Hkv * D;
}

// dq, dk, dv (in the inputs' type) from dout (o's type), the forward's
// o and lse; dvec is f32 scratch of B * Sq * Hkv * G, part f32 scratch
// of flash_bwd_workspace floats.  Kernels: Dv, dK/dV, the sum of its
// splits, dQ; *launched counts those launched.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, float* dvec, float* part,
                                void* dq, void* dk, void* dv, int B, int Sq,
                                int Sk, int Hkv, int G, int D, int causal,
                                int q_offset, int bf16, float scale,
                                int* launched, void* stream) {
  *launched = 0;
  if (!valid(B, Sq, Sk, Hkv, G, D, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims p = dims(B, Sq, Sk, Hkv, G, causal, q_offset, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = bf16 != 0;
  switch (D) {
    case 16: return bwd<16>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, tc, s, launched);
    case 32: return bwd<32>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, tc, s, launched);
    case 64: return bwd<64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, tc, s, launched);
    case 128: return bwd<128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, tc, s, launched);
    case 256: return bwd<256>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, tc, s, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
