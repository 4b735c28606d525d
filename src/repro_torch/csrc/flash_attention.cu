// Blockwise (flash) attention, forward and backward, in float32 FFMA.
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
// (bf16 or f32, converted to f32 on load; G query heads share a kv
// head).  For each (b, kv head) the G * Sq query rows r = t * G + g
// (position t + q_offset) attend to the Sk keys:
//   s = (q * D^-0.5) . k,  -1e30 where causal and key > position,
//   o = softmax(s) v  (in q's type),  lse = max + log(sum)  (f32).
// The backward recomputes each tile's probabilities from lse:
//   Dv = rowsum(dO * o);  p = exp(s - lse);  dS = p * (dO . v - Dv);
//   dq = D^-0.5 dS k,  dk = dS^T (q * D^-0.5),  dv = p^T dO,
// dk and dv summed over the G query heads of their kv head.  All
// products are f32 FFMA: no TF32 and no bf16 products, as the reference
// computes _flash in float32.
//
// Tiles.  T = 64 rows (32 for D = 256) by T keys, 256 threads as 16 x 16;
// a thread owns rows ty + 16 i and keys tx + 16 j (i, j < T / 16), so a
// row's keys lie in 16 lanes of one warp (shuffle reductions) and the
// shared-memory reads of a row stride (D + 4 floats) fall in distinct
// banks.  The forward keeps the online softmax (m, l, acc) in
// registers and stages k, then v, in one shared buffer.  Key tiles that
// lie wholly above the diagonal are skipped: every row's first tile
// holds key 0, so m is finite after it and a masked term, exp(-1e30 -
// m), is 0 in f32; the skipped tiles add nothing.  Rows and keys past
// the ends are loaded as 0 and masked, so any Sq and Sk run.
//
// Backward: a Dv pass (one warp a row), then dK/dV (one block a key
// tile and run of SPLIT_TILES query tiles from the diagonal on, each
// writing f32 partial sums that a small kernel adds in run order) and dQ (one block a query tile, walking the key tiles up to
// the diagonal).  No atomics: each output is summed in a fixed order,
// so a step is deterministic.  The forward and dQ launch their heavier
// tiles (the last query tiles) first.
//
// What bounds it on the H100: the products, 4 B Sq Sk Hq D FLOPs forward
// (halved when causal) at 66.9 TFLOP/s f32 FFMA; the bytes (q, k, v, o
// read or written once) are a few percent of that time at 3.35 TB/s
// for S >= 1024.  A thread's 4 x 4 tile does 16 FFMAs for two 16-byte
// shared loads; the kernels reach about 0.4 of the FFMA peak at step
// 8's shape (PERF.md §6).  wgmma (3xTF32) and TMA are later work
// (ROADMAP, queue 2).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct Dims {
  int B, Sq, Sk, Hkv, G;
  int causal, q_offset, bf16;
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

// Four consecutive elements at element index idx, as f32.
__device__ __forceinline__ float4 load4(const void* base, long idx, bool bf) {
  if (bf) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        static_cast<const uint16_t*>(base) + idx);
    return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                       bf16_hi(w.y));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(base) +
                                          idx);
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
__device__ __forceinline__ void load_q_rows(float* dst, const void* src,
                                            const Dims& p, int b, int h,
                                            int r0, float mul) {
  constexpr int V = D / 4, LD = D + 4;
  const int nrows = p.Sq * p.G;
  for (int idx = threadIdx.x; idx < T * V; idx += THREADS) {
    const int row = idx / V, c = (idx - row * V) * 4, r = r0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      x = load4(src, q_row(p, b, h, r) * D + c, p.bf16);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + row * LD + c) = x;
  }
}

// T key rows from n0 into dst [T][D + 4]; 0 past Sk.
template <int D, int T>
__device__ __forceinline__ void load_k_rows(float* dst, const void* src,
                                            const Dims& p, int b, int h,
                                            int n0) {
  constexpr int V = D / 4, LD = D + 4;
  for (int idx = threadIdx.x; idx < T * V; idx += THREADS) {
    const int row = idx / V, c = (idx - row * V) * 4, n = n0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < p.Sk) x = load4(src, k_row(p, b, h, n) * D + c, p.bf16);
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
    flash_fwd_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, void* __restrict__ o,
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
      store1(o, row * D + Cols<D>::d(e, tx), acc[i][e] / den, p.bf16);
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
    flash_bwd_dq_kernel(const void* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v,
                        const void* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, void* __restrict__ dq,
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
      store1(dq, row * D + Cols<D>::d(e, tx), acc[i][e] * p.scale, p.bf16);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const void* __restrict__ q,
                          const void* __restrict__ k,
                          const void* __restrict__ v,
                          const void* __restrict__ dout,
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
  flash_fwd_kernel<D><<<grid, THREADS, fwd_smem<D>(), s>>>(q, k, v, o, lse,
                                                           p);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV splits a key tile's query tiles into runs of SPLIT_TILES, one
// block each: the causal triangle's first key tiles would otherwise walk
// every query tile alone while the last walk a few.
// scripts/torch_flash_probe.py builds it with other values.
#ifndef FLASH_SPLIT_TILES
#define FLASH_SPLIT_TILES 32
#endif
constexpr int SPLIT_TILES = FLASH_SPLIT_TILES;

int nsplit_of(int Sq, int G, int D) {
  const long nqt = (static_cast<long>(Sq) * G + tile_of(D) - 1) / tile_of(D);
  return static_cast<int>((nqt + SPLIT_TILES - 1) / SPLIT_TILES);
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* dvec, void* dq, void* dk,
        void* dv, float* part, const Dims& p, cudaStream_t s,
        int* launched) {
  constexpr int T = tile_of(D);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (e == cudaSuccess)
    e = allow_smem(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const long rows = static_cast<long>(p.B) * p.Sq * p.Hkv * p.G;
  flash_bwd_dot_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      o, dout, dvec, rows, D, p.bf16);
  ++*launched;
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nsplit = nsplit_of(p.Sq, p.G, D);
  const dim3 gk(p.B * p.Hkv, (p.Sk + T - 1) / T, nsplit);
  flash_bwd_dkdv_kernel<D><<<gk, THREADS, dkdv_smem<D>(), s>>>(
      q, k, v, dout, lse, dvec, part, SPLIT_TILES, p);
  ++*launched;
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long n_el = static_cast<long>(p.B) * p.Sk * p.Hkv * D;
  const long blocks = (n_el + 255) / 256;
  flash_bwd_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                         256, 0, s>>>(part, dk, dv, n_el, nsplit, p.bf16);
  ++*launched;
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gq(p.B * p.Hkv, (p.Sq * p.G + T - 1) / T);
  flash_bwd_dq_kernel<D><<<gq, THREADS, dq_smem<D>(), s>>>(
      q, k, v, dout, lse, dvec, dq, p);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

Dims dims(int B, int Sq, int Sk, int Hkv, int G, int causal, int q_offset,
          int bf16, float scale) {
  return Dims{B, Sq, Sk, Hkv, G, causal, q_offset, bf16, scale};
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

// o (q's type) and lse (f32, [B, Sq, Hkv, G]) from q, k, v; q is
// multiplied by scale (D^-0.5, rounded to f32 by the caller).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or head size (16, 32, 64, 128, 256) it does not take.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, int B, int Sq, int Sk,
                                int Hkv, int G, int D, int causal,
                                int q_offset, int bf16, float scale,
                                void* stream) {
  if (!valid(B, Sq, Sk, Hkv, G, D, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims p = dims(B, Sq, Sk, Hkv, G, causal, q_offset, bf16, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return fwd<16>(q, k, v, o, lse, p, s);
    case 32: return fwd<32>(q, k, v, o, lse, p, s);
    case 64: return fwd<64>(q, k, v, o, lse, p, s);
    case 128: return fwd<128>(q, k, v, o, lse, p, s);
    case 256: return fwd<256>(q, k, v, o, lse, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32 floats of the dK/dV partial sums flash_bwd_launch needs as part.
extern "C" long flash_bwd_workspace(int B, int Sq, int Sk, int Hkv, int G,
                                    int D) {
  return 2L * nsplit_of(Sq, G, D) * B * Sk * Hkv * D;
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
  const Dims p = dims(B, Sq, Sk, Hkv, G, causal, q_offset, bf16, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return bwd<16>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, s, launched);
    case 32: return bwd<32>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, s, launched);
    case 64: return bwd<64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, s, launched);
    case 128: return bwd<128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, s, launched);
    case 256: return bwd<256>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, p, s, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
