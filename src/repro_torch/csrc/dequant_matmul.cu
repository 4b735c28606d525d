// Fused bitplane-dequant matmul: out = x @ (decode(planes) * scale).
//
// Replaces the TPU kernel dequant_matmul_pallas
// (src/repro/kernels/dequant_matmul/kernel.py, bodies _decode_tile and
// _dq_matmul_kernel).
//
// What it computes: x [M, K] f32, planes [nbits, K, N/32] int32 (the
// "bitplane2d" layout: bit b of the StorageFormat code of weight (k, n)
// is bit n % 32 of planes[b, k, n / 32]), scale an f32 scalar read from
// device memory -> out [M, N] f32.  Each code is rebuilt from its nbits
// plane bits and decoded by bit assembly,
//   sign << 31 | (exp - bias + 127) << 23 | frac << (23 - w_f),
// with code 0 decoding to +0; the decoded weight is multiplied by scale
// element by element (as _decode_tile does) before the product.  Every
// output is one f32 FMA chain over k = 0 .. K-1 in order, so the result
// does not depend on the tile configuration.  The multiply and the FMAs
// flush subnormals to zero (PTX .ftz), as the reference's platforms do
// (the TPU has no subnormals; XLA on the CPU runs flush-to-zero), so a
// decoded weight equals quant.dequantize's bit for bit.
//
// What bounds it on the H100: at a prefill's M (hundreds of rows) the
// 2*M*K*N f32 operations, against 67 TFLOP/s of FMA without tensor
// cores (TF32 would break the reference's 1e-5 tolerance, so none are
// used); at a decode step's M (a few rows) the plane bytes, nbits/8 per
// weight, against 3.35 TB/s, and in practice the decode itself, which
// costs a few dozen integer operations per weight and is repeated by
// every row tile.
//
// Design: each block owns a [BM, BN] output tile and loops over K in
// tiles of BK.  Per K tile it stages the [nbits, BK, BN/32] plane words
// and the [BM, BK] tile of x (transposed, odd pitch) in shared memory,
// decodes the planes in shared memory into a [BK, BN] f32 weight tile
// (one thread rebuilds one code from nbits words with shifts and masks),
// then each thread accumulates a TM x TN register tile with f32 FMAs.
// Out-of-range rows, columns and K positions are masked here: x reads
// as 0 and planes as code 0, which adds exactly +0 to every sum.
// Two instantiations: a 64x64 tile for many rows and an 8x32 tile, with
// more blocks along N, for up to 64 rows (the wrapper's SMALL_M).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANE = 32;
constexpr int MAX_NBITS = 16;

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
dequant_matmul_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ planes,
                      const float* __restrict__ scale_ptr,
                      float* __restrict__ out, int M, int K, int N,
                      int nbits, int w_e, int w_f) {
  constexpr int NTX = BN / TN;
  constexpr int NT = (BM / TM) * NTX;
  constexpr int BW = BN / LANE;          // plane words of one K row
  __shared__ int32_t ps[MAX_NBITS][BK][BW];
  __shared__ float xs[BK][BM + 1];       // odd pitch: conflict-free stores
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX, ty = tid / NTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Nw = N / LANE, w0 = n0 / LANE;
  const float scale = *scale_ptr;
  const uint32_t fmask = (1u << w_f) - 1u, emask = (1u << w_e) - 1u;
  const int bias = (1 << (w_e - 1)) - 1;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < nbits * BK * BW; e += NT) {
      const int b = e / (BK * BW), r = e % (BK * BW);
      const int k = r / BW, w = r % BW;
      ps[b][k][w] = (k0 + k < K && w0 + w < Nw)
                        ? planes[((size_t)b * K + k0 + k) * Nw + w0 + w]
                        : 0;
    }
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, k = e % BK;
      xs[k][m] = (m0 + m < M && k0 + k < K)
                     ? x[(size_t)(m0 + m) * K + k0 + k]
                     : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, n = e % BN;
      const int w = n / LANE, j = n % LANE;
      uint32_t code = 0;
      for (int b = 0; b < nbits; ++b)
        code |= (((uint32_t)ps[b][k][w] >> j) & 1u) << b;
      const uint32_t frac = code & fmask;
      const uint32_t exp = (code >> w_f) & emask;
      const uint32_t sign = (code >> (w_e + w_f)) & 1u;
      const uint32_t e8 = (uint32_t)((int)exp - bias + 127);
      const uint32_t bits = (sign << 31) | (e8 << 23) | (frac << (23 - w_f));
      const float val = code == 0 ? 0.0f : __uint_as_float(bits);
      ws[k][n] = mul_ftz(val, scale);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fma_ftz(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const int32_t* planes, const float* scale,
            float* out, int M, int K, int N, int nbits, int w_e, int w_f,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_matmul_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, planes, scale, out, M,
                                                   K, N, nbits, w_e, w_f);
}

}  // namespace

// tile 0: 64x64 output tile, K tiles of 32, 4x4 outputs a thread.
// tile 1: 8x32 output tile, K tiles of 64, one output a thread.
// Returns cudaGetLastError() after the launch; a bad argument returns
// cudaErrorInvalidValue without launching.
extern "C" int dequant_matmul_launch(const float* x, const int32_t* planes,
                                     const float* scale, float* out, int M,
                                     int K, int N, int nbits, int w_e,
                                     int w_f, int tile, void* stream) {
  if (M < 1 || K < 0 || N < LANE || N % LANE != 0 || nbits < 1 ||
      nbits > MAX_NBITS || nbits != 1 + w_e + w_f || w_e < 1 || w_f > 23)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0)
    launch<64, 64, 32, 4, 4>(x, planes, scale, out, M, K, N, nbits, w_e, w_f,
                             s);
  else if (tile == 1)
    launch<8, 32, 64, 1, 1>(x, planes, scale, out, M, K, N, nbits, w_e, w_f,
                            s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
