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
// with code 0 decoding to +0 and subnormals flushed to zero (PTX .ftz),
// as the reference's platforms do (the TPU has no subnormals; XLA on
// the CPU runs flush-to-zero).  Two routes, chosen by format:
//
// Tensor-core route (w_f <= 10, w_e <= 8: every HOBFLOPS storage format
// of the paper).  A decoded code has w_f + 1 significant bits and an
// 8-bit exponent, so it is exact in TF32.  The kernel computes
// out^T = codes^T x^T with wgmma: the decoded [64 (N), 32 (K)] code tile
// is the A operand, the rows of x are B's columns (n = 8 ... 64), so
// a decode step's few rows waste at most 7 of 8 columns.  x is split
// once, by a first small kernel, into two TF32 halves
// x_hi = tf32(x), x_lo = tf32(x - x_hi) (round to nearest; the dropped
// bits cost about 2^-22 |x| |W| in all), laid out in the 128-byte
// swizzled rows wgmma reads, so each stage's B tiles arrive by one
// cp.async.bulk each.  Two MMAs (hi, lo) a k step accumulate in f32;
// scale is applied once in the epilogue (mul.rn.ftz).  K is cut into
// chunks of KCHUNK that depend on K alone; each chunk starts from a
// zero accumulator and the chunk sums are added in chunk order
// (add.rn.ftz), either by the block that walks every chunk (many rows)
// or, when each block owns one chunk (few rows: more blocks along K),
// by a last small kernel over the partial sums.  Every output is
// therefore summed in an order that depends on K alone, whatever the
// row count, n width or split.
//
//   Block: 384 threads.  Warpgroup 0 issues the wgmmas and fetches the
//   x tiles by cp.async.bulk.  Warpgroups 1 and 2 decode alternate K
//   tiles, each staging the plane words of its tile i + RAW - 1 with
//   cp.async (zero filled past K and N) while it decodes its tile i
//   into A's swizzled layout, in a ring of STAGES (A, B_hi, B_lo)
//   tiles: full/empty mbarriers, the B tiles' bytes counted on the full
//   barrier.  A tile's decode waits on its own latency (plane loads,
//   barriers), so two in flight nearly double the decode rate.
//
// FMA route (w_f > 10: a code no longer fits TF32).  Each block owns a
// 64x64 output tile, decodes [32, 64] weight tiles (times scale) in
// shared memory and accumulates f32 FMAs over k in order.
//
// What bounds it on the H100: the function needs two TF32 products at
// 495 TFLOP/s, each weight decoded once (2 nbits + 6 integer operations)
// at 16.7 Tops/s, and the plane and x bytes at 3.35 TB/s.  This kernel
// decodes each weight once per row tile, so at a prefill's M its decode
// is several times the function's; two decoding warpgroups a block and
// the K split (few rows) spread it over the SMs.  A tile's decode is
// bound about equally by its integer issue (the per-bit funnel shifts
// and LOP3s) and by its serial steps (plane-word wait, barriers, proxy
// fence): PERF.md.

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
dequant_fma_kernel(const float* __restrict__ x,
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
void launch_fma(const float* x, const int32_t* planes, const float* scale,
            float* out, int M, int K, int N, int nbits, int w_e, int w_f,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_fma_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, planes, scale, out, M,
                                                   K, N, nbits, w_e, w_f);
}


__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------
constexpr int TC_BN = 64;            // weight columns a block: wgmma's M
constexpr int TC_BK = 32;            // K a stage: one 128-byte row of f32
constexpr int KCHUNK_TILES = 8;      // K chunk = 256: fixed by K alone
constexpr int STAGES = 4;            // (A, B_hi, B_lo) ring
constexpr int RAW = 3;               // plane-word ring (cp.async)
constexpr int RAW_WORDS = MAX_NBITS * 2 * TC_BK;   // [nbits][2 words][BK]
constexpr int A_FLOATS = TC_BN * TC_BK;
constexpr int NPROD = 2;             // decoding warpgroups a block
constexpr int TC_THREADS = 128 * (1 + NPROD);
constexpr int WPT = A_FLOATS / 128;  // weights a decoder decodes a tile

__host__ __device__ constexpr size_t tc_smem_bytes(int nw) {
  return 1024 + (size_t)STAGES * 4 * (A_FLOATS + 2 * nw * TC_BK) +
         (size_t)NPROD * RAW * 4 * RAW_WORDS + 2 * STAGES * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
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

// Named barrier 1 + g over decoding warpgroup g alone (immediate ids:
// a register id would reserve all 16 barriers of the SM).
__device__ __forceinline__ void producer_sync(int g) {
  static_assert(NPROD == 2, "one named barrier a decoding warpgroup");
  if (g == 0)
    asm volatile("bar.sync 1, 128;" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;" ::: "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), tile base 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Index of float k (0..31) of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int sw128(int r, int k) {
  return r * TC_BK + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

template <int NW>
struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int NREG>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x [M, K] -> xs [2][Kt][Mp][32]: the TF32 halves (hi, then lo), zero
// past M and K, each 128-byte row's 16-byte chunks swizzled by row as
// wgmma reads them.  One thread a 16-byte chunk.
__global__ void split_x_kernel(const float* __restrict__ x,
                               float* __restrict__ xs, int M, int K, int Mp,
                               int Kt) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)Kt * Mp * 8;
  if (idx >= total) return;
  const int c = (int)(idx & 7);
  const size_t rest = idx >> 3;
  const int m = (int)(rest % Mp);
  const int kt = (int)(rest / Mp);
  float4 hi, lo;
  float* h = &hi.x;
  float* l = &lo.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kt * TC_BK + c * 4 + j;
    const float v =
        (m < M && k < K) ? mul_ftz(x[(size_t)m * K + k], 1.0f) : 0.0f;
    h[j] = tf32_rna(v);
    l[j] = tf32_rna(sub_ftz(v, h[j]));
  }
  const size_t dst = ((size_t)kt * Mp + m) * TC_BK + ((c ^ (m & 7)) << 2);
  *reinterpret_cast<float4*>(xs + dst) = hi;
  *reinterpret_cast<float4*>(xs + total * 4 + dst) = lo;
}

// out = scale * (part[0] + part[1] + ...), the chunk sums in order.
__global__ void chunk_sum_kernel(const float* __restrict__ part,
                                 const float* __restrict__ scale_ptr,
                                 float* __restrict__ out, size_t MN,
                                 int nchunks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = part[i];
  for (int z = 1; z < nchunks; ++z) s = add_ftz(s, part[(size_t)z * MN + i]);
  out[i] = mul_ftz(s, *scale_ptr);
}

template <int NW>
__global__ void __launch_bounds__(TC_THREADS, NW <= 32 ? 2 : 1)
dequant_tc_kernel(const int32_t* __restrict__ planes,
                  const float* __restrict__ xs,
                  const float* __restrict__ scale_ptr,
                  float* __restrict__ out, float* __restrict__ part, int M,
                  int K, int N, int Mp, int Kt, int nbits, int w_e, int w_f,
                  int split) {
  constexpr int NREG = NW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* As = reinterpret_cast<float*>(base);
  float* Bh = As + STAGES * A_FLOATS;
  float* Bl = Bh + STAGES * NW * TC_BK;
  uint32_t* raw = reinterpret_cast<uint32_t*>(Bl + STAGES * NW * TC_BK);
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + NPROD * RAW * RAW_WORDS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * NW;
  const int nchunks = (Kt + KCHUNK_TILES - 1) / KCHUNK_TILES;
  const int c_begin = split ? (int)blockIdx.z : 0;
  const int kt_begin = c_begin * KCHUNK_TILES;
  const int kt_end = split ? min(kt_begin + KCHUNK_TILES, Kt) : Kt;
  const int T = kt_end - kt_begin;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);   // a warpgroup's decoders + x's bytes
      mbar_init(&empty[s], 128);      // wgmma threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- warpgroup 0: wgmma over the ring, chunk sums, epilogue ------
    // Thread 0 fetches tile t's x halves into slot t % STAGES by
    // cp.async.bulk, counted on the slot's full barrier: the first
    // STAGES up front, then each as the wgmma of the slot's last tile
    // has finished reading it.
    const size_t xs_lo = (size_t)Kt * Mp * TC_BK;
    auto fetch_x = [&](int t) {
      if (tid == 0 && t < T) {
        const int s = t % STAGES;
        const size_t off = ((size_t)(kt_begin + t) * Mp + m0) * TC_BK;
        mbar_arrive_expect_tx(&full[s], 2 * NW * TC_BK * 4);
        bulk_copy(Bh + s * NW * TC_BK, xs + off, NW * TC_BK * 4, &full[s]);
        bulk_copy(Bl + s * NW * TC_BK, xs + xs_lo + off, NW * TC_BK * 4,
                  &full[s]);
      }
    };
    for (int t = 0; t < STAGES; ++t) fetch_x(t);
    float acc[NREG], total[NREG];
#pragma unroll
    for (int i = 0; i < NREG; ++i) total[i] = 0.0f;
    for (int t = 0; t < T; ++t) {
      const int kt = kt_begin + t;
      if (kt % KCHUNK_TILES == 0) {
#pragma unroll
        for (int i = 0; i < NREG; ++i) acc[i] = 0.0f;
      }
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      fence_regs<NREG>(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      const uint64_t da = sw128_desc(As + s * A_FLOATS);
      const uint64_t dh = sw128_desc(Bh + s * NW * TC_BK);
      const uint64_t dl = sw128_desc(Bl + s * NW * TC_BK);
#pragma unroll
      for (int ks = 0; ks < TC_BK / 8; ++ks) {
        Wgmma<NW>::run(acc, da + 2 * ks, dh + 2 * ks);
        Wgmma<NW>::run(acc, da + 2 * ks, dl + 2 * ks);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs<NREG>(acc);
      mbar_arrive(&empty[s]);
      fetch_x(t + STAGES);
      if ((kt + 1) % KCHUNK_TILES == 0 || kt + 1 == kt_end) {
        if (kt / KCHUNK_TILES == c_begin) {
#pragma unroll
          for (int i = 0; i < NREG; ++i) total[i] = acc[i];
        } else {
#pragma unroll
          for (int i = 0; i < NREG; ++i) total[i] = add_ftz(total[i], acc[i]);
        }
      }
    }
    const float scale = *scale_ptr;
    const bool partial = split && nchunks > 1;
    float* dst = partial ? part + (size_t)blockIdx.z * M * N : out;
    const int warp = tid >> 5, lane = tid & 31;
    const int row0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < NREG; ++i) {
      const int n = n0 + row0 + ((i & 2) ? 8 : 0);
      const int m = m0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      if (n < N && m < M)
        dst[(size_t)m * N + n] = partial ? total[i] : mul_ftz(total[i], scale);
    }
  } else {
    // ---- warpgroups 1..NPROD: group g stages and decodes the tiles
    // t = g, g + NPROD, ... (its own plane-word ring and barrier), so
    // NPROD tiles decode at once --------------------------------------
    const int g = (tid - 128) / 128, ptid = (tid - 128) % 128;
    const int kk = ptid & 31, q = ptid >> 5;
    const int wsel = q >> 1, jb = (q & 1) * WPT;
    const int Nw = N / LANE, w0 = n0 / LANE;
    const int sh = 23 - w_f;                           // frac's float shift
    const uint32_t ebias = (uint32_t)(127 - ((1 << (w_e - 1)) - 1)) << 23;
    uint32_t* ring = raw + g * RAW * RAW_WORDS;
    // Thread ptid copies word (ptid & 1) of K row (ptid >> 1) & 31 of
    // planes ptid >> 6, ptid >> 6 + 2, ...: one cp.async of 4 bytes
    // each, its address advanced by constants.
    const int ck = (ptid >> 1) & 31, cw = ptid & 1, cb = ptid >> 6;
    const bool w_ok = w0 + cw < Nw;
    const size_t plane_step = (size_t)2 * K * Nw;
    const int32_t* src0 =
        planes + ((size_t)cb * K + kt_begin * TC_BK + ck) * Nw + w0 + cw;
    const int dst0 = cb * 64 + cw * 32 + ck;
    const int Tg = (T - g + NPROD - 1) / NPROD;      // this group's tiles
    auto issue = [&](int i) {                         // group tile i
      if (i < Tg) {
        const int t = g + NPROD * i;
        const bool ok = w_ok && (kt_begin + t) * TC_BK + ck < K;
        const int32_t* src = src0 + (size_t)t * TC_BK * Nw;
        uint32_t* dst = ring + (i % RAW) * RAW_WORDS + dst0;
        for (int b = cb; b < nbits; b += 2, src += plane_step, dst += 128)
          cp_async4(dst, ok ? src : planes, ok);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < RAW - 1; ++i) issue(i);
    for (int i = 0; i < Tg; ++i) {
      const int t = g + NPROD * i;
      cp_async_wait<RAW - 2>();
      producer_sync(g);         // tile t landed; the group left its last
      issue(i + RAW - 1);
      const int s = t % STAGES;
      mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
      // Gather the WPT codes of (k = kk, n = wsel*32 + jb + j) straight
      // into float bit positions: frac and exp at sh.., sign at 31.
      const uint32_t* rw = ring + (i % RAW) * RAW_WORDS + wsel * 32 + kk;
      uint32_t v[WPT];
#pragma unroll
      for (int j = 0; j < WPT; ++j) v[j] = 0u;
#pragma unroll
      for (int b = 0; b < MAX_NBITS; ++b) {
        if (b >= nbits) break;
        const uint32_t P = rw[b * 64];
        const int pb = b == nbits - 1 ? 31 : b + sh;
        const uint32_t Pr = __funnelshift_l(P, P, pb - jb);
        const uint32_t mask = 1u << pb;
#pragma unroll
        for (int j = 0; j < WPT; ++j) v[j] |= __funnelshift_r(Pr, Pr, j) & mask;
      }
      float* a = As + s * A_FLOATS;
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        uint32_t bits = v[j] + ebias;
        if ((bits & 0x7F800000u) == 0u) bits &= 0x80000000u;   // subnormal
        if (v[j] == 0u) bits = 0u;                              // code 0
        a[sw128(wsel * 32 + jb + j, kk)] = __uint_as_float(bits);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&full[s]);
    }
  }
}

template <int NW>
int launch_tc(const int32_t* planes, const float* xs, const float* scale,
              float* out, float* part, int M, int K, int N, int Mp, int Kt,
              int nbits, int w_e, int w_f, int split, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes(NW);
  cudaError_t err = cudaFuncSetAttribute(
      dequant_tc_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (Kt + KCHUNK_TILES - 1) / KCHUNK_TILES;
  const dim3 grid((N + TC_BN - 1) / TC_BN, Mp / NW, split ? nchunks : 1);
  dequant_tc_kernel<NW><<<grid, TC_THREADS, smem, stream>>>(
      planes, xs, scale, out, part, M, K, N, Mp, Kt, nbits, w_e, w_f, split);
  return (int)cudaGetLastError();
}

}  // namespace

// FMA route: 64x64 output tiles, K tiles of 32, 4x4 outputs a thread.
// Both entries return cudaGetLastError() after their launches and set
// *launched to the number of kernels they launched; a bad argument
// returns cudaErrorInvalidValue without launching.
extern "C" int dequant_matmul_launch(const float* x, const int32_t* planes,
                                     const float* scale, float* out, int M,
                                     int K, int N, int nbits, int w_e,
                                     int w_f, int* launched, void* stream) {
  *launched = 0;
  if (M < 1 || K < 0 || N < LANE || N % LANE != 0 || nbits < 1 ||
      nbits > MAX_NBITS || nbits != 1 + w_e + w_f || w_e < 1 || w_f > 23)
    return (int)cudaErrorInvalidValue;
  launch_fma<64, 64, 32, 4, 4>(x, planes, scale, out, M, K, N, nbits, w_e,
                               w_f, static_cast<cudaStream_t>(stream));
  *launched = 1;
  return (int)cudaGetLastError();
}

// Tensor-core route: n width nw (8, 16, 32 or 64 rows of x a
// block); split != 0 gives each block one K chunk.  xs holds
// 2 * Kt * Mp * 32 floats (Mp = M rounded up to nw, Kt = ceil(K / 32));
// part holds nchunks * M * N floats when split and K spans more than one
// chunk, else it is not read.
extern "C" int dequant_matmul_tc_launch(const float* x, const int32_t* planes,
                                        const float* scale, float* out,
                                        float* xs, float* part, int M, int K,
                                        int N, int nbits, int w_e, int w_f,
                                        int nw, int split, int* launched,
                                        void* stream) {
  *launched = 0;
  if (M < 1 || K < 1 || N < LANE || N % LANE != 0 || nbits < 2 ||
      nbits > MAX_NBITS || nbits != 1 + w_e + w_f || w_e < 1 || w_e > 8 ||
      w_f > 10 || (nw != 8 && nw != 16 && nw != 32 && nw != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Mp = (M + nw - 1) / nw * nw, Kt = (K + TC_BK - 1) / TC_BK;
  const int nchunks = (Kt + KCHUNK_TILES - 1) / KCHUNK_TILES;
  const size_t chunks16 = (size_t)Kt * Mp * 8;
  split_x_kernel<<<(unsigned)((chunks16 + 255) / 256), 256, 0, s>>>(
      x, xs, M, K, Mp, Kt);
  *launched = 1;
  int code;
  switch (nw) {
    case 8:
      code = launch_tc<8>(planes, xs, scale, out, part, M, K, N, Mp,
                           Kt, nbits, w_e, w_f, split, s);
      break;
    case 16:
      code = launch_tc<16>(planes, xs, scale, out, part, M, K, N, Mp,
                           Kt, nbits, w_e, w_f, split, s);
      break;
    case 32:
      code = launch_tc<32>(planes, xs, scale, out, part, M, K, N, Mp,
                           Kt, nbits, w_e, w_f, split, s);
      break;
    default:
      code = launch_tc<64>(planes, xs, scale, out, part, M, K, N, Mp,
                           Kt, nbits, w_e, w_f, split, s);
  }
  if (code != 0) return code;
  *launched = 2;
  if (split && nchunks > 1) {
    const size_t MN = (size_t)M * N;
    chunk_sum_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
        part, scale, out, MN, nchunks);
    *launched = 3;
  }
  return (int)cudaGetLastError();
}
