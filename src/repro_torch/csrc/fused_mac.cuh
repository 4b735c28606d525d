// Fused bitslice-parallel HOBFLOPS MAC: the k-step MAC chain netlist as
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
// The netlist body of each (format, chain depth, extended, rounding) is
// emitted by repro_torch/core/fused_backend/emitter.py as a struct with
// a static run(x, y, acc): every register-file slot is a local
// uint32_t, every gate one C expression (3-input LUT3 cells as
// sum-of-minterms expressions that ptxas folds into one LOP3 each), and
// the accumulator a local array indexed by constants, so the whole
// chain step lives in registers.
//
// What bounds it on the H100: 32-bit logic issue (gates x rows x lane
// words x C / k), far above the bytes it moves.  The design keeps the
// chain step in registers with no decode or slot traffic, stages a C
// tile of weights and IFM masks in shared memory once per block (rows
// padded to an odd pitch so a warp's reads are conflict-free), and
// leaves the chain depth k to fused_chain_k.  No depth up to hobflops16
// k=4 spills on sm_90a; the depth is chosen from measured time over
// depth and body size (see PERF.md).

#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define HF_INLINE __device__ __forceinline__

template <class Body, bool RELU>
__global__ void fused_mac_kernel(const int32_t* __restrict__ i_masks,
                                 const int32_t* __restrict__ w_planes,
                                 int32_t* __restrict__ out, int P, int C,
                                 int Mw, int ct) {
  constexpr int NIN = Body::NIN, NOUT = Body::NOUT, K = Body::K;
  extern __shared__ uint32_t smem[];
  const int tw = blockDim.x, tp = blockDim.y;
  const int nthr = tw * tp;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tw + tx;
  const int w0 = blockIdx.x * tw, p0 = blockIdx.y * tp;
  const int pitch = ct * NIN + 1;
  uint32_t* wsm = smem;                      // [tw][pitch]
  uint32_t* ism = wsm + tw * pitch;          // [tp][pitch]

  uint32_t acc[NOUT];
#pragma unroll
  for (int b = 0; b < NOUT; ++b) acc[b] = 0u;  // +0

  for (int c0 = 0; c0 < C; c0 += ct) {
    __syncthreads();
    for (int idx = tid; idx < ct * NIN * tw; idx += nthr) {
      const int t = idx % tw, cb = idx / tw;
      const int c = c0 + cb / NIN, w = w0 + t;
      wsm[t * pitch + cb] = (c < C && w < Mw)
          ? (uint32_t)w_planes[((size_t)c * NIN + cb % NIN) * Mw + w] : 0u;
    }
    for (int idx = tid; idx < tp * ct * NIN; idx += nthr) {
      const int r = idx / (ct * NIN), cb = idx % (ct * NIN);
      const int p = p0 + r, c = c0 + cb / NIN;
      ism[r * pitch + cb] = (p < P && c < C)
          ? (uint32_t)i_masks[((size_t)p * C + c) * NIN + cb % NIN] : 0u;
    }
    __syncthreads();
    const int cend = min(ct, C - c0);
    const uint32_t* xw = wsm + tx * pitch;
    const uint32_t* yi = ism + ty * pitch;
#pragma unroll 1
    for (int cc = 0; cc < cend; cc += K)
      Body::run(xw + cc * NIN, yi + cc * NIN, acc);
  }
  if (RELU) {
    const uint32_t s = acc[Body::SIGN_OFF];
#pragma unroll
    for (int b = 0; b < NOUT; ++b) acc[b] &= ~s;
  }
  const int p = p0 + ty, w = w0 + tx;
  if (p < P && w < Mw) {
#pragma unroll
    for (int b = 0; b < NOUT; ++b)
      out[((size_t)b * P + p) * Mw + w] = (int32_t)acc[b];
  }
}

template <class Body>
size_t fused_mac_smem_bytes(int tp, int tw, int ct) {
  return sizeof(uint32_t) * (size_t)(tw + tp) * (ct * Body::NIN + 1);
}

template <class Body, bool RELU>
int fused_mac_launch_t(const int32_t* i_masks, const int32_t* w_planes,
                       int32_t* out, int P, int C, int Mw, int tp, int tw,
                       int ct, void* stream) {
  const size_t smem = fused_mac_smem_bytes<Body>(tp, tw, ct);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mac_kernel<Body, RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(tw, tp);
  const dim3 grid((Mw + tw - 1) / tw, (P + tp - 1) / tp);
  fused_mac_kernel<Body, RELU><<<grid, block, smem, (cudaStream_t)stream>>>(
      i_masks, w_planes, out, P, C, Mw, ct);
  return (int)cudaGetLastError();
}

// One C entry per (generated body, epilogue) variant.
#define HF_DEFINE_FUSED_LAUNCH(NAME, BODY, RELU)                             \
  extern "C" int NAME(const int32_t* i_masks, const int32_t* w_planes,      \
                      int32_t* out, int P, int C, int Mw, int tp, int tw,   \
                      int ct, void* stream) {                               \
    return fused_mac_launch_t<BODY, RELU>(i_masks, w_planes, out, P, C, Mw, \
                                          tp, tw, ct, stream);              \
  }
