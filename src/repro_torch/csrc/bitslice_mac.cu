// Bitslice-parallel HOBFLOPS MAC (GEMM form) as a netlist interpreter.
//
// Replaces the TPU kernel bitslice_mac_pallas
// (src/repro/kernels/bitslice_mac/kernel.py, body _mac_kernel).
//
// What it computes: out[NOUT, P, Mw] int32 bit planes of
//   O[p, 32*w + j] = fold_c add(mul(I[p, c], W[c, 32*w + j]), acc),  acc0 = +0
// folding the C input channels in channel order through a k-step MAC
// chain netlist.  i_masks [P, C, NIN] holds each IFM bit broadcast to a
// 0/-1 word; w_planes [C, NIN, Mw] holds the weights bitsliced along M.
//
// The netlist arrives as an instruction stream built from the
// register-allocated schedule (_slot_schedule): one int4 per gate,
//   x = op | truth_table << 4 | dst_slot << 12,  y/z/w = source slots,
// where a source of -1 reads the all-zero word and -2 the all-ones word.
// An INPUT instruction loads bus bit y: [0, k*NIN) weight planes of
// chain step y / NIN, [k*NIN, 2k*NIN) IFM masks, then the accumulator.
// One build serves every format, chain depth, rounding and cell library.
//
// What bounds it on the H100: 32-bit logic issue.  Every gate is one or
// a few integer ops per 32 lanes; bytes are negligible beside them
// (i_masks is read once per output-word column block).  The design
// keeps the per-thread slot file and the accumulator in shared memory
// (conflict-free: slot s of thread t lives at s * nthreads + t), stages
// a C tile of weights and IFM masks in shared memory once per block,
// and reads each instruction with a warp-uniform load.  Interpreting
// costs a decode, operand loads and a store per gate; the generated
// straight-line kernel (fused_mac.cuh) removes that overhead.
//
// Thread mapping: each thread owns one (row p, lane word w).  The C
// reduction is a loop inside the block, so blocks are independent and
// the ragged P, Mw and C edges are masked here (out-of-range operands
// read as +0, the MAC identity).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum : int {
  OPI_INPUT = 1, OPI_NOT = 2, OPI_AND = 3, OPI_OR = 4, OPI_XOR = 5,
  OPI_ANDN = 6, OPI_MUX = 7, OPI_LUT3 = 8,
};

__device__ __forceinline__ uint32_t lut3(uint32_t tt, uint32_t a, uint32_t b,
                                         uint32_t c) {
  // Minterm m of the truth table is the input combination a + 2b + 4c.
  uint32_t v = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const uint32_t t = ((m & 1) ? a : ~a) & ((m & 2) ? b : ~b) &
                       ((m & 4) ? c : ~c);
    v |= ((tt >> m) & 1u) ? t : 0u;
  }
  return v;
}

__global__ void bitslice_mac_kernel(
    const int32_t* __restrict__ i_masks, const int32_t* __restrict__ w_planes,
    int32_t* __restrict__ out, const int4* __restrict__ prog, int n_instr,
    const int32_t* __restrict__ out_desc, int nslots, int nin, int nout,
    int k, int P, int C, int Mw, int ct) {
  extern __shared__ uint32_t smem[];
  const int tw = blockDim.x, tp = blockDim.y;
  const int nthr = tw * tp;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tw + tx;
  const int w0 = blockIdx.x * tw, p0 = blockIdx.y * tp;
  const int pitch = ct * nin + 1;            // odd: conflict-free rows
  uint32_t* wsm = smem;                      // [tw][pitch]
  uint32_t* ism = wsm + tw * pitch;          // [tp][pitch]
  uint32_t* file = ism + tp * pitch;         // [nslots + nout][nthr]
  uint32_t* accf = file + nslots * nthr;
  const int kn = k * nin;

  for (int b = 0; b < nout; ++b) accf[b * nthr + tid] = 0u;  // +0

  for (int c0 = 0; c0 < C; c0 += ct) {
    __syncthreads();
    for (int idx = tid; idx < ct * nin * tw; idx += nthr) {
      const int t = idx % tw, cb = idx / tw;   // cb = cc * nin + b
      const int c = c0 + cb / nin, w = w0 + t;
      wsm[t * pitch + cb] = (c < C && w < Mw)
          ? (uint32_t)w_planes[((size_t)c * nin + cb % nin) * Mw + w] : 0u;
    }
    for (int idx = tid; idx < tp * ct * nin; idx += nthr) {
      const int r = idx / (ct * nin), cb = idx % (ct * nin);
      const int p = p0 + r, c = c0 + cb / nin;
      ism[r * pitch + cb] = (p < P && c < C)
          ? (uint32_t)i_masks[((size_t)p * C + c) * nin + cb % nin] : 0u;
    }
    __syncthreads();
    const int cend = min(ct, C - c0);
    for (int cc = 0; cc < cend; cc += k) {
      const uint32_t* xw = wsm + tx * pitch + cc * nin;
      const uint32_t* yi = ism + ty * pitch + cc * nin;
      for (int i = 0; i < n_instr; ++i) {
        const int4 ins = __ldg(prog + i);
        const int op = ins.x & 15;
        uint32_t v;
        if (op == OPI_INPUT) {
          const int s = ins.y;
          v = s < kn ? xw[s] : (s < 2 * kn ? yi[s - kn]
                                           : accf[(s - 2 * kn) * nthr + tid]);
        } else {
          const uint32_t a = ins.y >= 0 ? file[ins.y * nthr + tid]
                                        : (ins.y == -1 ? 0u : ~0u);
          const uint32_t b = ins.z >= 0 ? file[ins.z * nthr + tid]
                                        : (ins.z == -1 ? 0u : ~0u);
          const uint32_t c = ins.w >= 0 ? file[ins.w * nthr + tid]
                                        : (ins.w == -1 ? 0u : ~0u);
          switch (op) {
            case OPI_NOT: v = ~a; break;
            case OPI_AND: v = a & b; break;
            case OPI_OR: v = a | b; break;
            case OPI_XOR: v = a ^ b; break;
            case OPI_ANDN: v = a & ~b; break;
            case OPI_MUX: v = c ^ (a & (b ^ c)); break;
            default: v = lut3((uint32_t)(ins.x >> 4) & 255u, a, b, c); break;
          }
        }
        file[(ins.x >> 12) * nthr + tid] = v;
      }
      for (int b = 0; b < nout; ++b) {
        const int s = __ldg(out_desc + b);
        accf[b * nthr + tid] = s >= 0 ? file[s * nthr + tid]
                                      : (s == -1 ? 0u : ~0u);
      }
    }
  }
  const int p = p0 + ty, w = w0 + tx;
  if (p < P && w < Mw) {
    for (int b = 0; b < nout; ++b)
      out[((size_t)b * P + p) * Mw + w] = (int32_t)accf[b * nthr + tid];
  }
}

}  // namespace

extern "C" size_t bitslice_mac_smem_bytes(int nslots, int nin, int nout,
                                          int tp, int tw, int ct) {
  return sizeof(uint32_t) *
         ((size_t)(tw + tp) * (ct * nin + 1) +
          (size_t)(nslots + nout) * tw * tp);
}

extern "C" int bitslice_mac_launch(const int32_t* i_masks,
                                   const int32_t* w_planes, int32_t* out,
                                   const int4* prog, int n_instr,
                                   const int32_t* out_desc, int nslots,
                                   int nin, int nout, int k, int P, int C,
                                   int Mw, int tp, int tw, int ct,
                                   void* stream) {
  const size_t smem = bitslice_mac_smem_bytes(nslots, nin, nout, tp, tw, ct);
  cudaError_t err = cudaFuncSetAttribute(
      bitslice_mac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(tw, tp);
  const dim3 grid((Mw + tw - 1) / tw, (P + tp - 1) / tp);
  bitslice_mac_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      i_masks, w_planes, out, prog, n_instr, out_desc, nslots, nin, nout, k,
      P, C, Mw, ct);
  return (int)cudaGetLastError();
}
