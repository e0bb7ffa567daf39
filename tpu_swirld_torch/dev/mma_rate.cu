// mma_rate: the throughput of two warp-level tensor-core products on this
// card, from registers: the measurement that chose the binary route of
// ssm_block.cu and ssm_matrix.cu, and the .b1 peak behind chip_smoke.py's
// bounds (run by mma_rate.py beside it; not part of the port's build):
//
//   route 0: mma.sync m16n8k256 .b1 AND-popc (a 0/1 AND-product a bit)
//   route 1: mma.sync m16n8k32 .s8
//
// Every warp of the grid keeps CHAINS independent accumulators in flight and
// runs `iters` rounds of CHAINS products; the sums are written out so no
// product is dead.  One product is 16 * 8 * 256 (b1) or 16 * 8 * 32 (s8)
// multiply-adds; the caller times the launch.
//
// Plain C interface (bound with ctypes): mma_rate_launch returns the
// cudaError_t of the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bits.cuh"

namespace {

// m16n8k32 .s8: c[r][j] += sum over 32 bytes of k of a_row[k] * b_col[k]
// (the fragment layout of mma_bits.cuh).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int CHAINS = 8;

template <int ROUTE>
__global__ void rate(const uint32_t* __restrict__ in, int iters,
                     int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = in[(lane + 32 * i) & 127];
  b[0] = in[lane ^ 5];
  b[1] = in[(lane ^ 9) + 32];
  int c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch) {
      if (ROUTE == 0)
        mma_b1_and_popc(c[ch], a, b);
      else
        mma_s8(c[ch], a, b);
    }
  }
  int s = 0;
#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch) s += c[ch][0] + c[ch][1] + c[ch][2] + c[ch][3];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int mma_rate_launch(int route, const void* in, int iters,
                               int blocks, int threads, void* out,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0)
    rate<0><<<blocks, threads, 0, s>>>((const uint32_t*)in, iters, (int*)out);
  else
    rate<1><<<blocks, threads, 0, s>>>((const uint32_t*)in, iters, (int*)out);
  return (int)cudaGetLastError();
}
