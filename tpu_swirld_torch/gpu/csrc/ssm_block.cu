// ssm_block: the strongly-sees block for rows [row0, row0 + rows) x the
// column events cols, gathered from the sees slab through the member table:
//
//   out[i][j] = col_valid[j] AND 3 * sum_m stake[m] * hit_m(i, j) > 2 * tot
//   hit_m(i, j) = exists k: mt[m][k] >= 0 AND sees[row0 + i][mt[m][k]]
//                                         AND sees[mt[m][k]][cols[j]]
//
// with every index clipped to [0, n) before a gather, as the reference
// clips it.  Replaces the TPU kernel tpu_swirld/tpu/pallas_kernels.py:
// ssm_block_pallas (body _ssm_kernel): there a (rows/Tm, C/Tn, M) grid runs
// in order with the member axis innermost and carries the int32 tally across
// grid steps in VMEM scratch.  Hopper blocks run in parallel and carry
// nothing between them, so here each block owns one 64 x 64 output tile and
// loops over ALL members itself, with the int32 tally in registers; the
// thresholded bool tile is written once.
//
// What bounds it on an H100: the bytes of the a-side gather.  Every output
// row reads one sees row through the whole member table (rows x M*K bytes,
// ~115 MB at rows = 10112, M*K = 11392), while the products are only ~7.4e9
// AND-products, a few microseconds of tensor-core time.  The design gathers
// each needed sees byte once into bit-packed operands (a_bits[rows][M][KW],
// b_bits[C][M][KW], KW = ceil(K / 32)), consecutive threads reading within
// one sees row, so hit_m is an OR over KW word-ANDs.
//
// Plain C interface (bound with ctypes): ssm_block_launch returns the
// cudaError_t of the launches, 0 on success.  Launches on the caller's
// stream, allocates nothing (the caller passes the packed-word scratch).
// The caller clamps row0 to [0, n - rows].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;     // output tile edge, rows and columns
constexpr int EDGE = 16;     // threads per tile edge; each owns 4 x 4 outputs
constexpr int TW = 16;       // packed words staged in shared memory per step
constexpr int PACK_THREADS = 256;

// a_bits[i][m][w], bit b: k = 32w + b < K, e = mt[m][k] >= 0 and
// sees[row0 + i][min(e, n - 1)].
__global__ void pack_a(const uint8_t* __restrict__ sees, int n,
                       const int* __restrict__ mt, int M, int K, int nw,
                       int row0, int rows, uint32_t* __restrict__ a_bits) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_row = (long long)M * nw;
  if (idx >= (long long)rows * per_row) return;
  const int i = (int)(idx / per_row);
  const int rem = (int)(idx % per_row);
  const int m = rem / nw, w = rem % nw;
  const uint8_t* srow = sees + (size_t)(row0 + i) * n;
  const int* mrow = mt + (size_t)m * K;
  const int k0 = w * 32;
  const int kn = min(32, K - k0);
  uint32_t word = 0;
  for (int b = 0; b < kn; ++b) {
    const int e = mrow[k0 + b];
    if (e >= 0 && srow[min(e, n - 1)]) word |= 1u << b;
  }
  a_bits[idx] = word;
}

// b_bits[j][m][w], bit b: k = 32w + b < K, e = mt[m][k] >= 0, cols[j] >= 0
// and sees[min(e, n - 1)][min(cols[j], n - 1)].
__global__ void pack_b(const uint8_t* __restrict__ sees, int n,
                       const int* __restrict__ mt, int M, int K, int nw,
                       const int* __restrict__ cols, int C,
                       uint32_t* __restrict__ b_bits) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_col = (long long)M * nw;
  if (idx >= (long long)C * per_col) return;
  const int j = (int)(idx / per_col);
  const int rem = (int)(idx % per_col);
  const int m = rem / nw, w = rem % nw;
  const int c = cols[j];
  uint32_t word = 0;
  if (c >= 0) {
    const int cc = min(c, n - 1);
    const int* mrow = mt + (size_t)m * K;
    const int k0 = w * 32;
    const int kn = min(32, K - k0);
    for (int b = 0; b < kn; ++b) {
      const int e = mrow[k0 + b];
      if (e >= 0 && sees[(size_t)min(e, n - 1) * n + cc]) word |= 1u << b;
    }
  }
  b_bits[idx] = word;
}

// One 64 x 64 output tile per block, the member loop inside: per member the
// tile's packed words are staged through shared memory, hit_m is an OR of
// word-ANDs, and the int32 stake tally stays in registers.  Thread (tx, ty)
// owns rows ty + 16 i and columns tx + 16 j.
__global__ void ssm_tile(const uint32_t* __restrict__ a_bits,
                         const uint32_t* __restrict__ b_bits,
                         const int* __restrict__ stake,
                         const int* __restrict__ cols, int M, int nw,
                         int rows, int C, long long tot2,
                         uint8_t* __restrict__ out) {
  __shared__ uint32_t as[TILE][TW + 1];
  __shared__ uint32_t bs[TILE][TW + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * EDGE + tx;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  int acc[4][4] = {};
  for (int m = 0; m < M; ++m) {
    uint32_t hit[4][4] = {};
    for (int w0 = 0; w0 < nw; w0 += TW) {
      const int tw = min(TW, nw - w0);
      for (int e = tid; e < TILE * tw; e += EDGE * EDGE) {
        const int row = e / tw, w = e % tw;
        const int i = i0 + row, j = j0 + row;
        as[row][w] =
            i < rows ? a_bits[((size_t)i * M + m) * nw + w0 + w] : 0u;
        bs[row][w] = j < C ? b_bits[((size_t)j * M + m) * nw + w0 + w] : 0u;
      }
      __syncthreads();
      for (int w = 0; w < tw; ++w) {
        uint32_t av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[ty + EDGE * i][w];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[tx + EDGE * j][w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hit[i][j] |= av[i] & bv[j];
      }
      __syncthreads();
    }
    const int s = stake[m];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += hit[i][j] != 0u ? s : 0;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty + EDGE * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx + EDGE * j;
      if (c < C)
        out[(size_t)r * C + c] = cols[c] >= 0 && 3LL * acc[i][j] > tot2;
    }
  }
}

int blocks_for(long long n) { return (int)((n + PACK_THREADS - 1) / PACK_THREADS); }

}  // namespace

extern "C" int ssm_block_launch(const void* sees, int n, const void* mt,
                                int M, int K, const void* stake,
                                const void* cols, int C, int row0, int rows,
                                long long tot_stake, void* a_bits,
                                void* b_bits, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = (K + 31) / 32;
  pack_a<<<blocks_for((long long)rows * M * nw), PACK_THREADS, 0, s>>>(
      (const uint8_t*)sees, n, (const int*)mt, M, K, nw, row0, rows,
      (uint32_t*)a_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pack_b<<<blocks_for((long long)C * M * nw), PACK_THREADS, 0, s>>>(
      (const uint8_t*)sees, n, (const int*)mt, M, K, nw, (const int*)cols, C,
      (uint32_t*)b_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
  dim3 block(EDGE, EDGE);
  ssm_tile<<<grid, block, 0, s>>>((const uint32_t*)a_bits,
                                  (const uint32_t*)b_bits, (const int*)stake,
                                  (const int*)cols, M, nw, rows, C,
                                  2LL * tot_stake, (uint8_t*)out);
  return (int)cudaGetLastError();
}
