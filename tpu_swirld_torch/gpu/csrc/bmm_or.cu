// bmm_or: boolean OR-matmul, out[p][r] = OR_q (a[p][q] AND b[q][r]).
//
// Replaces the TPU kernel tpu_swirld/tpu/pallas_kernels.py:bmm_or_pallas
// (body _bmm_kernel): 0/1 operands in bf16 on the MXU, f32 accumulation,
// thresholded at 0.5.  Here there is no floating point at all: each row of a
// and each column of b is packed into 32-bit words along q, and an output is
// the OR of word-ANDs, exact by construction (it is an OR, not a count).
//
// What bounds it on an H100: at the pipeline's shapes the bytes.  The
// ancestry propagation hop (128 x 128) @ (128 x 10112) moves ~2.6 MB, under
// a microsecond at 3.35 TB/s, so launch overhead is what it competes with;
// the forkseen hop (10112 x 4517) @ (4517 x 64) reads 46 MB of a.  The design
// reads each input byte once (the two pack kernels), turns 32 products into
// one AND of words, and writes each output byte once, coalesced.  Any shape
// P, Q, R >= 1 is taken: the kernels mask ragged edges themselves.
//
// Plain C interface (bound with ctypes): bmm_or_launch returns the
// cudaError_t of the launches, 0 on success.  Launches on the caller's
// stream, allocates nothing (the caller passes the packed-word scratch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;     // output tile edge, rows and columns
constexpr int EDGE = 16;     // threads per tile edge; each owns 4 x 4 outputs
constexpr int TW = 16;       // packed words staged in shared memory per step
constexpr int PACK_THREADS = 256;

// words[r][w], bit b = x[r][32w + b] != 0, for a row-major x[rows][len].
__global__ void pack_rows(const uint8_t* __restrict__ x,
                          uint32_t* __restrict__ words, int rows, int len,
                          int nw) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * nw) return;
  int r = (int)(idx / nw);
  int w = (int)(idx % nw);
  const uint8_t* row = x + (size_t)r * len;
  int q0 = w * 32;
  int qn = min(32, len - q0);
  uint32_t word = 0;
  for (int b = 0; b < qn; ++b) word |= (uint32_t)(row[q0 + b] != 0) << b;
  words[idx] = word;
}

// words[c][w], bit b = x[32w + b][c] != 0, for a row-major x[len][cols].
// Neighbouring threads take neighbouring columns: each load is coalesced.
__global__ void pack_cols(const uint8_t* __restrict__ x,
                          uint32_t* __restrict__ words, int len, int cols,
                          int nw) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)cols * nw) return;
  int w = (int)(idx / cols);
  int c = (int)(idx % cols);
  int q0 = w * 32;
  int qn = min(32, len - q0);
  uint32_t word = 0;
  for (int b = 0; b < qn; ++b)
    word |= (uint32_t)(x[(size_t)(q0 + b) * cols + c] != 0) << b;
  words[(size_t)c * nw + w] = word;
}

// One 64 x 64 output tile per block: both operands' packed words are staged
// through shared memory TW words at a time; thread (tx, ty) owns rows
// ty + 16 i and columns tx + 16 j (the +1 row pad keeps the b reads on
// distinct banks).
__global__ void or_and_tile(const uint32_t* __restrict__ a_bits,
                            const uint32_t* __restrict__ b_bits,
                            uint8_t* __restrict__ out, int P, int R, int nw) {
  __shared__ uint32_t as[TILE][TW + 1];
  __shared__ uint32_t bs[TILE][TW + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * EDGE + tx;
  const int p0 = blockIdx.y * TILE, r0 = blockIdx.x * TILE;
  uint32_t acc[4][4] = {};
  for (int w0 = 0; w0 < nw; w0 += TW) {
    const int tw = min(TW, nw - w0);
    for (int e = tid; e < TILE * tw; e += EDGE * EDGE) {
      const int row = e / tw, w = e % tw;
      const int p = p0 + row, r = r0 + row;
      as[row][w] = p < P ? a_bits[(size_t)p * nw + w0 + w] : 0u;
      bs[row][w] = r < R ? b_bits[(size_t)r * nw + w0 + w] : 0u;
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
        for (int j = 0; j < 4; ++j) acc[i][j] |= av[i] & bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + EDGE * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx + EDGE * j;
      if (r < R) out[(size_t)p * R + r] = acc[i][j] != 0u;
    }
  }
}

int blocks_for(long long n) { return (int)((n + PACK_THREADS - 1) / PACK_THREADS); }

}  // namespace

extern "C" int bmm_or_launch(const void* a, const void* b, void* out,
                             void* a_bits, void* b_bits, int P, int Q, int R,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = (Q + 31) / 32;
  pack_rows<<<blocks_for((long long)P * nw), PACK_THREADS, 0, s>>>(
      (const uint8_t*)a, (uint32_t*)a_bits, P, Q, nw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pack_cols<<<blocks_for((long long)R * nw), PACK_THREADS, 0, s>>>(
      (const uint8_t*)b, (uint32_t*)b_bits, Q, R, nw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + TILE - 1) / TILE, (P + TILE - 1) / TILE);
  dim3 block(EDGE, EDGE);
  or_and_tile<<<grid, block, 0, s>>>((const uint32_t*)a_bits,
                                     (const uint32_t*)b_bits, (uint8_t*)out,
                                     P, R, nw);
  return (int)cudaGetLastError();
}
