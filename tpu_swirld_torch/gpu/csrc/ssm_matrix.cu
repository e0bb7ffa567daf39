// ssm_matrix: the full N x N strongly-sees matrix (the exists-z rule),
// gathered from the sees slab through the member table:
//
//   out[x][y] = 3 * sum_m stake[m] * hit_m(x, y) > 2 * tot
//   hit_m(x, y) = exists k: mt[m][k] >= 0 AND sees[x][mt[m][k]]
//                                        AND sees[mt[m][k]][y]
//
// with every member-table index clipped to [0, n) before a gather, as the
// reference clips it; every column is an event (no column mask).  Replaces
// the TPU kernel tpu_swirld/tpu/pallas_kernels.py:ssm_matrix_pallas (body
// _ssm_kernel): there an (N/Tm, N/Tn, M) grid runs in order with the member
// axis innermost, bf16 MXU hops, and the int32 tally carried across grid
// steps in VMEM scratch.  Hopper blocks run in parallel and carry nothing
// between them, so here each block owns one 64 x 64 output tile and loops
// over ALL members itself, with the int32 tally in registers; the
// thresholded bool tile is written once.
//
// What bounds it on an H100: the operations.  At N = 10112 and a (64, 182)
// member table the rule is N^2 * M * K = 1.2e12 AND-products; the bytes are
// ~0.3 GB (the two gathers and the N^2 bool output).  The design packs each
// operand once into 32-bit words along K, so a member hop is an OR of
// ceil(K / 32) word-ANDs:
//
//   a_bits[x][q]  (row-major, one row per event x)
//   b_t[q][y]     (one row per packed word, columns contiguous)
//
// with q = m * nw + w the flattened (member, word) index, nw = ceil(K / 32).
// The tile kernel streams q in chunks through shared memory and closes a
// member's hop every nw words, so any K is taken.  The b-side pack reads
// whole sees rows with neighbouring threads on neighbouring columns, so its
// loads are coalesced.  Every index product is taken in 64 bits.
//
// Plain C interface (bound with ctypes): ssm_matrix_launch returns the
// cudaError_t of the launches, 0 on success.  Launches on the caller's
// stream, allocates nothing (the caller passes the packed-word scratch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;     // output tile edge, rows and columns
constexpr int EDGE = 16;     // threads per tile edge; each owns 4 x 4 outputs
constexpr int CW = 32;       // packed words staged in shared memory per step
constexpr int PACK_THREADS = 256;

// a_bits[x][q], bit b: k = 32w + b < K, e = mt[m][k] >= 0 and
// sees[x][min(e, n - 1)].  Neighbouring threads gather within one sees row.
__global__ void pack_a(const uint8_t* __restrict__ sees, int n,
                       const int* __restrict__ mt, int K, int nw, int nq,
                       uint32_t* __restrict__ a_bits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * nq) return;
  const int x = (int)(idx / nq);
  const int q = (int)(idx % nq);
  const int m = q / nw, w = q % nw;
  const uint8_t* srow = sees + (size_t)x * n;
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

// b_t[q][y], bit b: k = 32w + b < K, e = mt[m][k] >= 0 and
// sees[min(e, n - 1)][y].  Neighbouring threads take neighbouring columns y
// of the same sees rows: every load and store is coalesced.
__global__ void pack_b(const uint8_t* __restrict__ sees, int n,
                       const int* __restrict__ mt, int K, int nw, int nq,
                       uint32_t* __restrict__ b_t) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nq * n) return;
  const int q = (int)(idx / n);
  const int y = (int)(idx % n);
  const int m = q / nw, w = q % nw;
  const int* mrow = mt + (size_t)m * K;
  const int k0 = w * 32;
  const int kn = min(32, K - k0);
  uint32_t word = 0;
  for (int b = 0; b < kn; ++b) {
    const int e = mrow[k0 + b];
    if (e >= 0 && sees[(size_t)min(e, n - 1) * n + y]) word |= 1u << b;
  }
  b_t[idx] = word;
}

// One 64 x 64 output tile per block.  The flattened words q are staged
// through shared memory CW at a time; hit is the OR of word-ANDs of the
// current member, folded into the int32 stake tally (registers) after its
// nw-th word.  Thread (tx, ty) owns rows ty + 16 i and columns tx + 16 j;
// the +1 row pad keeps both the staging stores and the reads on distinct
// banks.
__global__ void ssm_tile(const uint32_t* __restrict__ a_bits,
                         const uint32_t* __restrict__ b_t,
                         const int* __restrict__ stake, int n, int nw, int nq,
                         long long tot2, uint8_t* __restrict__ out) {
  __shared__ uint32_t as[TILE][CW + 1];
  __shared__ uint32_t bs[TILE][CW + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * EDGE + tx;
  const int x0 = blockIdx.y * TILE, y0 = blockIdx.x * TILE;
  int acc[4][4] = {};
  uint32_t hit[4][4] = {};
  int m = 0, w = 0;
  for (int q0 = 0; q0 < nq; q0 += CW) {
    const int cw = min(CW, nq - q0);
    for (int e = tid; e < TILE * cw; e += EDGE * EDGE) {
      const int row = e / cw, c = e % cw;        // a: along one a_bits row
      const int x = x0 + row;
      as[row][c] = x < n ? a_bits[(size_t)x * nq + q0 + c] : 0u;
      const int c2 = e / TILE, col = e % TILE;   // b: along one b_t row
      const int y = y0 + col;
      bs[col][c2] = y < n ? b_t[(size_t)(q0 + c2) * n + y] : 0u;
    }
    __syncthreads();
    for (int c = 0; c < cw; ++c) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty + EDGE * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[tx + EDGE * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hit[i][j] |= av[i] & bv[j];
      if (++w == nw) {                            // member m's hop is closed
        const int s = __ldg(stake + m);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] += hit[i][j] != 0u ? s : 0;
            hit[i][j] = 0u;
          }
        w = 0;
        ++m;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = x0 + ty + EDGE * i;
    if (x >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = y0 + tx + EDGE * j;
      if (y < n) out[(size_t)x * n + y] = 3LL * acc[i][j] > tot2;
    }
  }
}

int blocks_for(long long n) { return (int)((n + PACK_THREADS - 1) / PACK_THREADS); }

}  // namespace

extern "C" int ssm_matrix_launch(const void* sees, int n, const void* mt,
                                 int M, int K, const void* stake,
                                 long long tot_stake, void* a_bits,
                                 void* b_t, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = (K + 31) / 32;
  const int nq = M * nw;
  pack_a<<<blocks_for((long long)n * nq), PACK_THREADS, 0, s>>>(
      (const uint8_t*)sees, n, (const int*)mt, K, nw, nq, (uint32_t*)a_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pack_b<<<blocks_for((long long)nq * n), PACK_THREADS, 0, s>>>(
      (const uint8_t*)sees, n, (const int*)mt, K, nw, nq, (uint32_t*)b_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  dim3 block(EDGE, EDGE);
  ssm_tile<<<grid, block, 0, s>>>((const uint32_t*)a_bits,
                                  (const uint32_t*)b_t, (const int*)stake, n,
                                  nw, nq, 2LL * tot_stake, (uint8_t*)out);
  return (int)cudaGetLastError();
}
