// ssm_tally: one row shard's int32 stake tally of the row-sharded
// strongly-sees block, not thresholded (the tallies of all shards are summed
// before the strict-2/3 test):
//
//   out[i][j] = sum_m stake[m] * hit_m(i, j)
//   hit_m(i, j) = exists k: mt[m][k] >= 0 AND 0 <= row_lo + i < n_loc
//                           AND sees[row_lo + i][min(mt[m][k], n - 1)]
//                           AND b[m * K + k][j]
//
// for the shard's rows sees[n_loc][n] and the halo-assembled b[M * K][C].
// Replaces the member hops of the TPU route tpu_swirld/tpu/
// pallas_kernels.py:make_mesh_row_block_fn: there each shard runs M
// bmm_or_pallas calls and adds stake[m] * hit into an int32 tally, one XLA
// op after another.  Here one shard is two launches whatever M is:
//
// - pack: the a side gathered straight from the shard's slab rows through
//   the member table (a warp per word: lane k reads one byte, one
//   __ballot_sync forms the word, bit for bit as ssm_block.cu:pack_a packs
//   it), only for the rows this shard owns; and b packed once for the
//   shard, neighbouring threads on neighbouring columns of b, each thread
//   shifting in its bit;
// - tally: one output tile per block loops over ALL members, the packed
//   words staged through shared memory 64 words at a time (several members
//   per barrier), hit_m an OR of word-ANDs and the int32 tally in registers;
//   each output written once.  Tiles the shard does not own write zeros.
//
// Both launches are latency-bound at these sizes, so every loop issues all
// its independent loads before it uses the first.
//
// What bounds it on an H100: the bytes of the a-side gather (owned rows x
// valid member slots, ~11 MB for 1024 rows at M * K = 11392) and, at the
// main path's shapes, the fixed costs around them; the AND-products are a
// few microseconds of integer work, so no tensor cores.  The tile height is
// chosen from the owned rows so that the grid fills the card.
//
// Plain C interface (bound with ctypes): ssm_tally_launch returns the
// cudaError_t of the launches, 0 on success.  Launches on the caller's
// stream, allocates nothing (the caller passes the packed-word scratch:
// a_bits[owned][M * KW], b_bits[M * KW][C], KW = ceil(K / 32)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int EDGE = 16;      // threads per tile edge
constexpr int TC = 64;        // output tile width: 16 threads x 4 columns
constexpr int TQ = 64;        // packed words staged in shared memory per step
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 8;      // (member, word) tasks a warp has in flight

// Blocks [0, a_blocks) pack the a side, one block per owned row (its warps
// share the row's bytes in L1), each warp GROUP words at a time with all
// their loads issued before the first ballot; the rest pack b.
// a_bits[r][m * nw + w], bit L: k = 32 w + L < K, e = mt[m][k] >= 0 and
// sees[i_lo + r + row_lo][min(e, n - 1)].  b_bits[m * nw + w][j], bit L:
// k = 32 w + L < K and b[m * K + k][j].
__global__ void pack(const uint8_t* __restrict__ sees, int n,
                     const int* __restrict__ mt, int M, int K, int nw,
                     const uint8_t* __restrict__ b, int C, int row_first,
                     int a_blocks, uint32_t* __restrict__ a_bits,
                     uint32_t* __restrict__ b_bits) {
  const int mq = M * nw;
  if ((int)blockIdx.x < a_blocks) {
    const int r = blockIdx.x;
    const uint8_t* srow = sees + (size_t)(row_first + r) * n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int t0 = warp; t0 < mq; t0 += WARPS * GROUP) {
      int e[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        // task t = m * nw + w, its bit `lane` is member slot k = 32 w + lane
        const int t = t0 + WARPS * g, k = 32 * (t % nw) + lane;
        e[g] = t < mq && k < K ? mt[(size_t)(t / nw) * K + k] : -1;
      }
      bool bit[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) bit[g] = e[g] >= 0 && srow[min(e[g], n - 1)] != 0;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int t = t0 + WARPS * g;
        const uint32_t word = __ballot_sync(0xffffffffu, bit[g]);
        if (lane == 0 && t < mq) a_bits[(size_t)r * mq + t] = word;
      }
    }
    return;
  }
  const long long idx =
      (long long)(blockIdx.x - a_blocks) * blockDim.x + threadIdx.x;
  if (idx >= (long long)mq * C) return;
  const int q = (int)(idx / C), j = (int)(idx % C);
  const int m = q / nw, k0 = (q % nw) * 32;
  const int kn = min(32, K - k0);
  const uint8_t* col = b + ((size_t)m * K + k0) * C + j;
  uint32_t word = 0;
#pragma unroll
  for (int L = 0; L < 32; ++L)
    if (L < kn) word |= (uint32_t)(col[(size_t)L * C] != 0) << L;
  b_bits[idx] = word;
}

// One (16 RI) x 64 output tile per block; thread (tx, ty) owns rows
// ty + 16 i and columns tx + 16 j.  The words of (member, word) pairs are
// walked in order, so hit is complete when a member's last word is done.
// Each step's loads are all issued before the first lands in shared memory.
template <int RI>
__global__ void tally(const uint32_t* __restrict__ a_bits,
                      const uint32_t* __restrict__ b_bits,
                      const int* __restrict__ stake, int M, int nw, int rows,
                      int C, int i_lo, int i_hi, int* __restrict__ out) {
  constexpr int TR = EDGE * RI;
  constexpr int A_LOADS = TR * TQ / THREADS, B_LOADS = TC * TQ / THREADS;
  __shared__ uint32_t as[TR][TQ + 1];
  __shared__ uint32_t bs[TC][TQ + 1];
  const int tx = threadIdx.x % EDGE, ty = threadIdx.x / EDGE;
  const int i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;
  int acc[RI][4] = {};
  if (i0 < i_hi && i0 + TR > i_lo) {
    const int mq = M * nw;
    uint32_t hit[RI][4] = {};
    int m = 0, w = 0;
    for (int q0 = 0; q0 < mq; q0 += TQ) {
      const int tq = min(TQ, mq - q0);
      uint32_t ra[A_LOADS], rb[B_LOADS];
#pragma unroll
      for (int k = 0; k < A_LOADS; ++k) {
        const int e = threadIdx.x + THREADS * k;
        const int q = e % TQ, i = i0 + e / TQ;
        ra[k] = q < tq && i >= i_lo && i < i_hi
                    ? a_bits[(size_t)(i - i_lo) * mq + q0 + q] : 0u;
      }
#pragma unroll
      for (int k = 0; k < B_LOADS; ++k) {
        const int e = threadIdx.x + THREADS * k;
        const int q = e / TC, j = j0 + e % TC;
        rb[k] = q < tq && j < C ? b_bits[(size_t)(q0 + q) * C + j] : 0u;
      }
#pragma unroll
      for (int k = 0; k < A_LOADS; ++k) {
        const int e = threadIdx.x + THREADS * k;
        as[e / TQ][e % TQ] = ra[k];
      }
#pragma unroll
      for (int k = 0; k < B_LOADS; ++k) {
        const int e = threadIdx.x + THREADS * k;
        bs[e % TC][e / TC] = rb[k];
      }
      __syncthreads();
      for (int q = 0; q < tq; ++q) {
        uint32_t av[RI], bv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) av[i] = as[ty + EDGE * i][q];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[tx + EDGE * j][q];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hit[i][j] |= av[i] & bv[j];
        if (++w == nw) {
          const int s = __ldg(stake + m);
#pragma unroll
          for (int i = 0; i < RI; ++i)
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
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = i0 + ty + EDGE * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx + EDGE * j;
      if (c < C) out[(size_t)r * C + c] = acc[i][j];
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int RI>
cudaError_t launch_tally(const uint32_t* a_bits, const uint32_t* b_bits,
                         const int* stake, int M, int nw, int rows, int C,
                         int i_lo, int i_hi, int* out, cudaStream_t s) {
  constexpr int TR = EDGE * RI;
  dim3 grid((C + TC - 1) / TC, (rows + TR - 1) / TR);
  tally<RI><<<grid, THREADS, 0, s>>>(a_bits, b_bits, stake, M, nw, rows, C,
                                     i_lo, i_hi, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssm_tally_launch(const void* sees, int n_loc, int n,
                                const void* mt, int M, int K,
                                const void* stake, const void* b, int C,
                                int row_lo, int rows, void* a_bits,
                                void* b_bits, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = (K + 31) / 32;
  // the block's rows this shard owns: [i_lo, i_hi)
  const int i_lo = max(0, -row_lo);
  const int i_hi = max(i_lo, min(rows, n_loc - row_lo));
  const int owned = i_hi - i_lo;
  if (owned > 0) {
    const long long b_words = (long long)M * nw * C;
    const int b_blocks = (int)((b_words + THREADS - 1) / THREADS);
    pack<<<owned + b_blocks, THREADS, 0, s>>>(
        (const uint8_t*)sees, n, (const int*)mt, M, K, nw,
        (const uint8_t*)b, C, row_lo + i_lo, owned, (uint32_t*)a_bits,
        (uint32_t*)b_bits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the tallest tile whose grid over the owned rows still fills the card
  static const int sms = sm_count();
  const long long col_tiles = (C + TC - 1) / TC;
  auto blocks = [&](int tr) { return (owned + tr - 1) / tr * col_tiles; };
  const int* st = (const int*)stake;
  const uint32_t* ab = (const uint32_t*)a_bits;
  const uint32_t* bb = (const uint32_t*)b_bits;
  int* o = (int*)out;
  if (blocks(64) >= sms)
    return (int)launch_tally<4>(ab, bb, st, M, nw, rows, C, i_lo, i_hi, o, s);
  if (blocks(32) >= sms)
    return (int)launch_tally<2>(ab, bb, st, M, nw, rows, C, i_lo, i_hi, o, s);
  return (int)launch_tally<1>(ab, bb, st, M, nw, rows, C, i_lo, i_hi, o, s);
}
