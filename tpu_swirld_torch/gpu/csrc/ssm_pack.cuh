// ssm_pack.cuh: the bit packing shared by ssm_block.cu and ssm_matrix.cu.
//
// Both kernels pack each member's K slots into W = 8 ceil(K / 256) words, the
// whole 256-bit k-steps of a binary MMA (mma_bits.cuh); words past ceil(K /
// 32) are zero.  Row or column i packs as word t = m * W + w, bit L: member
// slot k = 32 w + L, set when k < K, e = mt[m][k] >= 0 and the gathered sees
// byte is set.  Word t is stored at kpos(t): within its k-step, word w and w
// + 4 sit side by side, so one 64-bit load gives a thread both words of an
// MMA fragment register pair (the AND-popcount of a k-step does not depend
// on the order of its words, as long as both sides share it).
//
// The a side (row x of sees, read through the member table): the sees bytes
// of one row are spread over the whole row (a member's events interleave
// with everyone else's), so a block first turns up to 16 whole rows into
// column bits in shared memory (coalesced 4-byte loads) and gathers from
// those; rows too long for that are gathered byte by byte from device
// memory through L1.  Each warp forms a word with one ballot a row, GROUP
// words in flight.
//
// The b side (column y, K contiguous as the .row.col fragments want it): a
// tile of BT_Y columns x BT_Q words a block, neighbouring threads on
// neighbouring columns (coalesced sees reads), written through a
// shared-memory transpose.

#pragma once

#include <stdint.h>

constexpr int BT_Y = 64, BT_Q = 32;  // b pack tile: columns x words

// Where word t of a row is stored.
__device__ __forceinline__ int kpos(int t) {
  return (t & ~7) | ((t & 3) << 1) | ((t >> 2) & 1);
}

// Up to 16 sees rows as column bits in shared memory: colbits[e] bit r is
// row r's byte e.  One 16-bit load then gives a lane the bits of all the
// rows for its member slot, so a warp forms 16 rows' words of 32 slots with
// one shared-memory load a lane, 16 ballots and one 16-lane store.
constexpr int COL_ROWS = 16;

// colbits[e] for e < n from rows [0, nr) (nr <= COL_ROWS) of src (row stride
// n bytes); bits of rows >= nr are zero.  Every thread of the block calls
// it; the caller synchronizes the block before reading colbits.
__device__ __forceinline__ void stage_col_bits(uint16_t* colbits,
                                               const uint8_t* __restrict__ src,
                                               int n, int nr) {
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0;
  for (int q = threadIdx.x; 4 * q < n; q += blockDim.x) {
    uint32_t x[COL_ROWS];                      // bytes 4q .. 4q + 3 of each row
#pragma unroll
    for (int r = 0; r < COL_ROWS; ++r) {     // every load before the first use
      x[r] = 0u;
      if (r < nr) {
        const uint8_t* p = src + (size_t)r * n + 4 * q;
        if (vec) {
          x[r] = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
          for (int j = 0; j < 4 && 4 * q + j < n; ++j) x[r] |= (uint32_t)p[j] << (8 * j);
        }
      }
    }
    uint32_t m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < COL_ROWS; ++r) {
      const uint32_t nz = __vcmpne4(x[r], 0u);  // 0xff for a set byte
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] |= ((nz >> (8 * j)) & 1u) << r;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * q + j < n) colbits[4 * q + j] = (uint16_t)m[j];
  }
}

// out[r * ostride + kpos(t)] for rows r < nr (nr <= COL_ROWS) of column
// bits and words t < M * wpm.  Words w >= ceil(K / 32) of a member pack
// zeros (its padding).  Every thread of the block calls it.
template <int GROUP = 8>
__device__ __forceinline__ void pack_words_cols(const uint16_t* colbits, int nr, int n,
                                                const int* __restrict__ mt, int K, int M,
                                                int wpm, uint32_t* out, size_t ostride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int words = M * wpm;
  for (int t0 = warp; t0 < words; t0 += warps * GROUP) {
    uint32_t cb[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {        // every load before the first use
      const int t = t0 + warps * g, k = 32 * (t % wpm) + lane;
      const int e = t < words && k < K ? mt[(size_t)(t / wpm) * K + k] : -1;
      cb[g] = e >= 0 ? colbits[min(e, n - 1)] : 0u;
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int t = t0 + warps * g;
      if (t >= words) break;                 // the same for the whole warp
      uint32_t mine = 0;
#pragma unroll
      for (int r = 0; r < COL_ROWS; ++r) {
        const uint32_t w = __ballot_sync(0xffffffffu, (cb[g] >> r) & 1u);
        if (lane == r) mine = w;
      }
      if (lane < nr) out[(size_t)lane * ostride + kpos(t)] = mine;
    }
  }
}

// out[r * ostride + kpos(t)] for rows r < nr of sees rows in device memory
// (row r at rows + r * rstride bytes), gathered byte by byte through L1: the
// route for rows too long for their column bits to fit in shared memory.
// Rows r >= valid pack zeros.  Every thread of the block calls it.
template <int GROUP = 8>
__device__ __forceinline__ void pack_words(const uint8_t* rows, size_t rstride,
                                           int nr, int valid, int n,
                                           const int* __restrict__ mt, int K,
                                           int M, int wpm, uint32_t* out,
                                           size_t ostride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int words = M * wpm;
  for (int t0 = warp; t0 < words; t0 += warps * GROUP) {
    int e[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int t = t0 + warps * g, k = 32 * (t % wpm) + lane;
      e[g] = t < words && k < K ? mt[(size_t)(t / wpm) * K + k] : -1;
    }
    for (int r = 0; r < nr; ++r) {
      uint8_t v[GROUP] = {};
      if (r < valid) {
        const uint8_t* row = rows + (size_t)r * rstride;
#pragma unroll
        for (int g = 0; g < GROUP; ++g) v[g] = row[min(max(e[g], 0), n - 1)];
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int t = t0 + warps * g;
        const uint32_t word = __ballot_sync(0xffffffffu, e[g] >= 0 && v[g] != 0);
        if (lane == 0 && t < words) out[(size_t)r * ostride + kpos(t)] = word;
      }
    }
  }
}

// Tile `tile` of b_bits[j][kpos(q)] for columns j < C and words q < bq = M *
// W: column j is event cols[j] (j itself when cols is null; a negative event
// packs zeros), clipped to [0, n) for the gather.  `buf` is BT_Y x (BT_Q + 1)
// words of shared memory; blockDim.x is a multiple of BT_Y.
__device__ __forceinline__ void pack_b_tile(const uint8_t* __restrict__ sees, int n,
                                            const int* __restrict__ mt, int K, int W,
                                            int bq, const int* __restrict__ cols, int C,
                                            int tile, uint32_t* __restrict__ b_bits,
                                            uint32_t (*buf)[BT_Q + 1]) {
  const int q_tiles = (bq + BT_Q - 1) / BT_Q;
  const int j0 = (tile / q_tiles) * BT_Y, q0 = (tile % q_tiles) * BT_Q;
  const int yl = threadIdx.x % BT_Y, j = min(j0 + yl, C - 1);
  const int c = cols ? cols[j] : j;
  const int y = min(max(c, 0), n - 1);
  // word q = m * W + w of column j; a warp shares q, so its member-table
  // loads are one broadcast and its sees loads one row segment
  for (int ql = threadIdx.x / BT_Y; ql < BT_Q; ql += blockDim.x / BT_Y) {
    const int q = q0 + ql, k0 = 32 * (q % W);
    uint32_t word = 0;
    if (q < bq && k0 < K && c >= 0) {          // else padding or an invalid column
      const int* mrow = mt + (size_t)(q / W) * K;
      int e[32];
#pragma unroll
      for (int L = 0; L < 32; ++L) e[L] = k0 + L < K ? mrow[k0 + L] : -1;
      uint8_t v[32];
#pragma unroll
      for (int L = 0; L < 32; ++L) v[L] = sees[(size_t)min(max(e[L], 0), n - 1) * n + y];
#pragma unroll
      for (int L = 0; L < 32; ++L) word |= (uint32_t)(e[L] >= 0 && v[L] != 0) << L;
    }
    buf[yl][ql] = word;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < BT_Y * BT_Q; f += blockDim.x) {
    const int r = f / BT_Q, ql = f % BT_Q;
    if (j0 + r < C && q0 + ql < bq) b_bits[(size_t)(j0 + r) * bq + kpos(q0 + ql)] = buf[r][ql];
  }
}
