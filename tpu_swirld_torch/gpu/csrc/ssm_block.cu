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
// nothing between them, so here each block owns TR rows and tallies ALL
// members itself, with the int32 tally in registers, and writes each
// thresholded output once.  Inside the int32 stake envelope (3 * tot <=
// INT32_MAX, which the wrapper checks) the tally and 3 * acc fit an int, as
// in the reference.
//
// What bounds it on an H100: the bytes of the a-side gather.  Every output
// row reads one sees row through the whole member table (~10 KB a row at n =
// 10112, ~100 MB at rows = 10112).  The hops run on the tensor cores as
// binary MMAs (mma.sync m16n8k256 .b1 AND-popc, mma_bits.cuh, the route
// ssm_matrix.cu takes), so the products and the per-member closes cost a few
// microseconds.  Two launches a call, one scratch buffer (the packed b
// words), no packed a side in device memory (ssm_pack.cuh packs both):
//
// - pack_b: b_bits[j][kpos(m * W + w)] for column cols[j] (zero words for a
//   negative one), BT_Y columns x BT_Q words a block.
// - tile: a block owns TR rows (16, or 8 or 4 when that fills the card or
//   the a words do not fit) and the column tiles of its column group.  It
//   turns its sees rows into column bits in shared memory and packs its a
//   words from those with warp ballots (ssm_pack.cuh), straight into shared
//   memory.  Then per 64-column tile the warps split the members (warp w
//   takes w, w + 8, ...): a warp loads the a fragment of a member from
//   shared memory and its b fragments from device memory (L2; each b word
//   is read once a tile), runs 8 MMAs a k-step, closes the member into its
//   int32 tally (acc += stake[m] when the popcount is > 0) and moves on with
//   no barrier; the next member's b loads start before the current
//   member's MMAs.  The 8 partial tallies meet in shared memory once a
//   tile, and the threshold and column mask are applied once an output.
//   When not even 4 rows' a words fit in shared memory (a member table of
//   more than ~445k slots, after padding), the block takes one column tile
//   and packs and tallies the members in chunks that fit, the tally carried
//   in registers across the chunks.
//
// Plain C interface (bound with ctypes): ssm_block_launch returns the
// cudaError_t of the launches, 0 on success.  Launches on the caller's
// stream, allocates nothing (the caller passes b_bits[C][M * W] words, W = 8
// ceil(K / 256)).  The caller clamps row0 to [0, n - rows].

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bits.cuh"
#include "ssm_pack.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 64;               // output tile width
constexpr int NF = BN / 8;           // n-fragments of a tile
constexpr int RED_STRIDE = BN + 8;   // a partial tally row, = 8 mod 32 words
constexpr int SMEM_TARGET = 110 * 1024;  // two blocks an SM
constexpr int SMEM_MAX = 227 * 1024;

__global__ void __launch_bounds__(THREADS)
pack_b(const uint8_t* __restrict__ sees, int n, const int* __restrict__ mt,
       int K, int W, int bq, const int* __restrict__ cols, int C,
       uint32_t* __restrict__ b_bits) {
  __shared__ uint32_t buf[BT_Y][BT_Q + 1];
  pack_b_tile(sees, n, mt, K, W, bq, cols, C, blockIdx.x, b_bits, buf);
}

// One k-step's b fragments of member m for the tile's columns j0 + 8 f + g
// (zeros past C).
__device__ __forceinline__ void load_b(uint2 (&bf)[NF], const uint32_t* __restrict__ b_bits,
                                       int bq, int C, int j0, int word) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int j = j0 + 8 * f + g;
    bf[f] = j < C ? __ldg(reinterpret_cast<const uint2*>(b_bits + (size_t)j * bq + word))
                  : make_uint2(0u, 0u);
  }
}

// One block: rows [i0, i0 + TR) of the block x the column tiles jt =
// blockIdx.y, blockIdx.y + gridDim.y, ...  Shared memory: as[TR][astride]
// (the rows' packed a words, astride = 8 mod 32 words so the fragment loads
// are conflict-free), then one region that first holds the rows' column
// bits (when `staged`; else the rows are gathered from device memory) and
// then the warps' partial tallies red[WARPS][TR][RED_STRIDE].  mc: the
// members a chunk of a words (M: one chunk, packed once for all the block's
// column tiles; fewer: each chunk packed in turn, rows gathered from device
// memory).  KS: the k-steps a member when known at compile time (1: K <=
// 256), else 0 and ks_arg.
template <int TR, int KS>
__global__ void __launch_bounds__(THREADS, 2)
tile(const uint8_t* __restrict__ sees, int n, const int* __restrict__ mt,
     int M, int K, int ks_arg, int bq, int astride,
     const uint32_t* __restrict__ b_bits, const int* __restrict__ stake,
     const int* __restrict__ cols, int C, int row0, int rows, int tot2, int staged,
     int mc, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int ks = KS ? KS : ks_arg;
  uint32_t* as = smem;
  uint32_t* region = smem + TR * astride;
  const int i0 = blockIdx.x * TR;
  const int W = 8 * ks;

  // ---- the a side: as[r][kpos(q)] of the block's rows; rows past `rows`
  // pack zeros
  const int valid = min(TR, rows - i0);
  const uint8_t* src = sees + (size_t)(row0 + i0) * n;
  const bool chunked = mc < M;
  if (!chunked) {
    if (staged) {
      uint16_t* colbits = reinterpret_cast<uint16_t*>(region);
      stage_col_bits(colbits, src, n, valid);
      __syncthreads();
      pack_words_cols(colbits, TR, n, mt, K, M, W, as, (size_t)astride);
    } else {
      pack_words(src, (size_t)n, TR, valid, n, mt, K, M, W, as, (size_t)astride);
    }
    __syncthreads();
  }

  // ---- the tally: per column tile, warp w over the chunk's members w, w +
  // WARPS, ... (m local to the chunk, m0 + m in the member table)
  int* red = reinterpret_cast<int*>(region);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col_tiles = (C + BN - 1) / BN;
  for (int jt = blockIdx.y; jt < col_tiles; jt += gridDim.y) {
    const int j0 = jt * BN;
    int acc[NF][4] = {};
    for (int m0 = 0; m0 < M; m0 += mc) {
      const int mn = min(mc, M - m0);
      if (chunked) {
        __syncthreads();                       // the last chunk's a words read
        pack_words(src, (size_t)n, TR, valid, n, mt + (size_t)m0 * K, K, mn, W, as,
                   (size_t)astride);
        __syncthreads();
      }
      const int steps = (warp < mn ? (mn - warp + WARPS - 1) / WARPS : 0) * ks;
      int c[NF][4];
      uint2 bnext[NF];
      if (steps > 0) load_b(bnext, b_bits, bq, C, j0, (m0 + warp) * W + 2 * t);
      for (int st = 0; st < steps; ++st) {
        const int m = warp + WARPS * (st / ks), kk = st % ks;
        uint2 bcur[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) bcur[f] = bnext[f];
        if (st + 1 < steps) {
          const int m1 = warp + WARPS * ((st + 1) / ks), kk1 = (st + 1) % ks;
          load_b(bnext, b_bits, bq, C, j0, (m0 + m1) * W + 8 * kk1 + 2 * t);
        }
        const uint32_t* ar = as + m * W + 8 * kk + 2 * t;
        const uint2 lo = g < TR ? *reinterpret_cast<const uint2*>(ar + g * astride)
                                : make_uint2(0u, 0u);
        const uint2 hi = g + 8 < TR ? *reinterpret_cast<const uint2*>(ar + (g + 8) * astride)
                                    : make_uint2(0u, 0u);
        const uint32_t af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const uint32_t bf[2] = {bcur[f].x, bcur[f].y};
          if (kk == 0)
            mma_b1_and_popc_first(c[f], af, bf);
          else
            mma_b1_and_popc(c[f], af, bf);
        }
        if (kk == ks - 1) {                    // member m's hop is closed
          const int s = __ldg(stake + m0 + m);
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[f][v] += min(c[f][v], 1) * s;
        }
      }
    }

    // c[v]: row g (v < 2) or g + 8, column 2 t + v % 2 of the 16 x 8 tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r < TR) {
#pragma unroll
        for (int f = 0; f < NF; ++f)
          *reinterpret_cast<int2*>(red + (warp * TR + r) * RED_STRIDE + 8 * f + 2 * t) =
              make_int2(acc[f][2 * h], acc[f][2 * h + 1]);
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < TR * BN / 4; o += THREADS) {
      const int r = o / (BN / 4), cq = 4 * (o % (BN / 4));
      int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int4 p = *reinterpret_cast<const int4*>(red + (w * TR + r) * RED_STRIDE + cq);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const int i = i0 + r;
      if (i < rows) {
        const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + cq + u;
          if (j < C) out[(size_t)i * C + j] = cols[j] >= 0 && 3 * s4[u] > tot2;
        }
      }
    }
    __syncthreads();                         // red read before the next tile
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int TR, int KS>
cudaError_t launch_tile(dim3 grid, size_t smem, cudaStream_t s,
                        const uint8_t* sees, int n, const int* mt, int M,
                        int K, int ks, int bq, int astride, const uint32_t* b_bits,
                        const int* stake, const int* cols, int C, int row0,
                        int rows, int tot2, int staged, int mc, uint8_t* out) {
  static bool raised = false;             // the opt-in above 48 KB, once
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        tile<TR, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  tile<TR, KS><<<grid, THREADS, smem, s>>>(sees, n, mt, M, K, ks, bq, astride, b_bits,
                                           stake, cols, C, row0, rows, tot2, staged, mc,
                                           out);
  return cudaGetLastError();
}

template <int TR>
cudaError_t launch_tile_ks(dim3 grid, size_t smem, cudaStream_t s,
                           const uint8_t* sees, int n, const int* mt, int M,
                           int K, int ks, int bq, int astride, const uint32_t* b_bits,
                           const int* stake, const int* cols, int C, int row0,
                           int rows, int tot2, int staged, int mc, uint8_t* out) {
  return ks == 1 ? launch_tile<TR, 1>(grid, smem, s, sees, n, mt, M, K, ks, bq, astride,
                                      b_bits, stake, cols, C, row0, rows, tot2, staged, mc,
                                      out)
                 : launch_tile<TR, 0>(grid, smem, s, sees, n, mt, M, K, ks, bq, astride,
                                      b_bits, stake, cols, C, row0, rows, tot2, staged, mc,
                                      out);
}

}  // namespace

extern "C" int ssm_block_launch(const void* sees, int n, const void* mt,
                                int M, int K, const void* stake,
                                const void* cols, int C, int row0, int rows,
                                int tot_stake, void* b_bits, void* out,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ks = ((K + 31) / 32 + 7) / 8;   // 256-bit k-steps a member
  const int W = 8 * ks;
  const int bq = M * W;
  const int b_tiles = ((C + BT_Y - 1) / BT_Y) * ((bq + BT_Q - 1) / BT_Q);
  pack_b<<<b_tiles, THREADS, 0, s>>>((const uint8_t*)sees, n, (const int*)mt, K, W,
                                     bq, (const int*)cols, C, (uint32_t*)b_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 16-row tiles (fewer when the a words do not fit), then as many column
  // groups as fill the card twice over (each group re-packs its rows' a
  // words, cheaper than tiles this short re-reading b), then shorter tiles;
  // when not even 4 rows' a words fit, members in chunks of mc and one
  // column tile a block
  static const int sms = sm_count();
  const int col_tiles = (C + BN - 1) / BN;
  const size_t col_bytes = ((size_t)n * 2 + 15) & ~(size_t)15;
  auto stride = [](int words) { return (words + 23) / 32 * 32 + 8; };
  int mc = M, astride = stride(bq);
  auto smem_for = [&](int tr, int* staged) {
    const size_t as_bytes = (size_t)tr * astride * 4;
    const size_t red = (size_t)WARPS * tr * RED_STRIDE * 4;
    *staged = mc == M && as_bytes + col_bytes <= (size_t)SMEM_TARGET;
    const size_t region = *staged && col_bytes > red ? col_bytes : red;
    return as_bytes + region;
  };
  int tr = 16, staged = 0, groups = col_tiles;
  while (tr > 4 && smem_for(tr, &staged) > (size_t)SMEM_MAX) tr /= 2;
  if (smem_for(tr, &staged) <= (size_t)SMEM_MAX) {
    const int strips = (rows + tr - 1) / tr;
    groups = (2 * sms + strips - 1) / strips;
    groups = groups < col_tiles ? groups : col_tiles;
    while ((rows + tr - 1) / tr * groups < sms && tr > 4) tr /= 2;
  } else {
    tr = 16;
    while (mc > 1 && smem_for(tr, &staged) > (size_t)SMEM_MAX) {
      mc = (mc + 1) / 2;
      astride = stride(mc * W);
    }
    while (tr > 4 && smem_for(tr, &staged) > (size_t)SMEM_MAX) tr /= 2;
  }
  const size_t smem = smem_for(tr, &staged);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;  // one member past ~445k slots
  const dim3 grid((rows + tr - 1) / tr, groups);
  const uint8_t* sv = (const uint8_t*)sees;
  const int* mv = (const int*)mt;
  const int* st = (const int*)stake;
  const int* cv = (const int*)cols;
  const uint32_t* bb = (const uint32_t*)b_bits;
  uint8_t* o = (uint8_t*)out;
  const int tot2 = 2 * tot_stake;
  if (tr == 16)
    err = launch_tile_ks<16>(grid, smem, s, sv, n, mv, M, K, ks, bq, astride, bb, st, cv,
                          C, row0, rows, tot2, staged, mc, o);
  else if (tr == 8)
    err = launch_tile_ks<8>(grid, smem, s, sv, n, mv, M, K, ks, bq, astride, bb, st, cv,
                         C, row0, rows, tot2, staged, mc, o);
  else
    err = launch_tile_ks<4>(grid, smem, s, sv, n, mv, M, K, ks, bq, astride, bb, st, cv,
                         C, row0, rows, tot2, staged, mc, o);
  return (int)err;
}
