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
// between them, so here each block owns one output tile and loops over ALL
// members itself, with the int32 tally in registers; each thresholded
// output is written once.  Inside the int32 stake envelope (3 * tot <=
// INT32_MAX, which the wrapper checks) the tally and 3 * acc fit an int.
//
// What bounds it on an H100: the operations.  At N = 10112 and 10000 valid
// member slots the rule is 1.02e12 AND-products; the bytes are ~0.3 GB.  On
// CUDA cores that is ~3.9e10 32-bit word-ANDs, ~2.5 ms even at the full
// logic rate, so the product runs on the tensor cores as a binary MMA:
// mma.sync m16n8k256 .b1 AND-popc (mma_bits.cuh), which runs 256-bit
// products at about eight times the rate of the s8 m16n8k32 (both measured
// on this card by tpu_swirld_torch/dev/mma_rate.py).  Each member's slots
// are packed into
// whole 256-bit k-steps (W = 8 ceil(ceil(K / 32) / 8) words a member,
// zero-padded), so a member is one k-step when K <= 256 and its popcount
// is > 0 exactly when hit_m holds.  Two launches a call:
//
// - pack: a_bits[x][kpos(m * W + w)] (the sees row x through the member
//   table) and b_bits[y][kpos(m * W + w)] (column y, K contiguous: the
//   .row.col fragments want K contiguous on both sides), bit L: k = 32 w +
//   L < K, e = mt[m][k] >= 0 and sees[x][min(e, n - 1)] (a) or
//   sees[min(e, n - 1)][y] (b), as ssm_pack.cuh packs them.  One launch,
//   the two halves split by blockIdx: a block of a turns 16 sees rows into
//   column bits in shared memory and forms 16 rows' words with one load a
//   lane and a ballot a row (rows longer than ~116k events, whose column
//   bits do not fit, are gathered from device memory instead); a block of b
//   reads sees rows with neighbouring threads on neighbouring y (coalesced)
//   and writes 32-word rows of b_bits through a shared-memory transpose.
// - tally: a 128 x 256 output tile a block, 8 warps of 64 x 64.  The
//   members' k-steps of both operands are staged through shared memory with
//   cp.async, 4 members a barrier in a ring of 3 such groups (XOR-swizzled
//   16-byte chunks, so ldmatrix reads are conflict-free); fragments come in
//   by ldmatrix, the popcounts of a member close into the int32 tally in
//   registers (acc += min(c, 1) * stake[m]) and restart; the threshold is
//   applied once at the end.  A member of more than 6 k-steps (K > 1536) is
//   staged in parts of at most 6, and whether its popcount was > 0 is
//   carried across its parts as one bit an output, so any K runs.  The
//   blocks in flight share the rows of a and all of b (~20 MB) in the 50 MB
//   L2.
//
// Plain C interface (bound with ctypes): ssm_matrix_launch returns the
// cudaError_t of the launches, 0 on success.  Launches on the caller's
// stream, allocates nothing (the caller passes a_bits and b_bits, each
// n * M * W words).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bits.cuh"
#include "ssm_pack.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;              // output tile rows (x)
constexpr int BN = 256;              // output tile columns (y)
constexpr int WM = 64, WN = 64;      // a warp's part: 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int SMEM_MAX = 227 * 1024;

// Blocks [0, a_blocks): COL_ROWS rows of a each, their column bits staged
// in shared memory when `staged` (else gathered from device memory); the
// rest: one BT_Y x BT_Q tile of b each.
__global__ void __launch_bounds__(THREADS)
pack(const uint8_t* __restrict__ sees, int n, const int* __restrict__ mt,
     int M, int K, int W, int aq, int a_blocks, int staged,
     uint32_t* __restrict__ a_bits, uint32_t* __restrict__ b_bits) {
  extern __shared__ __align__(16) uint8_t smem[];
  if ((int)blockIdx.x < a_blocks) {
    const int x0 = blockIdx.x * COL_ROWS, nr = min(COL_ROWS, n - x0);
    const uint8_t* rows = sees + (size_t)x0 * n;
    uint32_t* dst = a_bits + (size_t)x0 * aq;
    if (staged) {
      uint16_t* colbits = reinterpret_cast<uint16_t*>(smem);
      stage_col_bits(colbits, rows, n, nr);
      __syncthreads();
      pack_words_cols(colbits, nr, n, mt, K, M, W, dst, (size_t)aq);
    } else {
      pack_words(rows, (size_t)n, nr, nr, n, mt, K, M, W, dst, (size_t)aq);
    }
    return;
  }
  pack_b_tile(sees, n, mt, K, W, aq, nullptr, n, blockIdx.x - a_blocks, b_bits,
                     reinterpret_cast<uint32_t (*)[BT_Q + 1]>(smem));
}

// Stage layout: row r (a rows 0..BM-1, then b rows BM..BM+BN-1) holds the
// member's 2 ks 16-byte chunks, chunk c at position c ^ ((r >> 2) & 1).
__device__ __forceinline__ int chunk_at(int r, int c, int cpr) {
  return (r * cpr + (c ^ ((r >> 2) & 1))) * 16;
}

// The tally of one BM x BN output tile over ALL members.  A member's ks
// k-steps are staged in parts of kc k-steps (one part when they fit), so a
// "unit" is one part of one member; units are staged in groups of mps (one
// barrier a group) through a ring of STAGES groups: slot u of the ring holds
// one unit's a rows then b rows.  A member of several parts carries
// "popcount > 0" across them in hb, one bit an output.  KS and MPS: ks and
// mps when known at compile time (1 and 4: K <= 256), else 0 and ks_arg /
// kc_arg, mps_arg.
template <int STAGES, int KS, int MPS>
__global__ void __launch_bounds__(THREADS, 1)
tally(const uint32_t* __restrict__ a_bits, const uint32_t* __restrict__ b_bits,
      const int* __restrict__ stake, int n, int M, int ks_arg, int kc_arg, int aq,
      int mps_arg, int tot2, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ks = KS ? KS : ks_arg, kc = KS ? KS : kc_arg, mps = MPS ? MPS : mps_arg;
  const int parts = KS ? 1 : (ks + kc - 1) / kc;  // units a member
  const int units = M * parts;
  const int cpr = 2 * kc;                          // chunks a row
  const int unit_bytes = (BM + BN) * cpr * 16;
  const int x0 = blockIdx.y * BM, y0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx = warp / (BN / WN), wy = warp % (BN / WN);

  // this thread's staging work: chunk lc of rows lr, lr + rstep, ...; a
  // chunk past the member's last k-step is zero-filled
  const int rstep = THREADS / cpr, lr = threadIdx.x / cpr, lc = threadIdx.x % cpr;
  auto load = [&](int u, int slot) {
    if (lr >= rstep) return;
    uint8_t* base = smem + slot * unit_bytes;
    const int m = u / parts, kstep = (u - m * parts) * kc + lc / 2;
    const bool live = kstep < ks;
    const size_t word = (size_t)m * ks * 8 + (live ? 8 * kstep + 4 * (lc % 2) : 0);
    for (int r = lr; r < BM + BN; r += rstep) {
      const bool is_a = r < BM;
      const int g = is_a ? x0 + r : y0 + r - BM;
      const uint32_t* src = (is_a ? a_bits : b_bits) + (size_t)min(g, n - 1) * aq + word;
      cp_async16(base + chunk_at(r, lc, cpr), src, g < n && live ? 16 : 0);
    }
  };
  const int groups = (units + mps - 1) / mps;
  auto load_group = [&](int gi) {
    const int slot0 = (gi % STAGES) * mps;
    for (int u = 0; u < mps && gi * mps + u < units; ++u) load(gi * mps + u, slot0 + u);
  };

  int acc[MT][NT][4] = {};
  uint32_t hb[MT] = {};                            // bit 4 j + v: c[j][v] > 0 so far
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < groups) load_group(s);
    cp_async_commit();
  }
  // lane parts of the ldmatrix row addresses: a (rows, chunk) and b (cols,
  // chunk) of a 16 x 256-bit a fragment and two 8 x 256-bit b fragments
  const int a_row = WM * wx + (lane % 8) + 8 * ((lane / 8) % 2), a_chunk = lane / 16;
  const int b_row = BM + WN * wy + 8 * (lane / 16) + (lane % 8), b_chunk = (lane / 8) % 2;
  for (int gi = 0; gi < groups; ++gi) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                               // group gi landed; gi-1's slots free
    if (gi + STAGES - 1 < groups) load_group(gi + STAGES - 1);
    cp_async_commit();
    for (int uu = 0; uu < mps; ++uu) {
      const int u = gi * mps + uu;
      if (u >= units) break;
      const int m = u / parts;
      const bool last = u - m * parts == parts - 1;
      const uint8_t* base = smem + ((gi % STAGES) * mps + uu) * unit_bytes;
      const int s = __ldg(stake + m);
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int c[NT][4];
        for (int kk = 0; kk < kc; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, base + chunk_at(a_row + 16 * i, 2 * kk + a_chunk, cpr));
          if (i == 0 || kc > 1) {
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
              uint32_t r4[4];
              ldsm_x4(r4, base + chunk_at(b_row + 8 * j, 2 * kk + b_chunk, cpr));
              bf[j][0] = r4[0];
              bf[j][1] = r4[1];
              bf[j + 1][0] = r4[2];
              bf[j + 1][1] = r4[3];
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (kk == 0)
              mma_b1_and_popc_first(c[j], af, bf[j]);
            else
              mma_b1_and_popc(c[j], af, bf[j]);
          }
        }
        if (parts == 1) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][j][v] += min(c[j][v], 1) * s;
        } else {
          uint32_t h = hb[i];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) h |= (uint32_t)(c[j][v] > 0) << (4 * j + v);
          if (last) {                              // member m's hop is closed
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[i][j][v] += (int)((h >> (4 * j + v)) & 1u) * s;
            h = 0u;
          }
          hb[i] = h;
        }
      }
    }
  }
  cp_async_wait<0>();

  // c[v]: row g (v < 2) or g + 8, column 2 t + v % 2 of the 16 x 8 tile
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + WM * wx + 16 * i + g + 8 * h;
      if (x >= n) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int y = y0 + WN * wy + 8 * j + 2 * t;
        const uint8_t lo = 3 * acc[i][j][2 * h] > tot2;
        const uint8_t hi = 3 * acc[i][j][2 * h + 1] > tot2;
        uint8_t* o = out + (size_t)x * n + y;
        if (y + 1 < n && (n & 1) == 0) {
          *reinterpret_cast<uint16_t*>(o) = (uint16_t)(lo | (hi << 8));
        } else {
          if (y < n) o[0] = lo;
          if (y + 1 < n) o[1] = hi;
        }
      }
    }
}

template <int STAGES, int KS, int MPS>
cudaError_t launch_tally(dim3 grid, size_t smem, cudaStream_t s,
                         const uint32_t* a_bits, const uint32_t* b_bits,
                         const int* stake, int n, int M, int ks, int kc, int aq, int mps,
                         int tot2, uint8_t* out) {
  static bool raised = false;             // the opt-in above 48 KB, once
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        tally<STAGES, KS, MPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  tally<STAGES, KS, MPS><<<grid, THREADS, smem, s>>>(a_bits, b_bits, stake, n, M, ks, kc,
                                                     aq, mps, tot2, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssm_matrix_launch(const void* sees, int n, const void* mt,
                                 int M, int K, const void* stake,
                                 int tot_stake, void* a_bits, void* b_bits,
                                 void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nw = (K + 31) / 32;
  const int ks = (nw + 7) / 8;            // 256-bit k-steps a member
  const int W = 8 * ks;
  const int aq = M * W;
  // the column bits of a block's rows in shared memory when they fit (n up
  // to ~116k events), else the rows are gathered from device memory
  const size_t col_bytes = ((size_t)n * 2 + 15) & ~(size_t)15;
  const size_t tile_bytes = (size_t)BT_Y * (BT_Q + 1) * 4;
  const int staged = col_bytes <= (size_t)SMEM_MAX;
  const size_t pack_smem = staged && col_bytes > tile_bytes ? col_bytes : tile_bytes;
  static bool raised = false;             // the opt-in above 48 KB, once
  if (pack_smem > 48 * 1024 && !raised) {
    cudaError_t e = cudaFuncSetAttribute(pack, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const int a_blocks = (n + COL_ROWS - 1) / COL_ROWS;
  const int b_blocks = ((n + BT_Y - 1) / BT_Y) * ((aq + BT_Q - 1) / BT_Q);
  pack<<<a_blocks + b_blocks, THREADS, pack_smem, s>>>(
      (const uint8_t*)sees, n, (const int*)mt, M, K, W, aq, a_blocks, staged,
      (uint32_t*)a_bits, (uint32_t*)b_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // a ring of 3 groups of up to 4 units; a unit is a member's k-steps, or
  // a part of them when a ring of 3 cannot hold one member (ks > 6)
  const size_t kstep_bytes = (size_t)(BM + BN) * 32;   // a tile's rows, one k-step
  const int kc_max = (int)(SMEM_MAX / (3 * kstep_bytes));
  const dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM);
  const uint32_t* av = (const uint32_t*)a_bits;
  const uint32_t* bv = (const uint32_t*)b_bits;
  const int* st = (const int*)stake;
  uint8_t* o = (uint8_t*)out;
  const int tot2 = 2 * tot_stake;
  if (ks == 1)
    return (int)launch_tally<3, 1, 4>(grid, 3 * 4 * kstep_bytes, s, av, bv, st, n, M, 1, 1,
                                      aq, 4, tot2, o);
  const int parts = (ks + kc_max - 1) / kc_max;
  const int kc = (ks + parts - 1) / parts;
  int mps = (int)(SMEM_MAX / (3 * kc * kstep_bytes));
  mps = mps < 4 ? mps : 4;
  return (int)launch_tally<3, 0, 0>(grid, 3 * mps * kc * kstep_bytes, s, av, bv, st, n, M,
                                    ks, kc, aq, mps, tot2, o);
}
