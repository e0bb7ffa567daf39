// fame_scan: virtual fame voting over a witness table of R rounds x S slots.
// For every witness slot x (round xr, slot xs), the witnesses y of each later
// round ry vote on x, d = ry - xr rounds after it:
//
//   d == 1: y votes whether it sees x;
//   d >= 2: y tallies the stake of the witnesses p of round ry - 1 that it
//           strongly sees, `yes` those that voted for x, `no` the others;
//           v = yes >= no, super = 3 * max(yes, no) > 2 * tot.  On a coin
//           round (d % coin_period == 0) y votes v when super, else its
//           coin bit; otherwise it votes v, and a super tally decides x.
//
// x is decided in the first round with a deciding y: famous[x] is the
// tally's vote of the smallest such y, decided_at[x] that round.  An
// empty slot (-1) votes nothing and is never decided.  With `exact` (forks,
// or a stake total at or past 2^24) a creator's stake counts once in each
// of yes and no, however many of its witnesses of round ry - 1 qualify.
//
// Replaces no Pallas kernel.  It replaces the reference's jitted lax.scan of
// fame_scan (tpu_swirld/tpu/pipeline.py:372-491): a scan over rounds whose
// step tallies every (y, x) pair of the round at once with a float32 matmul,
// or with forks a per-creator boolean matmul, one device program a stage
// call.
//
// Why slots are independent.  In the reference's step the column of the
// vote matrix for x depends only on the same column of the previous vote,
// on round ry's and round ry - 1's cells, on creators, stake and coins;
// famous[x] and decided_at[x] are written only while famous[x] < 0.  So a
// column is computed alone, from round xr + 1, and it stops at the round
// that decides it: its later votes reach no output.
//
// What bounds it on an H100: latency, not bytes or operations.  The work is
// byte gathers of cells between witnesses and a few popcounts a cell, and
// each slot's result hangs on a chain of rounds.  The design:
//
// 1. A block takes slots of one round xr (a warp a slot), and its warps
//    share each later round ry: the block builds the
//    round's plan once in shared memory and stages round ry's strongly-sees
//    cells once, as one bit row over the slots p of round ry - 1 for each
//    voter y (tiles of voters where a round is wide).  No cell is gathered
//    outside the kernel: it reads `sees` and `ssm` (the full matrix, or the
//    column store through col_pos, -1 strongly seen by none) by witness
//    index, an event clipped to [0, n) as the reference clips it.  Only a
//    group rank's row view hands in gathered cells (sp, ss as [r-1][p][y]),
//    read through the same accessor (SRC == kCells).
// 2. Votes are bits.  A warp keeps x's votes on round ry - 1's slots as a
//    mask (ballots).  The plan holds the stake as bit-planes: plane b is the
//    mask of slots p whose creator's stake has bit b set, so a lane (a voter
//    y) tallies yes = sum_b 2^b popc(ss_y & vote & plane_b) and no alike
//    over ~vote, in uint32 arithmetic: it wraps as the reference's int32
//    sums do, and the envelope keeps 3 * max(yes, no) > 2 * tot exact.
// 3. With `exact` the plan also orders the round's slots: first the slots
//    of creators with one slot in round ry - 1, in slot order, then those
//    of each forked creator (two or more slots) as one run, the runs in
//    creator order.  Planes, staged rows and the warp's votes (permuted once
//    a round) follow that order, and a run's stake stands at its last
//    position alone.  A creator counts once iff its run meets the set: with
//    M the runs' other positions and E their last ones, ((a & M) + M + c)
//    carries into a run's last position iff a has a bit in the run (c, the
//    carry out of the word before, continues a run across words), so a
//    lane replaces a word a of its yes or no set by (a & ~(M | E)) | (((a &
//    M) + M + c | a) & E) before the plane popcounts: the reference's
//    per-creator OR (pipeline.py:415-428) in a few operations a word.
//    Without forks the order is the slots' own and M and E are empty.
// 4. The first deciding voter is a ballot and __ffs over each 32 voters, in
//    voter order: the smallest eligible y, the reference's argmax(eligible).
// 5. Cost follows each round's own width, not S: the block reads a round's
//    width (one past its last witness slot) from the table on the card, so
//    the caller passes a table with any slot capacity and pulls nothing.
//    Blocks whose slots are all empty write -1 and exit; a block stops when
//    its slots are decided, or when no later round holds a witness.
//
// Plain C interface (bound with ctypes): fame_scan_launch returns the
// cudaError_t of the launch, 0 on success.  Launches on the caller's
// stream, allocates nothing: famous and decided_at are the caller's, written
// whole.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 0, kColumns = 1, kCells = 2;   // where the cells come from
constexpr int kMinBlocks = 2;    // blocks of 16 warps an SM (64 registers a thread)

struct Fame {
  const int* tab;           // [r_max][s_max], -1 an empty slot
  const uint8_t* sees;      // (n, n); kCells: [r_max - 1][s_max][s_max] as [r-1][p][y]
  const uint8_t* ssm;       // (n, n) or (n, ld) columns; kCells: as sees
  const int* col_pos;       // kColumns: [n], -1 no column
  const int* creator;       // [n]
  const uint8_t* coin;      // [n]: coin bits
  const int* stake;         // [m]
  int8_t* famous;           // [r_max * s_max]
  int* dec;                 // [r_max * s_max]
  int n, ld, m, r_max, s_max, tot2, coin_period, ss_words;
};

// Dynamic shared memory in 32-bit words, SW = ceil(s_max / 32): the votes
// (two masks a slot), 32 stake planes, the staged strongly-sees rows
// (ss_words), and with `exact` four masks (forked slots, those not their
// creator's last; the runs' other and last positions) and the slot of each
// position (uint16).
__host__ __device__ inline size_t smem_words(int s_max, int warps, int ss_words, bool exact) {
  const size_t sw = (s_max + 31) / 32;
  size_t w = 2 * (size_t)warps * sw + 32 * sw + ss_words;
  if (exact) w += 4 * sw + (s_max + 1) / 2;
  return w;
}

// One past the last witness slot of row r (0 if none), max-ed into *width.
__device__ inline void scan_width(const Fame& a, int r, int* width) {
  const int S = a.s_max, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int* row = a.tab + (size_t)r * S;
  int best = 0;
  for (int c = threadIdx.x >> 5; c * 32 < S; c += W) {
    const int i = c * 32 + lane;
    const unsigned b = __ballot_sync(~0u, i < S && row[i] >= 0);
    if (b) best = c * 32 + 32 - __clz(b);
  }
  if (lane == 0 && best) atomicMax(width, best);
}

// Whether any row from r on holds a witness (block-wide; independent
// coalesced loads, a thread every blockDim.x entries).
__device__ inline bool rows_hold_witness(const Fame& a, int r) {
  const size_t end = (size_t)a.r_max * a.s_max;
  bool any = false;
#pragma unroll 8
  for (size_t i = (size_t)r * a.s_max + threadIdx.x; i < end; i += blockDim.x)
    any |= a.tab[i] >= 0;
  return __syncthreads_or(any);
}

__device__ inline bool bit_of(const uint32_t* m, int i) { return m[i >> 5] >> (i & 31) & 1; }

template <bool EXACT, int SRC>
__global__ void __launch_bounds__(512, kMinBlocks) fame_kernel(Fame a) {
  extern __shared__ uint32_t sm[];
  __shared__ int s_width[2];        // the width of a round, by round parity
  __shared__ unsigned s_or[2];      // the OR of its slots' stakes
  const int S = a.s_max, SW = (S + 31) >> 5, n = a.n;
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* votes = sm;                              // [W][2][SW]
  uint32_t* planes = votes + 2 * (size_t)W * SW;     // [32][SW]
  uint32_t* ss = planes + 32 * SW;                   // [TY][PW | 1]
  uint32_t* dupm = ss + a.ss_words;                  // EXACT: slots of forked creators
  uint32_t* nlm = dupm + SW;                         // EXACT: ... not their creator's last
  uint32_t* runm = nlm + SW;                         // EXACT: M, a run's other positions
  uint32_t* ende = runm + SW;                        // EXACT: E, a run's last position
  uint16_t* perm = (uint16_t*)(ende + SW);           // EXACT: the slot at each position
  int* pcre = (int*)ss;                              // EXACT: the plan's creators

  // this warp's slot x: round xr, slot xs, event xe
  const int xr = blockIdx.y, xs = blockIdx.x * W + warp;
  const int e = xs < S ? a.tab[(size_t)xr * S + xs] : -1;
  const int xe = min(e, n - 1);
  int fam = -1, dec = -1;
  bool live = e >= 0;                // x valid and undecided
  uint32_t* vbuf = votes + (size_t)warp * 2 * SW;   // x's two vote masks
  if (threadIdx.x < 2) {
    s_width[threadIdx.x] = 0;
    s_or[threadIdx.x] = 0;
  }
  if (EXACT)
    for (int k = threadIdx.x; k < SW; k += blockDim.x) dupm[k] = nlm[k] = 0;
  if (__syncthreads_or(live) && xr + 1 < a.r_max) {
    // d == 1: the voters of round xr + 1 vote whether they see x
    int ry = xr + 1;
    scan_width(a, ry, &s_width[ry & 1]);
    __syncthreads();
    int Y = s_width[ry & 1];
    if (threadIdx.x == 0) s_width[(ry + 1) & 1] = 0;
    const int* rowy = a.tab + (size_t)ry * S;
    if (live) {
#pragma unroll 4
      for (int c = 0; c * 32 < Y; ++c) {
        const int y = c * 32 + lane;
        const int ye = y < Y ? rowy[y] : -1;
        bool v = false;
        if (ye >= 0)
          v = SRC == kCells ? a.sees[((size_t)xr * S + xs) * S + y] != 0
                            : a.sees[(size_t)min(ye, n - 1) * n + xe] != 0;
        const unsigned b = __ballot_sync(~0u, v);
        if (lane == 0) vbuf[c] = b;
      }
    }
    __syncthreads();
    // cur: the mask of x's votes in slot order; without EXACT the tally
    // writes the other and they swap, with EXACT the votes are first
    // permuted into the other (the plan's order) and the tally writes cur
    int cur = 0, P = Y;
    for (ry = xr + 2; ry < a.r_max; ++ry) {
      const int d = ry - xr, PW = (P + 31) >> 5;
      const int* rowp = a.tab + (size_t)(ry - 1) * S;
      rowy = a.tab + (size_t)ry * S;
      // phase 1: this round's width; the plan of round ry - 1: stake planes
      // (EXACT: zeroed, set in pass B) and each slot's creator, -1 for an
      // empty slot or a creator outside the stake (it counts in no tally)
      scan_width(a, ry, &s_width[ry & 1]);
      if (EXACT) {
        for (int i = threadIdx.x; i < 32 * PW; i += blockDim.x)
          planes[(i / PW) * SW + i % PW] = 0;
        for (int k = threadIdx.x; k < PW; k += blockDim.x) runm[k] = ende[k] = 0;
      }
      for (int k = warp; k < PW; k += W) {
        const int p = k * 32 + lane;
        const int pe = p < P ? rowp[p] : -1;
        int c = -1;
        unsigned s = 0;
        if (pe >= 0) {
          c = a.creator[min(pe, n - 1)];
          if (c >= 0 && c < a.m) s = (unsigned)a.stake[c];
          else c = -1;
        }
        if (EXACT) {
          pcre[p] = c;
        } else {
          unsigned mine = 0;
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            const unsigned w = __ballot_sync(~0u, s >> b & 1);
            if (lane == b) mine = w;
          }
          planes[lane * SW + k] = mine;
        }
        const unsigned o = __reduce_or_sync(~0u, s);
        if (lane == 0 && o) atomicOr(&s_or[ry & 1], o);
      }
      __syncthreads();
      Y = s_width[ry & 1];
      const unsigned sor = s_or[ry & 1];
      if (threadIdx.x == 0) {
        s_width[(ry + 1) & 1] = 0;
        s_or[(ry + 1) & 1] = 0;
      }
      if (Y == 0) {
        // no voter: round ry's votes are all false; stop unless a later
        // round holds witnesses (then it tallies over an empty round)
        if (!rows_hold_witness(a, ry + 1)) break;
        P = 0;
        cur ^= 1;
        continue;
      }
      if (EXACT) {
        // pass A: the slots whose creator has another slot in the round,
        // and those that are not their creator's last (a warp a slot p,
        // its lanes over the other slots q)
        for (int p = warp; p < P; p += W) {
          const int c = pcre[p];
          if (c < 0) continue;
          bool other = false, after = false;
          for (int q = lane; q < P; q += 32) {
            const bool same = pcre[q] == c && q != p;
            other |= same;
            after |= same && q > p;
          }
          other = __any_sync(~0u, other);
          after = __any_sync(~0u, after);
          if (lane == 0 && other) atomicOr(&dupm[p >> 5], 1u << (p & 31));
          if (lane == 0 && after) atomicOr(&nlm[p >> 5], 1u << (p & 31));
        }
        __syncthreads();
        // pass B: each slot's position (the other slots in slot order, then
        // the forked ones by (creator, slot)), M and E, and the stake bits
        // at the position of a slot of its own creator or a run's last
        int D = 0;
        for (int k = 0; k < PW; ++k) D += __popc(dupm[k]);
        for (int p = warp; p < P; p += W) {
          const int c = pcre[p];
          const bool dup = bit_of(dupm, p), last = !bit_of(nlm, p);
          int below = 0, rank = 0;
          for (int q = lane; q < P; q += 32) {
            const bool dq = bit_of(dupm, q);
            const int cq = pcre[q];
            below += dq && q < p;
            rank += dq && (cq < c || (cq == c && q < p));
          }
          below = __reduce_add_sync(~0u, below);
          rank = __reduce_add_sync(~0u, rank);
          const int pos = dup ? P - D + rank : p - below;
          const unsigned s = c >= 0 && (!dup || last) ? (unsigned)a.stake[c] : 0u;
          if (s >> lane & 1) atomicOr(&planes[lane * SW + (pos >> 5)], 1u << (pos & 31));
          if (lane == 0) {
            perm[pos] = (uint16_t)p;
            if (dup) atomicOr(last ? &ende[pos >> 5] : &runm[pos >> 5], 1u << (pos & 31));
          }
        }
        __syncthreads();
        for (int k = threadIdx.x; k < PW; k += blockDim.x) dupm[k] = nlm[k] = 0;
        // x's votes in the plan's order
        if (live) {
          const uint32_t* va = vbuf + cur * SW;
          uint32_t* vb = vbuf + (cur ^ 1) * SW;
          for (int j = 0; j < PW; ++j) {
            const int pos = j * 32 + lane;
            const unsigned w = __ballot_sync(~0u, pos < P && bit_of(va, perm[pos]));
            if (lane == 0) vb[j] = w;
          }
        }
        __syncwarp();
      }
      // tiles of voters: stage their strongly-sees rows, then tally
      const int stride = PW | 1;
      const int TY = (a.ss_words / stride) & ~31;
      const bool coin_round = d % a.coin_period == 0;
      for (int t0 = 0; t0 < Y; t0 += TY) {
        const int ty = min(TY, Y - t0);
        const int nyb = (ty + 31) >> 5;
        // a job: one word of positions (a lane a slot p) over 32 voters,
        // whose events lane r loads once and hands round by shuffles, so
        // that the job's 32 cell loads are all in flight at once
        for (int job = warp; job < PW * nyb; job += W) {
          const int k = job % PW, yl0 = (job / PW) * 32;
          const int j = k * 32 + lane;
          const int p = EXACT && j < P ? (int)perm[j] : j;
          int col = -1;             // p's column, -1: strongly seen by none
          if (j < P) {
            const int pe = rowp[p];
            if (pe >= 0) {
              const int ev = min(pe, n - 1);
              col = SRC == kColumns ? a.col_pos[ev] : SRC == kCells ? p : ev;
            }
          }
          const bool mine_in = yl0 + lane < ty;
          const int ye_mine = mine_in ? rowy[t0 + yl0 + lane] : -1;
          unsigned mine = 0;
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const int ye = __shfl_sync(~0u, ye_mine, r);
            bool bit = false;
            if (ye >= 0 && col >= 0)
              bit = SRC == kCells
                  ? a.ssm[((size_t)(ry - 1) * S + p) * S + t0 + yl0 + r] != 0
                  : a.ssm[(size_t)min(ye, n - 1) * a.ld + col] != 0;
            const unsigned w = __ballot_sync(~0u, bit);
            if (lane == r) mine = w;
          }
          if (mine_in) ss[(yl0 + lane) * stride + k] = mine;
        }
        __syncthreads();
        if (live) {
          const uint32_t* vp = vbuf + (EXACT ? cur ^ 1 : cur) * SW;
          uint32_t* vn = vbuf + (EXACT ? cur : cur ^ 1) * SW;
          for (int c = 0; c * 32 < ty; ++c) {
            const int yl = c * 32 + lane;
            const int ye = yl < ty ? rowy[t0 + yl] : -1;
            const uint32_t* srow = ss + yl * stride;
            unsigned yes = 0, no = 0;
            uint32_t cy = 0, cn = 0;          // EXACT: a run continued from word k - 1
            for (int k = 0; k < PW; ++k) {
              const uint32_t s = srow[k], v = vp[k];
              uint32_t ay = s & v, an = s & ~v;
              if (EXACT) {
                // each forked creator once: a run's last position stands
                // for the run, set iff the run meets the set
                const uint32_t mk = runm[k], ek = ende[k];
                if (mk | ek) {
                  const uint64_t sy = (uint64_t)(ay & mk) + mk + cy;
                  const uint64_t sn = (uint64_t)(an & mk) + mk + cn;
                  cy = (uint32_t)(sy >> 32);
                  cn = (uint32_t)(sn >> 32);
                  ay = (ay & ~(mk | ek)) | (((uint32_t)sy | ay) & ek);
                  an = (an & ~(mk | ek)) | (((uint32_t)sn | an) & ek);
                }
              }
              for (unsigned bits = sor; bits; bits &= bits - 1) {
                const int b = __ffs(bits) - 1;
                const uint32_t pl = planes[b * SW + k];
                yes += (unsigned)__popc(ay & pl) << b;
                no += (unsigned)__popc(an & pl) << b;
              }
            }
            const bool vt = (int)yes >= (int)no;
            const bool sup = (int)(3u * (vt ? yes : no)) > a.tot2;
            bool vote = false, el = false;
            if (ye >= 0) {
              if (coin_round) {
                vote = sup ? vt : a.coin[min(ye, n - 1)] > 0;
              } else {
                vote = vt;
                el = sup;
              }
            }
            const unsigned vb = __ballot_sync(~0u, vote);
            if (lane == 0) vn[(t0 >> 5) + c] = vb;
            const unsigned eb = __ballot_sync(~0u, el);
            if (eb) {
              fam = __shfl_sync(~0u, (int)vt, __ffs(eb) - 1);
              dec = ry;
              live = false;
              break;
            }
          }
        }
        if (!__syncthreads_or(live)) break;
      }
      if (!__syncthreads_or(live)) break;
      P = Y;
      if (!EXACT) cur ^= 1;
    }
  }
  if (lane == 0 && xs < S) {
    a.famous[(size_t)xr * S + xs] = (int8_t)fam;
    a.dec[(size_t)xr * S + xs] = dec;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in first; the
// caller keeps it under the card's 227 KB.
template <bool EXACT, int SRC>
cudaError_t launch(const Fame& a, int warps, int smem, cudaStream_t s) {
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        fame_kernel<EXACT, SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((a.s_max + warps - 1) / warps, a.r_max);
  fame_kernel<EXACT, SRC><<<grid, warps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool EXACT>
cudaError_t launch_src(const Fame& a, int src, int warps, int smem, cudaStream_t s) {
  if (src == kColumns) return launch<EXACT, kColumns>(a, warps, smem, s);
  if (src == kCells) return launch<EXACT, kCells>(a, warps, smem, s);
  return launch<EXACT, kSlab>(a, warps, smem, s);
}

}  // namespace

extern "C" int fame_scan_launch(
    const void* tab, const void* sees, const void* ssm, const void* col_pos,
    const void* creator, const void* coin, const void* stake, int n, int ld,
    int m, int r_max, int s_max, int tot, int coin_period, int exact, int src,
    void* famous, void* dec, int warps, int ss_words,
    int smem_bytes, void* stream) {
  if (r_max <= 0 || s_max <= 0) return 0;
  const int sw = (s_max + 31) / 32;
  if (warps < 1 || warps > 16 || s_max >= 32768 || src < kSlab || src > kCells ||
      ss_words < 32 * (sw | 1) ||
      (size_t)smem_bytes != 4 * smem_words(s_max, warps, ss_words, exact != 0))
    return (int)cudaErrorInvalidValue;
  Fame a{(const int*)tab, (const uint8_t*)sees, (const uint8_t*)ssm,
         (const int*)col_pos, (const int*)creator, (const uint8_t*)coin,
         (const int*)stake, (int8_t*)famous, (int*)dec, n, ld, m, r_max, s_max,
         2 * tot, coin_period, ss_words};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(exact ? launch_src<true>(a, src, warps, smem_bytes, s)
                     : launch_src<false>(a, src, warps, smem_bytes, s));
}
