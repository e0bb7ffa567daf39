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
// call.  The port ran it as a host loop of about 60 PyTorch operations a
// round.
//
// Why a block a witness slot is exact.  In the reference's step the column
// of the vote matrix for x depends only on the same column of the previous
// vote, on round ry's and round ry - 1's cells, on creators, stake and
// coins; famous[x] and decided_at[x] are written only while famous[x] < 0.
// So a column is computed alone, from round xr + 1 (before it d < 1, its
// vote all false and nothing eligible), and it stops at the round that
// decides it: its later votes reach no output.
//
// Its inputs.  The kernel reads only S x S cells between consecutive rounds,
// which the caller gathers on the device with no host pull (kernels.py,
// _fame_cells): ss[r - 1][p][y], y (slot of round r) strongly sees p (slot of
// round r - 1) (false where p has no column of the store), and sp[r - 1][p][y],
// y sees p, the d == 1 vote, since then x is a slot of round r - 1.  Gathered
// cells, not the slabs by witness index, because one layout then serves the
// full matrix, the column store and a group rank's row view (where the cells
// are one collective and the slab's rows are other ranks'), and because the
// [p][y] order makes a warp's reads of one p coalesce.
//
// What bounds it on an H100: neither bytes nor operations.  Each block loops
// over rounds; a round is three barriers and, for each thread y, S reads of
// cells and of the previous round's votes in shared memory (and with
// `exact` a walk over the earlier witnesses of the same creator), so a
// block's time is a chain of a few rounds of O(S) steps, and the W = R * S
// blocks overlap on the SMs.  Most slots decide at d = 2 or 3, so the cells a
// round holds are read by the S blocks of round ry - d for a few d, from L2.
// Staging a round's cells in shared memory, votes as bits and a warp a slot
// are later work.
//
// Plain C interface (bound with ctypes): fame_scan_launch returns the
// cudaError_t of the launch, 0 on success.  Launches on the caller's
// stream, allocates nothing: famous and decided_at are the caller's.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

struct Fame {
  const int* tab;           // [r_max][s_max], -1 an empty slot
  const uint8_t* sp;        // [r_max - 1][s_max][s_max]: sees cells, [p][y]
  const uint8_t* ss;        // [r_max - 1][s_max][s_max]: strongly-sees cells
  const int* creator;       // [n]
  const uint8_t* coin;      // [n]: coin bits
  const int* stake;         // [m]
  int8_t* famous;           // [r_max * s_max]
  int* dec;                 // [r_max * s_max]
  int n, m, r_max, s_max, tot, coin_period;
};

// dynamic shared memory: pst, pcre, dprev (ints), then vote_a, vote_b, vtal
// (bytes), each s_max long
template <bool EXACT>
__global__ void fame_kernel(Fame a) {
  extern __shared__ int smem[];
  __shared__ int first;
  const int S = a.s_max;
  int* pst = smem;                        // stake of round ry - 1's slot p
  int* pcre = pst + S;                    // its creator, -1 for an empty slot
  int* dprev = pcre + S;                  // the slot before p of its creator
  uint8_t* vprev = (uint8_t*)(dprev + S); // round ry - 1's votes on x
  uint8_t* vnew = vprev + S;              // round ry's
  uint8_t* vtal = vnew + S;               // round ry's tallies' votes
  const int tid = threadIdx.x, nt = blockDim.x;
  const int x = blockIdx.x;
  const int xr = x / S, xs = x - xr * S;
  int fam = -1, dec = -1;
  if (a.tab[x] >= 0) {
    for (int ry = xr + 1; ry < a.r_max; ++ry) {
      const int d = ry - xr;
      const int* yrow = a.tab + (size_t)ry * S;
      const int* prow = yrow - S;
      const size_t blk = (size_t)(ry - 1) * S * S;
      if (tid == 0) first = INT_MAX;
      if (d >= 2) {
        for (int p = tid; p < S; p += nt) {
          const int pe = prow[p];
          const int c = pe >= 0 ? a.creator[min(pe, a.n - 1)] : -1;
          pcre[p] = c;
          pst[p] = (c >= 0 && c < a.m) ? a.stake[c] : 0;
        }
        if (EXACT) {
          __syncthreads();
          for (int p = tid; p < S; p += nt) {
            const int c = pcre[p];
            int q = p - 1;
            if (c >= 0)
              while (q >= 0 && pcre[q] != c) --q;
            dprev[p] = c >= 0 ? q : -1;
          }
        }
      }
      __syncthreads();
      for (int y = tid; y < S; y += nt) {
        const int ye = yrow[y];
        uint8_t vote = 0, vt = 0;
        if (ye >= 0 && d == 1) {
          vote = a.sp[blk + (size_t)xs * S + y] != 0;
        } else if (ye >= 0) {
          const uint8_t* col = a.ss + blk + y;    // col[p * S]: y over p
          int yes = 0, no = 0;
          for (int p = 0; p < S; ++p) {
            if (pcre[p] < 0 || !col[(size_t)p * S]) continue;
            const uint8_t v = vprev[p];
            if (EXACT) {
              // count p only as its creator's first qualifying slot
              bool dup = false;
              for (int q = dprev[p]; q >= 0 && !dup; q = dprev[q])
                dup = col[(size_t)q * S] && vprev[q] == v;
              if (dup) continue;
            }
            if (v) yes += pst[p];
            else no += pst[p];
          }
          vt = yes >= no;
          const bool super_ = 3 * max(yes, no) > 2 * a.tot;
          if (d % a.coin_period == 0) {
            vote = super_ ? vt : (a.coin[min(ye, a.n - 1)] > 0);
          } else {
            vote = vt;
            if (super_) atomicMin(&first, y);
          }
        }
        vnew[y] = vote;
        vtal[y] = vt;
      }
      __syncthreads();
      const int f = first;
      if (f != INT_MAX) {
        fam = vtal[f];
        dec = ry;
        break;
      }
      uint8_t* t = vprev;
      vprev = vnew;
      vnew = t;
      __syncthreads();    // every thread has read `first` before its reset
    }
  }
  if (tid == 0) {
    a.famous[x] = (int8_t)fam;
    a.dec[x] = dec;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in first; the
// caller keeps it under the card's 227 KB.
template <bool EXACT>
cudaError_t launch(const Fame& a, int threads, int smem, cudaStream_t s) {
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        fame_kernel<EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  fame_kernel<EXACT><<<a.r_max * a.s_max, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fame_scan_launch(
    const void* tab, const void* sp, const void* ss, const void* creator,
    const void* coin, const void* stake, int n, int m, int r_max, int s_max,
    int tot, int coin_period, int exact, void* famous, void* dec,
    int threads, int smem_bytes, void* stream) {
  Fame a{(const int*)tab, (const uint8_t*)sp, (const uint8_t*)ss,
         (const int*)creator, (const uint8_t*)coin, (const int*)stake,
         (int8_t*)famous, (int*)dec, n, m, r_max, s_max, tot, coin_period};
  if (r_max <= 0 || s_max <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(exact ? launch<true>(a, threads, smem_bytes, s)
                     : launch<false>(a, threads, smem_bytes, s));
}
