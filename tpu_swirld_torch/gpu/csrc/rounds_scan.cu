// rounds_scan: round assignment and witness registration over the events
// [start, start + length) of a DAG in topological order, resumed from the
// carry (rnd[n], wits[n], tab[r_max][s_max], cnt[r_max], overflow[1]) and
// updated in place.  For each event i below n_valid:
//
//   genesis (p1 < 0):  r = 0, a witness
//   otherwise:         r0 = max(rnd[p1], rnd[p2]), the witnesses w of window
//                      row r0 - r_base that event i strongly sees (ss[i][w],
//                      read through col_pos on the columns path, -1 = no
//                      column), their stake summed per slot, or per member
//                      ("any witness of member m") when forks are packed;
//                      r = r0 + (3 * amount > 2 * tot_stake), a witness iff
//                      r > rnd[p1]
//
// then a witness lands in slot cnt[r - r_base] of its window row, in event
// order; one outside the window sets OVF_ROUND (1), one past a full row
// OVF_SLOT (2).  Events at or past n_valid are padding: round 0, never a
// witness.  Gathers clip exactly where the reference's do.
//
// Replaces no Pallas kernel.  It replaces the reference's jitted lax.scan
// over _make_rounds_step (tpu_swirld/tpu/pipeline.py:301), the scan of
// rounds_scan (:260), rounds_chunk_stage (:922) and rounds_span_stage
// (:948), which XLA runs as one device program a call.  Without it the
// port ran the same step as some 50 PyTorch operations an event, launched
// from a Python loop on the host, and the card sat idle ~90% of the scan.
//
// What bounds it on an H100: neither bytes nor operations.  The scan is
// serial over events (an event's round reads its parents' rounds and the
// witness row its own registrations fill), so its time is the latency of
// one step times the events: a few dependent loads (the parents, their
// rounds, the witness row's columns and strongly-sees bits) and two or
// three block barriers.  The design is one thread block a launch that
// loops over the span:
//
// - the threads split the s_max witness slots of the row (and, with
//   forks, the M members), gather and sum the stake, and reduce it with
//   warp shuffles and one word a warp in shared memory;
// - thread 0 registers the witness and writes the event's round, then a
//   barrier makes both visible to the next step;
// - the witness table and counts live in shared memory when they fit
//   (tab_in_smem, decided by the caller: kernels.rounds_scan_route),
//   else in device memory, through the same generic pointer; with forks a
//   per-member stamp (the last event that saw a witness of the member)
//   replaces the per-step clear of a member mask;
// - padding events are written by all threads at once after the loop.
//
// Several events a step where the DAG allows it, or prefetching the next
// events' rows, is later work.
//
// Plain C interface (bound with ctypes): rounds_scan_launch returns the
// cudaError_t of the launch, 0 on success.  Launches on the caller's
// stream, allocates nothing.  parents and ssm are the span's rows:
// parents[length][2], ssm[length][n_cols].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int OVF_ROUND = 1;
constexpr int OVF_SLOT = 2;

struct Scan {
  const int* parents;       // [length][2]
  const uint8_t* ssm;       // [length][n_cols]
  int n_cols;
  const int* col_pos;       // [n], or null: ssm's columns are events
  const int* creator;       // [n]
  const int* stake;         // [M]
  int n_members;
  int* rnd;                 // [n]
  uint8_t* wits;            // [n]
  int* tab;                 // [r_max][s_max]
  int* cnt;                 // [r_max]
  int* overflow;            // [1]
  int n, r_max, s_max, start, length, n_valid, r_base, tot_stake;
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool FORKS>
__global__ void __launch_bounds__(MAX_THREADS)
scan_kernel(Scan a, int tab_in_smem) {
  extern __shared__ int smem[];
  __shared__ long long warp_part[MAX_THREADS / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = (nt + 31) >> 5;
  const int M = a.n_members, S = a.s_max, R = a.r_max, n = a.n;

  // dynamic shared memory: [seen M, forks only][tab R * S][cnt R]
  int* seen = smem;
  int* tab = a.tab;
  int* cnt = a.cnt;
  if (FORKS)
    for (int m = tid; m < M; m += nt) seen[m] = -1;
  if (tab_in_smem) {
    tab = smem + (FORKS ? M : 0);
    cnt = tab + R * S;
    for (int k = tid; k < R * S; k += nt) tab[k] = a.tab[k];
    for (int k = tid; k < R; k += nt) cnt[k] = a.cnt[k];
  }
  __syncthreads();

  int ovf = 0;                          // thread 0's
  const int stop = min(a.start + a.length, max(a.n_valid, a.start));
  for (int i = a.start; i < stop; ++i) {
    const int e = i - a.start;
    const int p1 = __ldg(a.parents + 2 * e);
    int r;
    bool is_wit;
    if (p1 < 0) {                       // genesis: round 0 and a witness
      r = 0;
      is_wit = true;
    } else {
      const int p2 = max(__ldg(a.parents + 2 * e + 1), 0);
      // rnd is written by this kernel: plain loads, never the read-only path
      const int rp1 = a.rnd[min(p1, n - 1)];
      const int r0 = max(rp1, a.rnd[min(p2, n - 1)]);
      const int r0w = r0 - a.r_base;                 // window row
      const int r0c = min(max(r0w, 0), R - 1);
      const bool row_ok = r0c == r0w;
      const int* row = tab + r0c * S;
      const uint8_t* ss_row = a.ssm + (size_t)e * a.n_cols;
      long long part = 0;
      for (int s = tid; s < S; s += nt) {
        const int w = row[s];
        if (w < 0 || !row_ok) continue;
        const int wc = min(w, n - 1);
        bool ss;
        if (a.col_pos != nullptr) {
          const int pos = __ldg(a.col_pos + wc);     // -1: no column
          ss = pos >= 0 && __ldg(ss_row + min(pos, a.n_cols - 1)) != 0;
        } else {
          ss = __ldg(ss_row + wc) != 0;
        }
        if (!ss) continue;
        const int cre = __ldg(a.creator + wc);
        if (FORKS) {
          if (cre >= 0 && cre < M) seen[cre] = i;    // any witness of member cre
        } else {
          // no forks: at most one witness a (creator, round)
          part += __ldg(a.stake + min(max(cre, 0), M - 1));
        }
      }
      if (FORKS) {
        __syncthreads();
        for (int m = tid; m < M; m += nt)
          if (seen[m] == i) part += __ldg(a.stake + m);
      }
      part = warp_sum(part);
      if (lane == 0) warp_part[warp] = part;
      __syncthreads();
      long long amount = 0;
      if (tid == 0)
        for (int k = 0; k < n_warps; ++k) amount += warp_part[k];
      r = r0 + (3 * amount > 2 * (long long)a.tot_stake ? 1 : 0);
      is_wit = r > rp1;
    }
    if (tid == 0) {
      const int rw = r - a.r_base;
      const int rc = min(max(rw, 0), R - 1);
      const bool in_window = rc == rw;
      const int slot = cnt[rc];
      if (is_wit && !in_window) ovf |= OVF_ROUND;
      if (is_wit && slot >= S) ovf |= OVF_SLOT;
      if (is_wit && slot < S && in_window) {
        tab[rc * S + slot] = i;
        cnt[rc] = slot + 1;
      }
      a.rnd[i] = r;
      a.wits[i] = is_wit ? 1 : 0;
    }
    __syncthreads();
  }
  // padding: round 0, never a witness
  for (int i = stop + tid; i < a.start + a.length; i += nt) {
    a.rnd[i] = 0;
    a.wits[i] = 0;
  }
  if (tid == 0 && ovf) a.overflow[0] |= ovf;
  if (tab_in_smem) {
    for (int k = tid; k < R * S; k += nt) a.tab[k] = tab[k];
    for (int k = tid; k < R; k += nt) a.cnt[k] = cnt[k];
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in first; the
// caller sizes it (at most the card's 227 KB less the static words).
template <bool FORKS>
cudaError_t launch(const Scan& a, int tab_in_smem, int threads, int smem,
                   cudaStream_t s) {
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<FORKS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  scan_kernel<FORKS><<<1, threads, smem, s>>>(a, tab_in_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rounds_scan_launch(
    const void* parents, const void* ssm, int n_cols, const void* col_pos,
    const void* creator, const void* stake, int n_members, void* rnd,
    void* wits, void* tab, void* cnt, void* overflow, int n, int r_max,
    int s_max, int start, int length, int n_valid, int r_base, int tot_stake,
    int has_forks, int tab_in_smem, int threads, int smem_bytes,
    void* stream) {
  Scan a{(const int*)parents, (const uint8_t*)ssm, n_cols, (const int*)col_pos,
         (const int*)creator, (const int*)stake, n_members, (int*)rnd,
         (uint8_t*)wits, (int*)tab, (int*)cnt, (int*)overflow, n, r_max,
         s_max, start, length, n_valid, r_base, tot_stake};
  cudaStream_t s = (cudaStream_t)stream;
  if (length <= 0) return 0;
  return (int)(has_forks ? launch<true>(a, tab_in_smem, threads, smem_bytes, s)
                         : launch<false>(a, tab_in_smem, threads, smem_bytes, s));
}
