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
// (:948), which XLA runs as one device program a call.
//
// Several events a step.  Take a run of consecutive events in which no
// event's parent lies inside the run: no event of the run reads a round
// that another writes, and, since strongly-sees implies ancestry, none
// strongly sees a witness that another registers.  So the run's rounds
// all come from the table as it stood at the run's start, and only the
// registration goes in event order.  A step:
//
// - every warp ballots the next events' staged parents: the run is the
//   longest prefix, at most one event a warp, whose parents all lie before
//   its first event (the first event, genesis and padding always join);
// - warp k computes the run's k-th event: its parents' rounds, then the
//   row's slots, each a shared load of the slot's entry and (column, stake
//   or member) and one strongly-sees byte, four or eight bytes a lane in
//   flight at once, summed with warp reductions; with forks a per-warp
//   member bitmask in shared memory counts a member once;
// - after a barrier warp 0 registers the run in event order: a lane an
//   event, the slot a count of the earlier lanes that register in the
//   same row (__match_any_sync), OVF_ROUND / OVF_SLOT exactly as one event
//   at a time sets them, a row that fills in the middle of a run included;
//   a second barrier ends the step.
//   The rule above holds for any DAG; the kernel does not assume it of its
//   inputs: an event whose row an earlier event of the run wrote, where it
//   strongly sees that witness or the slot lay below the row's bound (it
//   may have held an entry), ends the run before it (the next step
//   recomputes the rest), so the outputs equal the one-event-a-step scan
//   on any input.
//
// Each table slot's column position and stake (or member) sit beside the
// table, computed once a launch and at each registration (column
// positions change only between calls); the table, those and the counts
// live in shared memory when they fit (tab_in_smem, decided by the caller:
// kernels.rounds_scan_plan), else the table and the slot info in device
// memory, read once a launch with 16-byte loads.  Each row carries a bound
// past its last entry and its count, so a row of 2 019 slots with 200
// witnesses costs 200.
//
// The check epilogue (check != null): after the scan the block writes the
// call's witness-column check, int32 [3 + check_cap]: the overflow word,
// the number of table witnesses whose col_pos is -1 (-1 when more table
// entries lack a column than the list holds), whether a missing one is
// "affected" (below start, or a later event of the span, padding
// included, whose max(rnd[p1], rnd[p2]) is its round; genesis counts as
// -1), and those witnesses ascending, -1 after.  The host reads it in
// place of the table and the rounds.
//
// What bounds it on an H100: neither bytes nor operations.  The scan is
// serial over steps, so its time is a step's latency times the steps: a
// shared-memory parent read, the parents' rounds, the strongly-sees bytes
// from device memory, a warp reduction, two block barriers and warp 0's
// registration.  The DAG sets the steps: about 7 events a step at 64
// members (configs 3 and 4), 14 at 256 (config 5).  A call's fixed part is
// the table's prologue and the check.
//
// Plain C interface (bound with ctypes): rounds_scan_launch returns the
// cudaError_t of the launch, 0 on success.  Launches on the caller's
// stream, allocates nothing.  parents and ssm are the span's rows:
// parents[length][2], ssm[length][n_cols]; info is the caller's scratch of
// r_max * s_max int2 for the device-memory route (else null); stats, if
// not null, gets the steps and the runs a conflict cut added to it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 32;        // a block of 32 warps: at most 32 events a step
constexpr int PAR_WIN = 512;     // span events whose inputs are staged at once
constexpr int OVF_ROUND = 1;
constexpr int OVF_SLOT = 2;
constexpr int CHECK_HEAD = 3;
constexpr unsigned FULL = 0xffffffffu;

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
  int2* info_g;             // [r_max * s_max] scratch, device-memory route
  int* check;               // [CHECK_HEAD + check_cap], or null
  int check_cap;
  int* stats;               // [2], or null
  int n, r_max, s_max, start, length, n_valid, r_base, tot_stake;
  int tab_in_smem;
};

// the run's per-event results, written by each event's warp, read by warp 0
struct StepOut {
  int r[WARPS];
  int row[WARPS];           // table row read, -1: none (genesis, outside)
  int wit[WARPS];
  int c0[WARPS];            // count and bound of the row the event registers
  int h0[WARPS];            //   in, as they stood at the step's start
  unsigned ssrun[WARPS];    // bit k: strongly sees the run's k-th event
  int2 info[WARPS];         // the event's slot info, should it register
};

// the warp's sum of v, exact while |v| < 2^57 a lane: the low 27 bits and
// the rest, each summed over the 32 lanes inside 32 bits
__device__ __forceinline__ long long warp_sum(long long v) {
  const unsigned lo = __reduce_add_sync(FULL, (unsigned)(v & ((1 << 27) - 1)));
  const int hi = (int)__reduce_add_sync(FULL, (unsigned)(int)(v >> 27));
  return (long long)lo + ((long long)hi << 27);
}

// A lane's share of one table row: slots lane, lane + 32, ... below h, B
// at a time, every strongly-sees byte of a batch loaded before any is used
// (an empty slot's column is clamped; a slot past h loads nothing), so
// one wait on memory covers 32 * B slots.  Without forks it returns the
// stake of the slots the event strongly sees; with forks it sets their
// members' bits in the warp's mask and returns 0.
template <bool FORKS, int B>
__device__ __forceinline__ long long tally(const int* trow, const int2* irow, int h,
                                           const uint8_t* ss_row, int C, int lane,
                                           unsigned* mask) {
  long long part = 0;
  for (int s0 = lane; s0 < h; s0 += 32 * B) {
    int w[B];
    int2 f[B];
    uint8_t b[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int sl = s0 + 32 * u;
      w[u] = sl < h ? trow[sl] : -1;
      f[u] = sl < h ? irow[sl] : make_int2(-1, 0);
    }
#pragma unroll
    for (int u = 0; u < B; ++u)
      b[u] = s0 + 32 * u < h ? __ldg(ss_row + min(max(f[u].x, 0), C - 1)) : 0;
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const bool seen = w[u] >= 0 && f[u].x >= 0 && b[u] != 0;
      if (FORKS) {
        if (seen && f[u].y >= 0) atomicOr(mask + (f[u].y >> 5), 1u << (f[u].y & 31));
      } else {
        part += seen ? f[u].y : 0;      // no forks: one witness a (creator, round)
      }
    }
  }
  return part;
}

template <bool FORKS>
__global__ void __launch_bounds__(WARPS * 32)
scan_kernel(Scan a) {
  extern __shared__ int4 smem4[];
  __shared__ StepOut o;
  __shared__ int s_next, s_miss, s_flag, s_nd;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int M = a.n_members, S = a.s_max, R = a.r_max, n = a.n, C = a.n_cols;
  const int words = (M + 31) >> 5;
  const int end = a.start + a.length;
  const int stop = min(end, max(a.n_valid, a.start));
  const bool cols = a.col_pos != nullptr;

  // dynamic shared memory, in the order kernels.rounds_scan_plan sizes it:
  // [events PAR_WIN int4][need PAR_WIN][info R*S int2, tab R*S][cnt R]
  // [hi R][stake M][member masks WARPS*words, forks][check 3*cap]
  int4* ev_s = smem4;                   // (p1, clipped p2, column, creator)
  int* need_s = reinterpret_cast<int*>(ev_s + PAR_WIN);  // the first run start
  char* p = reinterpret_cast<char*>(need_s + PAR_WIN);   //   the event may join
  int2* info = a.info_g;
  int* tab = a.tab;
  if (a.tab_in_smem) {
    info = reinterpret_cast<int2*>(p);
    p += sizeof(int2) * (size_t)R * S;
    tab = reinterpret_cast<int*>(p);
    p += sizeof(int) * (size_t)R * S;
  }
  int* cnt = reinterpret_cast<int*>(p);
  int* hi = cnt + R;
  int* stake_s = hi + R;
  unsigned* masks = reinterpret_cast<unsigned*>(stake_s + M);
  int* miss_s = reinterpret_cast<int*>(masks + (FORKS ? WARPS * words : 0));
  int* first_s = miss_s + a.check_cap;
  int* sorted_s = first_s + a.check_cap;

  // ---- prologue: stake, counts, masks, then the table:
  // each entry's (column, stake or member) and each row's bound, past its
  // last entry and its count
  for (int m = tid; m < M; m += nt) stake_s[m] = __ldg(a.stake + m);
  for (int r = tid; r < R; r += nt) {
    cnt[r] = a.cnt[r];
    hi[r] = 0;
  }
  if (FORKS)
    for (int k = tid; k < WARPS * words; k += nt) masks[k] = 0;
  __syncthreads();
  auto take = [&](int k, int w) {
    if (a.tab_in_smem) tab[k] = w;
    if (w >= 0) {
      const int r = k / S;
      atomicMax(hi + r, k - r * S + 1);
      const int wc = min(w, n - 1);
      const int cre = __ldg(a.creator + wc);
      info[k] = make_int2(cols ? __ldg(a.col_pos + wc) : wc,
                          FORKS ? ((cre >= 0 && cre < M) ? cre : -1)
                                : stake_s[min(max(cre, 0), M - 1)]);
    }
  };
  const int RS = R * S;
  // 16-byte loads, four in flight a thread (the table may be megabytes)
  const int n4 = (reinterpret_cast<uintptr_t>(a.tab) & 15) == 0 ? RS >> 2 : 0;
  const int4* tab4 = reinterpret_cast<const int4*>(a.tab);
  for (int q0 = tid; q0 < n4; q0 += 4 * nt) {
    int4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * nt;
      v[u] = q < n4 ? tab4[q] : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * nt;
      if (q < n4) {
        take(4 * q, v[u].x);
        take(4 * q + 1, v[u].y);
        take(4 * q + 2, v[u].z);
        take(4 * q + 3, v[u].w);
      }
    }
  }
  for (int k = 4 * n4 + tid; k < RS; k += nt) take(k, a.tab[k]);
  __syncthreads();
  for (int r = tid; r < R; r += nt) hi[r] = max(hi[r], min(max(cnt[r], 0), S));
  __syncthreads();

  // ---- the scan, a run of events a step
  int ovf = 0;                          // warp 0's, a lane's bits
  int steps = 0, cuts = 0;              // thread 0's
  int win_lo = a.start, win_hi = a.start;
  int i0 = a.start;
  while (i0 < stop) {
    if (win_hi < min(i0 + WARPS, stop)) {  // stage the next events' inputs
      win_lo = i0;
      win_hi = min(i0 + PAR_WIN, stop);
      for (int k = tid; k < win_hi - win_lo; k += nt) {
        const int e = win_lo + k, ei = e - a.start;
        const int p1 = __ldg(a.parents + 2 * ei);
        const int q2 = min(max(__ldg(a.parents + 2 * ei + 1), 0), n - 1);
        ev_s[k] = make_int4(p1, q2, cols ? __ldg(a.col_pos + e) : e, __ldg(a.creator + e));
        need_s[k] = p1 < 0 ? INT_MIN : max(min(p1, n - 1), q2) + 1;
      }
      __syncthreads();
    }
    // the run: every warp ballots the same lanes
    const bool join = lane < WARPS && i0 + lane < stop &&
                      (lane == 0 || need_s[i0 + lane - win_lo] <= i0);
    const unsigned jm = __ballot_sync(FULL, join);
    const int run = jm == FULL ? 32 : __ffs(~jm) - 1;

    if (warp < run) {
      const int i = i0 + warp;
      const int4 ev = ev_s[i - win_lo];
      int r = 0, row = -1;
      bool wit = true;                  // genesis: round 0 and a witness
      unsigned ssrun = 0;
      if (ev.x >= 0) {
        const int q1 = min(ev.x, n - 1), q2 = ev.y;
        // rnd is written by this kernel: plain loads, never the read-only path
        const int rp1 = a.rnd[q1], rp2 = a.rnd[q2];
        const int r0 = max(rp1, rp2);
        const int r0w = r0 - a.r_base;                   // window row
        const int r0c = min(max(r0w, 0), R - 1);
        const uint8_t* ss_row = a.ssm + (size_t)(i - a.start) * C;
        // towards the run's lane-th event: loaded now, used after the slots
        int ssb = 0;
        if (lane < warp) {
          const int pk = ev_s[i0 + lane - win_lo].z;
          ssb = pk >= 0 ? __ldg(ss_row + min(pk, C - 1)) : 0;
        }
        long long part = 0;
        if (r0c == r0w) {
          row = r0c;
          const int h = hi[r0c];
          const int* trow = tab + (size_t)r0c * S;
          const int2* irow = info + (size_t)r0c * S;
          unsigned* mask = masks + warp * words;
          // a row of at most 128 slots four a lane, a longer one eight
          if (h <= 128)
            part += tally<FORKS, 4>(trow, irow, h, ss_row, C, lane, mask);
          else
            part += tally<FORKS, 8>(trow, irow, h, ss_row, C, lane, mask);
          if (FORKS) {
            __syncwarp();
            for (int wd = lane; wd < words; wd += 32) {
              unsigned bits = mask[wd];
              mask[wd] = 0;
              while (bits) {
                part += stake_s[wd * 32 + __ffs(bits) - 1];
                bits &= bits - 1;
              }
            }
          }
        }
        ssrun = __ballot_sync(FULL, ssb != 0);
        part = warp_sum(part);
        r = r0 + (3 * part > 2 * (long long)a.tot_stake ? 1 : 0);
        wit = r > rp1;
      }
      if (lane == 0) {
        const int rc = min(max(r - a.r_base, 0), R - 1);
        o.r[warp] = r;
        o.row[warp] = row;
        o.wit[warp] = wit;
        o.c0[warp] = cnt[rc];
        o.h0[warp] = hi[rc];
        o.ssrun[warp] = ssrun;
        o.info[warp] = make_int2(
            ev.z, FORKS ? ((ev.w >= 0 && ev.w < M) ? ev.w : -1)
                        : stake_s[min(max(ev.w, 0), M - 1)]);
      }
    }
    __syncthreads();

    if (warp == 0) {                    // register the run in event order
      const bool valid = lane < run;
      const int r = valid ? o.r[lane] : 0;
      const bool wit = valid && o.wit[lane];
      const int rw = r - a.r_base;
      const int rc = min(max(rw, 0), R - 1);
      const bool in_window = rc == rw;
      const int c0 = valid ? o.c0[lane] : 0;
      const unsigned lt = (1u << lane) - 1;
      // most runs register nothing: no slot counting, no conflict
      const unsigned wi = __ballot_sync(FULL, wit && in_window);
      unsigned grp = 0;
      int rank = 0;
      if (wi) {
        grp = __match_any_sync(FULL, valid ? rc : -1);
        rank = __popc(grp & wi & lt);
      }
      const int slot = c0 >= S ? c0 : min(c0 + rank, S);
      const bool reg = wit && in_window && slot < S;
      const unsigned rm = wi ? __ballot_sync(FULL, reg) : 0u;
      int keep_n = run;
      if (rm) {
        // a slot below the row's bound may have held an entry (never on a
        // table the scan filled in order)
        const unsigned fm = __ballot_sync(FULL, reg && slot < (valid ? o.h0[lane] : 0));
        // an event whose row an earlier event of the run wrote, where it
        // sees that witness or the slot may have held an entry, reads
        // another table
        const int row = valid ? o.row[lane] : -1;
        unsigned hits = row >= 0 ? (fm | (valid ? o.ssrun[lane] : 0u)) & rm & lt : 0u;
        bool conflict = false;
        while (hits) {
          const int k = __ffs(hits) - 1;
          hits &= hits - 1;
          conflict |= min(max(o.r[k] - a.r_base, 0), R - 1) == row;
        }
        const unsigned cm = __ballot_sync(FULL, valid && conflict);
        if (cm) {
          keep_n = __ffs(cm) - 1;
          cuts += lane == 0;
        }
      }
      const bool keep = lane < keep_n;
      if (keep) {
        const int i = i0 + lane;
        if (reg) {
          const size_t at = (size_t)rc * S + max(slot, 0);
          tab[at] = i;
          info[at] = o.info[lane];
        }
        a.rnd[i] = r;
        a.wits[i] = wit ? 1 : 0;
        if (wit && !in_window) ovf |= OVF_ROUND;
        if (wit && slot >= S) ovf |= OVF_SLOT;
      }
      // the last registration of each row sets its count and bound
      const unsigned km = rm & ((2u << (keep_n - 1)) - 1);
      if (reg && keep && 31 - __clz(grp & km) == lane) {
        cnt[rc] = slot + 1;
        hi[rc] = max(hi[rc], slot + 1);
      }
      if (lane == 0) {
        s_next = i0 + keep_n;
        ++steps;
      }
    }
    __syncthreads();
    i0 = s_next;
  }
  __syncthreads();
  // padding: round 0, never a witness
  for (int i = stop + tid; i < end; i += nt) {
    a.rnd[i] = 0;
    a.wits[i] = 0;
  }
  if (warp == 0) ovf = __reduce_or_sync(FULL, ovf);
  if (tid == 0) {
    if (ovf) a.overflow[0] |= ovf;
    if (a.stats != nullptr) {
      atomicAdd(a.stats, steps);
      atomicAdd(a.stats + 1, cuts);
    }
  }
  for (int r = tid; r < R; r += nt) a.cnt[r] = cnt[r];
  if (a.tab_in_smem)
    for (int k = tid; k < RS; k += nt) a.tab[k] = tab[k];
  if (a.check == nullptr) return;

  // ---- the witness-column check
  if (tid == 0) {
    s_miss = 0;
    s_flag = 0;
    s_nd = 0;
  }
  __syncthreads();
  if (cols) {
    for (int r = warp; r < R; r += WARPS)
      for (int s = lane; s < hi[r]; s += 32) {
        const size_t k = (size_t)r * S + s;
        if (tab[k] >= 0 && info[k].x < 0) {
          const int at = atomicAdd(&s_miss, 1);
          if (at < a.check_cap) miss_s[at] = tab[k];
        }
      }
  }
  __syncthreads();
  const int n_raw = s_miss;
  const bool complete = n_raw <= a.check_cap;
  if (complete) {
    // distinct values, ranked
    for (int x = tid; x < n_raw; x += nt) {
      const int v = miss_s[x];
      bool first = true;
      for (int y = 0; y < x; ++y) first &= miss_s[y] != v;
      first_s[x] = first;
    }
    __syncthreads();
    for (int x = tid; x < n_raw; x += nt) {
      if (!first_s[x]) continue;
      const int v = miss_s[x];
      int rank = 0;
      for (int y = 0; y < n_raw; ++y) rank += first_s[y] && miss_s[y] < v;
      sorted_s[rank] = v;
      atomicAdd(&s_nd, 1);
    }
    __syncthreads();
    const int nd = s_nd;
    // rounds were written by warp 0 and the padding loop: visible after the barriers
    for (int x = tid; x < nd; x += nt) {
      const int w = sorted_s[x];
      first_s[x] = a.rnd[min(w, n - 1)];  // the witness's round
      if (w < a.start) s_flag = 1;
    }
    __syncthreads();
    if (nd > 0)
      for (int e = a.start + tid; e < end; e += nt) {
        const int p1 = __ldg(a.parents + 2 * (e - a.start));
        const int p2 = __ldg(a.parents + 2 * (e - a.start) + 1);
        const int r0 = p1 < 0 ? -1 : max(a.rnd[min(p1, n - 1)], a.rnd[min(max(p2, 0), n - 1)]);
        for (int x = 0; x < nd; ++x)
          if (e > sorted_s[x] && r0 == first_s[x]) s_flag = 1;
      }
    __syncthreads();
  }
  int* out = a.check;
  const int nd = complete ? s_nd : 0;
  for (int x = tid; x < a.check_cap; x += nt) out[CHECK_HEAD + x] = x < nd ? sorted_s[x] : -1;
  if (tid == 0) {
    out[0] = a.overflow[0];
    out[1] = complete ? nd : -1;
    out[2] = complete ? s_flag : 0;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in first; the
// caller sizes it (at most the card's 227 KB less the static words).
template <bool FORKS>
cudaError_t launch(const Scan& a, int smem, cudaStream_t s) {
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<FORKS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  scan_kernel<FORKS><<<1, WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rounds_scan_launch(
    const void* parents, const void* ssm, int n_cols, const void* col_pos,
    const void* creator, const void* stake, int n_members, void* rnd,
    void* wits, void* tab, void* cnt, void* overflow, void* info, void* check,
    int check_cap, void* stats, int n, int r_max, int s_max, int start,
    int length, int n_valid, int r_base, int tot_stake, int has_forks,
    int tab_in_smem, int smem_bytes, void* stream) {
  Scan a{(const int*)parents, (const uint8_t*)ssm, n_cols, (const int*)col_pos,
         (const int*)creator, (const int*)stake, n_members, (int*)rnd,
         (uint8_t*)wits, (int*)tab, (int*)cnt, (int*)overflow, (int2*)info,
         (int*)check, check == nullptr ? 0 : check_cap, (int*)stats, n, r_max,
         s_max, start, length, n_valid, r_base, tot_stake, tab_in_smem};
  cudaStream_t s = (cudaStream_t)stream;
  if (length <= 0 && check == nullptr) return 0;
  return (int)(has_forks ? launch<true>(a, smem_bytes, s)
                         : launch<false>(a, smem_bytes, s));
}
