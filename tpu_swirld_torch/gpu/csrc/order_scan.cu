// order_scan: round received and consensus timestamp rank of every event,
// over the maximal prefix of fame-complete rounds.  For each event e below
// n_valid that is not received yet (received0[e] == 0), in ascending rounds
// r of the prefix:
//
//   e is received in r when every unique famous witness w of r has e as an
//   ancestor (anc[w][e]); its timestamp rank is then the lower median, the
//   ((nv - 1) / 2)-th smallest, of the nv values t_rank[d_w], d_w the
//   deepest self-ancestor of w within `chain` steps that still has e as an
//   ancestor (INT32_MAX when chain is 0)
//
// and e is received.  Events never received keep rr = -1 and ts = 0, and
// received = received0 | received here.
//
// A call covers the events of a column window [x0, x1) (the whole [0, n)
// on one process): anc is then the slab of those columns of every row,
// row i's byte for event e at anc[i * ld + (e - x0)], and rr, ts and
// received hold the window's events, event e at e - x0.  A rank of a
// process group runs its own events over the column slab it received
// (tpu_swirld_torch/parallel.py, exchange_columns): the walks read rows of
// any event, and only their columns of this window.  A round r is fame-complete when
// every witness slot of it is decided, max_round >= r + 2 and wit_count[r]
// > 0; its unique famous witnesses (UFWs) are its famous slots whose
// creator has no other famous slot in the round, in slot order.
//
// Replaces no Pallas kernel.  It replaces the reference's jitted lax.scan of
// order_scan (tpu_swirld/tpu/pipeline.py:497-601): a scan over rounds whose
// lax.cond (:587) decides on the device which rounds receive, with an inner
// scan of `chain` self-chain steps (:566-575) and a sort for the median
// (:577-580), one device program a stage call.
//
// What bounds it on an H100: latency, not bytes or operations.  The work is
// byte gathers of anc, a few an event and UFW, and compares; each result
// hangs on chains of dependent steps, so the design cuts the chains and
// keeps many independent loads in flight:
//
// 1. The round plan is built in the kernel, so the wrapper runs no device
//    op before the launch.  Each block builds it in shared memory as it
//    reaches a round: the round's slots and their creators (the prefix ends
//    at the first round that is not fame-complete), each famous slot's
//    creator compared with the round's other famous slots by a loop over S
//    in shared memory (no (R, S, S) tensor), and the unique ones packed in
//    slot order by warp ballots.
// 2. A walk through self_parent is three dependent loads a step, and its
//    rows do not depend on the event, so a block tabulates each UFW's
//    self-chain once.  A block is 32 consecutive events, one a lane, and 16
//    warps.  In a round where some of its events are received it tabulates
//    the chains in shared memory, a window of DEPTH rows at a time (a thread
//    a UFW walks self_parent), and each warp takes UFWs in turn: its lanes
//    read the window's anc rows at their own events, UNROLL independent
//    byte loads in flight a lane, one row coalesced over 32 consecutive
//    events, and stop at their first row that does not see them.  Another
//    window is tabulated only while some lane has seen every row of the
//    last one and the chain goes on.
// 3. The median reads each value once, and nothing goes to device memory:
//    each lane's value of each UFW stays in shared memory (val[k][lane]),
//    and a warp an event loads the values into registers and selects by
//    ballots, one bit a pass from the highest bit where the warp's least
//    and greatest value differ (the bits above it are every value's).
//
// The all-see test reads anc the same way: warp w tests UFWs w, w + 16, ...
// at its 32 events and the warps' ballots are ANDed.  A block leaves the
// round loop once none of its events is pending.
//
// Why it is exact.
// - The prefix property: anc is an ancestry closure, so a self-parent's
//   ancestors are a subset of its child's, and along a self-chain the rows
//   that see e form a prefix.  The reference overwrites the value at every
//   step that sees e, so its value is the prefix's last row's: the count of
//   leading seeing rows, found window by window, names that row.
// - Genesis: the reference's walk repeats the genesis event once there;
//   that row gives the same value again, so the tabulated chain ends there.
// - chain: exactly `chain` rows are tabulated in all (fewer at genesis);
//   with chain 0 none is, and every value stays INT32_MAX, the reference's
//   initial value.
// - Ties and INT32_MAX: the select finds the ((nv - 1) / 2)-th smallest of
//   the nv values with duplicates counted (a pass counts the candidates
//   whose bit is 0, equal values alike), over the values as int32 (sign
//   bit flipped), so INT32_MAX is the greatest as in the reference's sort;
//   the reference's masked rows sort after every UFW value and its index
//   stays below nv, so its median is this one.

// Plain C interface (bound with ctypes): order_scan_launch returns the
// cudaError_t of the launch, 0 on success.  Launches on the caller's
// stream, allocates nothing: received, rr and ts are the caller's, written
// whole over the window; received0 (may be null, [n]) is only read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int EVENTS = 32;         // events a block, one a lane
constexpr int DEPTH = 16;          // self-chain steps tabulated a window
constexpr int UNROLL = 8;          // anc loads in flight a lane
constexpr int VAL_STRIDE = 33;     // val[k][lane], padded: no bank conflicts
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT32_MAX_ = 0x7fffffff;

struct Order {
  const uint8_t* anc;        // [n][ld]: anc[i][e - x0], e an ancestor of i
  const int* tab;            // [r_max][s_max], -1 an empty slot
  const int* cnt;            // [r_max]
  const int8_t* famous;      // [r_max * s_max]: 1, 0, -1 undecided
  const int* creator;        // [n]
  const int* self_parent;    // [n], -1 at genesis
  const int* t_rank;         // [n]
  const uint8_t* received0;  // [n] or null
  const void* max_round;     // device scalar (int32 or int64) or null
  int max_round_is64;
  int max_round_value;       // when max_round is null
  uint8_t* received;         // [x1 - x0]
  int* rr;                   // [x1 - x0]
  int* ts;                   // [x1 - x0]
  int n, r_max, s_max, n_valid, chain;
  int x0, x1;                // the column window: events [x0, x1)
  int ld;                    // the slab's row stride, >= x1 - x0
};

// The dynamic shared memory of a block, S = s_max entries each.
struct Smem {
  int* ev;         // [S] the slot's event, clipped to [0, n)
  int* cre;        // [S] its creator
  int* fam;        // [S] 1 when the slot is valid and famous
  int* ufw;        // [S] the round's UFW events, packed in slot order
  int* rows;       // [S][DEPTH] the window's chain rows of each UFW
  int* trk;        // [S][DEPTH] their t_rank
  int* len;        // [S] rows in the window
  int* cur;        // [S] the next row to tabulate
  int* left;       // [S] chain steps left after the window
  unsigned* alive; // [S] lanes whose walk goes on past the window
  int* val;        // [S][VAL_STRIDE] each lane's value of each UFW
};

__device__ Smem carve(int* base, int s) {
  Smem m;
  m.ev = base;
  m.cre = m.ev + s;
  m.fam = m.cre + s;
  m.ufw = m.fam + s;
  m.rows = m.ufw + s;
  m.trk = m.rows + s * DEPTH;
  m.len = m.trk + s * DEPTH;
  m.cur = m.len + s;
  m.left = m.cur + s;
  m.alive = (unsigned*)(m.left + s);
  m.val = (int*)(m.alive + s);
  return m;
}

// Round r's plan: false when r is not fame-complete (the prefix ends),
// else true with *nv UFWs in m.ufw.
__device__ bool round_plan(const Order& a, const Smem& m, int r, long long max_round,
                           int* wcnt, int* nv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, S = a.s_max;
  bool undecided = false;
  for (int s = tid; s < S; s += THREADS) {
    const int t = __ldg(a.tab + (size_t)r * S + s);
    const int f = __ldg(a.famous + (size_t)r * S + s);
    const int we = min(max(t, 0), a.n - 1);
    undecided |= t >= 0 && f < 0;
    m.ev[s] = we;
    m.fam[s] = t >= 0 && f == 1;
    m.cre[s] = __ldg(a.creator + we);
  }
  const bool complete = max_round >= (long long)r + 2 && __ldg(a.cnt + r) > 0;
  if (!__syncthreads_and(complete && !undecided)) return false;
  int base = 0;
  for (int s0 = 0; s0 < S; s0 += THREADS) {
    const int s = s0 + tid;
    bool unique = false;
    if (s < S && m.fam[s]) {
      const int c = m.cre[s];
      int same = 0;
      for (int q = 0; q < S; ++q) same += m.fam[q] && m.cre[q] == c;
      unique = same == 1;
    }
    const unsigned b = __ballot_sync(FULL, unique);
    if (lane == 0) wcnt[warp] = __popc(b);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? wcnt[w] : 0;
      total += wcnt[w];
    }
    if (unique) m.ufw[off + __popc(b & ((1u << lane) - 1))] = m.ev[s];
    base += total;
    __syncthreads();
  }
  *nv = base;
  return true;
}

// The lower median of the nv values val[k][lane_e], k < nv: a radix select,
// one bit a pass, over the values as int32 (sign bit flipped to order them
// as unsigned).  Warp-wide; every lane returns it.
template <int J>
__device__ int lower_median(const Smem& m, int nv, int lane_e) {
  const int lane = threadIdx.x & 31;
  unsigned u[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    u[j] = k < nv ? (unsigned)m.val[k * VAL_STRIDE + lane_e] ^ 0x80000000u : 0u;
  }
  // the bits above the highest one where the values differ are every
  // value's: the passes start below them
  unsigned lo = ~0u, hi = 0u;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < nv) {
      lo = min(lo, u[j]);
      hi = max(hi, u[j]);
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lo == hi) return (int)(lo ^ 0x80000000u);
  const int top = 31 - __clz(lo ^ hi);
  const int jn = (nv + 31) / 32;
  int want = (nv - 1) / 2;
  unsigned prefix = top == 31 ? 0u : lo >> (top + 1) << (top + 1);
  for (int b = top; b >= 0; --b) {
    const unsigned above = b == 31 ? 0u : ~0u << (b + 1);
    int below = 0;   // candidates (agreeing with prefix above b) with bit b 0
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < jn) {
        const bool c = lane + 32 * j < nv && (u[j] & above) == prefix &&
                       !((u[j] >> b) & 1u);
        below += __popc(__ballot_sync(FULL, c));
      }
    }
    if (want >= below) {
      want -= below;
      prefix |= 1u << b;
    }
  }
  return (int)(prefix ^ 0x80000000u);
}

template <int J>
__global__ void __launch_bounds__(THREADS) order_kernel(Order a) {
  extern __shared__ int smem[];
  __shared__ int wcnt[WARPS];
  __shared__ unsigned wmask[WARPS];
  __shared__ int out_rr[EVENTS], out_ts[EVENTS];
  const Smem m = carve(smem, a.s_max);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = a.x0 + blockIdx.x * EVENTS + lane;   // every warp's lane l: event l
  const size_t ld = (size_t)a.ld;
  const int col = e - a.x0;                   // e's column in the slab
  const bool rec0 = e < a.x1 && a.received0 != nullptr && a.received0[e];
  unsigned pending = __ballot_sync(FULL, e < a.x1 && e < a.n_valid && !rec0);
  if (tid < EVENTS) {
    out_rr[tid] = -1;
    out_ts[tid] = 0;
  }
  long long max_round = a.max_round_value;
  if (a.max_round != nullptr)
    max_round = a.max_round_is64 ? *(const long long*)a.max_round
                                 : (long long)*(const int*)a.max_round;

  for (int r = 0; r < a.r_max && pending; ++r) {
    int nv;
    if (!round_plan(a, m, r, max_round, wcnt, &nv)) break;
    if (nv == 0) continue;

    // all-see: warp w tests UFWs w, w + WARPS, ... at its lanes' events
    bool see = (pending >> lane) & 1u;
    for (int k0 = warp; k0 < nv && __any_sync(FULL, see); k0 += WARPS * UNROLL) {
      uint8_t v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + u * WARPS;
        v[u] = (see && k < nv) ? __ldg(a.anc + (size_t)m.ufw[k] * ld + col) : 1;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) see = see && v[u];
    }
    const unsigned mine = __ballot_sync(FULL, see);
    if (lane == 0) wmask[warp] = mine;
    __syncthreads();
    unsigned newly = pending;
    for (int w = 0; w < WARPS; ++w) newly &= wmask[w];
    if (newly == 0) continue;

    // the walks: every UFW's chain, a window of DEPTH rows at a time
    for (int k = tid; k < nv; k += THREADS) {
      m.cur[k] = m.ufw[k];
      m.left[k] = a.chain;
      m.alive[k] = a.chain > 0 ? newly : 0u;
    }
    for (int k = warp; k < nv; k += WARPS) m.val[k * VAL_STRIDE + lane] = INT32_MAX_;
    bool more = __syncthreads_or(a.chain > 0);
    while (more) {
      for (int k = tid; k < nv; k += THREADS) {
        int c = m.cur[k], l = m.left[k], d = 0;
        if (m.alive[k]) {
          while (d < DEPTH && l > 0) {
            m.rows[k * DEPTH + d] = c;
            m.trk[k * DEPTH + d] = __ldg(a.t_rank + c);
            ++d;
            --l;
            const int nxt = __ldg(a.self_parent + c);
            if (nxt < 0) {        // genesis: later steps repeat it
              l = 0;
              break;
            }
            c = min(nxt, a.n - 1);
          }
        }
        m.len[k] = d;
        m.cur[k] = c;
        m.left[k] = l;
      }
      __syncthreads();
      bool goes_on = false;
      for (int k = warp; k < nv; k += WARPS) {
        const unsigned al = m.alive[k];
        if (al == 0) continue;
        const bool mine = (al >> lane) & 1u;
        const int len = m.len[k];
        const int* rows = m.rows + k * DEPTH;
        bool go = mine;
        int seen = 0;           // leading rows that see this lane's event
        for (int d0 = 0; d0 < len && __any_sync(FULL, go); d0 += UNROLL) {
          uint8_t v[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int d = d0 + u;
            v[u] = (go && d < len) ? __ldg(a.anc + (size_t)rows[d] * ld + col) : 0;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            go = go && v[u];
            seen += go;
          }
        }
        if (mine && seen > 0) m.val[k * VAL_STRIDE + lane] = m.trk[k * DEPTH + seen - 1];
        const unsigned next = __ballot_sync(FULL, mine && seen == len && m.left[k] > 0);
        if (lane == 0) m.alive[k] = next;
        goes_on |= next != 0;
      }
      more = __syncthreads_or(goes_on);
    }

    // the medians: a warp an event
    int i = 0;
    for (unsigned b = newly; b; b &= b - 1, ++i) {
      if (i % WARPS != warp) continue;
      const int le = __ffs(b) - 1;
      const int med = lower_median<J>(m, nv, le);
      if (lane == 0) {
        out_rr[le] = r;
        out_ts[le] = med;
      }
    }
    pending &= ~newly;
    __syncthreads();
  }
  __syncthreads();
  if (tid < EVENTS) {
    const int c = blockIdx.x * EVENTS + tid;  // the event's column
    if (a.x0 + c < a.x1) {
      const bool r0 = a.received0 != nullptr && a.received0[a.x0 + c];
      a.rr[c] = out_rr[tid];
      a.ts[c] = out_ts[tid];
      a.received[c] = r0 || out_rr[tid] >= 0;
    }
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in first; the
// caller keeps it under the card's 227 KB.
template <int J>
cudaError_t launch(const Order& a, int smem, cudaStream_t s) {
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        order_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int blocks = (a.x1 - a.x0 + EVENTS - 1) / EVENTS;
  order_kernel<J><<<blocks, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int order_scan_launch(
    const void* anc, int n, int x0, int x1, int ld, const void* tab,
    const void* cnt, const void* famous, const void* creator, int r_max, int s_max, const void* self_parent,
    const void* t_rank, const void* received0, const void* max_round,
    int max_round_is64, int max_round_value, int n_valid, int chain,
    void* received, void* rr, void* ts, int smem_bytes, void* stream) {
  Order a{(const uint8_t*)anc, (const int*)tab, (const int*)cnt,
          (const int8_t*)famous, (const int*)creator, (const int*)self_parent,
          (const int*)t_rank, (const uint8_t*)received0, max_round,
          max_round_is64, max_round_value, (uint8_t*)received, (int*)rr,
          (int*)ts, n, r_max, s_max, n_valid, chain, x0, x1, ld};
  if (x1 <= x0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // J registers a lane hold the values for the median: 32 J >= s_max >= nv
  if (s_max <= 64) return (int)launch<2>(a, smem_bytes, s);
  if (s_max <= 256) return (int)launch<8>(a, smem_bytes, s);
  if (s_max <= 1024) return (int)launch<32>(a, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
