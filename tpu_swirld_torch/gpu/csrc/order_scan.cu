// order_scan: round received and consensus timestamp rank of every event,
// over the maximal prefix of fame-complete rounds.  For each event e below
// n_valid that is not received yet (received[e] == 0), in ascending rounds
// r of the prefix:
//
//   e is received in r when every unique famous witness w of r has e as an
//   ancestor (anc[w][e]); its timestamp rank is then the lower median, the
//   ((nv - 1) / 2)-th smallest, of the nv values t_rank[d_w], d_w the
//   deepest self-ancestor of w within `chain` steps that still has e as an
//   ancestor (INT32_MAX when chain is 0)
//
// and received[e] is set.  Events never received keep rr = -1 and ts = 0.
// The caller computes the rounds' facts on the device (kernels.py,
// _order_plan): ufw[r][0 .. nv[r]) are round r's unique famous witnesses
// (famous, and the only famous witness of their creator there), packed to
// the front of the row, and nv[r] is 0 for a round outside the prefix or
// without one, a round that receives nothing.
//
// Replaces no Pallas kernel.  It replaces the reference's jitted lax.scan of
// order_scan (tpu_swirld/tpu/pipeline.py:497-601): a scan over rounds whose
// lax.cond (:587) decides on the device which rounds receive, with an inner
// scan of `chain` self-chain steps (:566-575) and a sort for the median
// (:577-580), one device program a stage call.  Without it the port pulled
// the rounds' facts to the host and ran about 7 PyTorch operations a chain
// step, some 1 100 launches a receiving round at config 3.
//
// What bounds it on an H100: neither bytes nor operations.  An event's
// result depends only on its own column of anc and on the rounds before its
// receipt, so the work is parallel over events, one thread an event, and
// each thread's time is a chain of dependent loads: one anc byte a round
// until its receipt (the first witness that does not see it ends a round),
// then nv self-chain walks of a few steps (self_parent, anc, t_rank, each
// step waiting on the last), then the median.  The design:
//
// - threads of a warp take consecutive events, so while they agree on the
//   round their anc reads of one witness row coalesce;
// - the walk stops at genesis or at the first self-ancestor that does not
//   see e.  That is exact because anc is an ancestry closure (a
//   self-parent's ancestors are a subset of its child's), so the steps
//   whose self-ancestor sees e are a prefix of the walk and the reference's
//   last overwrite is the last step of that prefix;
// - nv is at most the members (unique famous witnesses have distinct
//   creators) and at most the slots, so the walks' values go to a scratch
//   column of s_max ints an event (scratch[k][e], coalesced across the
//   warp), and a counting select over them gives the lower median: no
//   sort of the slot rows.
//
// A warp an event for large member counts, or a round's witness rows
// staged in shared memory, is later work.
//
// Plain C interface (bound with ctypes): order_scan_launch returns the
// cudaError_t of the launch, 0 on success.  Launches on the caller's
// stream, allocates nothing: rr, ts and scratch are the caller's,
// received is updated in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int INT32_MAX_ = 0x7fffffff;

struct Order {
  const uint8_t* anc;       // [n][n]: anc[i][j], j an ancestor of i
  const int* ufw;           // [r_max][s_max]: round r's UFW events first
  const int* nv;            // [r_max]: UFWs a receiving round, else 0
  const int* self_parent;   // [n], -1 at genesis
  const int* t_rank;        // [n]
  uint8_t* received;        // [n], in and out
  int* rr;                  // [n]
  int* ts;                  // [n]
  int* scratch;             // [s_max][n]
  int n, r_max, s_max, n_valid, chain;
};

__global__ void __launch_bounds__(THREADS) order_kernel(Order a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.n) return;
  const size_t n = (size_t)a.n;
  int rr = -1, ts = 0;
  if (e < a.n_valid && !a.received[e]) {
    for (int r = 0; r < a.r_max; ++r) {
      const int nv = __ldg(a.nv + r);
      if (nv <= 0) continue;
      const int* w = a.ufw + (size_t)r * a.s_max;
      bool all_see = true;
      for (int k = 0; k < nv && all_see; ++k)
        all_see = __ldg(a.anc + (size_t)__ldg(w + k) * n + e) != 0;
      if (!all_see) continue;
      // earliest-seeing self-ancestor of each UFW, within `chain` steps
      for (int k = 0; k < nv; ++k) {
        int cur = __ldg(w + k);
        int t = INT32_MAX_;
        for (int s = 0; s < a.chain; ++s) {
          if (!__ldg(a.anc + (size_t)cur * n + e)) break;
          t = __ldg(a.t_rank + cur);
          const int nxt = __ldg(a.self_parent + cur);
          if (nxt < 0) break;       // genesis: later steps repeat it
          cur = min(nxt, a.n - 1);
        }
        a.scratch[(size_t)k * n + e] = t;
      }
      // lower median: the value with at most `want` smaller values and
      // more than `want` values at most it
      const int want = (nv - 1) / 2;
      for (int i = 0; i < nv; ++i) {
        const int v = a.scratch[(size_t)i * n + e];
        int lt = 0, le = 0;
        for (int j = 0; j < nv; ++j) {
          const int u = a.scratch[(size_t)j * n + e];
          lt += u < v;
          le += u <= v;
        }
        if (lt <= want && want < le) {
          ts = v;
          break;
        }
      }
      rr = r;
      a.received[e] = 1;
      break;
    }
  }
  a.rr[e] = rr;
  a.ts[e] = ts;
}

}  // namespace

extern "C" int order_scan_launch(
    const void* anc, int n, const void* ufw, const void* nv, int r_max,
    int s_max, const void* self_parent, const void* t_rank, int n_valid,
    int chain, void* received, void* rr, void* ts, void* scratch,
    void* stream) {
  Order a{(const uint8_t*)anc, (const int*)ufw, (const int*)nv,
          (const int*)self_parent, (const int*)t_rank, (uint8_t*)received,
          (int*)rr, (int*)ts, (int*)scratch, n, r_max, s_max, n_valid, chain};
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  order_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
