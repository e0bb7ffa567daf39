// bmm_or: boolean OR-matmul, out[p][r] = OR_q (a[p][q] AND b[q][r]).
//
// Replaces the TPU kernel tpu_swirld/tpu/pallas_kernels.py:bmm_or_pallas
// (body _bmm_kernel): 0/1 operands in bf16 on the MXU, f32 accumulation,
// thresholded at 0.5.  Here there is no floating point at all: rows of a and
// columns of b are packed into 32-bit words along q, and an output is the OR
// of word-ANDs, exact by construction (it is an OR, not a count).
//
// What bounds it on an H100: bytes and launches, not operations.  The
// ancestry squarings (128 x 128 @ 128 x 128) and propagation hops (128 x 128
// @ 128 x 10112) move 0.05-2.6 MB, so a launch is what they cost; the
// forkseen hop (10112 x 4517 @ 4517 x 64) reads 46 MB of a.  So no tensor
// cores (a binary mma.sync with AND + POPC would speed up what is not the
// limit), and the design is one launch a call with no scratch in device
// memory: each block packs its own rows of a and columns of b into shared
// memory, 512 q at a time, then ORs word-ANDs over its output tile.
//
// - a: one thread per (row, word), neighbouring threads on neighbouring
//   words of a row, so the loads are coalesced: the word's 32 bytes come
//   from three aligned 16-byte loads (a row that does not start on 16
//   bytes is realigned by a funnel shift), and four bytes at a time turn
//   into four bits with one byte compare and one multiply.
// - b: neighbouring threads take neighbouring columns of one row of b, so
//   every load is coalesced, and each thread shifts in its bit; a word's 32
//   loads are all in flight at once.
// - The tile (16 RI x 16 RI outputs, RI in {4, 2, 1}) is the largest whose
//   grid still fills the card, so the tall forkseen hop (R = 64) runs
//   64 x 64 tiles and reads a once, and the 128^3 squarings run 64 blocks.
//
// Any shape P, Q, R >= 1 is taken: the kernel masks ragged edges itself.
// Plain C interface (bound with ctypes): bmm_or_launch returns the
// cudaError_t of the launch, 0 on success.  Launches on the caller's stream
// and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int EDGE = 16;              // threads per tile edge
constexpr int CHUNK = 512;            // q staged per step
constexpr int TW = CHUNK / 32;        // packed words per step

// The aligned 16-byte words that hold the 32 bytes at row[0..32) (three of
// them, whatever the alignment); a word that starts at or past row_end is
// not read.  An aligned word that holds a byte of the row lies in a mapped
// page, whatever lies around the row.
__device__ __forceinline__ void load_word(const uint8_t* row,
                                          const uint8_t* row_end, uint4 x[3]) {
  const uintptr_t base = (uintptr_t)row & ~(uintptr_t)15;
#pragma unroll
  for (int v = 0; v < 3; ++v)
    x[v] = base + 16u * v < (uintptr_t)row_end ? *(const uint4*)(base + 16u * v)
                                               : make_uint4(0u, 0u, 0u, 0u);
}

// The packed word of those bytes: bit L = (row[L] != 0) for L < n.
__device__ __forceinline__ uint32_t pack_word(const uint8_t* row, int n,
                                              const uint4 x[3]) {
  uint32_t w[12];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    w[4 * v] = x[v].x; w[4 * v + 1] = x[v].y;
    w[4 * v + 2] = x[v].z; w[4 * v + 3] = x[v].w;
  }
  const int off = (int)((uintptr_t)row & 15u), k = off >> 2, shift = 8 * (off & 3);
  uint32_t v[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const uint32_t even = (k & 1) ? w[t + 1] : w[t];
    const uint32_t odd = (k & 1) ? w[t + 3] : w[t + 2];
    v[t] = (k & 2) ? odd : even;
  }
  uint32_t word = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint32_t bytes = __funnelshift_r(v[t], v[t + 1], shift);
    // 0x01 in each nonzero byte, gathered into the top nibble by a multiply
    // whose partial products never overlap
    const uint32_t ones = __vcmpne4(bytes, 0u) & 0x01010101u;
    word |= ((ones * 0x10204080u) >> 28) << (4 * t);
  }
  return n < 32 ? word & ((1u << n) - 1u) : word;
}

// VEC_B: R and b's address are multiples of 4, so a thread reads four
// neighbouring columns of b with one 32-bit load a row.
template <int RI, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
bmm_or_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
              uint8_t* __restrict__ out, int P, int Q, int R) {
  constexpr int T = EDGE * RI;
  constexpr int WORDS = T * TW / THREADS;    // a (and byte-wise b) words a thread
  constexpr int B_TASKS = T / 4 * TW;        // (4 columns, word) tasks of VEC_B
  __shared__ uint32_t as[T][TW + 1];
  __shared__ uint32_t bs[T][TW + 1];
  const int tx = threadIdx.x % EDGE, ty = threadIdx.x / EDGE;
  const int p0 = blockIdx.y * T, r0 = blockIdx.x * T;
  uint32_t acc[RI][RI] = {};
  for (int q0 = 0; q0 < Q; q0 += CHUNK) {
    const int tw = (min(CHUNK, Q - q0) + 31) / 32;
    // ---- a, loads: one thread per (row, word), all issued before any use
    uint4 xa[WORDS][3];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const int e = threadIdx.x + THREADS * k;
      const int row = e / TW, u = e % TW, p = p0 + row;
      const uint8_t* rowp = a + (size_t)(p < P ? p : 0) * Q;
      load_word(rowp + q0 + 32 * u, p < P && u < tw ? rowp + Q : nullptr, xa[k]);
    }
    // ---- b: neighbouring threads on neighbouring columns of one row of b,
    // each shifting in its bit, bit L = q0 + 32 u + L
    if (VEC_B) {
      if (threadIdx.x < B_TASKS) {
        const int g = threadIdx.x % (T / 4), u = threadIdx.x / (T / 4);
        const int r = r0 + 4 * g, qb = q0 + 32 * u;
        uint32_t x[32];
#pragma unroll
        for (int L = 0; L < 32; ++L)
          x[L] = r < R && qb + L < Q
                     ? *(const uint32_t*)(b + (size_t)(qb + L) * R + r) : 0u;
        uint32_t w[4] = {};
#pragma unroll
        for (int L = 0; L < 32; ++L) {
          const uint32_t ones = __vcmpne4(x[L], 0u) & 0x01010101u;
#pragma unroll
          for (int c = 0; c < 4; ++c) w[c] |= ((ones >> (8 * c)) & 1u) << L;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) bs[4 * g + c][u] = w[c];
      }
    } else {
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        const int e = threadIdx.x + THREADS * k;
        const int col = e % T, u = e / T, r = r0 + col, qb = q0 + 32 * u;
        uint32_t w = 0;
        if (r < R && u < tw) {
          const uint8_t* src = b + (size_t)qb * R + r;
#pragma unroll
          for (int L = 0; L < 32; ++L)
            if (qb + L < Q) w |= (uint32_t)(src[(size_t)L * R] != 0) << L;
        }
        bs[col][u] = w;
      }
    }
    // ---- a, packed
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const int e = threadIdx.x + THREADS * k;
      const int row = e / TW, u = e % TW;
      as[row][u] = p0 + row < P && u < tw
                       ? pack_word(a + (size_t)(p0 + row) * Q + q0 + 32 * u,
                                   Q - q0 - 32 * u, xa[k])
                       : 0u;
    }
    __syncthreads();
    for (int w = 0; w < tw; ++w) {
      uint32_t av[RI], bv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) av[i] = as[ty + EDGE * i][w];
#pragma unroll
      for (int j = 0; j < RI; ++j) bv[j] = bs[tx + EDGE * j][w];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) acc[i][j] |= av[i] & bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int p = p0 + ty + EDGE * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int r = r0 + tx + EDGE * j;
      if (r < R) out[(size_t)p * R + r] = acc[i][j] != 0u;
    }
  }
}

template <int RI, bool VEC_B>
int launch(const void* a, const void* b, void* out, int P, int Q, int R,
           cudaStream_t s) {
  constexpr int T = EDGE * RI;
  dim3 grid((R + T - 1) / T, (P + T - 1) / T);
  bmm_or_kernel<RI, VEC_B><<<grid, THREADS, 0, s>>>(
      (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out, P, Q, R);
  return (int)cudaGetLastError();
}

template <int RI>
int launch_tile(const void* a, const void* b, void* out, int P, int Q, int R,
                cudaStream_t s) {
  const bool vec_b = R % 4 == 0 && ((uintptr_t)b & 3u) == 0;
  return vec_b ? launch<RI, true>(a, b, out, P, Q, R, s)
               : launch<RI, false>(a, b, out, P, Q, R, s);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

long long tiles(int P, int R, int t) {
  return (long long)((P + t - 1) / t) * ((R + t - 1) / t);
}

}  // namespace

extern "C" int bmm_or_launch(const void* a, const void* b, void* out, int P,
                             int Q, int R, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  static const int sms = sm_count();
  if (tiles(P, R, 64) >= sms) return launch_tile<4>(a, b, out, P, Q, R, s);
  if (tiles(P, R, 32) >= sms) return launch_tile<2>(a, b, out, P, Q, R, s);
  return launch_tile<1>(a, b, out, P, Q, R, s);
}
