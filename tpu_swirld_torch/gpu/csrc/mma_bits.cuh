// mma_bits.cuh: the warp-level tensor-core products shared by the kernels
// (inline PTX, sm_80 and later; built for sm_90a).
//
// Fragment layout of the m16n8 products, per thread (g = lane / 4, t = lane
// % 4), each register 32 bits of the contraction axis k (32 bits of b1, four
// s8):
//   a[0]: row g,     k word t      a[1]: row g + 8, k word t
//   a[2]: row g,     k word t + 4  a[3]: row g + 8, k word t + 4
//   b[0]: column g,  k word t      b[1]: column g,  k word t + 4
//   c[0..1]: row g, columns 2t, 2t + 1;  c[2..3]: row g + 8, the same
// where a "k word" is the 32-bit word of a 256-bit (b1) or 32-byte (s8) row
// slice.  c += a * b in place.

#pragma once

#include <stdint.h>

// m16n8k256 .b1, AND then population count: c[r][j] += popc(a_row & b_col)
// over 256 bits of k.
__device__ __forceinline__ void mma_b1_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same with c = 0 (the first k-step of a product).
__device__ __forceinline__ void mma_b1_and_popc_first(int (&c)[4], const uint32_t (&a)[4],
                                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// Four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each) from
// shared memory: lanes 8 q .. 8 q + 7 give the row addresses of matrix q,
// and r[q] gets 32-bit word lane % 4 of its row lane / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem_row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// 16 bytes from device to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
