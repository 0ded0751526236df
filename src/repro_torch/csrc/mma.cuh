// Warp-level tensor-core and copy helpers shared by the port's kernels
// (csrc/flash_attention.cu, csrc/ssd.cu, csrc/wkv6.cu): cp.async copies into shared
// memory, ldmatrix fragment loads and the bf16 mma.sync.m16n8k16 with a
// float32 accumulator, and the bf16 high + remainder split that keeps a
// float32 operand to about 16 significant bits through two products.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + q, g = lane / 4,
// q = lane % 4), each register two bf16 values along k (A, B) or a pair
// of floats along n (C):
//   A (16 x 16, rows m, cols k): a0 (g, 2q..2q+1), a1 (g+8, 2q..),
//                                a2 (g, 2q+8..),   a3 (g+8, 2q+8..)
//   B (16 x 8,  rows k, cols n): b0 (2q..2q+1, g), b1 (2q+8.., g)
//   C (16 x 8):                  c0, c1 (g, 2q..2q+1), c2, c3 (g+8, 2q..)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes < 16
// fills the rest with zeros (0: all zeros, nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 8 or 4 bytes, for rows whose width is not a multiple of 16 bytes.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and gets one register of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// Two 8x8 bf16 matrices; lanes 0-15 give the row addresses (lane l, row
// l % 8 of matrix l / 8), and each lane gets one register of each.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
// The x4 form, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, bf16 inputs, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (the first in the low half), rounded to
// nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// x0, x1 as bf16 high parts (hi) and the bf16 rounding of what those
// leave (lo): hi + lo holds each to about 2^-17 of its size, where one
// bf16 rounding holds it to 2^-9.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// f(r, c) for every r < rows and c < cols, spread over the block's
// nthreads threads in row-major order, with one division in all rather
// than one per element (copy loops run at every tile).
template <int nthreads, class F>
__device__ __forceinline__ void for_each_rc(int rows, int cols, F f) {
  const int dr = nthreads / cols, dc = nthreads % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

}  // namespace mma
