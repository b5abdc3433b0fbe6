// bf16 tensor-core helpers shared by the hand-written kernels (sm_80+ mma.sync).
//
// Fragment layout of mma.sync.m16n8k16 (row.col, bf16 in, fp32 accumulate),
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a[0] = (g,   2t..2t+1)   a[1] = (g+8, 2t..2t+1)
//                         a[2] = (g,   2t+8..2t+9) a[3] = (g+8, 2t+8..2t+9)
//   B (16x8, "col"):      b[0] = (k 2t..2t+1, n g) b[1] = (k 2t+8..2t+9, n g)
//   C (16x8):             c[0] = (g, 2t) c[1] = (g, 2t+1)
//                         c[2] = (g+8, 2t) c[3] = (g+8, 2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace sdt {

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// 32-bit shared-memory load of two adjacent bf16 (the address is 4-byte aligned).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte copy (global -> shared or shared -> global), both 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// Asynchronous 16-byte global -> shared copy (sm_80+), grouped by commit.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the row address of
// matrix i / 8, row i % 8. Register j holds matrix j in mma fragment order.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Two 8x8 b16 matrices from shared memory, each transposed on the way: lanes
// 0-7 give the row addresses of matrix 0, lanes 8-15 those of matrix 1. For
// a row-major (k, n) slab, register j of lane (g, t) then holds
// (k 2t..2t+1, n g) of matrix j: the B fragment of mma.m16n8k16.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

}  // namespace sdt
