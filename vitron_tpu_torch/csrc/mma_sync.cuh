// The tensor-core building blocks of the port's bf16 kernels (sm_90a):
// 16-byte asynchronous copies to shared memory and their commit/wait groups,
// ldmatrix fragment loads, the bf16 mma.sync m16n8k16 with float32 sums and
// the packing of two float32 values into one register of bf16, and the int8 mma.sync
// m16n8k32 with int32 sums. tiled_gemm.cuh (B3, B6), depthwise_conv.cu (B4),
// flash_attention_fwd.cu (B2), flash_attention_bwd.cu (B5a, B5b), w4a8_matmul.cu (Q1) and
// conv2d_w8a8.cu (Q2) include it; B9's wgmma kernel takes its primitives from wgmma.cuh.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4; two bf16
// values a register, the lower column in the low half):
//   A [16 x 16]: a0 (row g, cols 2t..2t+1), a1 (row g+8, 2t..), a2 (row g,
//     2t+8..), a3 (row g+8, 2t+8..)
//   B [16 x 8]:  b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g)
//   C [16 x 8]:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1)
#pragma once

#include "common.cuh"

namespace vt_gemm {
namespace {  // internal linkage: each source that includes this has its own copy

// cp.async of 16 bytes; `full` false copies nothing and zero-fills the 16 bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two float32 values rounded to nearest even as bf16, `lo` in the low half
// (the lower address, the lower column of a fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The int8 product of the W4A8 and W8A8 kernels: mma.m16n8k32, s8 x s8 with
// int32 sums. Four int8 values a register, the lowest k in the low byte
// (g = lane / 4, t = lane % 4):
//   A [16 x 32]: a0 (row g, k 4t..4t+3), a1 (row g+8, 4t..), a2 (row g,
//     16+4t..), a3 (row g+8, 16+4t..)
//   B [32 x 8]:  b0 (k 4t..4t+3, col g), b1 (k 16+4t.., col g)
//   C [16 x 8]:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
}  // namespace vt_gemm
