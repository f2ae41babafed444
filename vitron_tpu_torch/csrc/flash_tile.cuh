// Tile helpers shared by the bf16 flash-attention kernels on the tensor
// cores: the forward (flash_attention_fwd.cu, B2) and the backward
// (flash_attention_bwd.cu, B5a/B5b).
#pragma once

#include "mma_sync.cuh"

namespace vt_flash {
namespace {  // internal linkage: each source that includes this has its own copy

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two bf16 q values -> round(q * scale) as bf16, the TPU kernel's _scaled_q
__device__ __forceinline__ unsigned scaled_q(unsigned r, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  return vt_gemm::pack_bf16(f.x * scale, f.y * scale);
}

// cp.async rows [r0, r0 + ROWS) of head h of batch b of a [B, rows, heads, D]
// bf16 tensor into a [ROWS][P] shared tile, zero-filling rows past `rows`
// and columns D..DP-1
template <int ROWS, int D, int DP, int P, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int r0, int rows, int heads, int h, int tid) {
  constexpr int CH = DP / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < (ROWS * CH + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if ((ROWS * CH) % THREADS != 0 && i >= ROWS * CH) break;
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < rows && c * 8 < D;
    vt_gemm::cp_async16(dst + r * P + c * 8,
                        ok ? src + (((size_t)b * rows + row) * heads + h) * D + c * 8 : src, ok);
  }
}

}  // namespace
}  // namespace vt_flash
