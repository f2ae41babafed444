// GEGLU feed-forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/geglu_ff.py::_kernel
// (:45, pallas_call at :90, entry geglu_ff_fused :163).
//
//   [a | g] = x @ W1 + b1      x [M, C], W1 [C, 2F] (a = cols 0..F-1, g = F..2F-1)
//   t       = (a * gelu(g))    exact erf gelu in float32, then rounded to T
//   out     = t @ W2 + b2      W2 [F, C]; float32 sums, out in T
//
// Two launches of the tiled GEMM of tiled_gemm.cuh: the first product with
// the GEGLU epilogue (mode kGeglu: a block loads the a and g columns of the
// same 64 hidden indices, so gelu and the rounding of t happen in registers
// and only t [M, F] in T reaches device memory), then t @ W2 + b2 (mode
// kLinear). Where the second product has too few output tiles to fill the
// card (M = 128 rows at the SD UNet's 8x8 level), its depth F is split over
// blocks and a second kernel adds the float32 partial sums in a fixed order.
//
// What bounds it on the H100: 24 M C^2 FLOP against ~(2M + 12C) C values
// moved, so every UNet site (SD: C 320-1280; video: C 512-2048, M up to
// 138,240) is bound by operations. bfloat16 runs on the tensor cores
// (mma.sync), float32 on the CUDA cores' FMA pipes. t is written in x's type,
// as the reference rounds it before the second product. Times: PERF.md.
#include "tiled_gemm.cuh"

// x [M, C], w1 [C, 2F], b1 [2F], w2 [F, C], b2 [C], hidden [M, F] scratch in
// x's type, out [M, C]; C and F multiples of 8, every pointer but the
// biases' 16-byte aligned. splits > 1 splits the second product's depth F,
// with part [splits, M, C] float32 scratch. Returns cudaGetLastError()
// after the launches (or the first failure).
extern "C" int vt_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* hidden, void* part, void* out, int M, int C,
                           int F, int splits, int is_bf16, void* stream) {
  if (M <= 0 || C <= 0 || F <= 0 || C % 8 || F % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vt_gemm::Shape up{M, F, C, 2 * F, 1, 1, C, C};
  vt_gemm::Shape down{M, C, F, C, 1, 1, F, F};
  int rc = is_bf16
               ? vt_gemm::launch<__nv_bfloat16, vt_gemm::kGeglu>(x, w1, b1, hidden, up, st)
               : vt_gemm::launch<float, vt_gemm::kGeglu>(x, w1, b1, hidden, up, st);
  if (rc != 0) return rc;
  return is_bf16 ? vt_gemm::launch<__nv_bfloat16, vt_gemm::kLinear>(hidden, w2, b2, out, down, st,
                                                                    part, splits)
                 : vt_gemm::launch<float, vt_gemm::kLinear>(hidden, w2, b2, out, down, st, part,
                                                            splits);
}
