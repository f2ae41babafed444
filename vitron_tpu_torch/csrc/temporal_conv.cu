// Temporal (frame-axis) k=3 convolution for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/temporal_conv.py::_kernel
// (:44, pallas_call at :81 in _tconv_pallas :56, entry temporal_conv_k3 :177).
//
//   y[b, f, n, :] = sum_{d=0..2} x[b, f + d - 1, n, :] @ w[d] (+ bias)
//   x [B, F, N, C], w [3, C, Co], zero frames outside [0, F); y [B, F, N, Co]
//
// It is one GEMM of M = B * F * N rows, depth K = 3C and Co columns
// (tiled_gemm.cuh, mode kTconv): the A-tile loader maps output row
// (b, f, n) and depth d * C + c to x[b, f + d - 1, n, c] and reads zero
// outside the frame range, so the three taps accumulate in the same float32
// registers and y is written once: no frame-padded copy of x and no shifted
// partial product reaches device memory. Each row computes its own frame,
// so a row tile may straddle frames (N = 45 at the UNet's deepest level).
// The bias is added in the epilogue before the one rounding to y's type.
//
// What bounds it on the H100: the video UNet's sites (M 138,240 / 34,560 /
// 8,640 / 2,160 rows at C = Co = 512 / 1024 / 2048 / 2048 for a CFG batch of
// 2 x 24 frames) are 0.2-0.7 TFLOP each against 0.2-1.1 GB of x and y, so
// they are bound by operations: bfloat16 runs on the tensor cores
// (mma.sync), float32 on the CUDA cores' FMA pipes (TF32 would round x).
#include "tiled_gemm.cuh"

// x [B*F*N, C] (frames of N contiguous rows), w [3, C, Co], bias [Co] or
// null, y [B*F*N, Co]; C and Co multiples of 8, x, w and y 16-byte aligned.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for other shapes.
extern "C" int vt_temporal_conv_k3(const void* x, const void* w, const void* bias, void* y,
                                   int B, int F, int N, int C, int Co, int is_bf16,
                                   void* stream) {
  if (B <= 0 || F <= 0 || N <= 0 || C <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * F * N;
  if (rows > 0x7fffffffLL || 3LL * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  vt_gemm::Shape s{(int)rows, Co, 3 * C, Co, F, N, C, 3 * C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? vt_gemm::launch<__nv_bfloat16, vt_gemm::kTconv>(x, w, bias, y, s, st)
             : vt_gemm::launch<float, vt_gemm::kTconv>(x, w, bias, y, s, st);
}
