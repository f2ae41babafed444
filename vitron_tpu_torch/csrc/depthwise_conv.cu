// Depthwise 2D convolution for Hopper (sm_90a): NHWC, stride 1, SAME zero
// padding, odd square kernel k in {3, 5, 7, 9}.
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/depthwise_conv.py::_kernel
// (:35, pallas_call at :66 in _dw_pallas :54, entry depthwise_conv2d :138).
//
//   y[b, h, w, c] = sum_{dy, dx} xpad[b, h + dy, w + dx, c] * w[dy, dx, c]
//
// x, w and y are float or bfloat16 (one type; C contiguous), w is
// [k, k, C]; products and sums are float32, y is rounded once to x's type.
// The bias is added by the caller, as in the JAX package (:157-159).
//
// What bounds it on the H100: 2 k^2 FLOP per output element on the CUDA
// cores (no matrix-product form for the tensor cores) against one read of x
// and one write of y. At FocalNet-L's k = 3..9 that is 18..162 FLOP per
// 4..8 bytes, so from k ~ 5 up (float32) the 67 TFLOP/s FP32 rate bounds it,
// below that the 3.35 TB/s device memory. The TPU kernel staged a halo row
// block in VMEM so the input was read from HBM once, not k^2 times; here a
// block stages the (TH + k - 1) x (TW + k - 1) halo of a 32-channel strip in
// shared memory (one channel per lane: coalesced loads, conflict-free shared
// reads), zero-filled outside the image, with the strip's k x k taps beside
// it. Each thread then slides along 8 output columns of one row: per tap row
// it loads 8 + k - 1 halo values into registers and does 8 k FMAs, so shared
// memory is read about once per k FMAs. Ragged H, W and C are masked.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // channels per block, one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kStrip = 8;    // output columns per thread step

// grid (tiles_w * tiles_h, ceil(C / 32), B); dynamic shared memory
// ((TH + K - 1) * (TW + K - 1) + K * K) * 32 floats
template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
          int H, int W, int C, int TH, int TW, int tiles_w) {
  extern __shared__ float smem[];
  constexpr int P = K / 2;
  const int TWp = TW + K - 1;
  const int rows = TH + K - 1;
  float* xs = smem;                          // [rows][TWp][32]
  float* ws = smem + rows * TWp * kLanes;    // [K*K][32]
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int c0 = blockIdx.y * kLanes;
  const int b = blockIdx.z;
  const size_t img = (size_t)b * H * W * C;

  // taps of this strip
  for (int i = threadIdx.x; i < K * K * kLanes; i += kThreads) {
    const int t = i / kLanes, c = c0 + i % kLanes;
    ws[i] = c < C ? vt::to_f32(w[(size_t)t * C + c]) : 0.f;
  }
  // halo, zero outside the image and past C
  const int npix = rows * TWp;
  for (int i = threadIdx.x; i < npix * kLanes; i += kThreads) {
    const int pix = i / kLanes, c = c0 + i % kLanes;
    const int gh = h0 + pix / TWp - P, gw = w0 + pix % TWp - P;
    float v = 0.f;
    if (c < C && gh >= 0 && gh < H && gw >= 0 && gw < W)
      v = vt::to_f32(x[img + ((size_t)gh * W + gw) * C + c]);
    xs[i] = v;
  }
  __syncthreads();

  const int c = c0 + lane;
  const int strips = TW / kStrip;
  for (int item = warp; item < TH * strips; item += kWarps) {
    const int r = item / strips, s = item % strips;
    const int oh = h0 + r, ow0 = w0 + s * kStrip;
    if (oh >= H || ow0 >= W) continue;  // uniform over the warp
    float acc[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const float* row = xs + ((r + dy) * TWp + s * kStrip) * kLanes + lane;
      float xv[kStrip + K - 1];
#pragma unroll
      for (int j = 0; j < kStrip + K - 1; ++j) xv[j] = row[j * kLanes];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float wv = ws[(dy * K + dx) * kLanes + lane];
#pragma unroll
        for (int j = 0; j < kStrip; ++j) acc[j] = fmaf(xv[j + dx], wv, acc[j]);
      }
    }
    if (c < C) {
      T* out = y + img + ((size_t)oh * W + ow0) * C + c;
#pragma unroll
      for (int j = 0; j < kStrip; ++j)
        if (ow0 + j < W) out[(size_t)j * C] = vt::from_f32<T>(acc[j]);
    }
  }
}

template <int K, typename T>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int C, int TH, int TW,
           cudaStream_t stream) {
  const size_t smem = ((size_t)(TH + K - 1) * (TW + K - 1) + K * K) * kLanes * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (C + kLanes - 1) / kLanes, B);
  dw_kernel<K, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), H, W, C, TH, TW,
      tiles_w);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(int K, const void* x, const void* w, void* y, int B, int H, int W, int C, int TH,
               int TW, cudaStream_t st) {
  switch (K) {
    case 3: return launch<3, T>(x, w, y, B, H, W, C, TH, TW, st);
    case 5: return launch<5, T>(x, w, y, B, H, W, C, TH, TW, st);
    case 7: return launch<7, T>(x, w, y, B, H, W, C, TH, TW, st);
    case 9: return launch<9, T>(x, w, y, B, H, W, C, TH, TW, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y [B, H, W, C]; w [K, K, C]. TH rows x TW columns (a multiple of 8) of
// output per block. is_bf16: x, w and y are bfloat16 (else float).
// Returns cudaGetLastError() after the launch.
extern "C" int vt_depthwise_conv2d(const void* x, const void* w, void* y, int B, int H, int W,
                                   int C, int K, int TH, int TW, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || TH <= 0 || TW <= 0 || TW % kStrip || B > 65535 ||
      (C + kLanes - 1) / kLanes > 65535)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch_k<__nv_bfloat16>(K, x, w, y, B, H, W, C, TH, TW, st)
                 : dispatch_k<float>(K, x, w, y, B, H, W, C, TH, TW, st);
}
