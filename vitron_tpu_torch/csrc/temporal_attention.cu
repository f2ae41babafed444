// Per-pixel frame attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// vitron_tpu/kernels/temporal_attention.py::_kernel (:45, pallas_call at :97
// in _fwd :87, entry frame_attention :150).
//
//   for every (b, pixel n, head h), with q, k, v, o the [F, D] slices
//   x[b, :, n, h*D : (h+1)*D] of [B, F, N, H*D] tensors:
//   o = softmax_over_frames((q @ k^T) * scale) @ v
//
// float32 scores, an exact float32 softmax (max-subtracted, normalised
// before the product with v), o rounded to the input type.
//
// What bounds it on the H100: one (b, n, h) is F x F x D x 4 FLOP (24 x 24 x
// 64 at the video UNet: 147 kFLOP) against 4 x F x D values in and out: 6
// FLOP a float32 byte, under the card's 20 (67 TFLOP/s of float32 FMA over
// 3.35 TB/s), so it is bound by the bytes moved and by latency. The design reads the [B, F, N, H*D] layout in place (no
// transpose to [B*N, H, F, D] and back): one warp owns one (b, n, h), its
// lanes read each frame's D contiguous values (coalesced), and q, k and v
// are staged once in shared memory as float32 with rows padded to D + 1
// (lane j reading row j at the same depth hits bank j + d: no conflicts).
// Lane j < F owns key frame j: it forms score (i, j) for every query frame
// i, the warp takes each row's max and sum with shuffles, and the
// normalised probabilities go to shared memory; then lane l forms output
// depths l, l + 32, ... of every frame from them and v. F <= 32 (one key per
// lane); D in {32, 64, 128}.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxF = 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int warp_floats(int F, int D) {
  return 3 * F * (D + 1) + F * kMaxF;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
frame_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int F, int N, int H,
                       long long items, float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int DL = D / 32;  // depths per lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= items) return;  // whole warps leave; no block barrier follows
  float* qs = smem + (size_t)warp * warp_floats(F, D);  // [F][DP]
  float* ks = qs + F * DP;
  float* vs = ks + F * DP;
  float* ps = vs + F * DP;  // [F][kMaxF] probabilities

  const int h = (int)(item % H);
  const long long bn = item / H;
  const int n = (int)(bn % N);
  const long long b = bn / N;
  const size_t hd = (size_t)H * D;
  const size_t frame_stride = (size_t)N * hd;
  const size_t base = ((size_t)b * F * N + n) * hd + (size_t)h * D;

#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const size_t row = base + f * frame_stride;
#pragma unroll
    for (int j = 0; j < DL; ++j) {
      const int d = lane + 32 * j;
      qs[f * DP + d] = vt::to_f32(q[row + d]);
      ks[f * DP + d] = vt::to_f32(k[row + d]);
      vs[f * DP + d] = vt::to_f32(v[row + d]);
    }
  }
  __syncwarp();

  const bool key = lane < F;
  const float* krow = ks + (key ? lane : 0) * DP;
  for (int i = 0; i < F; ++i) {
    const float* qrow = qs + i * DP;
    float sc = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) sc = fmaf(qrow[d], krow[d], sc);
    sc = key ? sc * scale : -__int_as_float(0x7f800000);  // -inf
    const float mx = warp_max(sc);
    const float e = key ? expf(sc - mx) : 0.f;
    const float sum = warp_sum(e);
    ps[i * kMaxF + lane] = e / sum;
  }
  __syncwarp();

  for (int i = 0; i < F; ++i) {
    float acc[DL];
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[j] = 0.f;
    const float* prow = ps + i * kMaxF;
    for (int g = 0; g < F; ++g) {
      const float p = prow[g];
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[j] = fmaf(p, vs[g * DP + lane + 32 * j], acc[j]);
    }
    const size_t row = base + i * frame_stride;
#pragma unroll
    for (int j = 0; j < DL; ++j) o[row + lane + 32 * j] = vt::from_f32<T>(acc[j]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int F, int N, int H,
           float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)kWarps * warp_floats(F, D);
  cudaError_t err = cudaFuncSetAttribute(frame_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)B * N * H;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  frame_attention_kernel<T, D><<<(unsigned)blocks, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), F, N, H, items, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int F, int N, int H,
             int D, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, F, N, H, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, F, N, H, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, F, N, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, F, N, H*D] contiguous; 1 <= F <= 32, D in {32, 64, 128}.
// Returns cudaGetLastError() after the launch.
extern "C" int vt_frame_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int F, int N, int H, int D, float scale, int is_bf16,
                                  void* stream) {
  if (B <= 0 || F <= 0 || F > kMaxF || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, F, N, H, D, scale, st)
                 : dispatch<float>(q, k, v, o, B, F, N, H, D, scale, st);
}
