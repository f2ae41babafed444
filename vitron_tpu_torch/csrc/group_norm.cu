// Group-norm statistics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/group_norm.py::_kernel
// (:44, pallas_call at :75, entry group_norm_sums :114).
//
//   x [B, R, C] (float or bfloat16, C contiguous) -> out [B, 2, C] float32
//   out[b, 0, c] = sum_r x[b, r, c],  out[b, 1, c] = sum_r x[b, r, c]^2
//
// What bounds it on the H100: one read of x and a few flops per element,
// so device-memory bandwidth (at the VAE's full-resolution [1, 262144, 128]
// float32 site, 134 MB). The design reads each element once, coalesced: a
// warp covers 32 consecutive channels of one row, the block's 8 warps take
// rows 8 apart. The TPU kernel carried its [2, C] sums across sequential
// row blocks of one grid; here blocks run in parallel, so the rows are split
// over blocks, each block writes its partial sums, and a second pass adds
// the splits in a fixed order: no atomics, the same bits run to run.
#include "common.cuh"

namespace {

constexpr int kChTile = 32;   // channels per block (one per lane)
constexpr int kRowLanes = 8;  // warps per block, each on its own rows
constexpr int kThreads = kChTile * kRowLanes;

// grid (ceil(C / 32), splits, B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_sums_kernel(const T* __restrict__ x, float* __restrict__ out, float* __restrict__ part,
               int R, int C, int rows_per_split) {
  __shared__ float red[2][kRowLanes][kChTile];
  const int lane = threadIdx.x % kChTile, rl = threadIdx.x / kChTile;
  const int c = blockIdx.x * kChTile + lane;
  const int split = blockIdx.y, b = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int r1 = min(R, r0 + rows_per_split);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const T* xb = x + (size_t)b * R * C + c;
    for (int r = r0 + rl; r < r1; r += kRowLanes) {
      const float v = vt::to_f32(xb[(size_t)r * C]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  red[0][rl][lane] = s1;
  red[1][rl][lane] = s2;
  __syncthreads();
  if (threadIdx.x < 2 * kChTile) {
    const int which = threadIdx.x / kChTile, ch = blockIdx.x * kChTile + lane;
    if (ch < C) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < kRowLanes; ++i) v += red[which][i][lane];
      if (gridDim.y == 1) {
        out[((size_t)b * 2 + which) * C + ch] = v;
      } else {
        part[(((size_t)b * gridDim.y + split) * 2 + which) * C + ch] = v;
      }
    }
  }
}

// second pass: out[b, w, c] = sum over splits in order of part[b, s, w, c]
__global__ void gn_split_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int B, int C, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_b = (size_t)2 * C;
  if (i >= (size_t)B * per_b) return;
  const size_t b = i / per_b, wc = i % per_b;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[(b * splits + s) * per_b + wc];
  out[i] = v;
}

template <typename T>
int run(const void* x, void* out, void* part, int B, int R, int C, int splits,
        cudaStream_t stream) {
  const int rows_per_split = (R + splits - 1) / splits;
  dim3 grid((C + kChTile - 1) / kChTile, splits, B);
  gn_sums_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<float*>(out),
                                                   static_cast<float*>(part), R, C,
                                                   rows_per_split);
  if (splits > 1) {
    const size_t total = (size_t)B * 2 * C;
    gn_split_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(out), B, C, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// part is [B, splits, 2, C] float32 scratch when splits > 1 (else unused).
// Returns cudaGetLastError() after the launches.
extern "C" int vt_group_norm_sums(const void* x, void* out, void* part, int B, int R, int C,
                                  int splits, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || C <= 0 || splits <= 0 || splits > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? run<__nv_bfloat16>(x, out, part, B, R, C, splits, st)
                 : run<float>(x, out, part, B, R, C, splits, st);
}
