// int4 weight-only matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/int4_matmul.py::_kernel
// (pallas_call at :108, entry _int4_matmul_impl :78 / int4_matmul :53).
//
//   y[M, N] = (sum_r x[:, 2r] * lo[r, :] + x[:, 2r+1] * hi[r, :]) * s[N]
//
// q4 is [K/2, N] int8, N contiguous: packed row r holds K row 2r in the low
// nibble and K row 2r+1 in the high nibble, both two's complement. The sum
// is float32 and the per-column scale is applied once at the end; y has the
// type of x (float32 or bfloat16).
//
// What bounds it on the H100: decode (M = 1) streams every packed weight
// byte once per token -- about 3.4 GB at Vicuna-7B with the int4 head -- so
// the GEMV is bound by device-memory bandwidth. The design therefore reads
// the packed bytes exactly once, coalesced (a warp reads 128 consecutive
// bytes of a row), and never materialises the unpacked matrix. A nibble
// becomes a float without the quarter-rate int->float convert: XOR 8 biases
// it to [0, 15], OR-ing that into the mantissa of 2^23 and subtracting
// 2^23 + 8 gives the exact value with full-rate integer and FADD
// instructions. Decode shapes have too few column tiles to fill 132 SMs, so
// the rows are split over blocks (split-K) and a second pass adds the
// partial sums in a fixed order: no atomics, identical bits run to run.
//
// Prefill (M > 8) is a plain shared-memory tiled GEMM with float32 FMAs:
// each block unpacks a [16, 64] packed tile into a [32, 64] float tile and
// multiplies it with a [64, 32] activation tile. It is compute-bound and
// far from the tensor-core rate; wgmma/TMA belong to a later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvCols = 128;  // 32 lanes x 4 columns (one 32-bit word)
constexpr int kGemvUnroll = 4;

// biased nibble (value + 8, in [0, 15]) -> exact float value
__device__ __forceinline__ float nib(uint32_t biased) {
  return __uint_as_float(0x4B000000u | biased) - 8388616.0f;  // 2^23 + 8
}

template <typename T, int MR>
__device__ __forceinline__ void gemv_row(float (&acc)[MR][4], uint32_t w,
                                         const T* __restrict__ x, int r, int K) {
  w ^= 0x88888888u;
  float lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = nib((w >> (8 * j)) & 0xFu);
    hi[j] = nib((w >> (8 * j + 4)) & 0xFu);
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float xe = vt::to_f32(x[(size_t)m * K + 2 * r]);
    const float xo = vt::to_f32(x[(size_t)m * K + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xo, hi[j], fmaf(xe, lo[j], acc[m][j]));
  }
}

// grid (ceil(N / 128), splits); each warp walks every 8th packed row of the
// block's row range for 128 columns; the 8 warps' sums meet in shared memory.
template <typename T, int MR>
__global__ void __launch_bounds__(kThreads)
int4_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q4,
                 const float* __restrict__ s, T* __restrict__ y,
                 float* __restrict__ part, int K2, int N, int rows_per_split) {
  __shared__ __align__(16) float red[kGemvWarps][MR][kGemvCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kGemvCols + lane * 4;
  const int split = blockIdx.y;
  const int r_end = min(K2, (split + 1) * rows_per_split);
  const int K = 2 * K2;

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  if (col < N) {
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(q4 + col);
    const size_t row_words = (size_t)(N >> 2);
    int r = split * rows_per_split + warp;
    for (; r + (kGemvUnroll - 1) * kGemvWarps < r_end; r += kGemvUnroll * kGemvWarps) {
      uint32_t w[kGemvUnroll];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) w[u] = __ldg(wp + (size_t)(r + u * kGemvWarps) * row_words);
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) gemv_row<T, MR>(acc, w[u], x, r + u * kGemvWarps, K);
    }
    for (; r < r_end; r += kGemvWarps) gemv_row<T, MR>(acc, __ldg(wp + (size_t)r * row_words), x, r, K);
  }

#pragma unroll
  for (int m = 0; m < MR; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();

  for (int o = threadIdx.x; o < MR * kGemvCols; o += kThreads) {
    const int m = o / kGemvCols;
    const int c = o % kGemvCols;
    const int n = blockIdx.x * kGemvCols + c;
    if (n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) v += red[w][m][c];
    if (gridDim.y == 1) {
      y[(size_t)m * N + n] = vt::from_f32<T>(v * s[n]);
    } else {
      part[((size_t)split * MR + m) * N + n] = v;
    }
  }
}

// second pass of split-K: fixed-order sum over the splits, then the scale
template <typename T>
__global__ void int4_split_reduce_kernel(const float* __restrict__ part,
                                         const float* __restrict__ s, T* __restrict__ y,
                                         int M, int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float v = 0.f;
  for (int sp = 0; sp < splits; ++sp) v += part[sp * total + i];
  y[i] = vt::from_f32<T>(v * s[i % N]);
}

constexpr int kBM = 64, kBN = 64, kBK2 = 16, kBK = 2 * kBK2;

// grid (ceil(N / 64), ceil(M / 64)); 16 x 16 threads, 4 x 4 outputs each
template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q4,
                 const float* __restrict__ s, T* __restrict__ y, int M, int K2, int N) {
  __shared__ __align__(16) float xs[kBK][kBM + 4];  // activations, k-major
  __shared__ __align__(16) float ws[kBK][kBN + 4];  // unpacked weights
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int K = 2 * K2;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < K2; kb += kBK2) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i % kBK;
      const int gm = m0 + mm, gk = 2 * kb + kk;
      xs[kk][mm] = (gm < M && gk < K) ? vt::to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    {
      const int rr = tid / 16, cw = tid % 16;  // one 32-bit word (4 columns) per thread
      const int gr = kb + rr, gc = n0 + cw * 4;
      uint32_t w = 0u;  // zero nibbles outside the matrix add nothing
      if (gr < K2 && gc < N) w = __ldg(reinterpret_cast<const uint32_t*>(q4 + (size_t)gr * N + gc));
      w ^= 0x88888888u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ws[2 * rr][cw * 4 + j] = nib((w >> (8 * j)) & 0xFu);
        ws[2 * rr + 1][cw * 4 + j] = nib((w >> (8 * j + 4)) & 0xFu);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) y[(size_t)gm * N + gn] = vt::from_f32<T>(acc[i][j] * s[gn]);
    }
  }
}

template <typename T, int MR>
void launch_gemv(const T* x, const int8_t* q4, const float* s, T* y, float* part,
                 int K2, int N, int splits, cudaStream_t stream) {
  const int rows_per_split = (K2 + splits - 1) / splits;
  dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  int4_gemv_kernel<T, MR><<<grid, kThreads, 0, stream>>>(x, q4, s, y, part, K2, N, rows_per_split);
  if (splits > 1) {
    const size_t total = (size_t)MR * N;
    int4_split_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, s, y, MR, N, splits);
  }
}

template <typename T>
int run(const void* x_, const void* q4_, const void* s_, void* y_, void* part_, int M,
        int K2, int N, int splits, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const int8_t* q4 = static_cast<const int8_t*>(q4_);
  const float* s = static_cast<const float*>(s_);
  T* y = static_cast<T*>(y_);
  float* part = static_cast<float*>(part_);
  switch (M) {
#define VT_GEMV_CASE(R) \
  case R:               \
    launch_gemv<T, R>(x, q4, s, y, part, K2, N, splits, stream); \
    break;
    VT_GEMV_CASE(1) VT_GEMV_CASE(2) VT_GEMV_CASE(3) VT_GEMV_CASE(4)
    VT_GEMV_CASE(5) VT_GEMV_CASE(6) VT_GEMV_CASE(7) VT_GEMV_CASE(8)
#undef VT_GEMV_CASE
    default: {
      dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
      int4_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(x, q4, s, y, M, K2, N);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// M <= 8 takes the split-K GEMV (`part` is [splits, M, N] float32 scratch
// when splits > 1), larger M the tiled GEMM. N must be a multiple of 4.
// Returns cudaGetLastError() after the launches.
extern "C" int vt_int4_matmul(const void* x, const void* q4, const void* s, void* y,
                              void* part, int M, int K2, int N, int splits, int is_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run<__nv_bfloat16>(x, q4, s, y, part, M, K2, N, splits, st);
  return run<float>(x, q4, s, y, part, M, K2, N, splits, st);
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
