// 3x3 stride-1 SAME convolution (B9) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/conv2d.py::_kernel (:39,
// pallas_call at :99 in _conv3x3 :70, entry conv3x3_same :150).
//
//   y[b, h, w, :] = sum_{dy, dx} x[b, h + dy - 1, w + dx - 1, :] @ w[dy, dx]
//   x [B, H, W, C] (NHWC), w [3, 3, C, D] (HWIO), zero outside the image;
//   y [B, H, W, D] in x's type
//
// The TPU kernel computes its nine tap products with the taps cast to
// bfloat16 (for float32 inputs too) and float32 sums; so does this one. It
// is an implicit GEMM of M = B * H * W output pixels, depth K = 9C and D
// columns: A is never stored. The tile loader maps output row (b, h, w)
// and depth t * C + c (tap t = 3 dy + dx) to x[b, h + dy - 1, w + dx - 1, c]
// and reads zero outside the image, so no padded copy of x and no partial
// product reaches device memory; B is w seen as [9C, D]. Both operands are
// rounded to bfloat16 as they are staged into shared memory, whatever the
// input type, and multiplied on the tensor cores (mma.sync m16n8k16, bf16
// in, float32 sums); each step's 32 products are summed by the tensor
// cores and added to the running float32 sum on the CUDA cores, so the
// sums round to nearest; y is written once, rounded to x's type.
//
// Tiles: a block of 256 threads owns 128 x 128 outputs and walks K in steps
// of 32 (C is a multiple of 32, so a step never straddles two taps); its
// eight warps (2 x 4) each multiply a 64 x 32 sub-tile, with the fragment
// loads and products of tiled_gemm.cuh. The next step's values are loaded
// into registers (16 bytes a load) while the current one is multiplied, then
// converted and stored to the other shared buffer: one barrier a step.
//
// What bounds it on the H100: the video UNet's 3x3 sites (2 x 16 frames of
// 64x64 latents down to 8x8, C 512-4096) are 0.3-1.9 TFLOP each against
// 0.05-0.9 GB of x, w and y, so they are bound by operations, at the bf16
// tensor-core rate of 989 TFLOP/s for both input types. This first kernel
// feeds mma.sync from register-staged loads; wgmma with TMA is the next step.
#include "tiled_gemm.cuh"

namespace {

using vt_gemm::pack_bf16;

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kAP = kBK + 8;  // A row pitch in shared memory (values): rows in distinct banks
constexpr int kBP = kBN + 8;  // B row pitch

struct ConvShape {
  int B, H, W, C, D;
};

// 8 consecutive values at p (16-byte aligned) as 8 bfloat16 in a uint4
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// two blocks an SM (at most 128 registers a thread), so one block's
// loads and barrier overlap the other's products
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, ConvShape s) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kAP];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK][kBP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = s.B * s.H * s.W;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // each thread stages two 8-value chunks of A (rows a_row, depths a_kc..)
  // and two of B (depths b_k, columns b_n..) per step
  int a_row[2], a_kc[2], a_b[2], a_h[2], a_w[2], b_k[2], b_n[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * kThreads;
    a_row[i] = id >> 2;
    a_kc[i] = (id & 3) * 8;
    const int m = m0 + a_row[i];
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_w[i] = mm % s.W;
    a_h[i] = (mm / s.W) % s.H;
    a_b[i] = mm / (s.W * s.H);
    b_k[i] = id >> 4;
    b_n[i] = (id & 15) * 8;
  }

  auto load = [&](int k0, uint4 (&ra)[2], uint4 (&rb)[2]) {
    const int tap = k0 / s.C, c0 = k0 - tap * s.C;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hh = a_h[i] + dy, ww = a_w[i] + dx;
      const bool ok = a_ok[i] && hh >= 0 && hh < s.H && ww >= 0 && ww < s.W;
      ra[i] = ok ? load8_bf16(x + (((size_t)a_b[i] * s.H + hh) * s.W + ww) * s.C + c0 + a_kc[i])
                 : make_uint4(0, 0, 0, 0);
      rb[i] = load8_bf16(w + (size_t)(k0 + b_k[i]) * s.D + n0 + b_n[i]);
    }
  };
  auto store = [&](int buf, const uint4 (&ra)[2], const uint4 (&rb)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&As[buf][a_row[i]][a_kc[i]]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[buf][b_k[i]][b_n[i]]) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  uint4 ra[2], rb[2];
  load(0, ra, rb);
  store(0, ra, rb);
  __syncthreads();

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nk = 9 * s.C / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * kBK, ra, rb);  // in flight during the products
    unsigned bfr[2][2][4];  // [16-deep half of the step][column pair]
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        vt_gemm::ldmatrix_x4_trans(bfr[kh][nj],
                                   &Bs[st][kh * 16 + (lane & 15)][wn + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      unsigned af[2][4];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
        vt_gemm::ldmatrix_x4(af[kh],
                             &As[st][wm + mi * 16 + (lane & 15)][kh * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // the step's 32 products in a fresh accumulator, then one float32
        // add (round to nearest) into the running sum: the tensor cores'
        // own accumulation truncates, and over K = 9C up to 36,864 deep a
        // single chain of mma's drifts by ~5e-5 of the output's scale
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          vt_gemm::mma_bf16(part, af[kh], bfr[kh][ni >> 1][(ni & 1) * 2],
                            bfr[kh][ni >> 1][(ni & 1) * 2 + 1]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[r];
      }
    }
    // the other buffer's readers finished before the previous barrier
    if (more) store(st ^ 1, ra, rb);
    __syncthreads();
  }

  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + tig * 2;  // D is a multiple of 128: always in range
        store2(y + (size_t)m * s.D + n, acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
    }
  }
}

}  // namespace

// x [B, H, W, C], w [3, 3, C, D], y [B, H, W, D], all of one type (float32
// or bfloat16), contiguous and 16-byte aligned; C a multiple of 32, D of 128.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for other shapes.
extern "C" int vt_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int C, int D,
                          int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || C % kBK || D % kBN ||
      !vt_gemm::aligned16(x) || !vt_gemm::aligned16(w) || !vt_gemm::aligned16(y))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * W;
  const long long row_tiles = (rows + kBM - 1) / kBM;
  if (rows > 0x7fffffffLL || 9LL * C > 0x7fffffffLL || row_tiles > 0x7fffffffLL ||
      D / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const ConvShape s{B, H, W, C, D};
  const dim3 grid((unsigned)row_tiles, (unsigned)(D / kBN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    conv3x3_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), s);
  } else {
    conv3x3_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), s);
  }
  return (int)cudaGetLastError();
}
