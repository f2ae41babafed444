// Q2: the W8A8 3x3 convolution for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes it in XLA
// (vitron_tpu/kernels/quantization.py::conv2d_w8a8 :277, a
// conv_general_dilated of s8 x s8 with int32 sums), and PyTorch has no int8
// convolution on CUDA. It serves every eligible UNet conv when
// VITRON_UNET_QUANT / VITRON_VUNET_QUANT=w8a8 quantize the UNets.
//
//   y[b, oh, ow, co] = (float)(sum_{dy, dx, c} xq[b, oh s + dy - p, ow s + dx - p, c]
//                                              * w[dy, dx, c, co]) * ssx[co]
//
// xq [B, H, W, C] int8 NHWC (the activation quantized per tensor before the
// launch), w [3, 3, C, Co] int8 HWIO, ssx = s * sx [Co] float32 (JAX's
// association: y * (s * sx)), stride 1 or 2, padding 0 or 1; y in float32
// or bf16. The int32 sums are exact (127^2 9 C < 2^31 for C < 14,000), so
// only the one float32 product and the cast round.
//
// An implicit GEMM: M = B OH OW output pixels, depth 9C (tap-major, as the
// HWIO weight is laid out), Co columns, on mma.sync m16n8k32 s8 x s8 -> s32.
// It is bound by operations at the UNets' widths (2 M 9C Co against M C +
// 9 C Co + M Co bytes). A block owns 128 pixels x 64 columns, its 8 warps
// 32 x 32 each. A stage of one tap and 64 channels is staged through
// registers into a double buffer in shared memory: each pixel's 64 input
// channels at (oh s + dy - p, ow s + dx - p), zero outside the image (the
// padding: no padded copy of x exists), and the weight's 64 x 64 tile,
// transposed 4 x 4 bytes at a time by byte permutes as it is stored, so
// that a B fragment (4 consecutive K rows of one column) is one 32-bit
// load. C must be a multiple of 16 and Co of 4.
//
// Simple first: no cp.async ring, no wgmma (ROADMAP B: a wgmma s8 form on
// wgmma.cuh and the activation quantization fused into the prologue).
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using vt_gemm::mma_s8;

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 64, kBK = 64;
constexpr int kPitch = kBK + 16;  // bytes a row of either tile (conflict-free fragment loads)

struct ConvShape {
  int B, H, W, C, Co, OH, OW, stride, pad;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv2d_w8a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                   const float* __restrict__ ssx, T* __restrict__ y, ConvShape g) {
  __shared__ __align__(16) int8_t As[2][kBM][kPitch];  // [pixel][k]
  __shared__ __align__(16) int8_t Bs[2][kBN][kPitch];  // [co][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int M = g.B * g.OH * g.OW;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int cchunks = (g.C + kBK - 1) / kBK;
  const int KT = 9 * cchunks;

  // this thread's two A chunks: pixel rows tid / 4 and tid / 4 + 64, 16 bytes at (tid % 4) 16
  const int a_part = tid & 3;
  int a_img[2], a_ih[2], a_iw[2];
  bool a_ok[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int m = m0 + (tid >> 2) + 64 * u;
    a_ok[u] = m < M;
    const int mm = a_ok[u] ? m : 0;
    const int ow = mm % g.OW, oh = (mm / g.OW) % g.OH;
    a_img[u] = mm / (g.OW * g.OH);
    a_ih[u] = oh * g.stride - g.pad;
    a_iw[u] = ow * g.stride - g.pad;
  }
  // this thread's weight block: K rows 4 kb..4 kb+3 of columns 4 nb..4 nb+3
  const int kb = tid >> 4, nb = tid & 15;
  const bool b_ok = n0 + 4 * nb < g.Co;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra[2];
  unsigned rb[4];

  auto load = [&](int kt) {
    const int tap = kt / cchunks, c0 = (kt - tap * cchunks) * kBK;
    const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ih = a_ih[u] + dy, iw = a_iw[u] + dx, c = c0 + a_part * 16;
      const bool ok = a_ok[u] && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C;
      ra[u] = ok ? __ldg(reinterpret_cast<const uint4*>(
                       xq + (((size_t)a_img[u] * g.H + ih) * g.W + iw) * g.C + c))
                 : zero;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 4 * kb + i;
      rb[i] = b_ok && c < g.C
                  ? __ldg(reinterpret_cast<const unsigned*>(
                        w + ((size_t)tap * g.C + c) * g.Co + n0 + 4 * nb))
                  : 0u;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      *reinterpret_cast<uint4*>(&As[buf][(tid >> 2) + 64 * u][a_part * 16]) = ra[u];
    // rb[i] byte j = w[k 4 kb + i][co 4 nb + j] -> column j's four K rows in one word
    const unsigned t0 = __byte_perm(rb[0], rb[1], 0x5140), t1 = __byte_perm(rb[2], rb[3], 0x5140);
    const unsigned t2 = __byte_perm(rb[0], rb[1], 0x7362), t3 = __byte_perm(rb[2], rb[3], 0x7362);
    *reinterpret_cast<unsigned*>(&Bs[buf][4 * nb + 0][4 * kb]) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<unsigned*>(&Bs[buf][4 * nb + 1][4 * kb]) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<unsigned*>(&Bs[buf][4 * nb + 2][4 * kb]) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<unsigned*>(&Bs[buf][4 * nb + 3][4 * kb]) = __byte_perm(t2, t3, 0x7632);
  };
  auto word = [](const int8_t* p) { return *reinterpret_cast<const unsigned*>(p); };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c = kk * 32 + 4 * t;
      unsigned a[2][4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + gq;
        a[i][0] = word(&As[buf][r][c]);
        a[i][1] = word(&As[buf][r + 8][c]);
        a[i][2] = word(&As[buf][r][c + 16]);
        a[i][3] = word(&As[buf][r + 8][c + 16]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = word(&Bs[buf][wn + 8 * j + gq][c]);
        b1[j] = word(&Bs[buf][wn + 8 * j + gq][c + 16]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b0[j], b1[j]);
    }
    if (kt + 1 < KT) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int row = m0 + wm + 16 * i + gq + (h >> 1) * 8;
        const int col = n0 + wn + 8 * j + 2 * t + (h & 1);
        if (row < M && col < g.Co)
          y[(size_t)row * g.Co + col] = vt::from_f32<T>(__int2float_rn(acc[i][j][h]) * ssx[col]);
      }
}

}  // namespace

extern "C" int vt_conv2d_w8a8(const void* xq, const void* w, const void* ssx, void* y, int B,
                              int H, int W, int C, int Co, int stride, int pad, int is_bf16,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 || Co % 4 ||
      (stride != 1 && stride != 2) || (pad != 0 && pad != 1))
    return (int)cudaErrorInvalidValue;
  const int OH = (H + 2 * pad - 3) / stride + 1, OW = (W + 2 * pad - 3) / stride + 1;
  const long long M = (long long)B * OH * OW;
  if (OH <= 0 || OW <= 0 || M * Co > 0x7fffffffLL || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const ConvShape g{B, H, W, C, Co, OH, OW, stride, pad};
  const dim3 grid((Co + kBN - 1) / kBN, (unsigned)((M + kBM - 1) / kBM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(ssx);
  if (is_bf16)
    conv2d_w8a8_kernel<__nv_bfloat16>
        <<<grid, kThreads, 0, st>>>(xp, wp, sp, static_cast<__nv_bfloat16*>(y), g);
  else
    conv2d_w8a8_kernel<float><<<grid, kThreads, 0, st>>>(xp, wp, sp, static_cast<float*>(y), g);
  return (int)cudaGetLastError();
}
