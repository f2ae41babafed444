// Q1: the W4A8 integer product for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes it in XLA
// (vitron_tpu/kernels/quantization.py::_w4a8_matmul :130, a dot_general of
// s8 x s4 with int32 sums), and no PyTorch call takes the int4 packing. It
// serves the chat's decode matvecs and prefill products when VITRON_W4A8=1
// promotes the packed int4 weights to the W4A8 form ("qa8").
//
//   sx[m] = max(max_k |x[m, k]|, 1e-8) / 127   (or the static scale)
//   xq[m, k] = clamp(rint(x[m, k] / sx[m]), -127, 127)          (int8)
//   y[m, n] = ((float)(sum_k xq[m, k] * q[k, n]) * sx[m]) * s[n]  (in x's type)
//
// q4 is B1's packing: [K/2, N] int8, N contiguous, packed row r holding K
// row 2r in the low nibble and 2r+1 in the high one. The divisions are
// IEEE (__fdiv_rn) and rounding is half to even (rintf), as XLA's; the
// int32 sums are exact, so only the two float32 products of the epilogue
// round, in JAX's order.
//
// One entry, two launches on the caller's stream: quant_rows writes xq and
// sx (one block a row), then the product:
//
// - M <= 8 (decode: 1 row, 4 or 5 in speculation, 8 at most): a GEMV on
//   __dp4a, bound by the packed weight stream (K N / 2 bytes). A lane owns 4
//   columns; per group of 4 K rows it reads one 32-bit word of packed rows
//   2p and 2p + 1, sign-extends the nibbles to s8 in registers (quad_cols)
//   and runs one dp4a a row and column. The 8 warps of a block walk every
//   8th group; the rows are split over blocks (grid.y) so that ~264 blocks
//   fill the 132 SMs, the splits meet by int32 atomics in `acc` (exact in
//   any order) and the strip's last block (a ticket) writes y. The entry
//   zeroes acc and the tickets with cudaMemsetAsync, so every launch starts
//   clean and the call can be captured in a CUDA graph.
// - M > 8 (prefill): a tiled GEMM on mma.sync m16n8k32 s8 x s8 -> s32. A
//   block owns 64 rows x 128 columns, its 8 warps 32 x 32 each; a stage of
//   64 K rows is staged through registers into a double buffer in shared
//   memory (xq rows as they are, the packed tile as it is). A B fragment
//   needs 4 consecutive K rows of one column: fragment column g of the
//   warp's n8 tile j is the block column wn + 4g + j, so one 32-bit word of
//   packed rows 2t and 2t + 1 (and 2t + 8, 2t + 9) gives a thread its b0
//   (and b1) of all four tiles after quad_cols.
//
// Simple first: no cp.async ring, no wgmma; speed is later work.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using vt_gemm::mma_s8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGemvMaxM = 8;
constexpr int kMvCols = 128;  // GEMV columns a block: 32 lanes x 4
constexpr int kBM = 64, kBN = 128, kBK = 64;  // GEMM tile; kBK K rows = kBK / 2 packed rows
constexpr int kAPitch = kBK + 16;  // bytes a row of the xq tile (conflict-free fragment loads)
constexpr int kBPitch = kBN + 16;  // bytes a packed row of the weight tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_rows(const T* __restrict__ x, const float* __restrict__ static_sx, int8_t* __restrict__ xq,
           float* __restrict__ sx, int K) {
  __shared__ float red[kWarps];
  __shared__ float scale;
  const T* xr = x + (size_t)blockIdx.x * K;
  if (static_sx != nullptr) {
    if (threadIdx.x == 0) scale = *static_sx;
  } else {
    float m = 0.f;
    for (int k = threadIdx.x; k < K; k += kThreads) m = fmaxf(m, fabsf(vt::to_f32(xr[k])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = red[0];
      for (int w = 1; w < kWarps; ++w) a = fmaxf(a, red[w]);
      scale = __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
    }
  }
  __syncthreads();
  const float s = scale;
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* qr = xq + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float r = rintf(__fdiv_rn(vt::to_f32(xr[k]), s));
    qr[k] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
  }
}

// the low / high nibble of each byte, sign-extended to s8 in its byte
__device__ __forceinline__ unsigned sext_lo(unsigned w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned sext_hi(unsigned w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// packed words r0 (packed row 2p) and r1 (2p + 1) of 4 columns -> c[j], the
// K rows 4p..4p+3 of column j as four s8 (the lowest K row in the low byte)
__device__ __forceinline__ void quad_cols(unsigned r0, unsigned r1, unsigned (&c)[4]) {
  const unsigned l0 = sext_lo(r0), h0 = sext_hi(r0), l1 = sext_lo(r1), h1 = sext_hi(r1);
  const unsigned t0 = __byte_perm(l0, h0, 0x5140), t1 = __byte_perm(l1, h1, 0x5140);
  const unsigned t2 = __byte_perm(l0, h0, 0x7362), t3 = __byte_perm(l1, h1, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

template <typename T>
__device__ __forceinline__ T dequant(int acc, float sxm, float sn) {
  return vt::from_f32<T>(__int2float_rn(acc) * sxm * sn);  // (acc * sx) * s, as JAX
}

// grid (ceil(N / 128), splits); split y walks groups [y qps, (y + 1) qps) of 4 K rows
template <typename T, int MR>
__global__ void __launch_bounds__(kThreads)
w4a8_gemv(const int8_t* __restrict__ xq, const int8_t* __restrict__ q4,
          const float* __restrict__ sx, const float* __restrict__ s, T* __restrict__ y,
          int* __restrict__ acc_g, unsigned* __restrict__ ticket, int K, int N, int qps) {
  __shared__ int red[kWarps][MR][kMvCols];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kMvCols;
  const int col = c0 + lane * 4;
  const int P = K >> 2;
  const int p1 = min(P, ((int)blockIdx.y + 1) * qps);
  int acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;
  if (col < N) {
    const unsigned* xw = reinterpret_cast<const unsigned*>(xq);  // row m, group p: m P + p
#pragma unroll 4
    for (int p = blockIdx.y * qps + warp; p < p1; p += kWarps) {
      const unsigned r0 = __ldg(reinterpret_cast<const unsigned*>(q4 + (size_t)(2 * p) * N + col));
      const unsigned r1 =
          __ldg(reinterpret_cast<const unsigned*>(q4 + (size_t)(2 * p + 1) * N + col));
      unsigned c[4];
      quad_cols(r0, r1, c);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int xv = static_cast<int>(__ldg(xw + (size_t)m * P + p));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(static_cast<int>(c[j]), xv, acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  const bool split = gridDim.y > 1;
  for (int o = threadIdx.x; o < MR * kMvCols; o += kThreads) {
    const int m = o / kMvCols, cc = o % kMvCols, n = c0 + cc;
    if (n >= N) continue;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][m][cc];
    if (split)
      atomicAdd(acc_g + (size_t)m * N + n, v);
    else
      y[(size_t)m * N + n] = dequant<T>(v, sx[m], s[n]);
  }
  if (!split) return;
  __threadfence();  // this block's sums are in acc before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < MR * kMvCols; o += kThreads) {
    const int m = o / kMvCols, n = c0 + o % kMvCols;
    if (n < N) y[(size_t)m * N + n] = dequant<T>(__ldcg(acc_g + (size_t)m * N + n), sx[m], s[n]);
  }
}

// grid (ceil(N / 128), ceil(M / 64)); K % 16 == 0, N % 16 == 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
w4a8_gemm(const int8_t* __restrict__ xq, const int8_t* __restrict__ q4,
          const float* __restrict__ sx, const float* __restrict__ s, T* __restrict__ y, int M,
          int K, int N) {
  __shared__ __align__(16) int8_t As[2][kBM][kAPitch];
  __shared__ __align__(16) int8_t Bs[2][kBK / 2][kBPitch];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int K2 = K >> 1;
  const int a_row = tid >> 2, a_part = tid & 3;  // 64 rows x 4 chunks of 16 bytes
  const int b_row = tid >> 3, b_part = tid & 7;  // 32 packed rows x 8 chunks
  const bool a_ok = m0 + a_row < M;
  const bool b_ok = n0 + b_part * 16 < N;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra, rb;
  auto load = [&](int kt) {
    const int k0 = kt * kBK;
    ra = a_ok && k0 + a_part * 16 < K
             ? __ldg(reinterpret_cast<const uint4*>(xq + (size_t)(m0 + a_row) * K + k0 +
                                                    a_part * 16))
             : zero;
    const int r = (k0 >> 1) + b_row;
    rb = b_ok && r < K2
             ? __ldg(reinterpret_cast<const uint4*>(q4 + (size_t)r * N + n0 + b_part * 16))
             : zero;
  };
  auto store = [&](int buf) {
    *reinterpret_cast<uint4*>(&As[buf][a_row][a_part * 16]) = ra;
    *reinterpret_cast<uint4*>(&Bs[buf][b_row][b_part * 16]) = rb;
  };
  auto word = [](const int8_t* p) { return *reinterpret_cast<const unsigned*>(p); };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0;

  const int KT = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g, c = kk * 32 + 4 * t;
        a[i][0] = word(&As[buf][r][c]);
        a[i][1] = word(&As[buf][r + 8][c]);
        a[i][2] = word(&As[buf][r][c + 16]);
        a[i][3] = word(&As[buf][r + 8][c + 16]);
      }
      const int pr = kk * 16 + 2 * t, pc = wn + 4 * g;
      unsigned b0[4], b1[4];
      quad_cols(word(&Bs[buf][pr][pc]), word(&Bs[buf][pr + 1][pc]), b0);
      quad_cols(word(&Bs[buf][pr + 8][pc]), word(&Bs[buf][pr + 9][pc]), b1);
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
        const int row = m0 + wm + 16 * i + g + (h >> 1) * 8;
        const int col = n0 + wn + 4 * (2 * t + (h & 1)) + j;  // fragment column 2t (+1) of tile j
        if (row < M && col < N) y[(size_t)row * N + col] = dequant<T>(acc[i][j][h], sx[row], s[col]);
      }
}

template <typename T, int MR>
void launch_gemv(dim3 grid, cudaStream_t st, const int8_t* xq, const int8_t* q4, const float* sx,
                 const float* s, T* y, int* acc, unsigned* ticket, int K, int N, int qps) {
  w4a8_gemv<T, MR><<<grid, kThreads, 0, st>>>(xq, q4, sx, s, y, acc, ticket, K, N, qps);
}

template <typename T>
int run(const void* x, const void* q4v, const void* sv, const void* static_sx, void* yv, void* xqv,
        void* sxv, void* accv, void* ticketv, int M, int K2, int N, int splits, cudaStream_t st) {
  const int K = 2 * K2;
  auto* xq = static_cast<int8_t*>(xqv);
  auto* sx = static_cast<float*>(sxv);
  const auto* q4 = static_cast<const int8_t*>(q4v);
  const auto* s = static_cast<const float*>(sv);
  auto* y = static_cast<T*>(yv);
  quant_rows<T><<<M, kThreads, 0, st>>>(static_cast<const T*>(x),
                                        static_cast<const float*>(static_sx), xq, sx, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (M > kGemvMaxM) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    w4a8_gemm<T><<<grid, kThreads, 0, st>>>(xq, q4, sx, s, y, M, K, N);
    return (int)cudaGetLastError();
  }
  const int strips = (N + kMvCols - 1) / kMvCols;
  const int qps = (K / 4 + splits - 1) / splits;
  auto* acc = static_cast<int*>(accv);
  auto* ticket = static_cast<unsigned*>(ticketv);
  if (splits > 1) {
    if ((err = cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)M * N, st)) != cudaSuccess ||
        (err = cudaMemsetAsync(ticket, 0, sizeof(unsigned) * (size_t)strips, st)) != cudaSuccess)
      return (int)err;
  }
  const dim3 grid(strips, splits);
  switch (M) {
    case 1: launch_gemv<T, 1>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
    case 2: launch_gemv<T, 2>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
    case 3: launch_gemv<T, 3>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
    case 4: launch_gemv<T, 4>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
    case 5: launch_gemv<T, 5>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
    case 6: launch_gemv<T, 6>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
    case 7: launch_gemv<T, 7>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
    default: launch_gemv<T, 8>(grid, st, xq, q4, sx, s, y, acc, ticket, K, N, qps); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vt_w4a8_matmul(const void* x, const void* q4, const void* s, const void* static_sx,
                              void* y, void* xq, void* sx, void* acc, void* ticket, int M, int K2,
                              int N, int splits, int is_bf16, void* stream) {
  if (M <= 0 || K2 <= 0 || N <= 0 || splits <= 0 || (2 * K2) % 16 || N % 16 ||
      (M <= kGemvMaxM && splits > (2 * K2) / 4) || (M <= kGemvMaxM && splits > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run<__nv_bfloat16>(x, q4, s, static_sx, y, xq, sx, acc, ticket, M, K2, N, splits, st);
  return run<float>(x, q4, s, static_sx, y, xq, sx, acc, ticket, M, K2, N, splits, st);
}
