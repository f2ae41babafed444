// Fused GEGLU feed-forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/geglu_ff.py::_kernel
// (:45, pallas_call at :90, entry geglu_ff_fused :163).
//
//   [a | g] = x @ W1 + b1      x [M, C], W1 [C, 2F] (a = cols 0..F-1, g = F..2F-1)
//   t       = (a * gelu(g))    exact erf gelu in float32, then rounded to T
//   out     = t @ W2 + b2      W2 [F, C]; float32 sums, out in T
//
// What bounds it on the H100: the SD UNet sites (M 8192/2048/512/128 at
// C 320/640/1280, F = 4C) are 5-20 GFLOP each with 24 * M * C^2 flops over
// 2.4-39 MB of weights, so they are compute-bound; the one cost a fusion
// saves is the [M, 2F] hidden tensor (84 MB in float32 at M = 8192) going
// out to device memory and back. The design keeps it on chip: a block owns
// BM rows and the whole C-wide output, holds its [BM, C] float32 sum in
// registers (80 per thread: BM x C = 20480 for every width, so BM = 64, 32
// or 16 -- the TPU kernel's _pick_bm answer to the same budget), stages its
// x rows once in shared memory, and walks F in chunks of FC = 2048 / BM
// columns (32, 64, 128), so that every width gives each thread a 4-row by
// (2 a + 2 g)-column tile in phase 1: phase 1 makes the chunk's a and g
// columns (a [BM, FC + FC] product over C from W1 tiles in shared memory),
// applies the gelu and the rounding into a [BM, FC] shared tile, phase 2
// adds that tile times W2's FC rows (read straight from L2: each W2 word is
// used by at most 4 threads of a block).
// Too few row blocks to fill 132 SMs at the narrow sites, so F is split over
// blocks (split-F) and a second pass adds the float32 partial sums in a
// fixed order: no atomics, the same bits run to run. The products are plain
// float32 FMAs; tensor cores (mma/wgmma) belong to a later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;           // W1 rows per shared tile
constexpr int kAccElems = 20480;  // BM * C
constexpr int kColsPT = 5;        // phase-2 output columns per thread
constexpr int kRowsPT = 16;       // phase-2 output rows per thread
constexpr int kRowsPT1 = 4;       // phase-1 rows per thread

// hidden columns per step for width C: BM * FC = 2048 (a 4 x 4 phase-1 tile
// for each of the 256 threads)
template <int C>
__host__ __device__ constexpr int f_chunk() {
  return 2048 / (kAccElems / C);
}

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

template <int C>
constexpr size_t smem_bytes() {
  constexpr int BM = kAccElems / C;
  constexpr int FC = f_chunk<C>();
  return sizeof(float) * ((size_t)BM * (C + 1) + (size_t)kKC * 2 * FC + (size_t)BM * (FC + 1));
}

// grid (ceil(M / BM), splits); each block walks hidden chunks
// [split * per, min(n_chunks, (split + 1) * per)).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
geglu_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
             const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
             float* __restrict__ part, int M, int F, int per) {
  constexpr int BM = kAccElems / C;
  constexpr int FC = f_chunk<C>();        // hidden columns per step
  constexpr int XP = C + 1;               // padded x row (distinct banks per row)
  constexpr int CG1 = FC / 2;             // phase-1 column groups (2 a + 2 g columns)
  constexpr int CG = C / kColsPT;         // phase-2 column groups
  constexpr int TP = FC + 1;
  static_assert(CG1 * (BM / kRowsPT1) == kThreads, "phase-1 tiling must cover the block");
  static_assert(CG * (BM / kRowsPT) == kThreads, "phase-2 tiling must cover the block");
  extern __shared__ float smem[];
  float* Xs = smem;                       // [BM][XP]
  float* Ws = Xs + BM * XP;               // [kKC][2 FC]: a cols 0..FC-1, g cols FC..2FC-1
  float* Ts = Ws + kKC * 2 * FC;          // [BM][TP]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n_chunks = F / FC;
  const int c_begin = blockIdx.y * per;
  const int c_end = min(n_chunks, c_begin + per);

  for (int i = tid; i < BM * C; i += kThreads) {
    const int r = i / C, c = i % C;
    Xs[r * XP + c] = (m0 + r < M) ? vt::to_f32(x[(size_t)(m0 + r) * C + c]) : 0.f;
  }

  // phase 1: rows ty * 4 + i, a/g columns 2tx, 2tx + 1 of the chunk
  const int ty = tid / CG1, tx = tid % CG1;
  // phase 2: rows rg * 16 + i, output columns cg + CG * j
  const int cg = tid % CG, rg = tid / CG;

  float acc[kRowsPT][kColsPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int j = 0; j < kColsPT; ++j) acc[i][j] = 0.f;

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int f0 = ch * FC;
    float h[kRowsPT1][4];
#pragma unroll
    for (int i = 0; i < kRowsPT1; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = 0.f;

    for (int k0 = 0; k0 < C; k0 += kKC) {
      __syncthreads();  // Xs is written / the previous tile's readers are done
      for (int i = tid; i < kKC * 2 * FC; i += kThreads) {
        const int r = i / (2 * FC), col = i % (2 * FC);
        const int gcol = col < FC ? f0 + col : F + f0 + (col - FC);
        Ws[i] = vt::to_f32(w1[(size_t)(k0 + r) * 2 * F + gcol]);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        const float2 wa = *reinterpret_cast<const float2*>(&Ws[k * 2 * FC + 2 * tx]);
        const float2 wg = *reinterpret_cast<const float2*>(&Ws[k * 2 * FC + FC + 2 * tx]);
#pragma unroll
        for (int i = 0; i < kRowsPT1; ++i) {
          const float xv = Xs[(ty * kRowsPT1 + i) * XP + k0 + k];
          h[i][0] = fmaf(xv, wa.x, h[i][0]);
          h[i][1] = fmaf(xv, wa.y, h[i][1]);
          h[i][2] = fmaf(xv, wg.x, h[i][2]);
          h[i][3] = fmaf(xv, wg.y, h[i][3]);
        }
      }
    }
    const float ba0 = vt::to_f32(b1[f0 + 2 * tx]), ba1 = vt::to_f32(b1[f0 + 2 * tx + 1]);
    const float bg0 = vt::to_f32(b1[F + f0 + 2 * tx]), bg1 = vt::to_f32(b1[F + f0 + 2 * tx + 1]);
#pragma unroll
    for (int i = 0; i < kRowsPT1; ++i) {
      const int r = ty * kRowsPT1 + i;
      // the hidden tile is rounded to the input type before the second product
      Ts[r * TP + 2 * tx] =
          vt::to_f32(vt::from_f32<T>((h[i][0] + ba0) * gelu_erf(h[i][2] + bg0)));
      Ts[r * TP + 2 * tx + 1] =
          vt::to_f32(vt::from_f32<T>((h[i][1] + ba1) * gelu_erf(h[i][3] + bg1)));
    }
    __syncthreads();

    const T* w2c = w2 + (size_t)f0 * C + cg;
#pragma unroll 4
    for (int f = 0; f < FC; ++f) {
      float wv[kColsPT];
#pragma unroll
      for (int j = 0; j < kColsPT; ++j) wv[j] = vt::to_f32(__ldg(w2c + (size_t)f * C + CG * j));
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const float tv = Ts[(rg * kRowsPT + i) * TP + f];
#pragma unroll
        for (int j = 0; j < kColsPT; ++j) acc[i][j] = fmaf(tv, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const int m = m0 + rg * kRowsPT + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kColsPT; ++j) {
      const int c = cg + CG * j;
      if (gridDim.y == 1) {
        out[(size_t)m * C + c] = vt::from_f32<T>(acc[i][j] + vt::to_f32(b2[c]));
      } else {
        part[((size_t)blockIdx.y * M + m) * C + c] = acc[i][j];
      }
    }
  }
}

// second pass of split-F: fixed-order sum over the splits, then the bias
template <typename T>
__global__ void geglu_split_reduce_kernel(const float* __restrict__ part,
                                          const T* __restrict__ b2, T* __restrict__ out,
                                          int M, int C, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * C;
  if (i >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * total + i];
  out[i] = vt::from_f32<T>(v + vt::to_f32(b2[i % C]));
}

template <typename T, int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, void* part, int M, int F, int splits, int per, cudaStream_t stream) {
  constexpr int BM = kAccElems / C;
  constexpr size_t bytes = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(geglu_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, splits);
  geglu_kernel<T, C><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out),
      static_cast<float*>(part), M, F, per);
  if (splits > 1) {
    const size_t total = (size_t)M * C;
    geglu_split_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<const T*>(b2), static_cast<T*>(out), M, C,
        splits);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
             void* out, void* part, int M, int C, int F, int splits, int per,
             cudaStream_t st) {
  switch (C) {
    case 320: return launch<T, 320>(x, w1, b1, w2, b2, out, part, M, F, splits, per, st);
    case 640: return launch<T, 640>(x, w1, b1, w2, b2, out, part, M, F, splits, per, st);
    case 1280: return launch<T, 1280>(x, w1, b1, w2, b2, out, part, M, F, splits, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C in {320, 640, 1280}; F a multiple of 2048 / (20480 / C) (32, 64, 128:
// the hidden chunk); `per` chunks per split; `part` is [splits, M, C]
// float32 scratch when splits > 1. Returns cudaGetLastError() after the
// launches.
extern "C" int vt_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, void* part, int M, int C, int F,
                           int splits, int per, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((C != 320 && C != 640 && C != 1280) || M <= 0 || F <= 0 || F % (2048 / (kAccElems / C)) ||
      splits <= 0 || per <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, out, part, M, C, F, splits, per, st)
                 : dispatch<float>(x, w1, b1, w2, b2, out, part, M, C, F, splits, per, st);
}
