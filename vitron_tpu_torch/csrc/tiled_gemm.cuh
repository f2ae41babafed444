// One shared-memory tiled GEMM for the video UNet's kernels (sm_90a).
//
//   out[M, Nc] = epilogue(A[M, K] @ B[K, *])       float32 sums, out in T
//
// Three ways to read A and B and to finish a tile, chosen at compile time:
// - kLinear: A is [M, K] row-major, B [K, Nc]; out = A @ B (+ bias).
// - kTconv: the temporal k=3 conv of temporal_conv.cu. A is never stored:
//   x is [B, F, N, C] (rows (b, f, n), C contiguous), K = 3C, and A's row
//   (b, f, n) at depth d * C + c reads x[b, f + d - 1, n, c], zero outside
//   [0, F). B is the tap weight [3, C, Co] seen as [3C, Co]; out = A @ B
//   (+ bias).
// - kGeglu: the first product of the GEGLU feed-forward (geglu_ff.cu). B is
//   W1 [K, 2 Fh]; a block owns hidden columns [h0, h0 + 64) and loads the
//   64 "a" columns h0.. and the 64 "g" columns Fh + h0.. as one 128-wide
//   tile, so each thread holds a and g of the same hidden index; out is
//   t [M, Fh] = (a + b1[h]) * gelu(g + b1[Fh + h]) rounded to T.
//
// Tiles: a block of 256 threads owns 128 x 128 outputs and walks K in steps
// of 16; each thread sums an 8 x 8 sub-tile (rows ty*4 + i and 64 + ty*4 + i,
// columns tx*4 + j and 64 + tx*4 + j) in registers, so each shared value it
// reads feeds 8 FMAs. The next step's A and B values are loaded into
// registers while the current one is multiplied (two shared buffers, one
// barrier a step), 16 bytes at a time. float32 inputs run this CUDA-core
// kernel (67 TFLOP/s of FMA at the data-sheet clock; TF32 would round the
// inputs, so it is not used); bfloat16 inputs run the tensor-core kernel
// further down. `launch` takes only shapes whose every 16-byte load is whole
// and aligned (K, Nc, ldb and kTconv's C multiples of 8, A, B and out
// 16-byte aligned) and refuses the rest, so neither kernel has a scalar path.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace vt_gemm {
namespace {  // internal linkage: each source that includes this has its own copy

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256;
enum Mode { kLinear = 0, kTconv = 1, kGeglu = 2 };

struct Shape {
  int M;       // rows of A and out
  int Nc;      // output columns (Co, Fh or N)
  int K;       // depth
  int ldb;     // row stride of B
  int frames;  // kTconv: F
  int pixels;  // kTconv: N (rows per frame)
  int C;       // kTconv: input channels (K = 3C)
  int k_split; // depth per blockIdx.z (split-K); K when not split
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ part, Shape s) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  // kGeglu: 64 hidden columns per block; else 128 output columns
  const int n0 = blockIdx.y * (MODE == kGeglu ? kBN / 2 : kBN);
  const int kb = blockIdx.z * s.k_split, ke = min(s.K, kb + s.k_split);

  // this thread's loads, two chunks of 4 values each of A and of B per step:
  // A rows ar (a warp takes 32 consecutive rows: conflict-free transposed
  // stores) at depths ak[i] .. ak[i] + 3; B depths bk[i], columns bn .. bn + 3
  const int ar = tid & 127;
  const int ak[2] = {(tid >> 7) * 4, 8 + (tid >> 7) * 4};
  const int am = m0 + ar;
  const bool a_row_ok = am < s.M;
  int a_frame = 0;
  if (MODE == kTconv && a_row_ok) a_frame = (am / s.pixels) % s.frames;
  const int bk[2] = {tid >> 5, 8 + (tid >> 5)};
  const int bn = (tid & 31) * 4;
  int b_col = n0 + bn;  // column of B (kGeglu: the a or g half)
  bool b_col_ok = b_col < s.Nc;
  if (MODE == kGeglu) {
    const int h = n0 + (bn & 63);
    b_col_ok = h < s.Nc;
    b_col = bn < 64 ? h : s.Nc + h;
  }

  // A value (am, k), or null where it reads zero (outside the matrix or the
  // frame range)
  auto a_ptr = [&](int k) -> const float* {
    if (!a_row_ok || k >= ke) return nullptr;
    if (MODE == kTconv) {
      const int d = k < s.C ? 0 : (k < 2 * s.C ? 1 : 2);
      const int f = a_frame + d - 1;
      if (f < 0 || f >= s.frames) return nullptr;
      return A + (size_t)(am + (d - 1) * s.pixels) * s.C + (k - d * s.C);
    }
    return A + (size_t)am * s.K + k;
  };
  auto load = [&](int k0, float (&ra)[2][4], float (&rb)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four depths are one aligned float4, all in or all out
      const float* p = a_ptr(k0 + ak[i]);
      const float4 va = p ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0, 0, 0, 0);
      ra[i][0] = va.x, ra[i][1] = va.y, ra[i][2] = va.z, ra[i][3] = va.w;
      // b_col_ok holds for all four columns or none: Nc is a multiple of 8
      const int k = k0 + bk[i];
      const bool ok = k < ke && b_col_ok;
      const float4 vb = ok ? __ldg(reinterpret_cast<const float4*>(B + (size_t)k * s.ldb + b_col))
                           : make_float4(0, 0, 0, 0);
      rb[i][0] = vb.x, rb[i][1] = vb.y, rb[i][2] = vb.z, rb[i][3] = vb.w;
    }
  };
  auto store = [&](int buf, const float (&ra)[2][4], const float (&rb)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) As[buf][ak[i] + j][ar] = ra[i][j];
      *reinterpret_cast<float4*>(&Bs[buf][bk[i]][bn]) =
          make_float4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
    }
  };

  float ra[2][4], rb[2][4];
  load(kb, ra, rb);
  store(0, ra, rb);
  __syncthreads();

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    const bool more = k0 + kBK < ke;
    if (more) load(k0 + kBK, ra, rb);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      buf ^= 1;
      store(buf, ra, rb);
      // the other buffer's readers finished before the previous barrier
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= s.M) continue;
    if (MODE == kGeglu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = n0 + tx * 4 + j;
        if (h >= s.Nc) continue;
        const float a = acc[i][j] + bias[h];
        const float g = acc[i][4 + j] + bias[s.Nc + h];
        out[(size_t)m * s.Nc + h] = a * gelu_erf(g);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (n >= s.Nc) continue;
        if (gridDim.z > 1) {  // a split-K partial: float32, no bias
          part[((size_t)blockIdx.z * s.M + m) * s.Nc + n] = acc[i][j];
          continue;
        }
        out[(size_t)m * s.Nc + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: the same tiles, modes and epilogues, but the
// block's eight warps (2 x 4) each multiply a 64 x 32 sub-tile with
// mma.sync m16n8k16 (bf16 in, float32 sums: the products are exact and the
// sums float32, as on the CUDA-core path, only in another order). Tiles are
// copied to shared memory with cp.async (16 bytes a thread, zero-filled
// outside the matrix and outside the frame range), two stages deep, and read
// into fragments with ldmatrix; rows are padded by 8 values so the eight
// rows of each ldmatrix land in distinct banks. kGeglu interleaves the B
// tile in 8-column groups (a h0.., g h0.., a h0+8.., ...), so one thread
// holds the a and g sums of the same hidden columns.

constexpr int kTK = 32;           // depth per stage
constexpr int kAP = kTK + 8;      // A row pitch in shared memory (values)
constexpr int kBP = kBN + 8;      // B row pitch

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_tc_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part, Shape s) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kAP];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kTK][kBP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * (MODE == kGeglu ? kBN / 2 : kBN);
  const int kb = blockIdx.z * s.k_split, ke = min(s.K, kb + s.k_split);

  // each thread copies two 8-value chunks of A and two of B per stage
  int a_row[2], a_kc[2], a_m[2], a_frame[2];
  bool a_ok[2];
  int b_k[2], b_n[2], b_col[2];
  bool b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * kThreads;
    a_row[i] = id >> 2;
    a_kc[i] = (id & 3) * 8;
    a_m[i] = m0 + a_row[i];
    a_ok[i] = a_m[i] < s.M;
    a_frame[i] = (MODE == kTconv && a_ok[i]) ? (a_m[i] / s.pixels) % s.frames : 0;
    b_k[i] = id >> 4;
    const int q = id & 15;
    b_n[i] = q * 8;
    if (MODE == kGeglu) {
      const int h = n0 + (q >> 1) * 8;
      b_ok[i] = h < s.Nc;
      b_col[i] = (q & 1) ? s.Nc + h : h;
    } else {
      b_col[i] = n0 + q * 8;
      b_ok[i] = b_col[i] < s.Nc;
    }
  }

  auto load_stage = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + a_kc[i];
      bool ok = a_ok[i] && k < ke;
      const __nv_bfloat16* src = A;
      if (MODE == kTconv) {
        const int d = k < s.C ? 0 : (k < 2 * s.C ? 1 : 2);
        const int f = a_frame[i] + d - 1;
        ok = ok && f >= 0 && f < s.frames;
        if (ok) src = A + (size_t)(a_m[i] + (d - 1) * s.pixels) * s.C + (k - d * s.C);
      } else if (ok) {
        src = A + (size_t)a_m[i] * s.K + k;
      }
      cp_async16(&As[st][a_row[i]][a_kc[i]], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + b_k[i];
      const bool ok = b_ok[i] && k < ke;
      cp_async16(&Bs[st][b_k[i]][b_n[i]], ok ? B + (size_t)k * s.ldb + b_col[i] : B, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nk = (ke - kb + kTK - 1) / kTK;
  load_stage(0, kb);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, kb + (kt + 1) * kTK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &As[st][wm + mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], &Bs[st][kk + (lane & 15)][wn + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();  // the stage just read is the next one written
  }

  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= s.M) continue;
      if (MODE == kGeglu) {
#pragma unroll
        for (int ni = 0; ni < 4; ni += 2) {
          const int h = n0 + wn / 2 + (ni >> 1) * 8 + tig * 2;
          if (h >= s.Nc) continue;
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float a = acc[mi][ni][half * 2 + j] + vt::to_f32(bias[h + j]);
            const float gt = acc[mi][ni + 1][half * 2 + j] + vt::to_f32(bias[s.Nc + h + j]);
            v[j] = a * gelu_erf(gt);
          }
          *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)m * s.Nc + h]) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn + ni * 8 + tig * 2;
          if (n >= s.Nc) continue;
          float v0 = acc[mi][ni][half * 2], v1 = acc[mi][ni][half * 2 + 1];
          if (gridDim.z > 1) {  // a split-K partial: float32, no bias
            float* p = part + ((size_t)blockIdx.z * s.M + m) * s.Nc + n;
            p[0] = v0;
            p[1] = v1;
            continue;
          }
          if (bias != nullptr) {
            v0 += vt::to_f32(bias[n]);
            v1 += vt::to_f32(bias[n + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)m * s.Nc + n]) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// second pass of split-K: the partial sums in a fixed order (no atomics:
// the same bits run to run), then the bias and the rounding to T
template <typename T>
__global__ void split_k_reduce_kernel(const float* __restrict__ part, const T* __restrict__ bias,
                                      T* __restrict__ out, int M, int Nc, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * Nc;
  if (i >= total) return;
  float v = bias != nullptr ? vt::to_f32(bias[i % Nc]) : 0.f;
  for (int z = 0; z < splits; ++z) v += part[z * total + i];
  out[i] = vt::from_f32<T>(v);
}

// Launch on `stream`; returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or pointer the kernels do not take.
// splits > 1 (kLinear and kTconv only) splits K into `splits` ranges of a
// multiple of 32 over blockIdx.z; `part` is then [splits, M, Nc] float32
// scratch and a second kernel adds the ranges.
template <typename T, int MODE>
int launch(const void* A, const void* B, const void* bias, void* out, Shape s,
           cudaStream_t stream, void* part = nullptr, int splits = 1) {
  if (s.M <= 0 || s.Nc <= 0 || s.K <= 0 || s.Nc % 8 || s.K % 8 || s.ldb % 8 ||
      (MODE == kTconv && s.C % 8) || !aligned16(A) || !aligned16(B) || !aligned16(out) ||
      splits < 1 || splits > 64 || (splits > 1 && (MODE == kGeglu || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int cols = MODE == kGeglu ? kBN / 2 : kBN;
  const long long row_tiles = (s.M + kBM - 1) / kBM;
  const int col_tiles = (s.Nc + cols - 1) / cols;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  s.k_split = (((s.K + splits - 1) / splits + kTK - 1) / kTK) * kTK;
  splits = (s.K + s.k_split - 1) / s.k_split;
  dim3 grid((unsigned)row_tiles, (unsigned)col_tiles, (unsigned)splits);
  float* p = static_cast<float*>(part);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    gemm_bf16_tc_kernel<MODE><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), p, s);
  } else {
    static_assert(std::is_same_v<T, float>, "float32 or bfloat16");
    gemm_f32_kernel<MODE><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(bias), static_cast<float*>(out), p, s);
  }
  if (splits > 1) {
    const size_t total = (size_t)s.M * s.Nc;
    split_k_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        p, static_cast<const T*>(bias), static_cast<T*>(out), s.M, s.Nc, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vt_gemm
