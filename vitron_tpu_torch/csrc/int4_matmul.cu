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
// Four kernels, chosen by M and the type of x:
//
// - Decode (M <= 8) with bf16 x, the GEMV. It streams every packed weight
//   byte once per token (about 3.4 GB at Vicuna-7B with the int4 head), so
//   it is bound by device-memory bandwidth -- and, at 3.35 TB/s, by the
//   unpack, which must run at ~1.6 warp instructions a cycle on every SM. So
//   the products go to the tensor cores (the weights are the A tile of
//   mma.sync, x^T the B tile) and a byte of two nibbles costs ~3.5 integer
//   instructions (nib_bf16x2, below); each lane keeps 4 k16 steps of 16-byte
//   loads in flight. Decode shapes have too few 128-column strips to fill
//   132 SMs, so the rows are split over blocks (split-K); the last block of
//   a strip to finish (a ticket counter; no atomics on the sums) adds the
//   partial sums in a fixed order: identical bits run to run, and no second
//   launch.
//
// - Decode with float32 x (the CPU-vs-card checks): the same split GEMV on
//   the CUDA cores, 16 packed bytes a lane, the next 4 rows' loads in flight.
//   A nibble becomes a float without the quarter-rate int->float convert:
//   XOR 8 biases it to [0, 15], a byte permute drops it into the mantissa of
//   2^23, and subtracting 2^23 + 8 gives the exact value (`nib`).
//
// - Prefill and training with bf16 x (M > 8): a tensor-core GEMM, bound by
//   operations (2 M K N FLOP against M K bf16 + K N / 2 packed bytes). The
//   block's eight warps (2 x 4) multiply with mma.sync m16n8k16 (bf16 in,
//   float32 sums: every int4 value is exact in bf16 and every product
//   bf16 x int4 is exact, so only the order of the float32 sums differs from
//   the Pallas kernel). x and the packed tile arrive by cp.async in a ring of
//   four 64-deep stages (the packed tile at a quarter of the bf16 bytes) and
//   x reaches its fragments through ldmatrix. The nibbles go straight into B
//   fragments, with no unpacked tile: a B fragment gives a thread K rows 2t,
//   2t+1 (b0) and 2t+8, 2t+9 (b1) of one column, which are the low and high
//   nibble of packed rows t and t+4 of the k16 step, so one byte becomes one
//   fragment register -- exponent of 128 OR-ed over the biased nibble in
//   each bf16 half, then one bf16x2 FMA subtracts 136, exactly. Fragment
//   column g of the warp's n8 tile j is the block column wn + 4g + j, so a
//   thread's four tiles are one 32-bit word of packed row t (conflict-free
//   with a 160-byte row pitch), and in the epilogue each thread owns 8
//   consecutive columns of a row (one 16-byte store). 128-row tiles where
//   they give 264 blocks or more (two per SM), else 64-row tiles (chat
//   prefill at M 384). Ragged K and N are masked inside the kernel: 4-byte
//   cp.async copies, zero-filled outside the matrix, where a row is not
//   16-byte aligned.
//
// - float32 x (M > 8): a shared-memory tiled GEMM with float32 FMAs (the
//   tensor cores would round x to TF32). It serves the float32 CPU-vs-card
//   checks; every model path runs bf16.
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using vt_gemm::cp_async16;
using vt_gemm::cp_async_commit;
using vt_gemm::cp_async_wait;
using vt_gemm::ldmatrix_x4;
using vt_gemm::mma_bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ----------------------------------------------------------------- GEMV

constexpr int kGemvCols = 512;  // 32 lanes x 16 columns (16 packed bytes)

// (0x4B000000 | biased nibble) as a float is 2^23 + biased: minus 2^23 + 8 is
// the nibble's exact value
__device__ __forceinline__ float nib(uint32_t magic) {
  return __uint_as_float(magic) - 8388616.0f;  // 2^23 + 8
}

// one packed word (4 columns) -> lo[j] (K row 2r) and hi[j] (K row 2r+1)
__device__ __forceinline__ void unpack_word(uint32_t w, float* lo, float* hi) {
  const uint32_t L = (w & 0x0F0F0F0Fu) ^ 0x08080808u;  // biased, [0, 15]
  const uint32_t H = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = nib(__byte_perm(L, 0x4B000000u, 0x7540 | j));
    hi[j] = nib(__byte_perm(H, 0x4B000000u, 0x7540 | j));
  }
}

template <typename T, int MR>
__device__ __forceinline__ void gemv_row(float (&acc)[MR][16], const uint4& w,
                                         const T* __restrict__ x, int r, int K) {
  float lo[16], hi[16];
  unpack_word(w.x, lo, hi);
  unpack_word(w.y, lo + 4, hi + 4);
  unpack_word(w.z, lo + 8, hi + 8);
  unpack_word(w.w, lo + 12, hi + 12);
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float xe = vt::to_f32(x[(size_t)m * K + 2 * r]);
    const float xo = vt::to_f32(x[(size_t)m * K + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xo, hi[j], fmaf(xe, lo[j], acc[m][j]));
  }
}

// The split-K ending of both GEMVs: this block (column strip blockIdx.x,
// split blockIdx.y) has written its partial sums of rows [0, M) x columns
// [c0, c0 + cols) to part[split]; it takes a ticket, and the strip's last
// block adds the splits in a fixed order (the same bits whichever block is
// last), scales, stores y and returns the ticket to 0 for the next launch.
template <typename T>
__device__ void finish_splits(const float* __restrict__ part, const float* __restrict__ s,
                              T* __restrict__ y, unsigned* __restrict__ ticket, int M, int N,
                              int c0, int cols) {
  __shared__ bool last;
  __threadfence();  // this block's partial sums are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < M * cols; o += blockDim.x) {
    const int m = o / cols, n = c0 + o % cols;
    if (n >= N) continue;
    float v = 0.f;  // the loads in flight together, the sum in split order
#pragma unroll 8
    for (int sp = 0; sp < (int)gridDim.y; ++sp) v += __ldcg(part + ((size_t)sp * M + m) * N + n);
    y[(size_t)m * N + n] = vt::from_f32<T>(v * s[n]);
  }
  if (threadIdx.x == 0) ticket[blockIdx.x] = 0u;
}

// grid (ceil(N / 512), splits); each warp walks every 8th packed row of the
// block's row range for 512 columns, U rows at a time, with the next U rows'
// loads in flight while it unpacks and sums the current ones; the 8 warps'
// sums meet in shared memory. VEC: N % 16 == 0 and q4 16-byte aligned (one
// 16-byte load a lane), else four 4-byte loads, each word in or out of the
// matrix (N % 4 == 0). With splits, the blocks of a strip meet in
// finish_splits. float32 x only: bf16 x takes int4_gemv_tc_kernel.
template <typename T, int MR, bool VEC>
__global__ void __launch_bounds__(kThreads, MR <= 2 ? 2 : 1)
int4_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q4,
                 const float* __restrict__ s, T* __restrict__ y, float* __restrict__ part,
                 unsigned* __restrict__ ticket, int K2, int N, int rows_per_split) {
  constexpr int U = 4;  // rows a warp per step
  __shared__ __align__(16) float red[kWarps][kGemvCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kGemvCols + lane * 16;
  const int split = blockIdx.y;
  const int r_end = min(K2, (split + 1) * rows_per_split);
  const int K = 2 * K2;
  const int words = min(4, (N - col) / 4);  // this lane's words inside N

  float acc[MR][16];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  if (words > 0) {
    auto load = [&](int r) -> uint4 {
      const int8_t* p = q4 + (size_t)r * N + col;
      if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
      uint4 w = make_uint4(0u, 0u, 0u, 0u);  // zero nibbles outside N add nothing
      w.x = __ldg(pw);
      if (words > 1) w.y = __ldg(pw + 1);
      if (words > 2) w.z = __ldg(pw + 2);
      if (words > 3) w.w = __ldg(pw + 3);
      return w;
    };
    auto fetch = [&](uint4 (&w)[U], int r) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        w[u] = r + u * kWarps < r_end ? load(r + u * kWarps) : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 cur[U], nxt[U];
    int r = split * rows_per_split + warp;
    fetch(cur, r);
    for (; r < r_end; r += U * kWarps) {
      fetch(nxt, r + U * kWarps);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * kWarps < r_end) gemv_row<T, MR>(acc, cur[u], x, r + u * kWarps, K);
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }

  const bool split_k = gridDim.y > 1;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float4* dst = reinterpret_cast<float4*>(&red[warp][lane * 16]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
    __syncthreads();
    for (int c = threadIdx.x; c < kGemvCols; c += kThreads) {
      const int n = blockIdx.x * kGemvCols + c;
      if (n >= N) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][c];
      if (split_k) {
        part[((size_t)split * MR + m) * N + n] = v;
      } else {
        y[(size_t)m * N + n] = vt::from_f32<T>(v * s[n]);
      }
    }
    __syncthreads();  // red is rewritten for the next row of x
  }
  if (split_k) finish_splits(part, s, y, ticket, MR, N, blockIdx.x * kGemvCols, kGemvCols);
}

// ------------------------------------------------- bf16 tensor-core GEMM

constexpr int kTK = 64;           // K per stage
constexpr int kTK2 = kTK / 2;     // packed rows per stage
constexpr int kStages = 4;
constexpr int kTN = 128;          // columns per block
constexpr int kAP = kTK + 8;      // x row pitch in shared memory (values): ldmatrix rows in distinct banks
constexpr int kBP = kTN + 32;     // packed row pitch (bytes): lane (g, t) reads word g of row t, bank 8t + g
constexpr int kMinTcBlocks = 264; // two blocks per SM: below that, 64-row tiles

template <int BM>
struct TcTile {
  static constexpr int a_bytes = BM * kAP * 2;
  static constexpr int b_bytes = kTK2 * kBP;
  static constexpr int stage = a_bytes + b_bytes;
  static constexpr int smem = stage * kStages;
};

// 4-byte cp.async; `full` false copies nothing and zero-fills the 4 bytes
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 4 : 0));
}

// byte j of a packed word (x = word ^ 0x88888888: biased nibbles; xh = x >> 4)
// -> one B fragment register: bf16 {lo nibble, hi nibble} = {K row 2r, 2r+1},
// exact: 0x4300 | b is the bf16 of 128 + b, and 128 + b - 136 = b - 8
__device__ __forceinline__ unsigned nib_bf16x2(uint32_t x, uint32_t xh, int j) {
  uint32_t r = __byte_perm(x, xh, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
  r = (r & 0x000F000Fu) | 0x43004300u;
  unsigned out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return out;
}

// grid (ceil(M / BM), ceil(N / 128)); warps 2 (rows) x 4 (columns), each a
// (BM / 2) x 32 tile. x_vec: K % 8 == 0 and x 16-byte aligned; q_vec: N % 16
// == 0 and q4 16-byte aligned (else 4-byte copies).
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
int4_gemm_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
                    const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int K2,
                    int N, int x_vec, int q_vec) {
  constexpr int MI = BM / 32;  // m16 tiles a warp
  using Tile = TcTile<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTN;
  const int K = 2 * K2;
  const int nk = (K2 + kTK2 - 1) / kTK2;

  auto load_stage = [&](int st, int kt) {
    if (kt < nk) {
      __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + st * Tile::stage);
      const int k0 = kt * kTK;
#pragma unroll
      for (int i = 0; i < BM * (kTK / 8) / kThreads; ++i) {
        const int id = tid + i * kThreads;
        const int row = id / (kTK / 8), kc = (id % (kTK / 8)) * 8;
        const int gm = m0 + row, gk = k0 + kc;
        __nv_bfloat16* dst = As + row * kAP + kc;
        const __nv_bfloat16* src = x + (size_t)gm * K + gk;
        if (x_vec) {
          const bool ok = gm < M && gk < K;  // K % 8 == 0: the 8 values are all in or out
          cp_async16(dst, ok ? src : x, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const bool ok = gm < M && gk + e < K;  // K is even: a pair is all in or out
            cp_async4(dst + e, ok ? src + e : x, ok);
          }
        }
      }
      unsigned char* Bs = smem + st * Tile::stage + Tile::a_bytes;
      const int row = tid >> 3, cc = (tid & 7) * 16;  // 32 packed rows x 8 chunks
      const int gr = kt * kTK2 + row, gc = n0 + cc;
      unsigned char* dst = Bs + row * kBP + cc;
      const int8_t* src = q4 + (size_t)gr * N + gc;
      if (q_vec) {
        const bool ok = gr < K2 && gc < N;
        cp_async16(dst, ok ? src : q4, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const bool ok = gr < K2 && gc + e < N;  // N % 4 == 0
          cp_async4(dst + e, ok ? src + e : q4, ok);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups
  };

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_stage(st, st);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 is read by none
    load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    const int st = kt % kStages;
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem + st * Tile::stage);
    const unsigned char* Bs = smem + st * Tile::stage + Tile::a_bytes + wn + 4 * g;
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      unsigned af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], As + (wm + mi * 16 + (lane & 15)) * kAP + kk * 16 + (lane >> 4) * 8);
      const uint32_t x0 = *reinterpret_cast<const uint32_t*>(Bs + (kk * 8 + t) * kBP) ^ 0x88888888u;
      const uint32_t x1 =
          *reinterpret_cast<const uint32_t*>(Bs + (kk * 8 + t + 4) * kBP) ^ 0x88888888u;
      const uint32_t h0 = x0 >> 4, h1 = x1 >> 4;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const unsigned b0 = nib_bf16x2(x0, h0, ni), b1 = nib_bf16x2(x1, h1, ni);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // this thread's columns: nb + e, e in [0, 8): tile e % 4, register e / 4
  const int nb = n0 + wn + 8 * t;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = nb + e < N ? s[nb + e] : 0.f;
  const bool whole = (N % 8) == 0 && nb + 8 <= N;  // y rows 16-byte aligned
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = acc[mi][e & 3][2 * half + (e >> 2)] * sc[e];
      __nv_bfloat16* dst = y + (size_t)m * N + nb;
      if (whole) {
        uint4 o;
        o.x = vt_gemm::pack_bf16(v[0], v[1]);
        o.y = vt_gemm::pack_bf16(v[2], v[3]);
        o.z = vt_gemm::pack_bf16(v[4], v[5]);
        o.w = vt_gemm::pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(dst) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (nb + e < N) dst[e] = __float2bfloat16(v[e]);
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BM>
int launch_tc(const __nv_bfloat16* x, const int8_t* q4, const float* s, __nv_bfloat16* y,
              int M, int K2, int N, cudaStream_t stream) {
  static bool attr_set = false;  // per instantiation: the smem limit is a property of the kernel
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_gemm_tc_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, TcTile<BM>::smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long row_tiles = (M + BM - 1) / BM;
  const int col_tiles = (N + kTN - 1) / kTN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int x_vec = (2 * K2) % 8 == 0 && aligned16(x);
  const int q_vec = N % 16 == 0 && aligned16(q4);
  dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  int4_gemm_tc_kernel<BM><<<grid, kThreads, TcTile<BM>::smem, stream>>>(x, q4, s, y, M, K2, N,
                                                                      x_vec, q_vec);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16 tensor-core GEMV

constexpr int kMvCols = 128;  // columns a block (a column strip)
constexpr int kMvU = 4;       // k16 steps a warp has in flight

// grid (ceil(N / 128), splits), M <= 8, bf16 x. The weights are the A tile
// of mma.m16n8k16 and x^T the B tile (n = the row of x; rows M.. are zero),
// so one mma takes 16 columns x 16 rows of K and the products go to the
// tensor cores; the unpack is a byte permute, a LOP3 and a bf16x2 FMA for
// two nibbles (nib_bf16x2), against a permute, an FADD and an FMA for each
// nibble on the CUDA cores. Lane (g, t) loads 16 packed bytes -- columns
// c0 + 16g .. c0 + 16g + 15 -- of rows t and t + 4 of each k16 step (8
// lanes read 128 contiguous bytes of a row): the A fragments of 8 tiles,
// tile i taking its row g as column 16g + 2i and its row g + 8 as column
// 16g + 2i + 1 (byte 2i and 2i + 1 of the lane's 16). Warp w takes k16
// steps w, w + 8, .. of the block's split, kMvU steps of loads at a time;
// the warps' sums meet in shared memory and the splits in finish_splits.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
int4_gemv_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
                    const float* __restrict__ s, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ part, unsigned* __restrict__ ticket, int M, int K2,
                    int N, int steps_per_split) {
  __shared__ __align__(16) float red[kWarps][8][kMvCols + 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kMvCols;
  const int col = c0 + 16 * g;
  const int words = min(4, (N - col) / 4);  // this lane's words inside N
  const int K = 2 * K2;
  const int steps = (K2 + 7) / 8;
  const int s_beg = blockIdx.y * steps_per_split;
  const int s_end = min(steps, s_beg + steps_per_split);

  auto load = [&](int r) -> uint4 {  // packed row r at this lane's columns, 0 outside
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r >= K2 || words <= 0) return w;
    const int8_t* p = q4 + (size_t)r * N + col;
    if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
    w.x = __ldg(pw);
    if (words > 1) w.y = __ldg(pw + 1);
    if (words > 2) w.z = __ldg(pw + 2);
    if (words > 3) w.w = __ldg(pw + 3);
    return w;
  };
  auto xpair = [&](int k) -> unsigned {  // bf16 x[g, k], x[g, k + 1]; K is even
    if (g >= M || k >= K) return 0u;
    return __ldg(reinterpret_cast<const unsigned*>(x + (size_t)g * K + k));
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

  for (int st = s_beg + warp; st < s_end; st += kMvU * kWarps) {
    uint4 lo[kMvU], hi[kMvU];
    unsigned b0[kMvU], b1[kMvU];
#pragma unroll
    for (int u = 0; u < kMvU; ++u) {
      const int step = st + u * kWarps;
      const bool in = step < s_end;
      lo[u] = in ? load(8 * step + t) : make_uint4(0u, 0u, 0u, 0u);
      hi[u] = in ? load(8 * step + t + 4) : make_uint4(0u, 0u, 0u, 0u);
      b0[u] = in ? xpair(16 * step + 2 * t) : 0u;
      b1[u] = in ? xpair(16 * step + 2 * t + 8) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kMvU; ++u) {
      const uint32_t w0[4] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w};
      const uint32_t w1[4] = {hi[u].x, hi[u].y, hi[u].z, hi[u].w};
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        const uint32_t x0 = w0[wd] ^ 0x88888888u, x1 = w1[wd] ^ 0x88888888u;
        const uint32_t h0 = x0 >> 4, h1 = x1 >> 4;
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // tile 2 wd + p: bytes 2p (row g) and 2p + 1 (row g + 8)
          const unsigned a[4] = {nib_bf16x2(x0, h0, 2 * p), nib_bf16x2(x0, h0, 2 * p + 1),
                                 nib_bf16x2(x1, h1, 2 * p), nib_bf16x2(x1, h1, 2 * p + 1)};
          mma_bf16(acc[2 * wd + p], a, b0[u], b1[u]);
        }
      }
    }
  }

  // tile i: c0, c1 are x rows 2t, 2t + 1 at column 16g + 2i; c2, c3 at 16g + 2i + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 2 * t + h;
    if (m < M) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(&red[warp][m][16 * g + 2 * i]) =
            make_float2(acc[i][h], acc[i][2 + h]);
    }
  }
  __syncthreads();
  const bool split_k = gridDim.y > 1;
  for (int o = threadIdx.x; o < M * kMvCols; o += kThreads) {
    const int m = o / kMvCols, c = o % kMvCols, n = c0 + c;
    if (n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][m][c];
    if (split_k) {
      part[((size_t)blockIdx.y * M + m) * N + n] = v;
    } else {
      y[(size_t)m * N + n] = __float2bfloat16(v * s[n]);
    }
  }
  if (split_k) finish_splits(part, s, y, ticket, M, N, c0, kMvCols);
}

int launch_gemv_tc(const __nv_bfloat16* x, const int8_t* q4, const float* s, __nv_bfloat16* y,
                   float* part, unsigned* ticket, int M, int K2, int N, int splits,
                   cudaStream_t stream) {
  const int steps = (K2 + 7) / 8;
  const int per_split = (steps + splits - 1) / splits;
  const dim3 grid((N + kMvCols - 1) / kMvCols, (steps + per_split - 1) / per_split);  // none empty
  if (N % 16 == 0 && aligned16(q4)) {
    int4_gemv_tc_kernel<true><<<grid, kThreads, 0, stream>>>(x, q4, s, y, part, ticket, M, K2,
                                                             N, per_split);
  } else {
    int4_gemv_tc_kernel<false><<<grid, kThreads, 0, stream>>>(x, q4, s, y, part, ticket, M, K2,
                                                              N, per_split);
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------- float32 FMA GEMM

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
      float lo[4], hi[4];
      unpack_word(w, lo, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ws[2 * rr][cw * 4 + j] = lo[j];
        ws[2 * rr + 1][cw * 4 + j] = hi[j];
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
int launch_gemv(const T* x, const int8_t* q4, const float* s, T* y, float* part,
                unsigned* ticket, int K2, int N, int splits, cudaStream_t stream) {
  const int rows_per_split = (K2 + splits - 1) / splits;
  const dim3 grid((N + kGemvCols - 1) / kGemvCols, (K2 + rows_per_split - 1) / rows_per_split);
  if (N % 16 == 0 && aligned16(q4)) {
    int4_gemv_kernel<T, MR, true><<<grid, kThreads, 0, stream>>>(x, q4, s, y, part, ticket, K2,
                                                                 N, rows_per_split);
  } else {
    int4_gemv_kernel<T, MR, false><<<grid, kThreads, 0, stream>>>(x, q4, s, y, part, ticket, K2,
                                                                  N, rows_per_split);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x_, const void* q4_, const void* s_, void* y_, void* part_, void* ticket_,
        int M, int K2, int N, int splits, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const int8_t* q4 = static_cast<const int8_t*>(q4_);
  const float* s = static_cast<const float*>(s_);
  T* y = static_cast<T*>(y_);
  float* part = static_cast<float*>(part_);
  unsigned* ticket = static_cast<unsigned*>(ticket_);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (M <= 8) return launch_gemv_tc(x, q4, s, y, part, ticket, M, K2, N, splits, stream);
    const long long big_blocks = (long long)((M + 127) / 128) * ((N + kTN - 1) / kTN);
    return big_blocks >= kMinTcBlocks ? launch_tc<128>(x, q4, s, y, M, K2, N, stream)
                                      : launch_tc<64>(x, q4, s, y, M, K2, N, stream);
  } else {
    static_assert(std::is_same_v<T, float>, "float32 or bfloat16");
    switch (M) {
#define VT_GEMV_CASE(R) \
  case R:               \
    return launch_gemv<T, R>(x, q4, s, y, part, ticket, K2, N, splits, stream);
      VT_GEMV_CASE(1) VT_GEMV_CASE(2) VT_GEMV_CASE(3) VT_GEMV_CASE(4)
      VT_GEMV_CASE(5) VT_GEMV_CASE(6) VT_GEMV_CASE(7) VT_GEMV_CASE(8)
#undef VT_GEMV_CASE
      default:
        break;
    }
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    int4_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(x, q4, s, y, M, K2, N);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// M <= 8 takes the split-K GEMV (when splits > 1, `part` is [splits, M, N]
// float32 scratch and `ticket` one unsigned counter a column strip, 0 and
// left 0); larger M the tensor-core GEMM for bf16 x and the FMA GEMM for
// float32 x. N must be a multiple of 4 and q4 4-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_int4_matmul(const void* x, const void* q4, const void* s, void* y,
                              void* part, void* ticket, int M, int K2, int N, int splits,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run<__nv_bfloat16>(x, q4, s, y, part, ticket, M, K2, N, splits, st);
  return run<float>(x, q4, s, y, part, ticket, M, K2, N, splits, st);
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
