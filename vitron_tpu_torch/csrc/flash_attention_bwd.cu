// Flash-attention backward for Hopper (sm_90a): B5a (dK, dV) and B5b (dQ).
//
// Replaces the Pallas TPU kernels of
// vitron_tpu/kernels/flash_attention.py::_flash_backward (:379):
// _flash_bwd_kv_kernel (:302, pallas_call at :429) and _flash_bwd_q_kernel
// (:343, pallas_call at :450), with _bwd_common (:268) recomputing the
// probabilities from the forward's saved log-sum-exp.
//
// Semantics, in key-slot space (JAX layout: q, dout [B,S,N,D]; k, v
// [B,T,KH,D]; lse, delta [B,N,S] float32, delta = rowsum(dout * out)):
//   visible(i, j) = (!causal || q_offset + i >= j) && kv_mask[b,j] && j < T
//   p[i,j]  = visible ? exp(round(q[i] * scale) . k[j] - lse[i]) : 0
//   ds[i,j] = p[i,j] * (dout[i] . v[j] - delta[i])
//   dV[j] = sum_i round(p) dout[i]      dK[j] = scale sum_i round(ds) q[i]
//   dQ[i] = scale sum_j round(ds) k[j]
// where round() is to the input type (bf16 or float32), as the TPU kernel
// rounds q * scale (_scaled_q :85-89) and casts p and ds before its products
// (:330-335, :370-372); ds takes the unrounded float32 p, and dK the
// unscaled q. Sums run in float32. A query row that sees no valid key has
// p = 0 everywhere (from the visibility test, never from exp of its
// -FLT_MAX LSE) and gets zero gradients.
//
// The TPU grid runs in order and carries dK/dV (or dQ) in scratch from one
// grid step to the next; here the sequential axis is a loop inside the
// block and the sums stay in registers. JAX's split into two kernels stays:
// B5b recomputes the scores and dP that B5a computes, seven products where
// FlashAttention-2's fused backward takes five, but the fused form adds dQ
// across key blocks with atomics, and two runs must give the same bits. No
// atomics here: every sum runs in one fixed order. GQA dK/dV are reduced
// inside B5a's block over the group's query heads (JAX's :465-469), in
// float32, and written once in [B,T,KH,D]. Tiles wholly in the causal
// future are skipped (:320, :360).
//
// bfloat16 (the trainer's type: every main path) runs on the tensor cores,
// mma.sync m16n8k16 with bf16 fragments and float32 sums (mma_sync.cuh):
// - B5b, dQ, has the forward's shape: a block owns 64 query rows of one
//   (b, head), 16 a warp; it copies its Q and dout rows once (cp.async),
//   and each warp keeps round(q * scale) and dout as A fragments in
//   registers for the whole key loop. K and V tiles of 64 keys come through
//   a 2-stage cp.async ring, with each tile's slot bytes. Per tile:
//   S = Qs K^T and dP = dO V^T from ldmatrix'ed K and V fragments; p and
//   ds on the C fragments in registers; round(ds) packed into A fragments
//   (two m16n8 C tiles are one m16n8k16 A operand); dQ += dS K with K
//   fragments from ldmatrix.trans.
// - B5a, dK and dV, takes the transposed products, so that no fragment
//   passes through shared memory: a block owns 128 keys of one (b, KV
//   head), 16 a warp, the keys the M dimension: S^T = K Qs^T and
//   dP^T = V dO^T; the C fragments of round(p^T) and round(ds^T) are then
//   the A fragments of dV += P^T dO and dK += dS^T Q (dO and Q fragments
//   from ldmatrix.trans). lse and delta are indexed by column. The block
//   walks the visible query tiles (64 rows) of every query head of its
//   GQA group as one sequence, so the 2-stage cp.async ring of round(q *
//   scale), q, dout, lse and delta never drains between heads. round(q *
//   scale) is a copy made once before the main kernel, by a small kernel
//   in the same launch, as _scaled_q rounds it: rounding it per tile would
//   cost a shared-memory pass and a barrier a tile. K and V stay in shared
//   memory and their A fragments are re-read each tile (16 ldmatrix a warp
//   against 128 for the tile's B operands): in registers they would take
//   64 more a thread at D 128, beside the 128 of the dK/dV sums and the 64
//   of S^T and dP^T. A block whose keys are all masked or past T writes
//   zeros and loads nothing; a warp whose keys are all masked computes
//   nothing.
// - Head dims 40, 80 and 160 (the SD UNet's 8 heads at 320, 640 and 1280
//   channels, the diffusion trainers' sites) take the same two kernels.
//   D 40 is not a multiple of mma's k of 16: every tile is zero-filled from
//   depth 40 to 48 (load_rows), as B2 does, so the padded columns add
//   nothing to S or dP, their dQ, dK and dV sums stay zero and are never
//   written, and the round(q * scale) scratch keeps the unpadded
//   [B,S,N,D] layout. At D 160, B5b reads the round(q * scale) and dout
//   fragments from shared memory each tile (Q rounded in place once)
//   instead of holding 80 more registers, and B5a gives each 16 keys two
//   warps, each summing dK and dV over 80 of the columns: both compute the
//   tile's S^T and dP^T, six products a tile where four would do, in
//   blocks of 64 keys.
// Rows are padded by 8 values (16 bytes) in shared memory, so the eight
// rows of each ldmatrix land in distinct banks. exp is one ex2 a logit,
// log2(e) folded into one FMA after the float32 product, the LSE scaled by
// log2(e) once a row.
// Schedules (registers and shared memory a block, on 227 KB and 64K
// registers an SM; `-Xptxas -v` for sm_90a shows no spills):
//   B5b: 4 warps, 64 rows, 64-key tiles; 54 KB (D 64) / 102 KB (D 128) of
//     shared memory, 215 / 253 registers a thread (round(q*scale) and dout
//     fragments, KS = D/16 x 4 registers each; the dQ sum, D/2; S and dP,
//     32 each): two blocks an SM;
//   B5a: 8 warps, 128 keys, 64-query tiles; 91 KB / 171 KB (K, V, and two
//     stages of round(q*scale), q and dout), 233 / 255 registers (the dK
//     and dV sums, D/2 each; S^T and dP^T, 32 each): one block an SM.
//   4-warp blocks, 32-row query tiles in B5a and 32-key tiles in B5b were
//   no faster at D 128 on the H100.
//   D 40 / 80 / 160 (rows of the depth padded to 16, plus 8): B5b 42 / 66 /
//   126 KB and 168 / 240 / 244 registers; B5a 71 / 111 / 169 KB and
//   207 / 243 / 243 registers (at D 160 in blocks of 64 keys).
// What bounds it on the H100: at the trainer's [2, 2048, 32, 128] (causal,
// right-padded: 1.31e8 visible pairs) the seven products are 2.34e11 FLOP,
// 0.24 ms on the bf16 tensor cores at 989 TFLOP/s (the five of a fused
// backward 0.17 ms); the bytes (q, k, v, dout, dq, dk, dv, lse, delta once)
// take 0.07 ms. So the tensor pipes bound it. mma.sync reaches them only
// through registers: each warp loads every B fragment it uses from shared
// memory (one 512-byte ldmatrix per two MMAs), and the registers these
// tiles need leave two warps a scheduler to hide the latency of that
// stream. Both kernels run at about the same rate per product as SDPA's
// backward does per product of its five; the split's two extra products
// are what is left between them. A deterministic fused backward and wgmma
// with TMA and warp specialisation (operands read by the tensor cores from
// shared memory, FlashAttention-3's shape) are the next steps.
//
// float32 inputs (no main path; the CPU-versus-card checks and the tests)
// keep the FMA schedule on the CUDA cores: the port holds float32 to 1e-4
// of the TPU kernel's exact float32, which TF32 or bf16 tensor cores would
// break. 256 threads as a 16 x 16 grid, each scoring a 4 x 4 block of the
// 64 x 64 tile (rows and columns strided by 16 so that the float32 tiles,
// padded by one word a row, are read without bank conflicts) and owning
// 4 x D/16 of the [64, D] accumulators; B5a a block per 64 keys, B5b per 64
// query rows. Shared memory: 198 KB at D = 128 for B5a (K, V,
// round(q*scale), q, dout, p, ds), 149 KB for B5b; one block an SM.
#include <algorithm>
#include <cfloat>
#include <cmath>

#include "common.cuh"
#include "flash_tile.cuh"
#include "mma_sync.cuh"

namespace {

// ------------------------------------------------------------ float32, FMA


constexpr int kThreads = 256;
constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int PP = BK + 1;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return vt::to_f32(vt::from_f32<T>(x));
}

__device__ __forceinline__ bool visible(int i, int t, int S, int Tk, const uint8_t* mask_b,
                                        int q_offset, int causal) {
  return i < S && t < Tk && (mask_b == nullptr || mask_b[t] != 0) &&
         (!causal || q_offset + i >= t);
}

// Loads rows [r0, r0 + R) of a [B, rows, H, D] tensor at head h into a
// float32 [R][D + 1] tile, zeros past `rows`; with `scaled`, also writes
// round(x * scale) into `xs`.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, float* xt, float* xs,
                                          float scale, int b, int r0, int rows, int H, int h) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    const float v = row < rows ? vt::to_f32(x[(((size_t)b * rows + row) * H + h) * D + d]) : 0.f;
    xt[r * DP + d] = v;
    if (xs != nullptr) xs[r * DP + d] = round_to<T>(v * scale);
  }
}

// sc = Qs Ks^T and dp = dOs Vs^T for this thread's 4 x 4 block of the
// [BQ, BK] tile: rows ty + 16 i, keys tx + 16 j.
template <int D>
__device__ __forceinline__ void score_tile(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, int ty, int tx, float (&sc)[4][4],
                                           float (&dp)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], o[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty + 16 * i) * DP + d];
      o[i] = dOs[(ty + 16 * i) * DP + d];
      kk[i] = Ks[(tx + 16 * i) * DP + d];
      vv[i] = Vs[(tx + 16 * i) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
        dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
      }
  }
}

template <int D>
constexpr size_t kv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)BK * (D + 1) + 3 * (size_t)BQ * (D + 1) +
                          2 * (size_t)BQ * PP + 2 * BQ);
}

template <int D>
constexpr size_t q_smem_bytes() {
  return sizeof(float) * (2 * (size_t)BK * (D + 1) + 2 * (size_t)BQ * (D + 1) +
                          (size_t)BQ * PP + 2 * BQ);
}

// B5a: dK, dV for the keys [kt * BK, kt * BK + BK) of KV head kvh.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
                    T* __restrict__ dk, T* __restrict__ dv, int S, int Tk, int N, int KH,
                    int q_offset, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][DP]
  float* Vs = Ks + BK * DP;    // [BK][DP]
  float* Qs = Vs + BK * DP;    // [BQ][DP] round(q * scale)
  float* Qr = Qs + BQ * DP;    // [BQ][DP] q
  float* dOs = Qr + BQ * DP;   // [BQ][DP]
  float* Ps = dOs + BQ * DP;   // [BQ][PP] round(p)
  float* dSs = Ps + BQ * PP;   // [BQ][PP] round(ds)
  float* lse_s = dSs + BQ * PP;  // [BQ]
  float* dlt_s = lse_s + BQ;     // [BQ]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int groups = N / KH;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = kt * BK;
  const uint8_t* mask_b = kv_mask != nullptr ? kv_mask + (size_t)b * Tk : nullptr;

  load_tile<T, D, BK>(k, Ks, nullptr, 0.f, b, t0, Tk, KH, kvh);
  load_tile<T, D, BK>(v, Vs, nullptr, 0.f, b, t0, Tk, KH, kvh);

  float acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // the first query tile holding a row that can see key t0
  const int iq0 = causal ? max(0, t0 - q_offset) / BQ : 0;
  const int nq = (S + BQ - 1) / BQ;
  for (int g = 0; g < groups; ++g) {
    const int n = kvh * groups + g;
    for (int iq = iq0; iq < nq; ++iq) {
      const int s0 = iq * BQ;
      __syncthreads();  // the previous tile's readers are done (and K, V are visible)
      load_tile<T, D, BQ>(q, Qr, Qs, scale, b, s0, S, N, n);
      load_tile<T, D, BQ>(dout, dOs, nullptr, 0.f, b, s0, S, N, n);
      if (tid < BQ) {
        const int sq = s0 + tid;
        const size_t o = ((size_t)b * N + n) * S + sq;
        lse_s[tid] = sq < S ? lse[o] : 0.f;
        dlt_s[tid] = sq < S ? delta[o] : 0.f;
      }
      __syncthreads();

      float sc[4][4], dp[4][4];
      score_tile<D>(Qs, dOs, Ks, Vs, ty, tx, sc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = visible(s0 + r, t0 + c, S, Tk, mask_b, q_offset, causal);
          const float p = ok ? expf(sc[i][j] - lse_s[r]) : 0.f;
          Ps[r * PP + c] = round_to<T>(p);
          dSs[r * PP + c] = round_to<T>(p * (dp[i][j] - dlt_s[r]));
        }
      }
      __syncthreads();

      // dV += round(p)^T dout, dK += round(ds)^T q over this tile's rows
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pk[4], sk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = Ps[r * PP + ty + 16 * i];
          sk[i] = dSs[r * PP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float o = dOs[r * DP + tx + 16 * j];
          const float x = Qr[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_dv[i][j] = fmaf(pk[i], o, acc_dv[i][j]);
            acc_dk[i][j] = fmaf(sk[i], x, acc_dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= Tk) continue;
    const size_t base = (((size_t)b * Tk + t) * KH + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = vt::from_f32<T>(acc_dk[i][j] * scale);
      dv[base + tx + 16 * j] = vt::from_f32<T>(acc_dv[i][j]);
    }
  }
}

// B5b: dQ for the query rows [iq * BQ, iq * BQ + BQ) of head n.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
                   T* __restrict__ dq, int S, int Tk, int N, int KH, int q_offset, float scale,
                   int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][DP]
  float* Qs = Vs + BK * DP;      // [BQ][DP] round(q * scale)
  float* dOs = Qs + BQ * DP;     // [BQ][DP]
  float* dSs = dOs + BQ * DP;    // [BQ][PP] round(ds)
  float* lse_s = dSs + BQ * PP;  // [BQ]
  float* dlt_s = lse_s + BQ;     // [BQ]

  const int iq = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (N / KH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s0 = iq * BQ;
  const uint8_t* mask_b = kv_mask != nullptr ? kv_mask + (size_t)b * Tk : nullptr;

  load_tile<T, D, BQ>(q, Qs, Qs, scale, b, s0, S, N, n);  // only round(q * scale) is kept
  load_tile<T, D, BQ>(dout, dOs, nullptr, 0.f, b, s0, S, N, n);
  if (tid < BQ) {
    const int sq = s0 + tid;
    const size_t o = ((size_t)b * N + n) * S + sq;
    lse_s[tid] = sq < S ? lse[o] : 0.f;
    dlt_s[tid] = sq < S ? delta[o] : 0.f;
  }

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) {
    const int last = q_offset + min(S, s0 + BQ) - 1;  // the tile's last query slot
    n_tiles = min(n_tiles, last / BK + 1);
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done (and Q, dout are visible)
    load_tile<T, D, BK>(k, Ks, nullptr, 0.f, b, t0, Tk, KH, kvh);
    load_tile<T, D, BK>(v, Vs, nullptr, 0.f, b, t0, Tk, KH, kvh);
    __syncthreads();

    float sc[4][4], dp[4][4];
    score_tile<D>(Qs, dOs, Ks, Vs, ty, tx, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(s0 + r, t0 + c, S, Tk, mask_b, q_offset, causal);
        const float p = ok ? expf(sc[i][j] - lse_s[r]) : 0.f;
        dSs[r * PP + c] = round_to<T>(p * (dp[i][j] - dlt_s[r]));
      }
    }
    __syncthreads();

    // dQ += round(ds) K over this tile's keys
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sk[i] = dSs[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float x = Ks[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sk[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sq = s0 + ty + 16 * i;
    if (sq >= S) continue;
    const size_t base = (((size_t)b * S + sq) * N + n) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + tx + 16 * j] = vt::from_f32<T>(acc[i][j] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *kv_mask;
  int B, S, Tk, N, KH, q_offset;
  float scale;
  int causal;
};

template <typename T, int D>
int launch_kv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  constexpr size_t bytes = kv_smem_bytes<D>();
  auto kernel = flash_bwd_kv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tk + BK - 1) / BK, a.KH, a.B);
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const uint8_t*>(a.kv_mask),
      static_cast<T*>(dk), static_cast<T*>(dv), a.S, a.Tk, a.N, a.KH, a.q_offset, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_q(const Args& a, void* dq, cudaStream_t st) {
  constexpr size_t bytes = q_smem_bytes<D>();
  auto kernel = flash_bwd_q_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, a.N, a.B);
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const uint8_t*>(a.kv_mask),
      static_cast<T*>(dq), a.S, a.Tk, a.N, a.KH, a.q_offset, a.scale, a.causal);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* kv_mask, int B, int S, int Tk, int N, int KH,
               int q_offset, float scale, int causal) {
  return Args{q, k, v, dout, lse, delta, kv_mask, B, S, Tk, N, KH, q_offset, scale, causal};
}

// ------------------------------------------------------ bfloat16, mma.sync

using vt_gemm::cp_async16;
using vt_gemm::cp_async_commit;
using vt_gemm::cp_async_wait;
using vt_gemm::ldmatrix_x4;
using vt_gemm::ldmatrix_x4_trans;
using vt_gemm::mma_bf16;
using vt_gemm::pack_bf16;
using vt_flash::ex2;
using vt_flash::kLog2e;
using vt_flash::load_rows;
using vt_flash::scaled_q;

struct MArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* qs;  // round(q * scale) (B5a), or null
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  const uint8_t* kv_mask;  // [B, T] or null
  __nv_bfloat16* dq;       // B5b
  __nv_bfloat16* dk;       // B5a
  __nv_bfloat16* dv;       // B5a
  int S, Tk, N, KH, q_offset;
  float scale;
  int causal;
};

// round(q * scale) of every q value, 8 a thread a step
__global__ void flash_bwd_kv_scaled_q_kernel(const uint4* __restrict__ q, uint4* __restrict__ qs,
                                             size_t n16, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n16;
       i += (size_t)gridDim.x * blockDim.x) {
    uint4 r = q[i];
    r.x = scaled_q(r.x, scale), r.y = scaled_q(r.y, scale);
    r.z = scaled_q(r.z, scale), r.w = scaled_q(r.w, scale);
    qs[i] = r;
  }
}

// The A fragment of an m16n8k16 product from a [16][P] shared tile (rows
// the M dimension, columns the depth, starting at column c0).
__device__ __forceinline__ void load_a(unsigned (&a)[4], const __nv_bfloat16* tile, int c0,
                                       int lane, int P) {
  ldmatrix_x4(a, tile + (lane & 15) * P + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (rows n0..n0+15 of a [n][depth] shared tile,
// depth columns c0..c0+15): {b0, b1} of the first, {b2, b3} of the second.
__device__ __forceinline__ void load_b(unsigned (&b)[4], const __nv_bfloat16* tile, int n0,
                                       int c0, int lane, int P) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles from a [depth][n] shared tile (depth rows
// k0..k0+15, columns n0..n0+15), transposed by ldmatrix.
__device__ __forceinline__ void load_b_trans(unsigned (&b)[4], const __nv_bfloat16* tile, int k0,
                                             int n0, int lane, int P) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * P + n0 + (lane >> 4) * 8);
}

// C fragments c[2j], c[2j+1] (16 x 16, float32) rounded to bf16 as the A
// fragment of the next product's k-step j
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

template <int D>
struct QTile {  // B5b: 16 query rows a warp, 64 keys a tile
  static constexpr int DP = (D + 15) / 16 * 16;  // depth padded to the MMA's k of 16
  static constexpr int P = DP + 8;               // shared row pitch (values)
  static constexpr int WARPS = 4, BQ = WARPS * 16, BK = 64, THREADS = WARPS * 32;
  // round(q * scale) and dout as A fragments in registers for the whole key
  // loop (D <= 128), or read from shared memory each tile (D 160, whose dQ
  // sum takes 80 registers a thread)
  static constexpr bool REG_FRAGS = D <= 128;
  // Q and dout, then K and V in two stages each, then two stages of slot bytes
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (2 * (size_t)BQ * P + 4 * (size_t)BK * P) + 2 * BK;
};

// B5b: dQ for 64 query rows of head blockIdx.y, the last tile first: in
// causal order it sees the most keys, and the blocks start in index order.
template <int D>
__global__ void __launch_bounds__(QTile<D>::THREADS)
flash_bwd_q_mma_kernel(const MArgs a) {
  using L = QTile<D>;
  constexpr int DP = L::DP, P = L::P, BQ = L::BQ, BK = L::BK, THREADS = L::THREADS;
  constexpr int KS = DP / 16;  // k-steps of S and dP
  constexpr int NT = BK / 8;   // n-tiles of S and dP
  constexpr int DT = DP / 8;   // n-tiles of dQ (those past D hold zeros and are not written)
  extern __shared__ __align__(16) unsigned char smem_q[];
  __nv_bfloat16* Qst = reinterpret_cast<__nv_bfloat16*>(smem_q);  // [BQ][P]
  __nv_bfloat16* Ost = Qst + BQ * P;                               // [BQ][P]
  __nv_bfloat16* Ks = Ost + BQ * P;                                // [2][BK][P]
  __nv_bfloat16* Vs = Ks + 2 * BK * P;                             // [2][BK][P]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + 2 * BK * P);       // [2][BK] slot ok

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (a.N / a.KH);
  const int s0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int w0 = s0 + warp * 16;  // the warp's first query row
  const uint8_t* mask_b = a.kv_mask != nullptr ? a.kv_mask + (size_t)b * a.Tk : nullptr;

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (a.q_offset + min(a.S, s0 + BQ) - 1) / BK + 1);

  load_rows<BQ, D, DP, P, THREADS>(Qst, a.q, b, s0, a.S, a.N, n, tid);
  load_rows<BQ, D, DP, P, THREADS>(Ost, a.dout, b, s0, a.S, a.N, n, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<BK, D, DP, P, THREADS>(Ks, a.k, b, 0, a.Tk, a.KH, kvh, tid);
    load_rows<BK, D, DP, P, THREADS>(Vs, a.v, b, 0, a.Tk, a.KH, kvh, tid);
    if (tid < BK) Ms[tid] = tid < a.Tk && (mask_b == nullptr || mask_b[tid] != 0);
  }
  cp_async_commit();

  // this thread's two rows: lse (times log2 e) and delta; 0 past S, where
  // q and dout are zero and nothing is written
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    const size_t o = ((size_t)b * a.N + n) * a.S + row;
    l2[r] = row < a.S ? a.lse[o] * kLog2e : 0.f;
    dl[r] = row < a.S ? a.delta[o] : 0.f;
  }

  cp_async_wait<1>();
  __syncthreads();  // Q and dout have landed
  unsigned qf[L::REG_FRAGS ? KS : 1][4], of[L::REG_FRAGS ? KS : 1][4];
  if constexpr (L::REG_FRAGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a(qf[ks], Qst + warp * 16 * P, ks * 16, lane, P);
      load_a(of[ks], Ost + warp * 16 * P, ks * 16, lane, P);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[ks][i] = scaled_q(qf[ks][i], a.scale);
    }
  } else {  // round(q * scale) in place, once
    for (int i = tid; i < BQ * DP / 2; i += THREADS) {
      unsigned* pair = reinterpret_cast<unsigned*>(Qst + (i / (DP / 2)) * P + 2 * (i % (DP / 2)));
      *pair = scaled_q(*pair, a.scale);
    }
    __syncthreads();
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, t0 = kt * BK;
    uint8_t ok_next = 0;
    if (kt + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      load_rows<BK, D, DP, P, THREADS>(Ks + (st ^ 1) * BK * P, a.k, b, t0 + BK, a.Tk, a.KH,
                                       kvh, tid);
      load_rows<BK, D, DP, P, THREADS>(Vs + (st ^ 1) * BK * P, a.v, b, t0 + BK, a.Tk, a.KH,
                                       kvh, tid);
      const int t = t0 + BK + tid;
      if (tid < BK) ok_next = t < a.Tk && (mask_b == nullptr || mask_b[t] != 0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt and its slot bytes are visible

    // rows at or past S, or all before the tile in causal order, skip it
    if (w0 < a.S && (!a.causal || a.q_offset + w0 + 15 >= t0)) {
      const __nv_bfloat16* Kt = Ks + st * BK * P;
      const __nv_bfloat16* Vt = Vs + st * BK * P;
      const uint8_t* ok = Ms + st * BK;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned qa[4], oa[4];
        if constexpr (L::REG_FRAGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[ks][i], oa[i] = of[ks][i];
        } else {
          load_a(qa, Qst + warp * 16 * P, ks * 16, lane, P);
          load_a(oa, Ost + warp * 16 * P, ks * 16, lane, P);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned kb[4], vb[4];
          load_b(kb, Kt, np * 16, ks * 16, lane, P);
          load_b(vb, Vt, np * 16, ks * 16, lane, P);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
        }
      }
      const bool masked =
          mask_b != nullptr || t0 + BK > a.Tk || (a.causal && a.q_offset + w0 < t0 + BK - 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = nt * 8 + 2 * tq + (e & 1);
          float p = ex2(fmaf(s[nt][e], kLog2e, -l2[r]));
          if (masked && (!ok[j] || (a.causal && a.q_offset + w0 + g + 8 * r < t0 + j))) p = 0.f;
          s[nt][e] = p * (dp[nt][e] - dl[r]);  // ds, from the unrounded p
        }
      // dQ += round(ds) K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned da[4];
        pack_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < DP / 16; ++dp2) {
          unsigned kb[4];
          load_b_trans(kb, Kt, kk * 16, dp2 * 16, lane, P);
          mma_bf16(acc[2 * dp2], da, kb[0], kb[1]);
          mma_bf16(acc[2 * dp2 + 1], da, kb[2], kb[3]);
        }
      }
    }
    if (kt + 1 < n_tiles && tid < BK) Ms[(st ^ 1) * BK + tid] = ok_next;
    __syncthreads();  // stage st is free for tile kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= a.S) continue;
    __nv_bfloat16* out = a.dq + (((size_t)b * a.S + row) * a.N + n) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<unsigned*>(out + dt * 8) =
          pack_bf16(acc[dt][2 * r] * a.scale, acc[dt][2 * r + 1] * a.scale);
  }
}

template <int D>
struct KvTile {  // B5a
  static constexpr int DP = (D + 15) / 16 * 16;  // depth padded to the MMA's k of 16
  static constexpr int P = DP + 8;
  static constexpr int WARPS = 8, THREADS = WARPS * 32;
  // warps sharing 16 keys, each holding the dK/dV sums of DP / KSPLIT
  // columns: 2 at D 160, whose sums would take 160 registers a thread
  static constexpr int KSPLIT = D > 128 ? 2 : 1;
  static constexpr int DH = DP / KSPLIT;           // dK/dV columns a warp
  static constexpr int BKB = WARPS / KSPLIT * 16;  // keys a block
  static constexpr int BQ = 64;                    // query rows a tile
  // K and V, then two stages of round(q*scale), q and dout, then two stages
  // of lse * log2(e) and of delta
  static constexpr size_t bytes = sizeof(__nv_bfloat16) *
                                      (2 * (size_t)BKB * P + 6 * (size_t)BQ * P) +
                                  sizeof(float) * 4 * BQ;
};

// B5a: dK, dV for the keys [blockIdx.x * BKB, + BKB) of KV head blockIdx.y.
template <int D>
__global__ void __launch_bounds__(KvTile<D>::THREADS, 1)
flash_bwd_kv_mma_kernel(const MArgs a) {
  using L = KvTile<D>;
  constexpr int DP = L::DP, P = L::P, BKB = L::BKB, BQ = L::BQ, THREADS = L::THREADS;
  constexpr int KS = DP / 16;     // k-steps of S^T and dP^T
  constexpr int NT = BQ / 8;      // n-tiles of S^T and dP^T (queries)
  constexpr int DT = L::DH / 8;   // n-tiles of this warp's dK and dV columns
  static_assert(2 * BQ <= THREADS, "one thread a row for lse and one for delta");
  extern __shared__ __align__(16) unsigned char smem_kv[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_kv);  // [BKB][P]
  __nv_bfloat16* Vs = Ks + BKB * P;                                // [BKB][P]
  __nv_bfloat16* Qss = Vs + BKB * P;     // [2][BQ][P] round(q * scale)
  __nv_bfloat16* Qrs = Qss + 2 * BQ * P;  // [2][BQ][P] q
  __nv_bfloat16* Os = Qrs + 2 * BQ * P;   // [2][BQ][P] dout
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * P);  // [2][BQ] lse * log2(e)
  float* Dl = Ls + 2 * BQ;                                 // [2][BQ] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int groups = a.N / a.KH;
  const int t0 = blockIdx.x * BKB;
  const int kw = warp / L::KSPLIT;        // the warp's 16 keys in the block
  const int c0 = (warp % L::KSPLIT) * L::DH;  // its first dK/dV column
  const int tw = t0 + kw * 16;            // the warp's first key
  const uint8_t* mask_b = a.kv_mask != nullptr ? a.kv_mask + (size_t)b * a.Tk : nullptr;

  // this thread's two keys (rows g and g + 8 of the warp's C fragments)
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tw + g + 8 * r;
    kok[r] = t < a.Tk && (mask_b == nullptr || mask_b[t] != 0);
  }
  const bool warp_live = __any_sync(0xffffffffu, kok[0] || kok[1]);
  const bool block_live = __syncthreads_or(warp_live) != 0;

  // the query tiles from the first holding a row that can see key t0, for
  // each query head of the group: one sequence of n_tiles tiles
  const int nq = (a.S + BQ - 1) / BQ;
  const int iq0 = a.causal ? max(0, t0 - a.q_offset) / BQ : 0;
  const int n_tiles = block_live ? groups * max(0, nq - iq0) : 0;

  // rows of tile (n, iq) into stage st: q, round(q*scale) and dout by
  // cp.async; lse and delta returned to the threads that stage them
  auto issue = [&](int st, int n, int iq) {
    const int s0 = iq * BQ;
    load_rows<BQ, D, DP, P, THREADS>(Qss + st * BQ * P, a.qs, b, s0, a.S, a.N, n, tid);
    load_rows<BQ, D, DP, P, THREADS>(Qrs + st * BQ * P, a.q, b, s0, a.S, a.N, n, tid);
    load_rows<BQ, D, DP, P, THREADS>(Os + st * BQ * P, a.dout, b, s0, a.S, a.N, n, tid);
    cp_async_commit();
    const int row = s0 + (tid & (BQ - 1));
    const size_t o = ((size_t)b * a.N + n) * a.S + row;
    if (tid >= 2 * BQ || row >= a.S) return 0.f;
    return tid < BQ ? a.lse[o] * kLog2e : a.delta[o];
  };
  auto stage = [&](int st, float x) {  // lse: threads 0..63, delta: 64..127
    if (tid < 2 * BQ) (tid < BQ ? Ls : Dl)[st * BQ + (tid & (BQ - 1))] = x;
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  int n = kvh * groups, iq = iq0;  // the head and query tile of tile j
  if (n_tiles > 0) {
    load_rows<BKB, D, DP, P, THREADS>(Ks, a.k, b, t0, a.Tk, a.KH, kvh, tid);
    load_rows<BKB, D, DP, P, THREADS>(Vs, a.v, b, t0, a.Tk, a.KH, kvh, tid);
    stage(0, issue(0, n, iq));  // one group: K, V and tile 0
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    int n_next = n, iq_next = iq + 1;
    if (iq_next == nq) iq_next = iq0, ++n_next;
    float x_next = 0.f;
    if (j + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      x_next = issue(st ^ 1, n_next, iq_next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and K, V) visible

    const int s0 = iq * BQ;
    // a warp with no valid key, or whose keys all follow the tile's last row
    // in causal order, skips it
    if (warp_live && (!a.causal || a.q_offset + min(a.S, s0 + BQ) - 1 >= tw)) {
      const __nv_bfloat16* Qs = Qss + st * BQ * P;
      const __nv_bfloat16* Qr = Qrs + st * BQ * P;
      const __nv_bfloat16* Ot = Os + st * BQ * P;
      const float* lt = Ls + st * BQ;
      const float* dt_ = Dl + st * BQ;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned ka[4], va[4];  // re-read each tile from shared memory
        load_a(ka, Ks + kw * 16 * P, ks * 16, lane, P);
        load_a(va, Vs + kw * 16 * P, ks * 16, lane, P);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned qb[4], ob[4];
          load_b(qb, Qs, np * 16, ks * 16, lane, P);
          load_b(ob, Ot, np * 16, ks * 16, lane, P);
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * np], va, ob[0], ob[1]);
          mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      const bool masked = mask_b != nullptr || tw + 16 > a.Tk || s0 + BQ > a.S ||
                          (a.causal && a.q_offset + s0 < tw + 15);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = nt * 8 + 2 * tq + (e & 1);  // key row, query column
          float p = ex2(fmaf(s[nt][e], kLog2e, -lt[c]));
          if (masked && (!kok[r] || s0 + c >= a.S ||
                         (a.causal && a.q_offset + s0 + c < tw + g + 8 * r)))
            p = 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dt_[c]);  // ds^T, from the unrounded p
        }
      // dV += round(p^T) dout, dK += round(ds^T) q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        unsigned pa[4], da[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < L::DH / 16; ++dp2) {
          unsigned ob[4], qb[4];
          load_b_trans(ob, Ot, kk * 16, c0 + dp2 * 16, lane, P);
          load_b_trans(qb, Qr, kk * 16, c0 + dp2 * 16, lane, P);
          mma_bf16(dv[2 * dp2], pa, ob[0], ob[1]);
          mma_bf16(dv[2 * dp2 + 1], pa, ob[2], ob[3]);
          mma_bf16(dk[2 * dp2], da, qb[0], qb[1]);
          mma_bf16(dk[2 * dp2 + 1], da, qb[2], qb[3]);
        }
      }
    }
    if (j + 1 < n_tiles) stage(st ^ 1, x_next);
    __syncthreads();  // stage st is free for tile j + 2
    n = n_next, iq = iq_next;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tw + g + 8 * r;
    if (t >= a.Tk) continue;
    const size_t base = (((size_t)b * a.Tk + t) * a.KH + kvh) * D + c0 + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      if (c0 + dt * 8 >= D) break;  // the padded columns of D 40
      *reinterpret_cast<unsigned*>(a.dk + base + dt * 8) =
          pack_bf16(dk[dt][2 * r] * a.scale, dk[dt][2 * r + 1] * a.scale);
      *reinterpret_cast<unsigned*>(a.dv + base + dt * 8) =
          pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

template <int D>
int launch_kv_mma(const MArgs& a, int B, __nv_bfloat16* qs, cudaStream_t st) {
  using L = KvTile<D>;
  const size_t n16 = (size_t)B * a.S * a.N * D / 8;
  const int blocks = (int)std::min<size_t>((n16 + 255) / 256, 132 * 16);
  flash_bwd_kv_scaled_q_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const uint4*>(a.q),
                                                       reinterpret_cast<uint4*>(qs), n16,
                                                       a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_kv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  MArgs m = a;
  m.qs = qs;
  dim3 grid((a.Tk + L::BKB - 1) / L::BKB, a.KH, B);
  flash_bwd_kv_mma_kernel<D><<<grid, L::THREADS, L::bytes, st>>>(m);
  return (int)cudaGetLastError();
}

template <int D>
int launch_q_mma(const MArgs& a, int B, cudaStream_t st) {
  using L = QTile<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_q_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + L::BQ - 1) / L::BQ, a.N, B);
  flash_bwd_q_mma_kernel<D><<<grid, L::THREADS, L::bytes, st>>>(a);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

MArgs make_margs(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* kv_mask, int S, int Tk, int N, int KH,
                 int q_offset, float scale, int causal) {
  MArgs m{};
  m.q = static_cast<const __nv_bfloat16*>(q);
  m.k = static_cast<const __nv_bfloat16*>(k);
  m.v = static_cast<const __nv_bfloat16*>(v);
  m.dout = static_cast<const __nv_bfloat16*>(dout);
  m.lse = static_cast<const float*>(lse);
  m.delta = static_cast<const float*>(delta);
  m.kv_mask = static_cast<const uint8_t*>(kv_mask);
  m.S = S, m.Tk = Tk, m.N = N, m.KH = KH, m.q_offset = q_offset;
  m.scale = scale, m.causal = causal;
  return m;
}

// ---------------------------------------------------------------- entries

}  // namespace

// B5a. q, dout [B,S,N,D] and k, v, dk, dv [B,T,KH,D], all float32 or all
// bfloat16 (is_bf16); lse, delta [B,N,S] float32; kv_mask a [B,T] bool or
// null; qs a [B,S,N,D] bf16 scratch that takes round(q * scale) (bf16
// only; null for float32). D is 40, 64, 80, 128 or 160 in bf16, 64 or 128
// in float32, and N a multiple of KH; bf16 tensors 16-byte aligned.
// Returns cudaGetLastError() after the launches.
extern "C" int vt_flash_attention_bwd_kv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* kv_mask, void* qs, void* dk, void* dv,
                                         int B, int S, int Tk, int N, int KH, int D,
                                         int q_offset, float scale, int causal, int is_bf16,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const Args a = make_args(q, k, v, dout, lse, delta, kv_mask, B, S, Tk, N, KH, q_offset,
                             scale, causal);
    if (D == 64) return launch_kv<float, 64>(a, dk, dv, st);
    if (D == 128) return launch_kv<float, 128>(a, dk, dv, st);
    return (int)cudaErrorInvalidValue;
  }
  if (qs == nullptr || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(qs) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  MArgs m = make_margs(q, k, v, dout, lse, delta, kv_mask, S, Tk, N, KH, q_offset, scale, causal);
  m.dk = static_cast<__nv_bfloat16*>(dk);
  m.dv = static_cast<__nv_bfloat16*>(dv);
  __nv_bfloat16* scratch = static_cast<__nv_bfloat16*>(qs);
  switch (D) {
    case 40: return launch_kv_mma<40>(m, B, scratch, st);
    case 64: return launch_kv_mma<64>(m, B, scratch, st);
    case 80: return launch_kv_mma<80>(m, B, scratch, st);
    case 128: return launch_kv_mma<128>(m, B, scratch, st);
    case 160: return launch_kv_mma<160>(m, B, scratch, st);
  }
  return (int)cudaErrorInvalidValue;
}

// B5b. The same inputs; dq [B,S,N,D] in the input type.
extern "C" int vt_flash_attention_bwd_q(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* kv_mask, void* dq, int B, int S, int Tk,
                                        int N, int KH, int D, int q_offset, float scale,
                                        int causal, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const Args a = make_args(q, k, v, dout, lse, delta, kv_mask, B, S, Tk, N, KH, q_offset,
                             scale, causal);
    if (D == 64) return launch_q<float, 64>(a, dq, st);
    if (D == 128) return launch_q<float, 128>(a, dq, st);
    return (int)cudaErrorInvalidValue;
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  MArgs m = make_margs(q, k, v, dout, lse, delta, kv_mask, S, Tk, N, KH, q_offset, scale, causal);
  m.dq = static_cast<__nv_bfloat16*>(dq);
  switch (D) {
    case 40: return launch_q_mma<40>(m, B, st);
    case 64: return launch_q_mma<64>(m, B, st);
    case 80: return launch_q_mma<80>(m, B, st);
    case 128: return launch_q_mma<128>(m, B, st);
    case 160: return launch_q_mma<160>(m, B, st);
  }
  return (int)cudaErrorInvalidValue;
}
