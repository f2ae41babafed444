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
// (:330-335, :370-372). Sums run in float32. A query row that sees no valid
// key has p = 0 everywhere and gets zero gradients.
//
// Design. The TPU grid runs in order and carries dK/dV (or dQ) in scratch
// from one grid step to the next; here the sequential axis is a loop inside
// the block and the sum stays in registers:
//   B5a: one block per (key tile of 64, KV head, batch). It walks the
//     visible query tiles of every query head of its GQA group and keeps
//     dK and dV of its 64 keys in float32 registers, so the GQA reduction
//     (:465-469) happens there too and dK/dV are written once, in [B,T,KH,D].
//   B5b: one block per (query tile of 64, query head, batch), walking the
//     key tiles up to the last one its rows can see.
// No atomics: two runs give the same bits. Tiles wholly in the causal
// future are skipped (:320, :360).
//
// What bounds it on the H100: the five products of the backward (scores,
// dP, dV, dK, dQ; halved when causal) are ~1.7e11 FLOP a layer at the
// trainer's [2, 2048, 32, 128]: 0.17 ms on the bf16 tensor cores. This
// first version computes them on the FMA pipes in float32 (B5a recomputes
// the scores and dP that B5b recomputes too, seven products in all), so it
// is bound by the FMA rate and the shared-memory loads feeding it: 256
// threads as a 16 x 16 grid, each scoring a 4 x 4 block of the 64 x 64
// tile (rows and columns strided by 16 so that the float32 tiles, padded by
// one word a row, are read without bank conflicts) and owning 4 x D/16 of
// the [64, D] accumulators. Shared memory: 198 KB at D = 128 for B5a (K, V,
// round(q*scale), q, dout, p, ds), 149 KB for B5b; one block an SM.
// mma/wgmma belong to a later change.
#include <cfloat>

#include "common.cuh"

namespace {

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

}  // namespace

// B5a. q, dout [B,S,N,D] and k, v, dk, dv [B,T,KH,D], all float32 or all
// bfloat16 (is_bf16); lse, delta [B,N,S] float32; kv_mask a [B,T] bool or
// null. D is 64 or 128 and N a multiple of KH. Returns cudaGetLastError()
// after the launch.
extern "C" int vt_flash_attention_bwd_kv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* kv_mask, void* dk, void* dv, int B, int S,
                                         int Tk, int N, int KH, int D, int q_offset, float scale,
                                         int causal, int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kv_mask, B, S, Tk, N, KH, q_offset, scale,
                           causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return is_bf16 ? launch_kv<__nv_bfloat16, 64>(a, dk, dv, st)
                              : launch_kv<float, 64>(a, dk, dv, st);
  if (D == 128) return is_bf16 ? launch_kv<__nv_bfloat16, 128>(a, dk, dv, st)
                               : launch_kv<float, 128>(a, dk, dv, st);
  return (int)cudaErrorInvalidValue;
}

// B5b. The same inputs; dq [B,S,N,D] in the input type.
extern "C" int vt_flash_attention_bwd_q(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* kv_mask, void* dq, int B, int S, int Tk,
                                        int N, int KH, int D, int q_offset, float scale,
                                        int causal, int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kv_mask, B, S, Tk, N, KH, q_offset, scale,
                           causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return is_bf16 ? launch_q<__nv_bfloat16, 64>(a, dq, st)
                              : launch_q<float, 64>(a, dq, st);
  if (D == 128) return is_bf16 ? launch_q<__nv_bfloat16, 128>(a, dq, st)
                               : launch_q<float, 128>(a, dq, st);
  return (int)cudaErrorInvalidValue;
}
