// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the forward of the Pallas TPU kernel
// vitron_tpu/kernels/flash_attention.py::_flash_kernel (:92), launched by
// _flash_forward (:179, pallas_call at :242).
//
// Semantics, in key-slot space (JAX layout: q [B,S,N,D], k/v [B,T,KH,D]):
//   logit[b,n,i,j] = scale * q[b,i,n] . k[b,j,n/groups]
//   visible iff (!causal || q_offset + i >= j) && kv_mask[b,j] && j < T
// with an online softmax in float32 (running max, sum and accumulator) and
// the TPU kernel's finalize out = acc / max(l, 1e-30), so a query row that
// sees no valid key comes out as zeros. softmax_shift replaces the running
// max by a fixed shift: p = exp(min(logit - shift, 60)).
//
// What bounds it on the H100: at the LLM prefill shape (S = 384, T = 512,
// 32 heads, D = 128) the whole attention is ~3 GFLOP a layer, tiny next to
// the int4 projections; at the SD UNet's 64x64 sites (4096 tokens, 8 heads,
// D = 40, CFG batch 2) it is ~43 GFLOP a site with only 40 multiply-adds
// per logit, so the float32 score loop and the exp dominate. This first
// version favours a simple, exact schedule over the tensor cores: one block
// of 256 threads per (b, head, query tile); K/V tiles are staged in shared
// memory as float32 (K rows padded by one word so the dot-product reads hit
// distinct banks); TPR threads share a query row, each scoring BKT / TPR
// keys and owning D / TPR output dims, and combine their max and sum with
// log2(TPR) warp shuffles in a fixed order (deterministic). Two schedules:
//   D <= 160 (40, 64, 80, 128, 160): TPR = 4, a 64-row query tile and
//     64-key tiles (48-140 KB of shared memory);
//   D = 512 (the VAE's single-head mid attention): staged like the rest it
//     would need ~410 KB against the 227 KB a block may use, so it takes a
//     16-row query tile, 32-key tiles and TPR = 16 (each thread owns 32
//     output dims, as at D = 128): 166 KB.
// Ragged S and T (the GLIGEN fuser sites have 4126 and 1054 tokens) are
// masked in the last tiles. Key tiles that lie wholly in the causal future
// are never loaded. mma/wgmma belong to a later change.
//
// For training (`lse` not null) the kernel also writes the per-row
// log-sum-exp that the backward (flash_attention_bwd.cu) recomputes the
// probabilities from, as the TPU kernel's _finalize (:169-176) does:
// lse = (running max, or the shift) + log(max(l, 1e-30)), [B, N, S] float32.
// It then rounds q * scale to the input type before the dot, as the TPU
// kernel's _scaled_q (:85-89) does, so that forward and backward score the
// same logits. With `lse` null (inference) neither changes.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int D, int TPR, int BKT>
constexpr size_t smem_bytes() {
  constexpr int BQ = kThreads / TPR;
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKT * (D + 1) + (size_t)BKT * D +
                          (size_t)BQ * (BKT + 1));
}

template <typename T, int D, int TPR, int BKT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tk, int N, int KH, int q_offset,
                 float scale, int causal, int use_shift, float shift) {
  constexpr int BQ = kThreads / TPR;  // query rows per block
  constexpr int KPT = BKT / TPR;      // keys scored per thread per tile
  constexpr int DQ = D / TPR;         // output dims per thread
  constexpr int DP = D + 1;
  constexpr int PP = BKT + 1;
  static_assert(D % TPR == 0 && BKT % TPR == 0 && KPT <= 32 && 32 % TPR == 0, "tiling");
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][DP], pre-scaled
  float* Ks = Qs + BQ * DP;    // [BKT][DP]
  float* Vs = Ks + BKT * DP;   // [BKT][D]
  float* Ps = Vs + BKT * D;    // [BQ][PP]

  const int iq = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (N / KH);
  const int tid = threadIdx.x;
  const int row = tid / TPR, sub = tid % TPR;
  const int s0 = iq * BQ;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, sq = s0 + r;
    float qv = sq < S ? vt::to_f32(q[(((size_t)b * S + sq) * N + n) * D + d]) * scale : 0.f;
    if (lse != nullptr) qv = vt::to_f32(vt::from_f32<T>(qv));
    Qs[r * DP + d] = qv;
  }

  const int q_pos = q_offset + s0 + row;
  int n_tiles = (Tk + BKT - 1) / BKT;
  if (causal) {
    const int last = q_offset + min(S, s0 + BQ) - 1;  // last query slot of the tile
    n_tiles = min(n_tiles, last / BKT + 1);
  }

  float m_i = -FLT_MAX, l_i = 0.f;
  float acc[DQ];
#pragma unroll
  for (int dd = 0; dd < DQ; ++dd) acc[dd] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * BKT;
    __syncthreads();  // the previous tile's readers are done (and Qs is visible)
    for (int i = tid; i < BKT * D; i += kThreads) {
      const int r = i / D, d = i % D, t = t0 + r;
      const bool in = t < Tk;
      const size_t off = (((size_t)b * Tk + t) * KH + kvh) * D + d;
      Ks[r * DP + d] = in ? vt::to_f32(k[off]) : 0.f;
      Vs[r * D + d] = in ? vt::to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[KPT];
    unsigned ok_bits = 0u;
    float m_cur = -FLT_MAX;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj, t = t0 + j;
      const bool ok = t < Tk && (kv_mask == nullptr || kv_mask[(size_t)b * Tk + t] != 0) &&
                      (!causal || q_pos >= t);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[row * DP + d], Ks[j * DP + d], dot);
      sc[jj] = ok ? dot : -FLT_MAX;
      ok_bits |= (ok ? 1u : 0u) << jj;
      m_cur = fmaxf(m_cur, sc[jj]);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
    float m_new = m_i, alpha = 1.f;
    if (!use_shift) {
      m_new = fmaxf(m_i, m_cur);
      alpha = expf(m_i - m_new);
    }

    float l_cur = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      float p = 0.f;
      if ((ok_bits >> jj) & 1u) p = use_shift ? expf(fminf(sc[jj] - shift, 60.f)) : expf(sc[jj] - m_new);
      Ps[row * PP + sub + TPR * jj] = p;
      l_cur += p;
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) l_cur += __shfl_xor_sync(0xffffffffu, l_cur, o);
    l_i = l_i * alpha + l_cur;
    m_i = m_new;
    __syncwarp();  // the row's TPR threads share their Ps entries

#pragma unroll
    for (int dd = 0; dd < DQ; ++dd) acc[dd] *= alpha;
    for (int j = 0; j < BKT; ++j) {
      const float p = Ps[row * PP + j];
#pragma unroll
      for (int dd = 0; dd < DQ; ++dd) acc[dd] = fmaf(p, Vs[j * D + sub + TPR * dd], acc[dd]);
    }
  }

  const int sq = s0 + row;
  if (sq < S) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* o = out + (((size_t)b * S + sq) * N + n) * D;
#pragma unroll
    for (int dd = 0; dd < DQ; ++dd) o[sub + TPR * dd] = vt::from_f32<T>(acc[dd] / denom);
    if (lse != nullptr && sub == 0)
      lse[((size_t)b * N + n) * S + sq] = (use_shift ? shift : m_i) + logf(denom);
  }
}

template <typename T, int D, int TPR = 4, int BKT = 64>
int launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
           float* lse, int B, int S, int Tk, int N, int KH, int q_offset, float scale, int causal,
           int use_shift, float shift, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, TPR, BKT>();
  constexpr int BQ = kThreads / TPR;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, TPR, BKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, N, B);
  flash_fwd_kernel<T, D, TPR, BKT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<T*>(out), lse, S, Tk, N, KH, q_offset,
      scale, causal, use_shift, shift);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
             float* lse, int B, int S, int Tk, int N, int KH, int D, int q_offset, float scale,
             int causal, int use_shift, float shift, cudaStream_t st) {
  switch (D) {
    case 40:
      return launch<T, 40>(q, k, v, kv_mask, out, lse, B, S, Tk, N, KH, q_offset, scale, causal,
                           use_shift, shift, st);
    case 64:
      return launch<T, 64>(q, k, v, kv_mask, out, lse, B, S, Tk, N, KH, q_offset, scale, causal,
                           use_shift, shift, st);
    case 80:
      return launch<T, 80>(q, k, v, kv_mask, out, lse, B, S, Tk, N, KH, q_offset, scale, causal,
                           use_shift, shift, st);
    case 128:
      return launch<T, 128>(q, k, v, kv_mask, out, lse, B, S, Tk, N, KH, q_offset, scale, causal,
                            use_shift, shift, st);
    case 160:
      return launch<T, 160>(q, k, v, kv_mask, out, lse, B, S, Tk, N, KH, q_offset, scale, causal,
                            use_shift, shift, st);
    case 512:
      return launch<T, 512, 16, 32>(q, k, v, kv_mask, out, lse, B, S, Tk, N, KH, q_offset, scale,
                                    causal, use_shift, shift, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_mask is a [B, T] bool (one byte per slot) or null; lse a [B, N, S]
// float32 output or null. D must be one of 40, 64, 80, 128, 160, 512 and N a
// multiple of KH. Returns cudaGetLastError() after the launch.
extern "C" int vt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* kv_mask, void* out, void* lse, int B, int S,
                                      int Tk, int N, int KH, int D, int q_offset, float scale,
                                      int causal, int use_shift, float shift, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, D,
                                           q_offset, scale, causal, use_shift, shift, st)
                 : dispatch<float>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, D, q_offset, scale,
                                   causal, use_shift, shift, st);
}
