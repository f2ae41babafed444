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
// the int4 projections, so this first version favours a simple, exact
// schedule over the tensor cores: one block of 256 threads per (b, head,
// 64-row query tile); K/V tiles of 64 keys are staged in shared memory as
// float32 (rows padded by one word so the dot-product reads hit distinct
// banks); four threads share a query row, each scoring 16 keys and owning a
// quarter of the output dims, and combine their max and sum with two warp
// shuffles in a fixed order (deterministic). Key tiles that lie wholly in
// the causal future are never loaded. mma/wgmma belong to a later change.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block (4 threads per row)
constexpr int kBKT = 64;  // keys per tile (16 per thread)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBKT * (D + 1) +
                          (size_t)kBKT * D + (size_t)kBQ * (kBKT + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, T* __restrict__ out, int S, int Tk,
                 int N, int KH, int q_offset, float scale, int causal, int use_shift,
                 float shift) {
  constexpr int DP = D + 1;
  constexpr int PP = kBKT + 1;
  constexpr int DQ = D / 4;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][DP], pre-scaled
  float* Ks = Qs + kBQ * DP;    // [kBKT][DP]
  float* Vs = Ks + kBKT * DP;   // [kBKT][D]
  float* Ps = Vs + kBKT * D;    // [kBQ][PP]

  const int iq = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (N / KH);
  const int tid = threadIdx.x;
  const int row = tid >> 2, sub = tid & 3;
  const int s0 = iq * kBQ;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, sq = s0 + r;
    Qs[r * DP + d] = sq < S ? vt::to_f32(q[(((size_t)b * S + sq) * N + n) * D + d]) * scale : 0.f;
  }

  const int q_pos = q_offset + s0 + row;
  int n_tiles = (Tk + kBKT - 1) / kBKT;
  if (causal) {
    const int last = q_offset + min(S, s0 + kBQ) - 1;  // last query slot of the tile
    n_tiles = min(n_tiles, last / kBKT + 1);
  }

  float m_i = -FLT_MAX, l_i = 0.f;
  float acc[DQ];
#pragma unroll
  for (int dd = 0; dd < DQ; ++dd) acc[dd] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * kBKT;
    __syncthreads();  // the previous tile's readers are done (and Qs is visible)
    for (int i = tid; i < kBKT * D; i += kThreads) {
      const int r = i / D, d = i % D, t = t0 + r;
      const bool in = t < Tk;
      const size_t off = (((size_t)b * Tk + t) * KH + kvh) * D + d;
      Ks[r * DP + d] = in ? vt::to_f32(k[off]) : 0.f;
      Vs[r * D + d] = in ? vt::to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[16];
    unsigned ok_bits = 0u;
    float m_cur = -FLT_MAX;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = sub + 4 * jj, t = t0 + j;
      const bool ok = t < Tk && (kv_mask == nullptr || kv_mask[(size_t)b * Tk + t] != 0) &&
                      (!causal || q_pos >= t);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[row * DP + d], Ks[j * DP + d], dot);
      sc[jj] = ok ? dot : -FLT_MAX;
      ok_bits |= (ok ? 1u : 0u) << jj;
      m_cur = fmaxf(m_cur, sc[jj]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    float m_new = m_i, alpha = 1.f;
    if (!use_shift) {
      m_new = fmaxf(m_i, m_cur);
      alpha = expf(m_i - m_new);
    }

    float l_cur = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      float p = 0.f;
      if ((ok_bits >> jj) & 1u) p = use_shift ? expf(fminf(sc[jj] - shift, 60.f)) : expf(sc[jj] - m_new);
      Ps[row * PP + sub + 4 * jj] = p;
      l_cur += p;
    }
    l_cur += __shfl_xor_sync(0xffffffffu, l_cur, 1);
    l_cur += __shfl_xor_sync(0xffffffffu, l_cur, 2);
    l_i = l_i * alpha + l_cur;
    m_i = m_new;
    __syncwarp();  // the row's four threads share their Ps entries

#pragma unroll
    for (int dd = 0; dd < DQ; ++dd) acc[dd] *= alpha;
    for (int j = 0; j < kBKT; ++j) {
      const float p = Ps[row * PP + j];
#pragma unroll
      for (int dd = 0; dd < DQ; ++dd) acc[dd] = fmaf(p, Vs[j * D + sub + 4 * dd], acc[dd]);
    }
  }

  const int sq = s0 + row;
  if (sq < S) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* o = out + (((size_t)b * S + sq) * N + n) * D;
#pragma unroll
    for (int dd = 0; dd < DQ; ++dd) o[sub + 4 * dd] = vt::from_f32<T>(acc[dd] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out, int B,
           int S, int Tk, int N, int KH, int q_offset, float scale, int causal, int use_shift,
           float shift, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, N, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<T*>(out), S, Tk, N, KH, q_offset, scale,
      causal, use_shift, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// kv_mask is a [B, T] bool (one byte per slot) or null. D must be 64 or
// 128 and N a multiple of KH. Returns cudaGetLastError() after the launch.
extern "C" int vt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* kv_mask, void* out, int B, int S, int Tk,
                                      int N, int KH, int D, int q_offset, float scale,
                                      int causal, int use_shift, float shift, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, kv_mask, out, B, S, Tk, N, KH, q_offset,
                                               scale, causal, use_shift, shift, st)
                   : launch<float, 64>(q, k, v, kv_mask, out, B, S, Tk, N, KH, q_offset, scale,
                                       causal, use_shift, shift, st);
  }
  if (D == 128) {
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, kv_mask, out, B, S, Tk, N, KH,
                                                q_offset, scale, causal, use_shift, shift, st)
                   : launch<float, 128>(q, k, v, kv_mask, out, B, S, Tk, N, KH, q_offset, scale,
                                        causal, use_shift, shift, st);
  }
  return (int)cudaErrorInvalidValue;
}
