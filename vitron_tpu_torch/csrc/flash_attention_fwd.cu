// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the forward of the Pallas TPU kernel
// vitron_tpu/kernels/flash_attention.py::_flash_kernel (:92), launched by
// _flash_forward (:179, pallas_call at :242).
//
// Semantics, in key-slot space (JAX layout: q [B,S,N,D], k/v [B,T,KH,D]):
//   logit[b,n,i,j] = round(q[b,i,n] * scale) . k[b,j,n/groups]
//   visible iff (!causal || q_offset + i >= j) && kv_mask[b,j] && j < T
// q_offset is the host int plus, when q_offset_dev is not null, the int64
// the device holds there (the TPU kernel's scalar-prefetch offset,
// off_ref[0] :111, :240): a CUDA graph then replays a cached window whose
// slot moves with the data. Each block reads it once, before the causal
// cut of its key tiles.
// with an online softmax in float32 (running max, sum and accumulator) and
// the TPU kernel's finalize out = acc / max(l, 1e-30), so a query row that
// sees no valid key comes out as zeros. softmax_shift replaces the running
// max by a fixed shift: p = exp(min(logit - shift, 60)). As the TPU kernel
// does, q * scale is rounded to the input type before the dot (_scaled_q
// :85-89) and p to v's type before p . v (:153, :165), while the row sum l
// adds the unrounded float32 p (:151, :163). With `lse` not null (training)
// the kernel also writes the per-row log-sum-exp that the backward
// (flash_attention_bwd.cu) recomputes the probabilities from, as _finalize
// (:169-176) does: lse = (running max, or the shift) + log(max(l, 1e-30)),
// [B, N, S] float32. No atomics: the same bits on every run.
//
// bfloat16 (every main path: the LLM's compute dtype, layers._mha for the
// UNets and the VAE) runs on the tensor cores, FlashAttention-2's register
// dataflow on mma.sync m16n8k16 (bf16 in, float32 sums; mma_sync.cuh):
// - a block owns BQ query rows of one (b, head), MT m16 tiles (16 MT rows)
//   a warp; the block copies its Q rows once (cp.async), and each warp
//   scales and rounds its rows to bf16 as _scaled_q does and keeps them in
//   registers as A fragments for the whole key loop;
// - K/V tiles of BKT keys come through a 2-stage cp.async ring (16 bytes a
//   thread, zero-filled past T and, at D 40, from depth 40 to 48, since
//   the MMA's depth is 16): tile k + 1 is in flight while tile k is
//   multiplied. Rows are padded by 8 values (16 bytes), so the eight rows
//   of each ldmatrix land in distinct banks at every head dim. Key tiles
//   that lie wholly in the causal future are never loaded, and a warp whose
//   rows all precede a tile skips it;
// - S = Q K^T with K fragments from ldmatrix; the online softmax runs on
//   the float32 accumulator fragments in registers: a thread holds two
//   rows, combines their max with two quad shfl_xor's in a fixed order,
//   and takes one ex2 a logit, log2(e) folded into one FMA after the
//   float32 product (not into q, which the TPU kernel rounds unscaled by
//   it). The mask (causal, kv_mask, ragged T, staged per tile in shared
//   memory with the K/V ring) is applied only on tiles that need it. l
//   adds the unrounded p (per thread, reduced across the quad at the end);
// - O += P V: the C fragments of S are the A fragments of P (two m16n8
//   tiles are one m16n8k16 operand), converted to bf16 in registers (the
//   TPU kernel's p.astype(v.dtype)); V's fragments come from ldmatrix.trans.
// Schedules (registers and shared memory a block, on 227 KB and 64K
// registers an SM):
//   D 40 (padded to 48), D 64: 4 warps of 32 rows (MT 2: each K and V
//     fragment from ldmatrix feeds two MMAs, half the shared-memory reads
//     a product of 16 rows a warp), 128 rows, 64-key tiles (43-55 KB,
//     199-241 registers a thread, two blocks an SM);
//   D 80, D 128: 4 warps of 16 rows, 64 rows, 64-key tiles (56-87 KB): two
//     m16 tiles a warp would take all 255 registers at D 80 and spill at
//     D 128;
//   D 160: 4 warps, 64 rows, 32-key tiles (65 KB): the accumulator (80
//     registers) and Q (40) leave no room for 64 keys of S;
//   D 512 (the VAE's single-head mid attention): a [64, 512] float32
//     accumulator does not fit one warp's registers, so the work is split.
//     8 warps, 64 rows, 32-key tiles, Q scaled once into shared memory
//     (207 KB: one block an SM). For S the warps split over rows and keys
//     (4 x 2 tiles of 16 x 16), exchange the row max through shared memory
//     and write P (bf16) and each row's rescale there; for P V they split
//     over D, each owning 64 output columns of all 64 rows (128 float32
//     accumulators a thread).
// What bounds it on the H100: the tensor cores at D 64 to 512 (4 D
// multiply-adds a logit against one exponential); at D 40 the ex2 unit
// nearly as much: 160 MMA FLOP a logit (192 with the padding) meet one
// exponential, ~4 T ex2/s (16 a clock an SM) against ~6 T logits/s from
// the tensor cores, which puts the 4096-token CFG site's floor at
// ~0.07 ms. The design takes one MUFU op a logit and keeps the rest of the
// softmax (the FMA, the max, the sum, the conversion) on the FP32 pipes;
// wgmma with TMA and warp specialisation (FlashAttention-3's shape) is the
// next step for D 64/128.
//
// float32 inputs (no main path; the CPU-versus-card checks and the tests)
// keep an FMA schedule on the CUDA cores: the port holds float32 to 1e-4
// of the TPU kernel's exact float32, which TF32 or bf16 tensor cores would
// break. One block of 256 threads per (b, head, query tile); K/V tiles in
// shared memory (K rows padded by one word); TPR threads share a query row,
// each scoring BKT / TPR keys and owning D / TPR output dims, combining
// their max and sum with log2(TPR) warp shuffles in a fixed order. D <= 160:
// TPR = 4, 64 rows, 64-key tiles; D 512: 16 rows, 32-key tiles, TPR = 16
// (166 KB). For float32 the roundings of q * scale and p are the identity.
#include <cfloat>
#include <cmath>

#include "common.cuh"
#include "flash_tile.cuh"
#include "mma_sync.cuh"

namespace {

using vt_flash::ex2;
using vt_flash::kLog2e;
using vt_flash::load_rows;
using vt_flash::scaled_q;
using vt_gemm::cp_async16;
using vt_gemm::cp_async_commit;
using vt_gemm::cp_async_wait;
using vt_gemm::ldmatrix_x4;
using vt_gemm::ldmatrix_x4_trans;
using vt_gemm::mma_bf16;
using vt_gemm::pack_bf16;

// ------------------------------------------------------------ float32, FMA

constexpr int kThreads = 256;

template <int D, int TPR, int BKT>
constexpr size_t smem_bytes() {
  constexpr int BQ = kThreads / TPR;
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKT * (D + 1) + (size_t)BKT * D +
                          (size_t)BQ * (BKT + 1));
}

template <int D, int TPR, int BKT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 float* __restrict__ out, float* __restrict__ lse, int S, int Tk, int N, int KH,
                 int q_offset_host, const long long* __restrict__ q_offset_dev, float scale,
                 int causal, int use_shift, float shift) {
  constexpr int BQ = kThreads / TPR;  // query rows per block
  const int q_offset = q_offset_host + (q_offset_dev != nullptr ? (int)*q_offset_dev : 0);
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
    Qs[r * DP + d] = sq < S ? q[(((size_t)b * S + sq) * N + n) * D + d] * scale : 0.f;
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
      Ks[r * DP + d] = in ? k[off] : 0.f;
      Vs[r * D + d] = in ? v[off] : 0.f;
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
    float* o = out + (((size_t)b * S + sq) * N + n) * D;
#pragma unroll
    for (int dd = 0; dd < DQ; ++dd) o[sub + TPR * dd] = acc[dd] / denom;
    if (lse != nullptr && sub == 0)
      lse[((size_t)b * N + n) * S + sq] = (use_shift ? shift : m_i) + logf(denom);
  }
}

template <int D, int TPR = 4, int BKT = 64>
int launch_f32(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
               float* lse, int B, int S, int Tk, int N, int KH, int q_offset,
               const long long* q_offset_dev, float scale, int causal, int use_shift, float shift,
               cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, TPR, BKT>();
  constexpr int BQ = kThreads / TPR;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, TPR, BKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, N, B);
  flash_fwd_kernel<D, TPR, BKT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<float*>(out), lse, S, Tk, N, KH,
      q_offset, q_offset_dev, scale, causal, use_shift, shift);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bfloat16, mma.sync

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* kv_mask;  // [B, T] or null
  __nv_bfloat16* out;
  float* lse;              // [B, N, S] or null
  int S, Tk, N, KH, q_offset;
  const long long* q_offset_dev;  // added to q_offset when not null
  float scale;
  int causal, use_shift;
  float shift;
};

// the launch's Args with the device-held offset added to q_offset
__device__ __forceinline__ Args with_offset(const Args& in) {
  Args a = in;
  if (a.q_offset_dev != nullptr) a.q_offset += (int)*a.q_offset_dev;
  return a;
}

// 1 where key slot t exists and kv_mask lets it be seen
__device__ __forceinline__ uint8_t slot_ok(const Args& a, int b, int t) {
  return t < a.Tk && (a.kv_mask == nullptr || a.kv_mask[(size_t)b * a.Tk + t] != 0);
}

// (running max or shift) + log(denom), the TPU kernel's LSE; the running
// max of a row that saw no key is its -FLT_MAX, as in the TPU kernel
__device__ __forceinline__ float lse_of(const Args& a, float m, float denom) {
  return (a.use_shift ? a.shift : (m == -INFINITY ? -FLT_MAX : m)) + logf(denom);
}

// The online softmax of one tile for a thread's two rows, on S's C
// fragments s[NT][4] (rows g and g + 8): s becomes p, the running max m
// moves on, p is added to the partial sums l, and alpha -- on entry the
// tile's row max (running-max mode) -- becomes each row's rescale of the
// accumulator (1 with softmax_shift).
template <int NT>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  if (a.use_shift) {
    const float sl2 = a.shift * kLog2e, cap = 60.f * kLog2e;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fminf(fmaf(s[nt][e], kLog2e, -sl2), cap));
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    alpha[0] = alpha[1] = 1.f;
    return;
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], alpha[r]);  // alpha holds the tile's row max on entry
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: p and alpha 0
    alpha[r] = ex2((m[r] - m_use) * kLog2e);
    m[r] = m_new;
    mb[r] = m_use * kLog2e;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[nt][e], kLog2e, -mb[e >> 1]));
      s[nt][e] = p;
      ls[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

// the row max of a thread's S fragments over the quad (the 4 threads of a
// row), combined in a fixed order
template <int NT>
__device__ __forceinline__ void quad_row_max(const float (&s)[NT][4], float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// -inf where a (row, key) pair is not visible: rows q0 + g (+ 8), keys
// j0 + nt * 8 + 2t (+ 1) of the tile starting at slot t0; ok holds the
// tile's slot_ok bytes
template <int NT>
__device__ __forceinline__ void mask_tile(const Args& a, float (&s)[NT][4], const uint8_t* ok,
                                          int q0, int t0, int j0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + nt * 8 + 2 * tq + (e & 1);
      const int qpos = a.q_offset + q0 + g + (e >> 1) * 8;
      if (!ok[j] || (a.causal && qpos < t0 + j)) s[nt][e] = -INFINITY;
    }
}

template <int D, int WARPS, int MT, int BKT>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;  // depth padded to the MMA's 16
  static constexpr int P = DP + 8;               // shared row pitch (values)
  static constexpr int BQ = WARPS * MT * 16;     // MT m16 tiles a warp
  static constexpr int THREADS = WARPS * 32;
  // Q, then K and V in two stages each, then two stages of slot_ok bytes
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * ((size_t)BQ * P + 4 * (size_t)BKT * P) + 2 * BKT;
};

template <int D, int WARPS, int MT, int BKT>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_mma_kernel(const Args args) {
  const Args a = with_offset(args);
  using L = Tile<D, WARPS, MT, BKT>;
  constexpr int DP = L::DP, P = L::P, BQ = L::BQ, THREADS = L::THREADS;
  constexpr int KS = DP / 16;  // k-steps of Q K^T
  constexpr int NT = BKT / 8;  // n-tiles of S
  constexpr int DT = DP / 8;   // n-tiles of O
  static_assert(BKT % 16 == 0 && BKT <= THREADS, "tiling");
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [BQ][P]
  __nv_bfloat16* Ks = Qs + BQ * P;                                // [2][BKT][P]
  __nv_bfloat16* Vs = Ks + 2 * BKT * P;                           // [2][BKT][P]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + 2 * BKT * P);     // [2][BKT] slot_ok

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (a.N / a.KH);
  const int s0 = blockIdx.x * BQ;
  const int w0 = s0 + warp * MT * 16;  // the warp's first query row

  int n_tiles = (a.Tk + BKT - 1) / BKT;
  if (a.causal) n_tiles = min(n_tiles, (a.q_offset + min(a.S, s0 + BQ) - 1) / BKT + 1);

  load_rows<BQ, D, DP, P, THREADS>(Qs, a.q, b, s0, a.S, a.N, n, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<BKT, D, DP, P, THREADS>(Ks, a.k, b, 0, a.Tk, a.KH, kvh, tid);
    load_rows<BKT, D, DP, P, THREADS>(Vs, a.v, b, 0, a.Tk, a.KH, kvh, tid);
    if (tid < BKT) Ms[tid] = slot_ok(a, b, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // Q has landed

  unsigned qf[MT][KS][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(qf[mi][ks],
                  Qs + (w0 - s0 + mi * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[mi][ks][i] = scaled_q(qf[mi][ks][i], a.scale);
    }

  float o[MT][DT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o[mi][dt][0] = o[mi][dt][1] = o[mi][dt][2] = o[mi][dt][3] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) m[mi][0] = m[mi][1] = -INFINITY, l[mi][0] = l[mi][1] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, t0 = kt * BKT;
    uint8_t ok_next = 0;
    if (kt + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      load_rows<BKT, D, DP, P, THREADS>(Ks + (st ^ 1) * BKT * P, a.k, b, t0 + BKT, a.Tk, a.KH,
                                        kvh, tid);
      load_rows<BKT, D, DP, P, THREADS>(Vs + (st ^ 1) * BKT * P, a.v, b, t0 + BKT, a.Tk, a.KH,
                                        kvh, tid);
      if (tid < BKT) ok_next = slot_ok(a, b, t0 + BKT + tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt and its slot bytes are visible

    // rows at or past S, or all before the tile in causal order, skip it
    if (w0 < a.S && (!a.causal || a.q_offset + w0 + MT * 16 - 1 >= t0)) {
      const __nv_bfloat16* Kt = Ks + st * BKT * P;
      const __nv_bfloat16* Vt = Vs + st * BKT * P;
      float s[MT][NT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          s[mi][nt][0] = s[mi][nt][1] = s[mi][nt][2] = s[mi][nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned kf[4];  // each K fragment feeds MT row tiles
          ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + ks * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(s[mi][2 * np], qf[mi][ks], kf[0], kf[1]);
            mma_bf16(s[mi][2 * np + 1], qf[mi][ks], kf[2], kf[3]);
          }
        }
      const bool masked = a.kv_mask != nullptr || t0 + BKT > a.Tk ||
                          (a.causal && a.q_offset + w0 < t0 + BKT - 1);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (masked) mask_tile<NT>(a, s[mi], Ms + st * BKT, w0 + mi * 16, t0, 0, lane);
        float alpha[2];
        if (!a.use_shift) quad_row_max<NT>(s[mi], alpha);
        softmax_tile<NT>(a, s[mi], m[mi], l[mi], alpha);
        if (!a.use_shift) {
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            o[mi][dt][0] *= alpha[0], o[mi][dt][1] *= alpha[0];
            o[mi][dt][2] *= alpha[1], o[mi][dt][3] *= alpha[1];
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        unsigned pa[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          pa[mi][0] = pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
          pa[mi][1] = pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
          pa[mi][2] = pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
          pa[mi][3] = pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          unsigned vf[4];
          ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * P + dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(o[mi][2 * dp], pa[mi], vf[0], vf[1]);
            mma_bf16(o[mi][2 * dp + 1], pa[mi], vf[2], vf[3]);
          }
        }
      }
    }
    if (kt + 1 < n_tiles && tid < BKT) Ms[(st ^ 1) * BKT + tid] = ok_next;
    __syncthreads();  // stage st is free for tile kt + 2
  }

  if (w0 >= a.S) return;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mi][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = w0 + mi * 16 + g + r * 8;
      if (row >= a.S) continue;
      const float denom = fmaxf(lr, 1e-30f);
      __nv_bfloat16* op = a.out + (((size_t)b * a.S + row) * a.N + n) * D + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<unsigned*>(op + dt * 8) =
            pack_bf16(o[mi][dt][2 * r] / denom, o[mi][dt][2 * r + 1] / denom);
      if (a.lse != nullptr && tq == 0)
        a.lse[((size_t)b * a.N + n) * a.S + row] = lse_of(a, m[mi][r], denom);
    }
}

// D 512: S split over rows and keys, P V over the output columns
constexpr int k512Q = 64, k512K = 32, k512P = 512 + 8, k512PP = k512K + 8;
constexpr size_t k512Bytes = sizeof(__nv_bfloat16) * ((size_t)k512Q * k512P +
                                                      4 * (size_t)k512K * k512P +
                                                      (size_t)k512Q * k512PP) +
                             sizeof(float) * 5 * k512Q + 2 * k512K;

__global__ void __launch_bounds__(256, 1) flash_fwd_mma512_kernel(const Args args) {
  const Args a = with_offset(args);
  constexpr int D = 512, BQ = k512Q, BKT = k512K, P = k512P, PP = k512PP, THREADS = 256;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [BQ][P], scaled
  __nv_bfloat16* Ks = Qs + BQ * P;                             // [2][BKT][P]
  __nv_bfloat16* Vs = Ks + 2 * BKT * P;                        // [2][BKT][P]
  __nv_bfloat16* Ps = Vs + 2 * BKT * P;                        // [BQ][PP]
  float* red = reinterpret_cast<float*>(Ps + BQ * PP);         // [2][BQ] row max of a key half
  float* rs = red + 2 * BQ;                                    // [BQ] rescale, then denom
  float* lsum = rs + BQ;                                       // [2][BQ]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(lsum + 2 * BQ);     // [2][BKT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (a.N / a.KH);
  const int s0 = blockIdx.x * BQ;
  const int r0 = (warp & 3) * 16, kh = warp >> 2;  // S: rows r0.., keys kh * 16..
  const int c0 = warp * 64;                        // P V: output columns c0..

  int n_tiles = (a.Tk + BKT - 1) / BKT;
  if (a.causal) n_tiles = min(n_tiles, (a.q_offset + min(a.S, s0 + BQ) - 1) / BKT + 1);

  load_rows<BQ, D, D, P, THREADS>(Qs, a.q, b, s0, a.S, a.N, n, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<BKT, D, D, P, THREADS>(Ks, a.k, b, 0, a.Tk, a.KH, kvh, tid);
    load_rows<BKT, D, D, P, THREADS>(Vs, a.v, b, 0, a.Tk, a.KH, kvh, tid);
    if (tid < BKT) Ms[tid] = slot_ok(a, b, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // Q has landed: scale and round it in place
  for (int i = tid; i < BQ * D / 2; i += THREADS) {
    unsigned* p = reinterpret_cast<unsigned*>(Qs + (i / (D / 2)) * P) + i % (D / 2);
    *p = scaled_q(*p, a.scale);
  }

  float o[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) o[mi][dt][0] = o[mi][dt][1] = o[mi][dt][2] = o[mi][dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, t0 = kt * BKT;
    uint8_t ok_next = 0;
    if (kt + 1 < n_tiles) {
      load_rows<BKT, D, D, P, THREADS>(Ks + (st ^ 1) * BKT * P, a.k, b, t0 + BKT, a.Tk, a.KH,
                                       kvh, tid);
      load_rows<BKT, D, D, P, THREADS>(Vs + (st ^ 1) * BKT * P, a.v, b, t0 + BKT, a.Tk, a.KH,
                                       kvh, tid);
      if (tid < BKT) ok_next = slot_ok(a, b, t0 + BKT + tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, on the first, the scaled Q) is visible
    const __nv_bfloat16* Kt = Ks + st * BKT * P;
    const __nv_bfloat16* Vt = Vs + st * BKT * P;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 8
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned qa[4], kf[4];
      ldmatrix_x4(qa, Qs + (r0 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kf, Kt + (kh * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qa, kf[0], kf[1]);
      mma_bf16(s[1], qa, kf[2], kf[3]);
    }
    if (a.kv_mask != nullptr || t0 + BKT > a.Tk || (a.causal && a.q_offset + s0 < t0 + BKT - 1))
      mask_tile<2>(a, s, Ms + st * BKT, s0 + r0, t0, kh * 16, lane);
    float alpha[2];
    if (!a.use_shift) {
      quad_row_max<2>(s, alpha);
      if (tq == 0) red[kh * BQ + r0 + g] = alpha[0], red[kh * BQ + r0 + g + 8] = alpha[1];
      __syncthreads();  // both key halves' row max
      alpha[0] = fmaxf(alpha[0], red[(kh ^ 1) * BQ + r0 + g]);
      alpha[1] = fmaxf(alpha[1], red[(kh ^ 1) * BQ + r0 + g + 8]);
    }
    softmax_tile<2>(a, s, m, l, alpha);
    if (!a.use_shift && kh == 0 && tq == 0) rs[r0 + g] = alpha[0], rs[r0 + g + 8] = alpha[1];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<unsigned*>(Ps + (r0 + g + r * 8) * PP + kh * 16 + nt * 8 + 2 * tq) =
            pack_bf16(s[nt][2 * r], s[nt][2 * r + 1]);
    __syncthreads();  // P and the rescales are visible

    if (!a.use_shift) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float a0 = rs[mi * 16 + g], a1 = rs[mi * 16 + g + 8];
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          o[mi][dt][0] *= a0, o[mi][dt][1] *= a0;
          o[mi][dt][2] *= a1, o[mi][dt][3] *= a1;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      unsigned pa[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(pa[mi], Ps + (mi * 16 + (lane & 15)) * PP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * P + c0 + dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(o[mi][2 * dp], pa[mi], vf[0], vf[1]);
          mma_bf16(o[mi][2 * dp + 1], pa[mi], vf[2], vf[3]);
        }
      }
    }
    if (kt + 1 < n_tiles && tid < BKT) Ms[(st ^ 1) * BKT + tid] = ok_next;
    __syncthreads();  // stage st, P and the row max are free
  }

  // each row's l is the sum of its two key halves' partial sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (tq == 0) {
      lsum[kh * BQ + r0 + g + r * 8] = l[r];
      if (kh == 0) red[r0 + g + r * 8] = m[r];
    }
  }
  __syncthreads();
  if (tid < BQ) {
    const float denom = fmaxf(lsum[tid] + lsum[BQ + tid], 1e-30f);
    rs[tid] = denom;
    if (a.lse != nullptr && s0 + tid < a.S)
      a.lse[((size_t)b * a.N + n) * a.S + s0 + tid] = lse_of(a, red[tid], denom);
  }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = mi * 16 + g + r * 8;
      if (s0 + row >= a.S) continue;
      const float denom = rs[row];
      __nv_bfloat16* op = a.out + (((size_t)b * a.S + s0 + row) * a.N + n) * D + c0 + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<unsigned*>(op + dt * 8) =
            pack_bf16(o[mi][dt][2 * r] / denom, o[mi][dt][2 * r + 1] / denom);
    }
}

template <int D, int WARPS, int MT, int BKT>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  using L = Tile<D, WARPS, MT, BKT>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D, WARPS, MT, BKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + L::BQ - 1) / L::BQ, a.N, B);
  flash_fwd_mma_kernel<D, WARPS, MT, BKT><<<grid, L::THREADS, L::bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_mma512(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma512_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)k512Bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + k512Q - 1) / k512Q, a.N, B);
  flash_fwd_mma512_kernel<<<grid, 256, k512Bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// kv_mask is a [B, T] bool (one byte per slot) or null; lse a [B, N, S]
// float32 output or null; q_offset_dev a device int64 added to q_offset,
// or null. D must be one of 40, 64, 80, 128, 160, 512 and N a
// multiple of KH; bf16 q, k and v 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* kv_mask, void* out, void* lse, int B, int S,
                                      int Tk, int N, int KH, int D, int q_offset,
                                      const void* q_offset_dev, float scale, int causal,
                                      int use_shift, float shift, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* off = static_cast<const long long*>(q_offset_dev);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    switch (D) {
      case 40:
        return launch_f32<40>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, q_offset, off, scale,
                              causal, use_shift, shift, st);
      case 64:
        return launch_f32<64>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, q_offset, off, scale,
                              causal, use_shift, shift, st);
      case 80:
        return launch_f32<80>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, q_offset, off, scale,
                              causal, use_shift, shift, st);
      case 128:
        return launch_f32<128>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, q_offset, off, scale,
                               causal, use_shift, shift, st);
      case 160:
        return launch_f32<160>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, q_offset, off, scale,
                               causal, use_shift, shift, st);
      case 512:
        return launch_f32<512, 16, 32>(q, k, v, kv_mask, out, l, B, S, Tk, N, KH, q_offset, off,
                                       scale, causal, use_shift, shift, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_mask),
               static_cast<__nv_bfloat16*>(out), l, S, Tk, N, KH, q_offset, off, scale, causal,
               use_shift, shift};
  switch (D) {
    case 40:
      return launch_mma<40, 4, 2, 64>(a, B, st);
    case 64:
      return launch_mma<64, 4, 2, 64>(a, B, st);
    case 80:
      return launch_mma<80, 4, 1, 64>(a, B, st);
    case 128:
      return launch_mma<128, 4, 1, 64>(a, B, st);
    case 160:
      return launch_mma<160, 4, 1, 32>(a, B, st);
    case 512:
      return launch_mma512(a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
