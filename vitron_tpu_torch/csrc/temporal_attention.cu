// Per-pixel frame attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// vitron_tpu/kernels/temporal_attention.py::_kernel (:45, pallas_call at :97
// in _fwd :87, entry frame_attention :150).
//
//   for every (b, pixel n, head h), with q, k, v, o the [F, D] slices
//   x[b, :, n, h*D : (h+1)*D] of [B, F, N, H*D] tensors:
//   o = softmax_over_frames((q @ k^T) * scale) @ v
//
// float32 scores, an exact float32 softmax (max-subtracted, normalised
// before the product with v), float32 probabilities in the product with v
// (as the Pallas kernel's s_ref keeps them: rounding them to bf16 would
// change the function), o rounded to the input type.
//
// What bounds it on the H100: one (b, n, h) is F x F x D x 4 FLOP (24 x 24 x
// 64 at the video UNet: 147 kFLOP) against 4 x F x D values in and out: 6
// FLOP a float32 byte, under the card's 20 (67 TFLOP/s of float32 FMA over
// 3.35 TB/s), so it is bound by the bytes moved -- if enough of them are in
// flight. Each item's q, k and v are F rows of D contiguous values, frames
// N x H x D apart, read in place from the [B, F, N, H*D] layout.
//
// The design keeps the loads in flight and the shared-memory traffic per
// FMA low:
// - one warp owns a stream of items (a block of its own; no block barrier)
//   and copies them into shared memory with 16-byte cp.async, in their
//   input type: the next item's q and k while it computes the current one
//   (two stages), and the current item's v while its scores and softmax run
//   (one stage, refilled once its product is done). Rows are padded by 16
//   bytes (an odd number of 16-byte units), so 8 lanes reading 8 rows at one
//   depth hit distinct banks. The grid holds as many warps as the shared
//   memory lets reside on every SM (6 in float32 and 11 in bf16 at F 24,
//   D 64), each walking the items with the grid's stride.
// - scores: lane (key group g, quarter) sums keys g, g + 8, .. against every
//   query row over a quarter of the depths, so each q value a quarter-warp
//   reads (a broadcast) feeds F / 8 FMAs a lane; two shuffles add the
//   quarters.
// - softmax: the scaled scores go to a key-major [F][F] float32 buffer; lane
//   i then owns query row i (consecutive words across lanes): max, exp, sum
//   and division run in the lane, with no shuffles.
// - P V: lane (row group, depth group g) sums F / 4 query rows at depth
//   chunks g, g + 8, ..: each probability read (a broadcast to a quarter)
//   feeds D / 8 FMAs and each v chunk F / 4; whole 16-byte output chunks are
//   stored.
// F <= 32 (bucketed into 8/16/24/32 at compile time); D in {32, 64, 128}.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using vt_gemm::cp_async16;
using vt_gemm::cp_async_commit;
using vt_gemm::cp_async_wait;

constexpr int kMaxF = 32;

template <typename T, int D>
struct Shape {
  static constexpr int kRow = D * (int)sizeof(T) + 16;     // staged row pitch (bytes)
  static constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  static constexpr int kVec = 16 / (int)sizeof(T);         // values a chunk
};

// the [F][p_pitch] float32 score / probability buffer, key-major: a pitch of
// 4 mod 8 floats puts the 8 key rows a quarter-warp writes in distinct banks
__host__ __device__ constexpr int p_pitch(int F) { return (F + 7) / 8 * 8 + 4; }

// bytes of one warp's shared memory: two stages of q and k rows, one of v
// rows and the probability buffer
template <typename T, int D>
__host__ __device__ constexpr int warp_bytes(int F) {
  return 5 * F * Shape<T, D>::kRow + F * p_pitch(F) * 4;
}

// N consecutive values (16 or 8 bytes) as float32
template <int N>
__device__ __forceinline__ void load_f32(const float* src, float* dst) {
  static_assert(N == 4, "4 float32 values: one 16-byte load");
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* src, float* dst) {
  static_assert(N == 4 || N == 8, "4 or 8 bf16 values: one 8- or 16-byte load");
  unsigned w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// N float32 values rounded to T, one 16- or 8-byte store
template <int N>
__device__ __forceinline__ void store_from_f32(float* dst, const float* v) {
  static_assert(N == 4, "4 float32 values: one 16-byte store");
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
template <int N>
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* dst, const float* v) {
  unsigned w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) w[i] = vt_gemm::pack_bf16(v[2 * i], v[2 * i + 1]);
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// one warp a block; KF in {8, 16, 24, 32} the frame bucket, F <= KF
template <typename T, int D, int KF>
__global__ void __launch_bounds__(32)
frame_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int F, int N, int H,
                       int items, float scale) {
  using S = Shape<T, D>;
  constexpr int KPL = KF / 8;   // scores: keys a lane (8 key groups) ...
  constexpr int DPP = D / 4;    // ... over a quarter of the depths (4 quarters)
  constexpr int RI = KF / 4;    // P V: query rows a lane (4 row groups) ...
  constexpr int CV = S::kVec < D / 8 ? S::kVec : D / 8;  // ... and D / 8 depths, in
  constexpr int NC = D / 8 / CV;                         // NC chunks of CV values
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int grp = lane & 7, quarter = lane >> 3;
  const int PP = p_pitch(F);
  const int stage_bytes = 2 * F * S::kRow;                      // q, k of one item
  unsigned char* vs = smem + 2 * stage_bytes;                    // v of the current item
  float* pt = reinterpret_cast<float*>(vs + F * S::kRow);        // [key][query]

  const size_t hd = (size_t)H * D;
  const size_t frame_stride = (size_t)N * hd;
  auto base_of = [&](int item) {
    const int h = item % H, bn = item / H;
    return ((size_t)(bn / N) * F * N + bn % N) * hd + (size_t)h * D;
  };
  // the F rows of one [F, D] slice into shared memory, 16 bytes a copy
  auto issue = [&](unsigned char* dst, const T* src) {
    for (int c = lane; c < F * S::kChunks; c += 32) {
      const int f = c / S::kChunks, ch = c % S::kChunks;
      cp_async16(dst + f * S::kRow + ch * 16, src + f * frame_stride + ch * S::kVec, true);
    }
  };
  // copy groups, in commit order: qk(n) v(n) qk(n+1) v(n+1) ..: q and k of
  // the next item land while this one computes, v while its scores do
  auto issue_qk = [&](unsigned char* st, int item) {
    if (item < items) {
      const size_t base = base_of(item);
      issue(st, q + base);
      issue(st + F * S::kRow, k + base);
    }
    cp_async_commit();
  };
  auto issue_v = [&](int item) {
    if (item < items) issue(vs, v + base_of(item));
    cp_async_commit();
  };

  int cur = 0;
  issue_qk(smem, blockIdx.x);
  issue_v(blockIdx.x);
  for (int item = blockIdx.x; item < items; item += gridDim.x, cur ^= 1) {
    issue_qk(smem + (cur ^ 1) * stage_bytes, item + gridDim.x);
    cp_async_wait<2>();  // q and k of this item
    __syncwarp();
    const unsigned char* qs = smem + cur * stage_bytes;
    const unsigned char* ks = qs + F * S::kRow;

    // scores: lane (key group grp, quarter) sums keys grp + 8r against every
    // query row over its quarter of the depths; a quarter-warp reads one q
    // address (a broadcast), its 8 lanes 8 k rows (distinct banks: the row
    // pitch is an odd number of 16-byte units)
    float sc[KPL][KF];
#pragma unroll
    for (int r = 0; r < KPL; ++r)
#pragma unroll
      for (int i = 0; i < KF; ++i) sc[r][i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPP; c += S::kVec) {
      const int d = quarter * DPP + c;
      float kv[KPL][S::kVec];
#pragma unroll
      for (int r = 0; r < KPL; ++r) {
        const int key = grp + 8 * r < F ? grp + 8 * r : 0;
        load_f32<S::kVec>(reinterpret_cast<const T*>(ks + key * S::kRow) + d, kv[r]);
      }
#pragma unroll
      for (int i = 0; i < KF; ++i) {
        if (i < F) {
          float qv[S::kVec];
          load_f32<S::kVec>(reinterpret_cast<const T*>(qs + i * S::kRow) + d, qv);
#pragma unroll
          for (int r = 0; r < KPL; ++r)
#pragma unroll
            for (int e = 0; e < S::kVec; ++e) sc[r][i] = fmaf(qv[e], kv[r][e], sc[r][i]);
        }
      }
    }
#pragma unroll
    for (int off = 8; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < KPL; ++r)
#pragma unroll
        for (int i = 0; i < KF; ++i) sc[r][i] += __shfl_xor_sync(0xffffffffu, sc[r][i], off);
    // the scaled scores, pt[key][query]: each quarter writes a quarter of the queries
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int key = grp + 8 * r;
#pragma unroll
      for (int i = 0; i < KF; ++i)
        if (key < F && i < F && (i & 3) == quarter) pt[key * PP + i] = sc[r][i] * scale;
    }
    __syncwarp();

    // softmax of query row `lane` over the F keys, in place (lanes read
    // consecutive words: no bank conflicts); normalised by the rounded
    // reciprocal of the sum, within an ulp of the division
    if (lane < F) {
      float mx = -__int_as_float(0x7f800000);
#pragma unroll 4
      for (int j = 0; j < F; ++j) mx = fmaxf(mx, pt[j * PP + lane]);
      float sum = 0.f;
#pragma unroll 4
      for (int j = 0; j < F; ++j) {
        const float e = expf(pt[j * PP + lane] - mx);
        pt[j * PP + lane] = e;
        sum += e;
      }
      const float inv = 1.f / sum;
#pragma unroll 4
      for (int j = 0; j < F; ++j) pt[j * PP + lane] *= inv;
    }
    cp_async_wait<1>();  // v of this item
    __syncwarp();

    // P V: lane (row group quarter, depth group grp) sums query rows
    // quarter * RI + r at depth chunks grp + 8c (8 lanes read 8 consecutive
    // chunks of a v row: distinct banks); a quarter-warp reads one address of
    // the probabilities at a time (a broadcast)
    float acc[RI][NC * CV];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int e = 0; e < NC * CV; ++e) acc[r][e] = 0.f;
#pragma unroll 4
    for (int j = 0; j < F; ++j) {
      float vv[NC * CV];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        load_f32<CV>(reinterpret_cast<const T*>(vs + j * S::kRow) + (grp + 8 * c) * CV,
                     vv + c * CV);
      float p[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) p[r] = pt[j * PP + quarter * RI + r];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int e = 0; e < NC * CV; ++e) acc[r][e] = fmaf(p[r], vv[e], acc[r][e]);
    }
    const size_t base = base_of(item);
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int i = quarter * RI + r;
      if (i < F) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          store_from_f32<CV>(o + base + i * frame_stride + (grp + 8 * c) * CV, acc[r] + c * CV);
      }
    }
    __syncwarp();  // v, pt and stage `cur` are rewritten next
    issue_v(item + gridDim.x);
  }
  cp_async_wait<0>();
}

template <typename T, int D, int KF>
int launch(const void* q, const void* k, const void* v, void* o, int B, int F, int N, int H,
           float scale, cudaStream_t stream) {
  auto kernel = frame_attention_kernel<T, D, KF>;
  static bool attr_set = false;  // per instantiation: set for the bucket's largest F
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, warp_bytes<T, D>(KF));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int bytes = warp_bytes<T, D>(F);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * N * H;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)sms * per_sm;
  const int warps = (int)(items < resident ? items : resident);
  kernel<<<warps, 32, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(o), F, N, H,
                                       (int)items, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_frames(const void* q, const void* k, const void* v, void* o, int B, int F, int N, int H,
              float scale, cudaStream_t st) {
  if (F <= 8) return launch<T, D, 8>(q, k, v, o, B, F, N, H, scale, st);
  if (F <= 16) return launch<T, D, 16>(q, k, v, o, B, F, N, H, scale, st);
  if (F <= 24) return launch<T, D, 24>(q, k, v, o, B, F, N, H, scale, st);
  return launch<T, D, 32>(q, k, v, o, B, F, N, H, scale, st);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int F, int N, int H,
             int D, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return by_frames<T, 32>(q, k, v, o, B, F, N, H, scale, st);
    case 64: return by_frames<T, 64>(q, k, v, o, B, F, N, H, scale, st);
    case 128: return by_frames<T, 128>(q, k, v, o, B, F, N, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, F, N, H*D] contiguous, 16-byte aligned; 1 <= F <= 32, D in
// {32, 64, 128}. Returns cudaGetLastError() after the launch.
extern "C" int vt_frame_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int F, int N, int H, int D, float scale, int is_bf16,
                                  void* stream) {
  if (B <= 0 || F <= 0 || F > kMaxF || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, F, N, H, D, scale, st)
                 : dispatch<float>(q, k, v, o, B, F, N, H, D, scale, st);
}
