// Depthwise 2D convolution for Hopper (sm_90a): NHWC, stride 1, SAME zero
// padding, odd square kernel k in {3, 5, 7, 9}; input rows streamed once.
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/depthwise_conv.py::_kernel
// (:35, pallas_call at :66 in _dw_pallas :54, entry depthwise_conv2d :138).
//
//   y[b, h, w, c] = sum_{dy, dx} xpad[b, h + dy, w + dx, c] * w[dy, dx, c]
//
// x, w and y are float or bfloat16 (one type; C contiguous), w is
// [k, k, C]; products and sums are float32, in JAX's tap order (dy, then
// dx), and y is rounded once to x's type. The bias is added by the caller,
// as in the JAX package (:157-159).
//
// What bounds it on the H100: 2 k^2 FLOP per output element on the CUDA
// cores (no matrix-product form for the tensor cores) against one read of x
// and one write of y: at FocalNet-L's k = 3..9 that is 18..162 FLOP per 4
// or 8 bytes, so the 67 TFLOP/s float32 rate bounds k >= 5 and the
// 3.35 TB/s device memory k = 3.
//
// Design. A block owns a group of CB channels (16 or 8 lanes of one
// 16-byte vector each: 8 bf16 or 4 float32 channels a thread), a strip of
// TW output columns and a segment of HS output rows of one image (the
// wrapper's planner, kernels/depthwise_conv.py::plan, sizes the grid to
// fill the 132 SMs). It walks down its segment: a cp.async ring of k + 1
// input rows (TW + k - 1 pixels of CB channels each, in the input type,
// zero-filled outside the image and past C) holds the k rows of the
// current output row while the next row is in flight, so each input row is
// read from device memory once per strip and segment (only the W halo and
// the k - 1 rows at a segment's edges are read again, from L2). The k x k
// taps of the group are copied to shared memory in the input type by the
// same cp.async wave as the first k rows: one memory latency before the
// first row. A thread
// computes 4 adjacent output columns of its vector: per tap row it loads
// the row's k taps once and slides along the k + 3 input vectors (16-byte
// shared loads, converted once), 4 k FMAs per channel, with no division in
// any loop. A ragged C (not a multiple of the vector) takes the same kernel
// one channel a lane (32 lanes), with plain loads in place of cp.async.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kCols = 4;  // adjacent output columns a thread computes
constexpr int kMaxThreads = 256;

// VEC values of T (16-byte aligned when VEC > 1) as float
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_f32(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
template <typename T>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[1]) {
  v[0] = vt::to_f32(*p);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(vt_gemm::pack_bf16(v[0], v[1]), vt_gemm::pack_bf16(v[2], v[3]),
                 vt_gemm::pack_bf16(v[4], v[5]), vt_gemm::pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[1]) {
  *p = vt::from_f32<T>(v[0]);
}

struct DwGeom {
  int H, W, C;
  int lanes, log2_lanes;  // CB = lanes * VEC channels a block
  int TW, HS, segs;       // output columns and rows a block; segments along H
};

// grid (channel groups, column strips, B * segs); blockDim lanes * TW / 4;
// dynamic shared memory: the ring, then the taps (see `smem_bytes`)
template <int K, typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
dw_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, DwGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = K / 2, R = K + 1;
  const int CB = g.lanes * VEC, TWp = g.TW + K - 1;
  T* ring = reinterpret_cast<T*>(smem);  // [R][TWp][CB]
  const size_t ring_bytes = ((size_t)R * TWp * CB * sizeof(T) + 15) & ~(size_t)15;
  T* ws = reinterpret_cast<T*>(smem + ring_bytes);  // [K * K][CB]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int c0 = blockIdx.x * CB, w0 = blockIdx.y * g.TW;
  const int b = blockIdx.z / g.segs, h0 = (blockIdx.z - b * g.segs) * g.HS;
  const int rows = min(g.HS, g.H - h0);
  const T* xb = x + (size_t)b * g.H * g.W * g.C;
  T* yb = y + (size_t)b * g.H * g.W * g.C;

  // input row h0 + rr - P of the strip into ring slot `slot`
  auto load_row = [&](int rr, int slot) {
    const int gh = h0 + rr - P;
    const bool row_ok = gh >= 0 && gh < g.H;
    const T* src_row = xb + (size_t)(row_ok ? gh : 0) * g.W * g.C;
    T* dst = ring + (size_t)slot * TWp * CB;
    for (int i = tid; i < TWp * g.lanes; i += nthreads) {
      const int p = i >> g.log2_lanes, l = i & (g.lanes - 1);
      const int gw = w0 + p - P, c = c0 + l * VEC;
      const bool ok = row_ok && gw >= 0 && gw < g.W && c < g.C;
      const T* src = ok ? src_row + (size_t)gw * g.C + c : x;
      if constexpr (VEC > 1) {
        vt_gemm::cp_async16(dst + p * CB + l * VEC, src, ok);
      } else {
        dst[p * CB + l] = ok ? *src : vt::from_f32<T>(0.f);
      }
    }
  };

  const int lane = tid & (g.lanes - 1), oc = (tid >> g.log2_lanes) * kCols;
  const int c_out = c0 + lane * VEC;

  for (int rr = 0; rr < K; ++rr) load_row(rr, rr);
  // the group's taps, zero past C, in the same wave as the first K rows
  for (int i = tid; i < K * K * g.lanes; i += nthreads) {
    const int t = i >> g.log2_lanes, l = i & (g.lanes - 1), c = c0 + l * VEC;
    T* dst = ws + t * CB + l * VEC;
    if constexpr (VEC > 1) {
      vt_gemm::cp_async16(dst, c < g.C ? w + (size_t)t * g.C + c : w, c < g.C);
    } else {
      *dst = c < g.C ? w[(size_t)t * g.C + c] : vt::from_f32<T>(0.f);
    }
  }
  vt_gemm::cp_async_commit();

  int s0 = 0;  // ring slot of output row r's first input row
  for (int r = 0; r < rows; ++r) {
    vt_gemm::cp_async_wait<0>();
    __syncthreads();  // rows r .. r + K - 1 landed; row r - 1's slot is free
    if (r + 1 < rows) load_row(r + K, s0 == 0 ? K : s0 - 1);
    vt_gemm::cp_async_commit();

    float acc[kCols][VEC];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[j][v] = 0.f;
    int s = s0;
#pragma unroll 1  // one tap row at a time: its K taps and K + kCols - 1 inputs in registers
    for (int dy = 0; dy < K; ++dy) {
      float wv[K][VEC];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) load_f32(ws + (dy * K + dx) * CB + lane * VEC, wv[dx]);
      const T* rp = ring + ((size_t)s * TWp + oc) * CB + lane * VEC;
#pragma unroll
      for (int j = 0; j < kCols + K - 1; ++j) {
        float xv[VEC];
        load_f32(rp + j * CB, xv);
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int col = j - dx;  // output column this input column feeds with tap dx
          if (col >= 0 && col < kCols) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[col][v] = fmaf(xv[v], wv[dx][v], acc[col][v]);
          }
        }
      }
      s = s + 1 == R ? 0 : s + 1;
    }

    if (c_out < g.C) {
      T* out = yb + ((size_t)(h0 + r) * g.W + w0 + oc) * g.C + c_out;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (w0 + oc + j < g.W) store_vec(out + (size_t)j * g.C, acc[j]);
    }
    s0 = s0 + 1 == R ? 0 : s0 + 1;
  }
}

template <int K, typename T, int VEC>
size_t smem_bytes(int lanes, int TW) {
  const size_t cb = (size_t)lanes * VEC;
  const size_t ring = ((K + 1) * (TW + K - 1) * cb * sizeof(T) + 15) & ~(size_t)15;
  return ring + (size_t)K * K * cb * sizeof(T);
}

template <int K, typename T, int VEC>
int launch(const void* x, const void* w, void* y, int B, const DwGeom& g, cudaStream_t stream) {
  const size_t smem = smem_bytes<K, T, VEC>(g.lanes, g.TW);
  const int threads = g.lanes * g.TW / kCols;
  const long long z = (long long)B * g.segs;
  if (g.TW % kCols || smem > 227 * 1024 || threads > kMaxThreads || z > 65535)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_rows_kernel<K, T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int cb = g.lanes * VEC;
  const dim3 grid((g.C + cb - 1) / cb, (g.W + g.TW - 1) / g.TW, (unsigned)z);
  dw_rows_kernel<K, T, VEC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dispatch_k(int K, const void* x, const void* w, void* y, int B, const DwGeom& g,
               cudaStream_t st) {
  switch (K) {
    case 3: return launch<3, T, VEC>(x, w, y, B, g, st);
    case 5: return launch<5, T, VEC>(x, w, y, B, g, st);
    case 7: return launch<7, T, VEC>(x, w, y, B, g, st);
    case 9: return launch<9, T, VEC>(x, w, y, B, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_vec(int vec, const void* x, const void* w, void* y, int B, int K,
                 const DwGeom& g, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    if (g.C % kVec || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(y) % 16)
      return (int)cudaErrorInvalidValue;
    return dispatch_k<T, kVec>(K, x, w, y, B, g, st);
  }
  if (vec == 1) return dispatch_k<T, 1>(K, x, w, y, B, g, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y [B, H, W, C]; w [K, K, C]. vec: channels a thread (16 bytes of x's
// type, or 1 for a C that is not a multiple of that); lanes (a power of
// two): threads across a block's channels; TW (a multiple of 4) output
// columns and HS output rows a block. is_bf16: x, w and y are bfloat16
// (else float). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int vt_depthwise_conv2d(const void* x, const void* w, void* y, int B, int H, int W,
                                   int C, int K, int vec, int lanes, int TW, int HS, int is_bf16,
                                   void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || lanes <= 0 || (lanes & (lanes - 1)) ||
      TW <= 0 || HS <= 0)
    return (int)cudaErrorInvalidValue;
  DwGeom g{H, W, C, lanes, __builtin_ctz((unsigned)lanes), TW, HS, (H + HS - 1) / HS};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_vec<__nv_bfloat16>(vec, x, w, y, B, K, g, st)
                 : dispatch_vec<float>(vec, x, w, y, B, K, g, st);
}
