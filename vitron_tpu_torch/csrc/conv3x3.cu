// 3x3 stride-1 SAME convolution (B9) for Hopper (sm_90a): wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel vitron_tpu/kernels/conv2d.py::_kernel (:39,
// pallas_call at :99 in _conv3x3 :70, entry conv3x3_same :150).
//
//   y[b, h, w, :] = sum_{dy, dx} x[b, h + dy - 1, w + dx - 1, :] @ w[dy, dx]
//   x [B, H, W, C] (NHWC) bf16, w [3, 3, C, D] (HWIO) bf16, zero outside the
//   image; y [B, H, W, D] in bf16 or float32
//
// The TPU kernel multiplies taps cast to bfloat16 (for float32 inputs too)
// and sums in float32; so does this one. The wrapper casts float32 x and w
// to bf16 once, before the launch, as JAX's _conv3x3 does in XLA, and asks
// for float32 output sums instead of bf16 ones.
//
// An implicit GEMM of M = B H W output pixels, depth K = 9C and D columns.
// A block owns 128 pixels x 128 columns. Its pixels are a rectangle of bb
// images x bh rows x bw columns (bb bh bw = 128, chosen by the wrapper's
// planner, kernels/conv2d.py::plan_boxes). The A tile of tap (dy, dx) and
// channels c0 .. c0 + 63 is one 4-D TMA box {64, bw, bh, bb} of x seen as
// [B, H, W, C] at (c0, w0 + dx - 1, h0 + dy - 1, b0): TMA fills the
// coordinates that leave the tensor with zeros, one dimension at a time, so
// SAME padding costs nothing and a row past H reads zero, never the next
// image; pixels of the rectangle outside the output are masked at the store.
// The B tile is w seen as [9C, D], rows t C + c0 .. + 63 (t = 3 dy + dx),
// two 2-D boxes of 64 columns: the MN-major layout wgmma reads with its
// transpose bit. Both land 128-byte swizzled in a ring of kStages stages of
// 32 KB, each tracked by a "full" mbarrier (the TMA bytes) and an "empty"
// one (both consumers done). One producer thread issues the loads; two
// consumer warpgroups each multiply 64 pixel rows x 128 columns with
// wgmma m64n128k16; setmaxnreg moves the producer's registers to them.
//
// Rounding: each k-block's four wgmma (64 deep) go into a fresh float32
// accumulator, which is then added with one float32 add into the running
// sum. The tensor cores' own accumulation truncates; over K = 9C up to
// 36,864 deep one chain of products drifts past float32's 1e-5, and a
// 64-deep chain followed by round-to-nearest adds does not. (Two partials
// a consumer, so that one k-block's products run while the previous one is
// added, measured no faster on the H100: PERF.md section 6.) Every output is
// summed in one fixed order (k-blocks tap-major), so a call gives the same
// bits twice.
//
// What bounds it on the H100: task G's 3x3 sites (2 x 16 frames of 64x64
// latents down to 8x8, C 640-2560) are 0.3-1.9 TFLOP each against
// 0.05-0.9 GB of x, w and y: bound by operations, at the bf16 tensor-core
// rate of 989 TFLOP/s. wgmma is the only way to that rate; TMA keeps the
// loads off the consumers' instruction stream.
#include "common.cuh"
#include "wgmma.cuh"

// a named namespace: nvcc's host stub of a kernel that takes a
// __grid_constant__ parameter cannot name a type of an anonymous one
namespace vt_b9 {

using namespace vt_wgmma;

constexpr int kBM = 128, kBN = 128, kBK = 64;  // kBK bf16 = one 128-byte swizzled row
constexpr int kStages = 6;
constexpr int kThreads = 384;  // consumers: warpgroups 0 and 1; producer: warpgroup 2
constexpr int kABytes = kBM * kBK * 2, kBBytes = kBK * kBN * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + alignment

struct ConvGeom {
  int B, H, W, C, D;
  int bb, bh, bw;          // pixel rectangle of a block
  int tiles_w, tiles_h;    // rectangles along W and H
};

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w, TOut* __restrict__ y,
                     ConvGeom g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* a_ring = smem;                               // kStages x [128 pixels][64 ch]
  uint8_t* b_ring = smem + kStages * kABytes;           // kStages x 2 x [64 k][64 d]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  // blocks in order (row tile, column tile), the column tile fastest: the
  // D / 128 blocks of one pixel rectangle run together and share its x in L2
  const int n_tiles = g.D / kBN;
  const int n0 = (int)(blockIdx.x % n_tiles) * kBN;
  int t = (int)(blockIdx.x / n_tiles);
  const int w0 = (t % g.tiles_w) * g.bw;
  t /= g.tiles_w;
  const int h0 = (t % g.tiles_h) * g.bh;
  const int b0 = (t / g.tiles_h) * g.bb;
  const int chunks = g.C / kBK;
  const int nk = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&tmap_x);
      tma_prefetch_map(&tmap_w);
      int tap = 0, c0 = 0, s = 0, phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        tma_load_4d(a_ring + s * kABytes, &tmap_x, &full[s], c0, w0 + dx - 1, h0 + dy - 1, b0);
        uint8_t* bs = b_ring + s * kBBytes;
        tma_load_2d(bs, &tmap_w, &full[s], n0, tap * g.C + c0);
        tma_load_2d(bs + kBBytes / 2, &tmap_w, &full[s], n0 + 64, tap * g.C + c0);
        c0 += kBK;
        if (c0 == g.C) {
          c0 = 0;
          ++tap;
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    int s = 0, phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], phase);
      const uint32_t a_addr = smem_u32(a_ring + s * kABytes) + wg * (64 * 128);
      const uint32_t b_addr = smem_u32(b_ring + s * kBBytes);
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        wgmma_m64n128k16_bf16_tn(part, desc_sw128(a_addr + k * 32, 16, 1024),
                                 desc_sw128(b_addr + k * 2048, kBBytes / 2, 1024), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }

    // epilogue: rows of this thread -> pixels of the rectangle, masked
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wg * 64 + warp * 16 + gq + half * 8;
      const int iw = r % g.bw, ih = (r / g.bw) % g.bh, ib = r / (g.bw * g.bh);
      const int b = b0 + ib, h = h0 + ih, w = w0 + iw;
      if (b >= g.B || h >= g.H || w >= g.W) continue;
      TOut* out = y + (((size_t)b * g.H + h) * g.W + w) * g.D + n0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store2(out + 8 * j, acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

template <typename TOut>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, void* y, const ConvGeom& g,
           unsigned blocks, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  conv3x3_wgmma_kernel<TOut><<<blocks, kThreads, kSmemBytes, st>>>(mx, mw, static_cast<TOut*>(y),
                                                                 g);
  return (int)cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace vt_b9

using namespace vt_b9;

// x [B, H, W, C] and w [3, 3, C, D] bfloat16, contiguous and 16-byte
// aligned, C a multiple of 64 and D of 128; y [B, H, W, D] float32 when
// out_f32, else bfloat16. (bb, bh, bw): powers of two with product 128, each
// at most 128 (TMA's box limit is 256). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for other shapes or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int vt_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int C,
                          int D, int bb, int bh, int bw, int out_f32, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || C % kBK || D % kBN ||
      !pow2(bb) || !pow2(bh) || !pow2(bw) || bb * bh * bw != kBM ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  const long long tiles_w = (W + bw - 1) / bw, tiles_h = (H + bh - 1) / bh,
                  tiles_b = (B + bb - 1) / bb;
  const long long row_tiles = tiles_w * tiles_h * tiles_b;
  const long long blocks = row_tiles * (D / kBN);
  if (9LL * C > 0x7fffffffLL || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                  (cuuint64_t)H * W * C * 2};
  const cuuint32_t xbox[4] = {kBK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bb};
  const cuuint64_t wdims[2] = {(cuuint64_t)D, 9 * (cuuint64_t)C};
  const cuuint64_t wstrides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t wbox[2] = {64, kBK};
  if (!vt_wgmma::encode_bf16_sw128(&mx, x, 4, xdims, xstrides, xbox) ||
      !vt_wgmma::encode_bf16_sw128(&mw, w, 2, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const ConvGeom g{B, H, W, C, D, bb, bh, bw, (int)tiles_w, (int)tiles_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<float>(mx, mw, y, g, (unsigned)blocks, st)
                 : launch<__nv_bfloat16>(mx, mw, y, g, (unsigned)blocks, st);
}
