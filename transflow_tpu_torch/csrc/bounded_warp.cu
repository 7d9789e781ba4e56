// Bounded-displacement bilinear backwarp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of transflow_tpu/ops/pallas_warp.py
// (bounded_backwarp -> pallas_call with the body _make_kernel). It computes,
// for every pixel (i, j) and channel c of an (H, W, C) image,
//
//   y0 = clamp(floor(fy), -K, K)   wy = fy - floor(fy)
//   x0 = clamp(floor(fx), -K, K)   wx = fx - floor(fx)
//   out[i, j, c] = ((0 + img[i+y0,   j+x0,   c] * (1-wy)*(1-wx))
//                      + img[i+y0,   j+x0+1, c] * (1-wy)*wx)
//                      + img[i+y0+1, j+x0,   c] * wy*(1-wx))
//                      + img[i+y0+1, j+x0+1, c] * wy*wx
//
// where (fx, fy) = flow[i, j], img is the image rounded to bfloat16 and read
// as zero outside the frame. Weights and sums are float32, and the four
// terms are added in the Pallas kernel's (dy, dx) order with no fused
// multiply-add, so the result equals the plain PyTorch version of
// ops/warp.py bit for bit. The image is bfloat16, or float32 rounded to
// bfloat16 as it is loaded; flow is (H, W, 2) float32 (x, y); the output is
// (H, W, C) float32.
//
// Bound on the H100. At LiteFlowNet's level 2 of a 1088x1920 frame
// (544x960x64, bf16 image) a launch reads the 67 MB image (each tap row is
// read by up to four neighbouring output pixels, mostly from L2) and 4 MB
// of flow, and writes 134 MB of f32: ~205 MB, ~61 us at 3.35 TB/s. It does
// ~0.5 GFLOP. So it is bound by device memory. What the design does:
//  * no padded or staged copy of the image exists: taps outside the frame
//    are masked to zero, and an f32 image is rounded to bf16 in registers;
//  * the TPU kernel's (2K+2)^2 offset loop over a VMEM band, which exists
//    because the TPU has no per-element gather, becomes a direct gather:
//    the block first computes each pixel's four tap offsets and weights
//    once into shared memory, then its threads cover the pixel's channels
//    with 16-byte loads (8 bf16 or 4 f32) and 16-byte stores, neighbouring
//    threads on neighbouring addresses. Its cost does not depend on K or on
//    how the flow varies;
//  * when C is not a multiple of the vector width, or the image is not
//    16-byte aligned, the same kernel runs one channel per thread.
// Staging tiles with cp.async or TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPixels = kThreads;  // blocks hold at most one pixel a thread

struct Tap {
  long long off[4];  // element offset of each tap's channel 0, or -1
  float w[4];
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC channels from ``src`` as float, bf16-rounded.
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* src, float* v) {
    const float4 raw = *reinterpret_cast<const float4*>(src);
    v[0] = bf16_round(raw.x);
    v[1] = bf16_round(raw.y);
    v[2] = bf16_round(raw.z);
    v[3] = bf16_round(raw.w);
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* v) {
    v[0] = __bfloat162float(*src);
  }
};

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* src, float* v) {
    v[0] = bf16_round(*src);
  }
};

template <int VEC>
__device__ __forceinline__ void store(float* dst, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[k] = v[k];
  }
}

// Block: ``lanes`` threads along x cover one pixel's C / VEC channel
// vectors, ``blockDim.y`` pixels along y. Pixels are consecutive in the
// flattened (H, W) grid, so a block's output is one contiguous run.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bounded_backwarp_kernel(const T* __restrict__ image,
                            const float* __restrict__ flow,
                            float* __restrict__ out, int H, int W, int C,
                            int bound) {
  __shared__ Tap taps[kMaxPixels];
  const int pixels = blockDim.y;
  const long long p0 = (long long)blockIdx.x * pixels;
  const long long npix = (long long)H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  // phase 1: each pixel's clamped floors, tap offsets and weights, once
  if (tid < pixels && p0 + tid < npix) {
    const long long p = p0 + tid;
    const int i = (int)(p / W);
    const int j = (int)(p % W);
    const float fx = flow[2 * p];
    const float fy = flow[2 * p + 1];
    const float x0f = floorf(fx);
    const float y0f = floorf(fy);
    const float wx = fx - x0f;
    const float wy = fy - y0f;
    const float kb = (float)bound;
    const int x0 = (int)fminf(fmaxf(x0f, -kb), kb);
    const int y0 = (int)fminf(fmaxf(y0f, -kb), kb);
    const float ax = 1.f - wx;
    const float ay = 1.f - wy;
    Tap t;
    t.w[0] = __fmul_rn(ay, ax);
    t.w[1] = __fmul_rn(ay, wx);
    t.w[2] = __fmul_rn(wy, ax);
    t.w[3] = __fmul_rn(wy, wx);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int y = i + y0 + (k >> 1);
      const int x = j + x0 + (k & 1);
      t.off[k] = (y >= 0 && y < H && x >= 0 && x < W)
                     ? ((long long)y * W + x) * C
                     : -1;
    }
    taps[tid] = t;
  }
  __syncthreads();

  // phase 2: the pixel's channels, VEC at a time
  const int py = threadIdx.y;
  const long long p = p0 + py;
  if (p >= npix) return;
  const Tap& t = taps[py];
  const int nvec = C / VEC;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int c = v * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float tap[VEC];
      if (t.off[k] >= 0) {
        Loader<T, VEC>::load(image + t.off[k] + c, tap);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tap[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(tap[e], t.w[k]));
    }
    store<VEC>(out + p * C + c, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* image, const float* flow, float* out, int H,
                   int W, int C, int bound, cudaStream_t stream) {
  const int nvec = C / VEC;
  const int lanes = nvec < 64 ? nvec : 64;
  const int pixels = kThreads / lanes;
  const long long npix = (long long)H * W;
  const long long blocks = (npix + pixels - 1) / pixels;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bounded_backwarp_kernel<T, VEC><<<(unsigned)blocks, dim3(lanes, pixels),
                                    0, stream>>>(
      static_cast<const T*>(image), flow, out, H, W, C, bound);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int transflow_bounded_backwarp(const void* image, int dtype,
                                          const void* flow, void* out, int H,
                                          int W, int C, int bound,
                                          void* stream) {
  if (H < 1 || W < 1 || C < 1 || bound < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  // 16-byte vectors need 16-byte aligned rows: C a multiple of the vector
  // width and aligned base pointers (torch's allocations are; views may
  // not be)
  const bool aligned = (reinterpret_cast<uintptr_t>(image) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (dtype == 1) {
    if (aligned && C % 8 == 0)
      return (int)launch<__nv_bfloat16, 8>(image, f, o, H, W, C, bound, s);
    return (int)launch<__nv_bfloat16, 1>(image, f, o, H, W, C, bound, s);
  }
  if (aligned && C % 4 == 0)
    return (int)launch<float, 4>(image, f, o, H, W, C, bound, s);
  return (int)launch<float, 1>(image, f, o, H, W, C, bound, s);
}
