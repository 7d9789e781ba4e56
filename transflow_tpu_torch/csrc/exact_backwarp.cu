// LiteFlowNet's exact bilinear backwarp for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes it with jnp ops
// (transflow_tpu/flow/estimators/liteflownet.py:106 backwarp, its
// unbounded path), which on the card were some 80 ATen launches a call.
// For every pixel (i, j) and channel c of an (H, W, C) image,
//
//   sx = j + fx         x0f = floor(sx)   wx = sx - x0f
//   sy = i + fy         y0f = floor(sy)   wy = sy - y0f
//   x0 = clamp(x0f, -1, W)   xc = clamp(x0, 0, W-1)   (and so on y)
//   t00 = img[yc, xc]        t01 = img[yc, xc+1]  (0 past the edge)
//   t10 = img[yc+1, xc]      t11 = img[yc+1, xc+1]
//   where x0 < 0: t01 -> t00, t11 -> t10; where y0 < 0: t10 -> t00,
//   t11 -> t01; where both: t11 -> t00
//   out = ((t00*(1-wx))*(1-wy))*inb(x0f, y0f)
//       + ((t01*wx)*(1-wy))*inb(x0f+1, y0f)
//       + ((t10*(1-wx))*wy)*inb(x0f, y0f+1)
//       + ((t11*wx)*wy)*inb(x0f+1, y0f+1)
//
// where (fx, fy) = flow[i, j] and inb is 1.0 where its point lies in the
// frame, else 0.0 (taken from the raw float floors). Every product and sum
// is rounded in that order (__fmul_rn / __fadd_rn, so nvcc fuses none into
// a multiply-add) and the additions go left to right: the result equals
// the plain PyTorch version of ops/warp.py bit for bit. The image is
// bfloat16 (widened exactly) or float32, its channels contiguous and its
// pixels ``pixel_stride`` elements apart (the 3-channel half of a
// 6-channel pair is read in place); flow is (H, W, 2) float32 (x, y); the
// output is (H, W, C) float32.
//
// Bound on the H100. At LiteFlowNet's level 2 of a 1088x1920 input
// (544x960x64, bf16 features) a launch reads the 67 MB image and 4 MB of
// flow and writes 134 MB: ~205 MB, ~61 us at 3.35 TB/s, against ~0.5
// GFLOP. So it is bound by device memory. The design is the bounded
// backwarp's (bounded_warp.cu): a block first computes each pixel's four
// tap offsets (after the edge fallbacks; -1 for a zero tap), its 1-wx, wx,
// 1-wy, wy and its four masks into shared memory once; its threads then
// cover the pixel's channels with 16-byte loads (8 bf16 or 4 f32) and
// 16-byte stores where C, the pixel stride and the alignment allow, else
// one channel a thread. Its cost does not depend on how far the flow
// reaches. Staging tiles with TMA, and fusing the regularization's
// distance into the warp, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPixels = kThreads;  // blocks hold at most one pixel a thread

struct Taps {
  long long off[4];  // element offset of each tap's channel 0, or -1
  float ax, wx, ay, wy;
  float mask[4];
};

// VEC channels from ``src`` as float, widened exactly.
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
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
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
    v[0] = *src;
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

__device__ __forceinline__ float inb(float x, float y, int H, int W) {
  return (x >= 0.f && x <= (float)(W - 1) && y >= 0.f &&
          y <= (float)(H - 1))
             ? 1.f
             : 0.f;
}

// Block: ``lanes`` threads along x cover one pixel's C / VEC channel
// vectors, ``blockDim.y`` pixels along y. Pixels are consecutive in the
// flattened (H, W) grid, so a block's output is one contiguous run.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    exact_backwarp_kernel(const T* __restrict__ image,
                          const float* __restrict__ flow,
                          float* __restrict__ out, int H, int W, int C,
                          int pixel_stride) {
  __shared__ Taps taps[kMaxPixels];
  const int pixels = blockDim.y;
  const long long p0 = (long long)blockIdx.x * pixels;
  const long long npix = (long long)H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  // phase 1: each pixel's anchor, tap offsets, fractions and masks, once
  if (tid < pixels && p0 + tid < npix) {
    const long long p = p0 + tid;
    const int i = (int)(p / W);
    const int j = (int)(p % W);
    const float sx = __fadd_rn((float)j, flow[2 * p]);
    const float sy = __fadd_rn((float)i, flow[2 * p + 1]);
    const float x0f = floorf(sx);
    const float y0f = floorf(sy);
    Taps t;
    t.wx = __fsub_rn(sx, x0f);
    t.wy = __fsub_rn(sy, y0f);
    t.ax = __fsub_rn(1.f, t.wx);
    t.ay = __fsub_rn(1.f, t.wy);
    // clamp in float before the conversion: x0f may lie far outside int
    const int x0 = (int)fminf(fmaxf(x0f, -1.f), (float)W);
    const int y0 = (int)fminf(fmaxf(y0f, -1.f), (float)H);
    const int xc = min(max(x0, 0), W - 1);
    const int yc = min(max(y0, 0), H - 1);
    const long long row = (long long)W * pixel_stride;
    const long long o00 = ((long long)yc * W + xc) * pixel_stride;
    const bool right = xc + 1 < W;
    const bool down = yc + 1 < H;
    const long long o01 = right ? o00 + pixel_stride : -1;
    const long long o10 = down ? o00 + row : -1;
    const long long o11 = right && down ? o00 + row + pixel_stride : -1;
    const bool mx = x0 < 0;
    const bool my = y0 < 0;
    t.off[0] = o00;
    t.off[1] = mx ? o00 : o01;
    t.off[2] = my ? o00 : o10;
    t.off[3] = mx && my ? o00 : mx ? o10 : my ? o01 : o11;
    const float x1f = __fadd_rn(x0f, 1.f);
    const float y1f = __fadd_rn(y0f, 1.f);
    t.mask[0] = inb(x0f, y0f, H, W);
    t.mask[1] = inb(x1f, y0f, H, W);
    t.mask[2] = inb(x0f, y1f, H, W);
    t.mask[3] = inb(x1f, y1f, H, W);
    taps[tid] = t;
  }
  __syncthreads();

  // phase 2: the pixel's channels, VEC at a time
  const int py = threadIdx.y;
  const long long p = p0 + py;
  if (p >= npix) return;
  const Taps& t = taps[py];
  const float wa[4] = {t.ax, t.wx, t.ax, t.wx};
  const float wb[4] = {t.ay, t.ay, t.wy, t.wy};
  const int nvec = C / VEC;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int c = v * VEC;
    float acc[VEC];
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
      for (int e = 0; e < VEC; ++e) {
        const float term = __fmul_rn(
            __fmul_rn(__fmul_rn(tap[e], wa[k]), wb[k]), t.mask[k]);
        acc[e] = k == 0 ? term : __fadd_rn(acc[e], term);
      }
    }
    store<VEC>(out + p * C + c, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* image, const float* flow, float* out, int H,
                   int W, int C, int pixel_stride, cudaStream_t stream) {
  const int nvec = C / VEC;
  const int lanes = nvec < 64 ? nvec : 64;
  const int pixels = kThreads / lanes;
  const long long npix = (long long)H * W;
  const long long blocks = (npix + pixels - 1) / pixels;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  exact_backwarp_kernel<T, VEC><<<(unsigned)blocks, dim3(lanes, pixels), 0,
                                  stream>>>(static_cast<const T*>(image),
                                            flow, out, H, W, C,
                                            pixel_stride);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. ``pixel_stride`` >= C: the
// elements from one pixel's channel 0 to the next's (rows W of them
// apart). Returns a cudaError_t.
extern "C" int transflow_exact_backwarp(const void* image, int dtype,
                                        int pixel_stride, const void* flow,
                                        void* out, int H, int W, int C,
                                        void* stream) {
  if (H < 1 || W < 1 || C < 1 || pixel_stride < C || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  // 16-byte vectors need 16-byte aligned taps: C and the pixel stride
  // multiples of the vector width and aligned base pointers (torch's
  // allocations are; views may not be)
  const bool aligned = (reinterpret_cast<uintptr_t>(image) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (dtype == 1) {
    if (aligned && C % 8 == 0 && pixel_stride % 8 == 0)
      return (int)launch<__nv_bfloat16, 8>(image, f, o, H, W, C,
                                           pixel_stride, s);
    return (int)launch<__nv_bfloat16, 1>(image, f, o, H, W, C, pixel_stride,
                                         s);
  }
  if (aligned && C % 4 == 0 && pixel_stride % 4 == 0)
    return (int)launch<float, 4>(image, f, o, H, W, C, pixel_stride, s);
  return (int)launch<float, 1>(image, f, o, H, W, C, pixel_stride, s);
}
