// Lucas-Kanade's hot loops for Hopper (sm_90a): kernels B13, B11 and B12.
//
// They replace jnp code that XLA compiles (there is no Pallas source) in
// transflow_tpu/flow/estimators/lucas_kanade.py's ``_lk_level`` (:32-62):
//  * B13 ``lk_scharr_kernel``: the level's two Scharr derivatives (:34-35,
//    ``_scharr`` at :26): ix is [-3, 0, 3] / 32 along x, then [3, 10, 3]
//    along y; iy the same with the axes swapped; each pass pads with
//    numpy's symmetric mode of width 1 (the edge sample repeats, so a
//    padded index is the clamped one);
//  * B11 ``lk_warp_products_kernel``: the loop body's (:49) warp and
//    products (:50-54): the second image sampled at (y + v, x + u) by
//    ``bilinear_sample_packed``'s rule (ops/image.py:265; the anchor floor
//    clamped to the frame, the weights from the unclamped coordinate, the
//    +1 taps edge-replicated, rows' x lerp first; the tap pack itself is a
//    TPU workaround, so the raw image is read), it = warped - prev, and
//    the planes ix * it and iy * it;
//  * B12 ``lk_window_kernel``: the body's rest (:53-60), the box sums of
//    those planes (zero padding, the vertical sum then the horizontal
//    one), b = -sums, du = (g22 * b1 - g12 * b2) * inv_det and dv, zeroed
//    where du^2 + dv^2 < eps^2, added to the flow; and, once per level,
//    the structure tensor (:36-42): the box sums of ix * ix, ix * iy and
//    iy * iy, det and inv_det = 1 / det where det > 1e-6, else 0.
//
// Numbers. Every product and sum is rounded to float32 (__fmul_rn,
// __fadd_rn: no contraction into FMAs) in the order of the plain versions
// in ops/lucas_kanade.py: B13's three taps in order, the zero tap's
// product included (it decides the sign of a zero sum), the first pass's
// three values, then the second pass's; the window's rows in order, then
// its columns in order; the lerps and the solve in the JAX expressions' order; 1 / det is
// the IEEE division (built without --use_fast_math). So each kernel equals
// its plain version bit for bit. A huge or infinite coordinate saturates
// at the frame's edge (fminf/fmaxf before the conversion) and a NaN one
// anchors at 0 (fmaxf(NaN, 0) is 0): its weights are NaN, so is the sample.
//
// Bounds on the H100 per launch at 1080x1920 (2.07 Mpixel), bytes each
// read or written once. B13 reads the level (4) and writes ix and iy (8):
// 12 B/pixel, ~0.0074 ms; its 20 float32 operations a pixel (5 a pass and
// derivative) take ~0.0006 ms: bound by bytes. Its design: a block of 32x8
// threads makes a 32 x 16 output tile from the (16 + 2) x (32 + 2) level
// values staged once in shared memory with their clamped halo, each
// thread two rows, each output's three first-pass values of each
// derivative from the stage (no second buffer), ix and iy stored
// coalesced along x. B11 reads prev, ix, iy, the flow and the sampled
// image (4 + 4 + 4 + 8 + 4) and writes two planes (8): 32 B/pixel, ~0.020
// ms. B12 reads two planes, the four tensor planes and the flow (8 + 16 +
// 8) and writes the flow (8): 40 B/pixel, ~0.025 ms; in its tensor mode it
// reads ix and iy and writes four planes, 24 B/pixel. Its sums are 2 * 2 *
// 14 adds a pixel (3 * 2 * 14 and three products in the tensor mode),
// ~0.002 ms of float32 operations: bound by bytes. What the design does: a
// block of 32x8 threads makes a 16x32 output tile; it stages the two input
// planes with the window's halo in shared memory (zeros outside the frame)
// so each input byte is read from device memory about once, takes the
// vertical sums of every staged column there, then the horizontal sums of
// its outputs, reading the tensor and the flow and writing the flow
// coalesced along x. The tap count is a template parameter for cv2's
// default window of 15 (the loops unroll; 20 KB of shared memory a block
// in the tensor mode), else a runtime count up to 63 (77 KB at 63).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kTileH = 2 * kBlockY;
constexpr int kTileW = kBlockX;
constexpr int kMaxTaps = 63;   // ops/lucas_kanade.py: MAX_WINDOW
constexpr int kWinTaps = 15;   // cv2's default window

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// B13's output tile and taps (ops/lucas_kanade.py: SCHARR, SCHARR_SMOOTH)
constexpr int kScharrH = 2 * kBlockY;
constexpr int kScharrW = kBlockX;
constexpr float kD0 = -0.09375f, kD1 = 0.0f, kD2 = 0.09375f;
constexpr float kS0 = 3.0f, kS1 = 10.0f, kS2 = 3.0f;

// one pass's three taps in order from the first: ((a d0 + b d1) + c d2)
__device__ __forceinline__ float taps3(float a, float b, float c, float t0,
                                       float t1, float t2) {
  return add(add(mul(a, t0), mul(b, t1)), mul(c, t2));
}

__global__ void __launch_bounds__(kThreads)
    lk_scharr_kernel(const float* __restrict__ image, float* __restrict__ ix,
                     float* __restrict__ iy, int H, int W) {
  // stage row t, column s: the level at (i0 - 1 + t, j0 - 1 + s), each
  // index clamped to the level (numpy's symmetric pad of width 1)
  __shared__ float stage[kScharrH + 2][kScharrW + 2];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int i0 = blockIdx.y * kScharrH, j0 = blockIdx.x * kScharrW;
  constexpr int kStageW = kScharrW + 2;
  for (int e = tid; e < (kScharrH + 2) * kStageW; e += kThreads) {
    const int t = e / kStageW, s = e - t * kStageW;
    const int gi = min(max(i0 - 1 + t, 0), H - 1);
    const int gj = min(max(j0 - 1 + s, 0), W - 1);
    stage[t][s] = image[(long long)gi * W + gj];
  }
  __syncthreads();
  const int q = threadIdx.x, j = j0 + q;
  if (j >= W) return;
  for (int r = threadIdx.y; r < kScharrH; r += kBlockY) {
    const int i = i0 + r;
    if (i >= H) return;
    // stage rows r..r+2 are the level's rows i-1..i+1, columns q..q+2 its
    // columns j-1..j+1 (clamped): the derivative's pass at the three
    // neighbours along the other axis, then the smoothing pass
    float dx[3], dy[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dx[k] = taps3(stage[r + k][q], stage[r + k][q + 1], stage[r + k][q + 2],
                    kD0, kD1, kD2);
      dy[k] = taps3(stage[r][q + k], stage[r + 1][q + k], stage[r + 2][q + k],
                    kD0, kD1, kD2);
    }
    const long long p = (long long)i * W + j;
    ix[p] = taps3(dx[0], dx[1], dx[2], kS0, kS1, kS2);
    iy[p] = taps3(dy[0], dy[1], dy[2], kS0, kS1, kS2);
  }
}

__global__ void __launch_bounds__(kThreads)
    lk_warp_products_kernel(const float* __restrict__ prev,
                            const float* __restrict__ nxt,
                            const float* __restrict__ ix,
                            const float* __restrict__ iy,
                            const float2* __restrict__ flow,
                            float* __restrict__ out, int H, int W) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= H || j >= W) return;
  const long long p = (long long)i * W + j;
  const float2 f = flow[p];
  const float y = add((float)i, f.y);
  const float x = add((float)j, f.x);
  const float y0f = floorf(y), x0f = floorf(x);
  const float wy = sub(y, y0f), wx = sub(x, x0f);
  const int y0 = (int)fminf(fmaxf(y0f, 0.f), (float)(H - 1));
  const int x0 = (int)fminf(fmaxf(x0f, 0.f), (float)(W - 1));
  const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);
  const float* row0 = nxt + (long long)y0 * W;
  const float* row1 = nxt + (long long)y1 * W;
  const float ax = sub(1.f, wx), ay = sub(1.f, wy);
  const float top = add(mul(__ldg(row0 + x0), ax), mul(__ldg(row0 + x1), wx));
  const float bot = add(mul(__ldg(row1 + x0), ax), mul(__ldg(row1 + x1), wx));
  const float warped = add(mul(top, ay), mul(bot, wy));
  const float it = sub(warped, prev[p]);
  out[p] = mul(ix[p], it);
  out[(long long)H * W + p] = mul(iy[p], it);
}

// The shared memory of a block of lk_window_kernel: both staged input
// planes, (kTileH + taps - 1) x (kTileW + taps - 1) floats each, then the
// vertical sums, ``sums`` planes of kTileH x (kTileW + taps - 1)
__host__ __device__ constexpr int window_smem_floats(int taps, int sums) {
  return (2 * (kTileH + taps - 1) + sums * kTileH) * (kTileW + taps - 1);
}

// kTaps: the window's taps, or 0 for a runtime count ``taps_rt`` (up to
// kMaxTaps). kTensor: the structure tensor of (in0, in1) = (ix, iy) into
// out_tensor; else the solve of the products (in0, in1) with ``tensor``
// and ``flow`` into out_flow. ``threshold``: det's floor in the tensor
// mode, eps^2 in the solve.
template <int kTaps, bool kTensor>
__global__ void __launch_bounds__(kThreads)
    lk_window_kernel(const float* __restrict__ in0,
                     const float* __restrict__ in1,
                     const float* __restrict__ tensor,
                     const float2* __restrict__ flow,
                     float* __restrict__ out_tensor,
                     float2* __restrict__ out_flow, int H, int W, int taps_rt,
                     float threshold) {
  constexpr int kSums = kTensor ? 3 : 2;
  extern __shared__ float smem[];
  // a compile-time count where kTaps is one: the loops below unroll
  const int taps = kTaps > 0 ? kTaps : taps_rt;
  const int lo = (taps - 1) / 2;
  const int staged_h = kTileH + taps - 1, staged_w = kTileW + taps - 1;
  float* staged0 = smem;
  float* staged1 = staged0 + staged_h * staged_w;
  float* vert = staged1 + staged_h * staged_w;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  // staged row t, column s holds the inputs at (i0 - lo + t, j0 - lo + s),
  // 0 outside the frame
  for (int e = tid; e < staged_h * staged_w; e += kThreads) {
    const int t = e / staged_w, s = e - t * staged_w;
    const int gi = i0 - lo + t, gj = j0 - lo + s;
    float a = 0.f, b = 0.f;
    if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
      const long long g = (long long)gi * W + gj;
      a = in0[g];
      b = in1[g];
    }
    staged0[e] = a;
    staged1[e] = b;
  }
  __syncthreads();
  // the vertical sums of every staged column, the window's rows in order;
  // sum plane m, row r at vert[(m * kTileH + r) * staged_w]
  const int plane_stride = kTileH * staged_w;
  for (int e = tid; e < kTileH * staged_w; e += kThreads) {
    if (kTensor) {
      float a = staged0[e], b = staged1[e];
      float s11 = mul(a, a), s12 = mul(a, b), s22 = mul(b, b);
#pragma unroll
      for (int k = 1; k < taps; ++k) {
        a = staged0[e + k * staged_w];
        b = staged1[e + k * staged_w];
        s11 = add(s11, mul(a, a));
        s12 = add(s12, mul(a, b));
        s22 = add(s22, mul(b, b));
      }
      vert[e] = s11;
      vert[plane_stride + e] = s12;
      vert[(kSums - 1) * plane_stride + e] = s22;
    } else {
      float s1 = staged0[e], s2 = staged1[e];
#pragma unroll
      for (int k = 1; k < taps; ++k) {
        s1 = add(s1, staged0[e + k * staged_w]);
        s2 = add(s2, staged1[e + k * staged_w]);
      }
      vert[e] = s1;
      vert[plane_stride + e] = s2;
    }
  }
  __syncthreads();
  const long long plane = (long long)H * W;
  for (int e = tid; e < kTileH * kTileW; e += kThreads) {
    const int r = e / kTileW, q = e - r * kTileW;
    const int i = i0 + r, j = j0 + q;
    if (i >= H || j >= W) continue;
    float sums[kSums];
#pragma unroll
    for (int m = 0; m < kSums; ++m) {
      const float* row = vert + m * plane_stride + r * staged_w + q;
      float acc = row[0];
#pragma unroll
      for (int k = 1; k < taps; ++k) acc = add(acc, row[k]);
      sums[m] = acc;
    }
    const long long p = (long long)i * W + j;
    if (kTensor) {
      const float g11 = sums[0], g12 = sums[1], g22 = sums[kSums - 1];
      const float det = sub(mul(g11, g22), mul(g12, g12));
      const float inv_det = det > threshold ? __fdiv_rn(1.f, det) : 0.f;
      out_tensor[p] = g11;
      out_tensor[plane + p] = g12;
      out_tensor[2 * plane + p] = g22;
      out_tensor[3 * plane + p] = inv_det;
    } else {
      const float b1 = -sums[0], b2 = -sums[1];
      const float g11 = tensor[p], g12 = tensor[plane + p];
      const float g22 = tensor[2 * plane + p], inv_det = tensor[3 * plane + p];
      float du = mul(sub(mul(g22, b1), mul(g12, b2)), inv_det);
      float dv = mul(sub(mul(g11, b2), mul(g12, b1)), inv_det);
      if (add(mul(du, du), mul(dv, dv)) < threshold) {
        du = 0.f;
        dv = 0.f;
      }
      const float2 f = flow[p];
      out_flow[p] = make_float2(add(f.x, du), add(f.y, dv));
    }
  }
}

constexpr int kMaxDevices = 64;

template <bool kTensor>
int launch_window(const float* in0, const float* in1, const float* tensor,
                  const float2* flow, float* out_tensor, float2* out_flow,
                  int H, int W, int taps, float threshold,
                  cudaStream_t stream) {
  if (H < 1 || W < 1 || taps < 1 || taps > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  constexpr int kSums = kTensor ? 3 : 2;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const dim3 block(kBlockX, kBlockY);
  const size_t smem = sizeof(float) * window_smem_floats(taps, kSums);
  if (taps == kWinTaps) {
    lk_window_kernel<kWinTaps, kTensor><<<grid, block, smem, stream>>>(
        in0, in1, tensor, flow, out_tensor, out_flow, H, W, taps, threshold);
    return (int)cudaGetLastError();
  }
  // the runtime count's largest window needs more than the default 48 KB:
  // raise its limit once per device (the call costs host time)
  constexpr size_t kMaxSmem = sizeof(float) * window_smem_floats(kMaxTaps,
                                                                 kSums);
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices || !raised[device]) {
    err = cudaFuncSetAttribute(lk_window_kernel<0, kTensor>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) raised[device] = true;
  }
  lk_window_kernel<0, kTensor><<<grid, block, smem, stream>>>(
      in0, in1, tensor, flow, out_tensor, out_flow, H, W, taps, threshold);
  return (int)cudaGetLastError();
}

}  // namespace

// image, ix, iy: (H, W) float32; ix and iy its Scharr derivatives along x
// and y. Returns a cudaError_t.
extern "C" int transflow_lk_scharr(const void* image, void* ix, void* iy,
                                   int H, int W, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kScharrW - 1) / kScharrW,
                  (H + kScharrH - 1) / kScharrH);
  lk_scharr_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<float*>(ix),
      static_cast<float*>(iy), H, W);
  return (int)cudaGetLastError();
}

// prev, nxt, ix, iy: (H, W) float32; flow: (H, W, 2) float32; out: (2, H,
// W) float32 [ix * it, iy * it]. Returns a cudaError_t.
extern "C" int transflow_lk_warp_products(const void* prev, const void* nxt,
                                          const void* ix, const void* iy,
                                          const void* flow, void* out, int H,
                                          int W, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  lk_warp_products_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(nxt),
      static_cast<const float*>(ix), static_cast<const float*>(iy),
      static_cast<const float2*>(flow), static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}

// ix, iy: (H, W) float32; out: (4, H, W) float32 [g11, g12, g22, inv_det];
// taps: the window (1 to 63); det_min: det's floor as float32. Returns a
// cudaError_t.
extern "C" int transflow_lk_structure_tensor(const void* ix, const void* iy,
                                             void* out, int H, int W,
                                             int taps, float det_min,
                                             void* stream) {
  return launch_window<true>(
      static_cast<const float*>(ix), static_cast<const float*>(iy), nullptr,
      nullptr, static_cast<float*>(out), nullptr, H, W, taps, det_min,
      static_cast<cudaStream_t>(stream));
}

// planes: (2, H, W) float32 [ix * it, iy * it]; tensor: (4, H, W) float32;
// flow, out: (H, W, 2) float32; taps: the window (1 to 63); small: eps^2
// as float32. Returns a cudaError_t.
extern "C" int transflow_lk_window_solve(const void* planes,
                                         const void* tensor, const void* flow,
                                         void* out, int H, int W, int taps,
                                         float small, void* stream) {
  const float* p = static_cast<const float*>(planes);
  return launch_window<false>(
      p, p + (long long)H * W, static_cast<const float*>(tensor),
      static_cast<const float2*>(flow), nullptr, static_cast<float2*>(out),
      H, W, taps, small, static_cast<cudaStream_t>(stream));
}
