// Farneback's hot loops for Hopper (sm_90a): kernels B1, B2a and B2b.
//
// They replace jnp code that XLA compiles (there is no Pallas source) in
// transflow_tpu/flow/estimators/farneback.py:
//  * B1 ``poly_expansion_kernel``: ``poly_expansion`` (:74), the per-pixel
//    weighted least-squares quadratic fit: 3 vertical and 6 horizontal 1-D
//    correlations with symmetric padding, then the constant 6x6 ``ginv``;
//  * B2a ``update_equations_kernel``: the first half of ``_update_flow``
//    (:102-148) with ``bilinear_sample_packed`` / ``shift_select_warp``:
//    image 2's five coefficient planes sampled at x + d, the averaged
//    matrix A, the displacement term b, and the six planes of A'A and A'b
//    times the in-bounds weight;
//  * B2b ``aggregate_solve_kernel``: the rest (:149-161), the window sums
//    (box with zero padding, or Gaussian with symmetric padding) of the six
//    planes and the closed-form 2x2 solve.
//
// Numbers. Every value is rounded to the storage dtype (bf16 or float32)
// where the JAX function rounds it, and every sum is taken in a fixed
// order with each product and sum rounded to float32 (__fmul_rn and
// __fadd_rn: no contraction into fused multiply-adds), which is the order
// of the plain versions in ops/farneback.py. A kernel and its plain
// version therefore agree bit for bit. Built without --use_fast_math, so
// 1 / det is the IEEE division.
//
// Bounds on the H100 at a 1080x1920 frame's four levels (2.75 Mpixel), bf16
// storage: B1 moves 12 bytes per pixel (the image in, five planes out) and
// does ~260 float32 operations (9 correlations of 11 taps and the fit), so
// it is bound by operations, ~21 us per frame for its 8 launches; B2a moves
// ~40 bytes (flow, both images' planes, six planes out), ~99 us for 12; B2b
// 28 bytes (six planes in, two flows), ~69 us for 12. What the design does:
//  * B1 stages a tile of the image with a poly_n halo in shared memory once
//    and runs all nine passes and the fit from it: 1 launch per image and
//    level in place of ~40 eager ops, and the intermediate planes never
//    reach device memory;
//  * B2a is one thread per pixel: the gathers of image 2's planes read the
//    (H, W, 5) stack where the sample falls (the TPU's tap pack, a
//    workaround for its gather, is not built), the select mode computes
//    the two row samples under each column tap directly;
//  * B2b stages each plane's tile with the window's halo in shared memory,
//    sums its columns into a second tile, its rows into registers, and
//    solves in registers: 1 launch per iteration, no aggregated plane in
//    device memory.
// Not fused multiply-adds and scalar loads keep them simple and exact;
// vector loads, wgmma-free register tiling and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kTileW = kBlockX;       // output columns of a B1/B2b block
constexpr int kTileH = 2 * kBlockY;   // output rows: two per thread
constexpr int kMaxPolyN = 12;
constexpr int kMaxPolyTaps = 2 * kMaxPolyN + 1;
constexpr int kMaxWinTaps = 63;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ``v`` as the storage dtype T holds it
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T stored(float v);
template <>
__device__ __forceinline__ float stored<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 stored<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// numpy's "symmetric" padding: sample r of an axis of n, the edge repeated
__device__ __forceinline__ int symmetric(int r, int n) {
  int m = r % (2 * n);
  if (m < 0) m += 2 * n;
  return m < n ? m : 2 * n - 1 - m;
}

// floor(v) clamped to [0, n - 1] as an index
__device__ __forceinline__ int clamped_floor(float f, int n) {
  return (int)fminf(fmaxf(f, 0.f), (float)(n - 1));
}

// sum_k src[k * stride] * taps[k], in tap order
__device__ __forceinline__ float correlate(const float* src, int stride,
                                           const float* taps, int n) {
  float acc = mul(src[0], taps[0]);
  for (int k = 1; k < n; ++k) acc = add(acc, mul(src[k * stride], taps[k]));
  return acc;
}

// ---------------------------------------------------------------------------
// B1: polynomial expansion
// ---------------------------------------------------------------------------

struct PolyParams {
  float taps[3][kMaxPolyTaps];  // g, x*g, x^2*g, rounded to the storage dtype
  float ginv[36];
};

// Block: a kTileH x kTileW tile of output pixels. The image tile with a
// halo of n (symmetric) is staged rounded to storage; the vertical passes
// cover every staged column of the tile's rows; each thread then runs the
// six horizontal passes and the fit for its two pixels.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    poly_expansion_kernel(const Tin* __restrict__ image,
                          Tout* __restrict__ out, int H, int W, int n,
                          const __grid_constant__ PolyParams p) {
  __shared__ float tile[(kTileH + 2 * kMaxPolyN) * (kTileW + 2 * kMaxPolyN)];
  __shared__ float fy[3][kTileH * (kTileW + 2 * kMaxPolyN)];
  const int taps = 2 * n + 1;
  const int pitch = kTileW + 2 * n;
  const int rows = kTileH + 2 * n;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  for (int e = tid; e < rows * pitch; e += kThreads) {
    const int y = symmetric(y0 - n + e / pitch, H);
    const int x = symmetric(x0 - n + e % pitch, W);
    tile[e] = rounded<Tout>(load(image + (long long)y * W + x));
  }
  __syncthreads();

  // fy0, fy1, fy2 = the columns against g, x*g, x^2*g
  for (int e = tid; e < kTileH * pitch; e += kThreads) {
    const float* col = tile + (e / pitch) * pitch + e % pitch;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      fy[m][e] = rounded<Tout>(correlate(col, pitch, p.taps[m], taps));
  }
  __syncthreads();

#pragma unroll
  for (int half = 0; half < kTileH / kBlockY; ++half) {
    const int r = threadIdx.y + half * kBlockY;
    const int y = y0 + r;
    const int x = x0 + threadIdx.x;
    if (y >= H || x >= W) continue;
    const int at = r * pitch + threadIdx.x;
    const float* g = p.taps[0];
    const float* xg = p.taps[1];
    const float* xxg = p.taps[2];
    // [m00, m10, m01, m20, m02, m11]
    float m[6];
    m[0] = correlate(fy[0] + at, 1, g, taps);
    m[1] = correlate(fy[0] + at, 1, xg, taps);
    m[2] = correlate(fy[1] + at, 1, g, taps);
    m[3] = correlate(fy[0] + at, 1, xxg, taps);
    m[4] = correlate(fy[2] + at, 1, g, taps);
    m[5] = correlate(fy[1] + at, 1, xg, taps);
#pragma unroll
    for (int k = 0; k < 6; ++k) m[k] = rounded<Tout>(m[k]);
    Tout* o = out + ((long long)y * W + x) * 5;
    // coefficients 1..5 of m @ ginv.T: [bx, by, axx, ayy, axy]
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      float c = mul(m[0], p.ginv[k * 6]);
#pragma unroll
      for (int l = 1; l < 6; ++l) c = add(c, mul(m[l], p.ginv[k * 6 + l]));
      c = rounded<Tout>(c);
      if (k == 5) c = mul(c, 0.5f);  // exact in either dtype
      o[k - 1] = stored<Tout>(c);
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_poly(const void* image, void* out, int H, int W, int n,
                        const PolyParams& p, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  poly_expansion_kernel<Tin, Tout><<<grid, dim3(kBlockX, kBlockY), 0,
                                     stream>>>(
      static_cast<const Tin*>(image), static_cast<Tout*>(out), H, W, n, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2a: warp of image 2's planes and the normal equations
// ---------------------------------------------------------------------------

// image 2's five planes at (y + dy, x + dx), clamped anchors
template <typename T>
__device__ __forceinline__ void sample_clamped(const T* __restrict__ poly,
                                               int H, int W, float sy,
                                               float sx, float* v) {
  const float y0f = floorf(sy);
  const float x0f = floorf(sx);
  const float wy = sub(sy, y0f);
  const float wx = sub(sx, x0f);
  const int ya = clamped_floor(y0f, H);
  const int xa = clamped_floor(x0f, W);
  const int yb = min(ya + 1, H - 1);
  const int xb = min(xa + 1, W - 1);
  const float ax = sub(1.f, wx);
  const float ay = sub(1.f, wy);
  const T* p00 = poly + ((long long)ya * W + xa) * 5;
  const T* p01 = poly + ((long long)ya * W + xb) * 5;
  const T* p10 = poly + ((long long)yb * W + xa) * 5;
  const T* p11 = poly + ((long long)yb * W + xb) * 5;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float top = add(mul(load(p00 + c), ax), mul(load(p01 + c), wx));
    const float bot = add(mul(load(p10 + c), ax), mul(load(p11 + c), wx));
    v[c] = add(mul(top, ay), mul(bot, wy));
  }
}

// the same sample by the two-pass clamped warp: the column pass at (y, x)
// lerps the row-warped samples of columns xa and xb, each made with that
// column's own dy
template <typename T>
__device__ __forceinline__ void sample_select(const T* __restrict__ poly,
                                              const float* __restrict__ flow,
                                              int H, int W, int y, int x,
                                              float dx, int radius,
                                              float* v) {
  const float rx = (float)min(radius, W - 1);
  const float ry = (float)min(radius, H - 1);
  const float sx = add((float)x, fminf(fmaxf(dx, -rx), rx));
  const float x0f = floorf(sx);
  const float wx = sub(sx, x0f);
  const int xa = clamped_floor(x0f, W);
  const int cols[2] = {xa, min(xa + 1, W - 1)};
  float row[2][5];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = cols[t];
    const float dy = flow[2 * ((long long)y * W + c) + 1];
    const float sy = add((float)y, fminf(fmaxf(dy, -ry), ry));
    const float y0f = floorf(sy);
    const float wy = sub(sy, y0f);
    const int ya = clamped_floor(y0f, H);
    const int yb = min(ya + 1, H - 1);
    const float ay = sub(1.f, wy);
    const T* pa = poly + ((long long)ya * W + c) * 5;
    const T* pb = poly + ((long long)yb * W + c) * 5;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      row[t][k] = add(mul(load(pa + k), ay), mul(load(pb + k), wy));
  }
  const float ax = sub(1.f, wx);
#pragma unroll
  for (int k = 0; k < 5; ++k)
    v[k] = add(mul(row[0][k], ax), mul(row[1][k], wx));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_equations_kernel(const T* __restrict__ poly1,
                            const T* __restrict__ poly2,
                            const float* __restrict__ flow,
                            T* __restrict__ planes, int H, int W,
                            int radius) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long q = (long long)y * W + x;
  const float dx = flow[2 * q];
  const float dy = flow[2 * q + 1];
  const float sx = add((float)x, dx);
  const float sy = add((float)y, dy);
  float w2[5];  // image 2 at x + d: bx, by, axx, ayy, axy
  if (radius > 0)
    sample_select(poly2, flow, H, W, y, x, dx, radius, w2);
  else
    sample_clamped(poly2, H, W, sy, sx, w2);
  const T* p1 = poly1 + q * 5;
  const float inb = (sx >= 0.f && sx <= (float)(W - 1) && sy >= 0.f &&
                     sy <= (float)(H - 1))
                        ? 1.f
                        : 0.f;
  const float a11 = mul(0.5f, add(load(p1 + 2), w2[2]));
  const float a22 = mul(0.5f, add(load(p1 + 3), w2[3]));
  const float a12 = mul(0.5f, add(load(p1 + 4), w2[4]));
  const float db_x = add(mul(-0.5f, sub(w2[0], load(p1 + 0))),
                         add(mul(a11, dx), mul(a12, dy)));
  const float db_y = add(mul(-0.5f, sub(w2[1], load(p1 + 1))),
                         add(mul(a12, dx), mul(a22, dy)));
  const float eq[6] = {
      mul(add(mul(a11, a11), mul(a12, a12)), inb),
      mul(add(mul(a11, a12), mul(a12, a22)), inb),
      mul(add(mul(a12, a12), mul(a22, a22)), inb),
      mul(add(mul(a11, db_x), mul(a12, db_y)), inb),
      mul(add(mul(a12, db_x), mul(a22, db_y)), inb),
      inb};
  const long long hw = (long long)H * W;
#pragma unroll
  for (int k = 0; k < 6; ++k) planes[k * hw + q] = stored<T>(eq[k]);
}

template <typename T>
cudaError_t launch_equations(const void* poly1, const void* poly2,
                             const float* flow, void* planes, int H, int W,
                             int radius, cudaStream_t stream) {
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  update_equations_kernel<T><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const T*>(poly1), static_cast<const T*>(poly2), flow,
      static_cast<T*>(planes), H, W, radius);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2b: window sums and the 2x2 solve
// ---------------------------------------------------------------------------

struct WindowParams {
  float vtaps[kMaxWinTaps];
  float htaps[kMaxWinTaps];
};

// Block: a kTileH x kTileW tile of output pixels. Per plane: the tile with
// the window's halo is staged (zeros or symmetric outside the frame), its
// columns are summed into ``mid`` (rounded to storage where the box asks),
// and each thread sums its two pixels' rows into registers. Dynamic shared
// memory: (kTileH + taps - 1 + kTileH) x (kTileW + taps - 1) floats.
template <typename T, bool kRoundMid>
__global__ void __launch_bounds__(kThreads)
    aggregate_solve_kernel(const T* __restrict__ planes,
                           const float* __restrict__ flow,
                           float* __restrict__ out, int H, int W, int taps,
                           int symmetric_pad,
                           const __grid_constant__ WindowParams p) {
  extern __shared__ float smem[];
  const int lo = (taps - 1) / 2;
  const int pitch = kTileW + taps - 1;
  const int rows = kTileH + taps - 1;
  float* tile = smem;
  float* mid = smem + rows * pitch;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const long long hw = (long long)H * W;
  float agg[kTileH / kBlockY][6];

#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T* plane = planes + c * hw;
    for (int e = tid; e < rows * pitch; e += kThreads) {
      int y = y0 - lo + e / pitch;
      int x = x0 - lo + e % pitch;
      float v = 0.f;
      if (symmetric_pad) {
        y = symmetric(y, H);
        x = symmetric(x, W);
        v = load(plane + (long long)y * W + x);
      } else if (y >= 0 && y < H && x >= 0 && x < W) {
        v = load(plane + (long long)y * W + x);
      }
      tile[e] = v;
    }
    __syncthreads();
    for (int e = tid; e < kTileH * pitch; e += kThreads) {
      const float s =
          correlate(tile + (e / pitch) * pitch + e % pitch, pitch, p.vtaps,
                    taps);
      mid[e] = kRoundMid ? rounded<T>(s) : s;
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < kTileH / kBlockY; ++half) {
      const int r = threadIdx.y + half * kBlockY;
      agg[half][c] = correlate(mid + r * pitch + threadIdx.x, 1, p.htaps,
                               taps);
    }
    __syncthreads();  // the next plane overwrites both tiles
  }

#pragma unroll
  for (int half = 0; half < kTileH / kBlockY; ++half) {
    const int y = y0 + threadIdx.y + half * kBlockY;
    const int x = x0 + threadIdx.x;
    if (y >= H || x >= W) continue;
    const float g11 = agg[half][0], g12 = agg[half][1], g22 = agg[half][2];
    const float h1 = agg[half][3], h2 = agg[half][4], weight = agg[half][5];
    const long long q = (long long)y * W + x;
    const float det = sub(mul(g11, g22), mul(g12, g12));
    if (det > 1e-9f && weight > 0.f) {
      const float inv_det = __fdiv_rn(1.f, det);
      out[2 * q] = mul(sub(mul(g22, h1), mul(g12, h2)), inv_det);
      out[2 * q + 1] = mul(sub(mul(g11, h2), mul(g12, h1)), inv_det);
    } else {
      out[2 * q] = flow[2 * q];
      out[2 * q + 1] = flow[2 * q + 1];
    }
  }
}

template <typename T, bool kRoundMid>
cudaError_t launch_solve(const void* planes, const float* flow, float* out,
                         int H, int W, int taps, int symmetric_pad,
                         const WindowParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * kTileH + taps - 1) *
                      (size_t)(kTileW + taps - 1);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  aggregate_solve_kernel<T, kRoundMid>
      <<<grid, dim3(kBlockX, kBlockY), smem, stream>>>(
          static_cast<const T*>(planes), flow, out, H, W, taps,
          symmetric_pad, p);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each returns a cudaError_t.

// params (host): the three rows of 2n+1 taps, then ginv's 36 entries
extern "C" int transflow_poly_expansion(const void* image, int dtype,
                                        void* out, int out_dtype, int H,
                                        int W, int n, const float* params,
                                        void* stream) {
  if (H < 1 || W < 1 || n < 1 || n > kMaxPolyN || dtype < 0 || dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || params == nullptr)
    return (int)cudaErrorInvalidValue;
  PolyParams p;
  memset(&p, 0, sizeof(p));
  const int taps = 2 * n + 1;
  for (int m = 0; m < 3; ++m)
    memcpy(p.taps[m], params + m * taps, sizeof(float) * taps);
  memcpy(p.ginv, params + 3 * taps, sizeof(p.ginv));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return (int)launch_poly<float, float>(image, out, H, W, n, p, s);
  if (dtype == 0)
    return (int)launch_poly<float, __nv_bfloat16>(image, out, H, W, n, p, s);
  if (out_dtype == 0)
    return (int)launch_poly<__nv_bfloat16, float>(image, out, H, W, n, p, s);
  return (int)launch_poly<__nv_bfloat16, __nv_bfloat16>(image, out, H, W, n,
                                                        p, s);
}

extern "C" int transflow_update_equations(const void* poly1,
                                          const void* poly2, int dtype,
                                          const void* flow, void* planes,
                                          int H, int W, int radius,
                                          void* stream) {
  if (H < 1 || W < 1 || radius < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flow);
  if (dtype == 1)
    return (int)launch_equations<__nv_bfloat16>(poly1, poly2, f, planes, H,
                                                W, radius, s);
  return (int)launch_equations<float>(poly1, poly2, f, planes, H, W, radius,
                                      s);
}

extern "C" int transflow_aggregate_solve(const void* planes, int dtype,
                                         const void* flow, void* out, int H,
                                         int W, int taps, int symmetric_pad,
                                         int round_mid, const float* vtaps,
                                         const float* htaps, void* stream) {
  if (H < 1 || W < 1 || taps < 1 || taps > kMaxWinTaps || dtype < 0 ||
      dtype > 1 || vtaps == nullptr || htaps == nullptr)
    return (int)cudaErrorInvalidValue;
  WindowParams p;
  memset(&p, 0, sizeof(p));
  memcpy(p.vtaps, vtaps, sizeof(float) * taps);
  memcpy(p.htaps, htaps, sizeof(float) * taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    if (round_mid)
      return (int)launch_solve<__nv_bfloat16, true>(planes, f, o, H, W, taps,
                                                    symmetric_pad, p, s);
    return (int)launch_solve<__nv_bfloat16, false>(planes, f, o, H, W, taps,
                                                   symmetric_pad, p, s);
  }
  // rounding a float32 sum to float32 changes nothing
  return (int)launch_solve<float, false>(planes, f, o, H, W, taps,
                                         symmetric_pad, p, s);
}
