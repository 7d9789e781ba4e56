// The image pyramids' level construction for Hopper (sm_90a): one kernel
// with two modes, B8 and B14.
//
// It replaces jnp code that XLA fuses (there is no Pallas source):
//  * B8, the resize mode: Farneback's pyramid level,
//    transflow_tpu/flow/estimators/farneback.py:243-248 (and :211-213, the
//    fb_downscale pre-resize), jax.image.resize(gaussian_blur(img, sigma),
//    (lh, lw), "linear"): a separable Gaussian of radius R with numpy's
//    symmetric padding (a bf16 image meets taps rounded to bf16 along its
//    rows' axis, then float32 taps) and JAX's anti-aliased linear resize,
//    each output from its band of K weights (ops/pyramid.py::
//    resize_weights). The four passes are linear and each acts along one
//    axis, so they run in the order that does the least work: the
//    vertical blur, the row resize, the horizontal blur (at the level's
//    height, not the frame's), the column resize;
//  * B14, the decimate mode: Lucas-Kanade's reduce,
//    transflow_tpu/ops/image.py:234 downsample2x: the binomial [1, 4, 6,
//    4, 1] / 16 along each axis with symmetric padding, then [::2, ::2].
//
// Numbers. Every sum is taken in tap (or band) order from its first term,
// each product __fmul_rn and each sum __fadd_rn (no contraction), the
// order of the plain versions in ops/pyramid.py: a kernel and its plain
// version agree bit for bit.
//
// Bounds on the H100 at 1080x1920, cv2's defaults (pyr_scale 0.5, 3
// levels): each level reads both bf16 frames (8.3 MB) and writes its two
// float32 levels: 24.9 MB in and 5.4 MB out a frame, ~9 us at 3.35 TB/s.
// The vertical blur at full resolution costs 2 (2R + 1) float32
// operations a pixel and image (R = 2, 5, 11 at levels 1-3), the rest
// less: levels 1-2 are bound by bytes, level 3 by operations (chip_smoke
// prints each bound). B14 reads a float32 level and writes a quarter of
// it, bound by bytes.
//
// What the design does about it. Nothing but the level is written to
// device memory. B8: a block of 256 threads makes a tile of tile_h (<= 8)
// output rows by tile_w output columns of one image (blockIdx.z: both
// images of a level in one launch):
//  1. each thread takes a column of the tile's input segment (the
//     columns its outputs' bands read, with the blur's margin) and walks
//     down the rows the tile's row bands read, 8 rows at a time: a window
//     of 8 frame values in registers slides through the taps, so a strip
//     of 8 vertical sums costs 2R + 8 loads (coalesced along x, issued 8
//     at a time, independent of the sums; a bf16 frame's products are
//     exact, so its sums are fused multiply-adds), and each sum is folded
//     at once into the row resize of the output rows whose bands hold its
//     row, accumulated in shared memory;
//  2. the horizontal blur of those tile_h rows, shared memory to shared
//     memory;
//  3. the column resize, stored coalesced along x.
// The host (ops/pyramid.py::level_plan) picks the widest tile whose
// segment fits 256 columns, and fewer rows where the grid would give the
// 132 SMs fewer than two blocks each; a deep level (radius 95 at
// fb_levels 8 on a 1080p frame) takes one output column and its threads
// walk several columns. Shared memory holds tile_h rows of the segment
// and of the blurred columns (and the taps and band weights) only, so no
// tap window of the frame has to fit it; the host raises where even that
// exceeds the H100's 227 KB.
// B14: a block of 8 x 32 outputs stages its input tile (19 x 67 values,
// loads coalesced and independent) in shared memory, makes the vertical
// pass at the even rows there, then the horizontal pass at the even
// columns.
// Each block copies its taps and its tiles' band weights to shared memory
// first. A simple kernel: no TMA staging, no warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kStrip = 8;      // B8: vertical sums a thread makes at once
constexpr int kMaxTileH = 8;   // B8: output rows a tile, accumulators
constexpr int kMaxTileW = 128;
constexpr int kReduceRows = 8;   // B14: a block's output rows
constexpr int kReduceCols = 32;  // B14: a block's output columns
constexpr int kReduceRadius = 2;
constexpr int kReduceInRows = 2 * (kReduceRows - 1) + 1 + 2 * kReduceRadius;
constexpr int kReduceInCols = 2 * (kReduceCols - 1) + 1 + 2 * kReduceRadius;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
// a bf16 value's bits are a float32's upper half: the conversion is exact
__device__ __forceinline__ float load(const bf16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}

// numpy's symmetric padding: the edge repeats, any pad width
__device__ __forceinline__ int reflect(int i, int n) {
  if (i >= 0 && i < n) return i;
  const int period = 2 * n;
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - 1 - i;
}

struct LevelArgs {
  const void* src[2];
  float* dst[2];
  int H, W, OH, OW;
  const float* vtaps;  // the vertical (first) pass's 2R + 1 taps
  const float* htaps;  // the horizontal (second) pass's
  int radius;
  const int* ystart;       // B8: each output row's first input row
  const float* yweights;   // (OH, ky)
  int ky;
  const int* xstart;       // each output column's first input column
  const float* xweights;   // (OW, kx)
  int kx;
  int tile_h, tile_w;
  int seg;   // the most segment columns a tile reads (blur margin in)
  int cols;  // the most blurred columns a tile reads
};

// the floats of B8's shared memory: the tile's rows of the segment and
// of the blurred columns, both passes' taps, the tile's row and column
// bands (starts as ints)
__host__ __device__ inline int level_smem_floats(int tile_h, int tile_w,
                                                 int seg, int cols,
                                                 int radius, int ky, int kx) {
  return tile_h * (seg + cols) + 2 * (2 * radius + 1) + tile_h * (ky + 1) +
         tile_w * (kx + 1);
}

// acc + v * t. A bf16 frame's value times a tap rounded to bf16 has at
// most 16 significant bits, exact in float32 (the frame holds no
// subnormal), so one fused multiply-add equals the rounded product and
// sum bit for bit; a float32 image keeps __fmul_rn and __fadd_rn
template <typename T>
__device__ __forceinline__ float tap_mac(float acc, float v, float t) {
  if constexpr (std::is_same_v<T, bf16>) return fmaf(v, t, acc);
  return add(acc, mul(v, t));
}

// B8 step 1 for one segment column: the vertical sums of the tile's input
// rows ry0 .. ry0 + nrows - 1, 8 at a time, each folded at once into the
// row resize of the tile's th output rows (their bands start at
// ystart[i], weights yw[i * ky + k]), accumulated in col[i * seg]
template <typename T>
__device__ __forceinline__ void column_walk(
    const T* __restrict__ column, int H, int W, int radius,
    const float* __restrict__ vt, int ry0, int nrows, int th, int ky,
    const int* __restrict__ ystart, const float* __restrict__ yw,
    float* __restrict__ col, int seg) {
  const int taps = 2 * radius + 1;
  int lo = 0, hi = -1;  // the output rows whose bands hold the current row
  for (int s0 = 0; s0 < nrows; s0 += kStrip) {
    const int r0 = ry0 + s0 - radius;  // the strip's first window row
    float win[kStrip], acc[kStrip];
#pragma unroll
    for (int m = 0; m < kStrip; ++m) {
      win[m] = load(column + (long long)reflect(r0 + m, H) * W);
      acc[m] = mul(win[m], vt[0]);
    }
    // the other taps 8 at a time: their 8 loads issued together; sum m
    // takes tap t0 + u from row r0 + m + t0 + u, win[m + u] or next[m + u - 8]
    for (int t0 = 1; t0 < taps; t0 += kStrip) {
      float next[kStrip];
#pragma unroll
      for (int u = 0; u < kStrip; ++u)
        next[u] = t0 + u < taps
                      ? load(column +
                             (long long)reflect(r0 + t0 + u + kStrip - 1, H) *
                                 W)
                      : 0.f;
#pragma unroll
      for (int u = 0; u < kStrip; ++u) {
        if (t0 + u < taps) {
          const float tk = vt[t0 + u];
#pragma unroll
          for (int m = 0; m < kStrip; ++m)
            acc[m] = tap_mac<T>(
                acc[m],
                m + u + 1 < kStrip ? win[min(m + u + 1, kStrip - 1)]
                                   : next[max(m + u + 1 - kStrip, 0)],
                tk);
        }
      }
#pragma unroll
      for (int m = 0; m < kStrip; ++m) win[m] = next[m];
    }
    // rows in ascending order: each output row's band terms arrive in
    // band order
#pragma unroll
    for (int m = 0; m < kStrip; ++m) {
      if (s0 + m < nrows) {
        const int r = ry0 + s0 + m;
        while (hi + 1 < th && ystart[hi + 1] <= r) ++hi;
        while (ystart[lo] + ky <= r) ++lo;
        for (int i = lo; i <= hi; ++i) {
          const int k = r - ystart[i];
          const float w = yw[i * ky + k];
          float* y = col + i * seg;
          *y = k == 0 ? mul(acc[m], w) : add(*y, mul(acc[m], w));
        }
      }
    }
  }
}

template <typename T, bool kDecimate>
__global__ void __launch_bounds__(kThreads)
    pyramid_kernel(const LevelArgs a) {
  const T* __restrict__ src =
      static_cast<const T*>(blockIdx.z ? a.src[1] : a.src[0]);
  float* __restrict__ dst = blockIdx.z ? a.dst[1] : a.dst[0];
  const int tid = threadIdx.x;
  const int ntaps = 2 * a.radius + 1;

  if constexpr (kDecimate) {
    // B14: stage the input tile, the vertical pass at the even rows, the
    // horizontal pass at the even columns
    __shared__ float xs[kReduceInRows][kReduceInCols];
    __shared__ float ts[kReduceRows][kReduceInCols];
    __shared__ float taps[2 * kReduceRadius + 1];
    const int i0 = blockIdx.y * kReduceRows;
    const int j0 = blockIdx.x * kReduceCols;
    if (tid < ntaps) taps[tid] = a.vtaps[tid];
    for (int p = tid; p < kReduceInRows * kReduceInCols; p += kThreads) {
      const int rr = p / kReduceInCols, cc = p % kReduceInCols;
      xs[rr][cc] = load(src + (long long)reflect(2 * i0 - a.radius + rr, a.H) *
                                  a.W +
                        reflect(2 * j0 - a.radius + cc, a.W));
    }
    __syncthreads();
    for (int p = tid; p < kReduceRows * kReduceInCols; p += kThreads) {
      const int i = p / kReduceInCols, c = p % kReduceInCols;
      float acc = mul(xs[2 * i][c], taps[0]);
#pragma unroll
      for (int t = 1; t < 2 * kReduceRadius + 1; ++t)
        acc = add(acc, mul(xs[2 * i + t][c], taps[t]));
      ts[i][c] = acc;
    }
    __syncthreads();
    const int i = tid / kReduceCols, j = tid % kReduceCols;
    if (i0 + i < a.OH && j0 + j < a.OW) {
      float acc = mul(ts[i][2 * j], taps[0]);
#pragma unroll
      for (int t = 1; t < 2 * kReduceRadius + 1; ++t)
        acc = add(acc, mul(ts[i][2 * j + t], taps[t]));
      dst[(long long)(i0 + i) * a.OW + j0 + j] = acc;
    }
  } else {
    extern __shared__ float smem[];
    const int i0 = blockIdx.y * a.tile_h;
    const int j0 = blockIdx.x * a.tile_w;
    const int th = min(a.tile_h, a.OH - i0);
    const int tw = min(a.tile_w, a.OW - j0);
    float* rowsum = smem;                      // (tile_h, seg)
    float* blurred = rowsum + a.tile_h * a.seg;  // (tile_h, cols)
    float* vt = blurred + a.tile_h * a.cols;     // 2R + 1
    float* ht = vt + ntaps;                      // 2R + 1
    float* yw = ht + ntaps;                      // (tile_h, ky)
    float* xw = yw + a.tile_h * a.ky;            // (tile_w, kx)
    int* ystart = reinterpret_cast<int*>(xw + a.tile_w * a.kx);  // tile_h
    int* xstart = ystart + a.tile_h;                              // tile_w
    for (int p = tid; p < ntaps; p += kThreads) {
      vt[p] = a.vtaps[p];
      ht[p] = a.htaps[p];
    }
    for (int p = tid; p < th * a.ky; p += kThreads)
      yw[p] = a.yweights[(long long)i0 * a.ky + p];
    for (int p = tid; p < tw * a.kx; p += kThreads)
      xw[p] = a.xweights[(long long)j0 * a.kx + p];
    if (tid < th) ystart[tid] = a.ystart[i0 + tid];
    for (int p = tid; p < tw; p += kThreads) xstart[p] = a.xstart[j0 + p];
    __syncthreads();
    // the tile's bands: input rows ry0 .. ry0 + nrows - 1, blurred columns
    // cx0 .. cx0 + ncols - 1, segment columns cx0 - R .. cx0 + ncols + R - 1
    const int ry0 = ystart[0];
    const int nrows = ystart[th - 1] + a.ky - ry0;
    const int cx0 = xstart[0];
    const int ncols = xstart[tw - 1] + a.kx - cx0;
    const int nseg = ncols + 2 * a.radius;
    // 1. the vertical blur and the row resize, a thread a segment column
    for (int c = tid; c < nseg; c += kThreads)
      column_walk(src + reflect(cx0 - a.radius + c, a.W), a.H, a.W, a.radius,
                  vt, ry0, nrows, th, a.ky, ystart, yw, rowsum + c, a.seg);
    __syncthreads();
    // 2. the horizontal blur of the tile's rows
    for (int i = 0; i < th; ++i) {
      const float* row = rowsum + i * a.seg;
      for (int c = tid; c < ncols; c += kThreads) {
        float acc = mul(row[c], ht[0]);
        for (int t = 1; t < ntaps; ++t)
          acc = add(acc, mul(row[c + t], ht[t]));
        blurred[i * a.cols + c] = acc;
      }
    }
    __syncthreads();
    // 3. the column resize: output (i, j) from its band of kx columns
    for (int p = tid; p < th * tw; p += kThreads) {
      const int i = p / tw, jj = p % tw;
      const float* row = blurred + i * a.cols + (xstart[jj] - cx0);
      const float* w = xw + jj * a.kx;
      float acc = mul(row[0], w[0]);
      for (int k = 1; k < a.kx; ++k) acc = add(acc, mul(row[k], w[k]));
      dst[(long long)(i0 + i) * a.OW + j0 + jj] = acc;
    }
  }
}

// launch with ``smem`` bytes of dynamic shared memory, raising the
// kernel's limit once per device where it is above the default 48 KB (the
// call costs host time)
template <typename T, bool kDecimate>
int launch(const LevelArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    static bool raised[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device >= kMaxDevices || !raised[device]) {
      err = cudaFuncSetAttribute(pyramid_kernel<T, kDecimate>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
      if (err != cudaSuccess) return (int)err;
      if (device < kMaxDevices) raised[device] = true;
    }
  }
  pyramid_kernel<T, kDecimate><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// B8. src0, src1: (H, W) float32 (dtype 0) or bf16 (dtype 1) images, the
// second unused when n_images is 1; dst0, dst1: (OH, OW) float32; vtaps,
// htaps: 2 * radius + 1 float32 taps each; ystart (OH int32), yweights
// (OH, ky float32), xstart (OW), xweights (OW, kx): the resize's bands,
// each inside its axis; tile_h (<= 8) x tile_w (<= 128) outputs a block,
// ``seg`` the most segment columns and ``cols`` the most blurred columns
// a tile reads, ``smem`` the bytes they take (ops/pyramid.py::
// level_plan). Returns a cudaError_t.
extern "C" int transflow_pyramid_level(
    const void* src0, const void* src1, int n_images, int dtype, void* dst0,
    void* dst1, int H, int W, int OH, int OW, const void* vtaps,
    const void* htaps, int radius, const void* ystart, const void* yweights,
    int ky, const void* xstart, const void* xweights, int kx, int tile_h,
    int tile_w, int seg, int cols, int smem, void* stream) {
  if (n_images < 1 || n_images > 2 || H < 1 || W < 1 || OH < 1 || OW < 1 ||
      radius < 0 || ky < 1 || ky > H || kx < 1 || kx > W || tile_h < 1 ||
      tile_h > kMaxTileH || tile_w < 1 || tile_w > kMaxTileW || cols < kx ||
      seg != cols + 2 * radius ||
      smem != (int)sizeof(float) * level_smem_floats(tile_h, tile_w, seg,
                                                      cols, radius, ky, kx))
    return (int)cudaErrorInvalidValue;
  LevelArgs a = {};
  a.src[0] = src0;
  a.src[1] = src1;
  a.dst[0] = static_cast<float*>(dst0);
  a.dst[1] = static_cast<float*>(dst1);
  a.H = H;
  a.W = W;
  a.OH = OH;
  a.OW = OW;
  a.vtaps = static_cast<const float*>(vtaps);
  a.htaps = static_cast<const float*>(htaps);
  a.radius = radius;
  a.ystart = static_cast<const int*>(ystart);
  a.yweights = static_cast<const float*>(yweights);
  a.ky = ky;
  a.xstart = static_cast<const int*>(xstart);
  a.xweights = static_cast<const float*>(xweights);
  a.kx = kx;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.seg = seg;
  a.cols = cols;
  const dim3 grid((OW + tile_w - 1) / tile_w, (OH + tile_h - 1) / tile_h,
                  n_images);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(a, grid, smem, s);
  if (dtype == 1) return launch<bf16, false>(a, grid, smem, s);
  return (int)cudaErrorInvalidValue;
}

// B14. src0, src1: (H, W) float32 images, the second unused when n_images
// is 1; dst0, dst1: ((H + 1) / 2, (W + 1) / 2) float32; taps: the five
// float32 taps. Returns a cudaError_t.
extern "C" int transflow_pyramid_reduce(const void* src0, const void* src1,
                                        int n_images, void* dst0, void* dst1,
                                        int H, int W, const void* taps,
                                        void* stream) {
  if (n_images < 1 || n_images > 2 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  LevelArgs a = {};
  a.src[0] = src0;
  a.src[1] = src1;
  a.dst[0] = static_cast<float*>(dst0);
  a.dst[1] = static_cast<float*>(dst1);
  a.H = H;
  a.W = W;
  a.OH = (H + 1) / 2;
  a.OW = (W + 1) / 2;
  a.vtaps = a.htaps = static_cast<const float*>(taps);
  a.radius = kReduceRadius;
  const dim3 grid((a.OW + kReduceCols - 1) / kReduceCols,
                  (a.OH + kReduceRows - 1) / kReduceRows, n_images);
  return launch<float, true>(a, grid, 0, static_cast<cudaStream_t>(stream));
}
