// Horn-Schunck's hot loops for Hopper (sm_90a): kernels B9 and B10.
//
// They replace jnp code that XLA compiles (there is no Pallas source) in
// transflow_tpu/flow/estimators/horn_schunck.py:
//  * B9 ``hs_derivatives_kernel``: ``_blur5`` of both frames (:34-36, the
//    binomial 5-tap kernel with reflect-101 padding along each axis) and
//    the stencils of ``horn_schunck`` (:41, :45-56): ex, ey and et from 2x2
//    windows with the high side padded by its edge, and denom = alpha^2 +
//    ex^2 + ey^2;
//  * B10 ``hs_iterate_kernel``: one pass of the ``while_loop``'s body
//    (:58-76, the body :62-74): the 3x3 average of u and v (symmetric padding), c = (ex *
//    u_avg + ey * v_avg + et) / denom, the new u and v, and the early stop
//    on ||new_u - u||_2 < delta, kept on the device.
//
// The early stop. The JAX loop stops after the first iteration whose step
// norm falls below delta. The host here launches B10 max_iters times and
// never reads the norm: a control block of four ints [stop, iterations,
// blocks done, unused], zeroed by B9, carries the decision. Each B10 block
// reads the stop word first; if it is set, the block copies its pixels of
// the flow through (so the last launch's output holds the flow the loop
// stopped at). Otherwise it steps, sums its pixels' (new_u - u)^2 (float32
// squares, as jnp.square makes them) in float64, and writes the sum to its
// slot of ``partials``; the last block to count itself done (atomicAdd on
// the third word, after a fence) adds the slots with a fixed tree, counts
// the iteration, sets the stop word if sqrt(sum) < delta, and resets the
// count of blocks done for the next launch. Every order is fixed, so the
// kernel is deterministic; the plain version (ops/horn_schunck.py) sums
// the squares in float64 in another order, so the two decisions could
// differ only for a norm within float64 rounding of delta.
//
// Numbers. B9's values are exact in float32: the frames are integers, the
// taps multiples of 1/16, so every blurred value is a multiple of 1/256 and
// every stencil value of 1/1024, far inside 24 bits; only denom rounds. XLA's
// CPU compiler fuses the JAX function's alpha^2 + ex^2 + ey^2 into two
// fused multiply-adds, fma(ey, ey, fma(ex, ex, alpha^2)), and the kernel
// takes the same two fmaf (the plain version emulates them exactly). So B9
// equals the JAX function and its plain version bit for bit in any order of
// sums. B10 takes the average's eight nonzero taps in row-major order, each
// product and sum rounded (__fmul_rn, __fadd_rn: no contraction into FMAs),
// then the JAX expression's products and sums in its order, and the IEEE
// division (built without --use_fast_math): it equals its plain version bit
// for bit. (XLA may fuse the loop body's products as well; the port keeps
// them rounded, and its flows stay within 1e-5 of the JAX function's.)
//
// Bounds on the H100 at 1080x1920 (2.07 Mpixel). B9 reads two bytes a pixel
// and writes four float32 planes, 18 B/pixel, ~0.011 ms at 3.35 TB/s; its
// ~83 operations a pixel take ~0.0026 ms at 67 TFLOP/s. B10 reads the four
// planes and the flow and writes the flow, 32 B/pixel, ~0.020 ms a launch.
// Both are bound by bytes, so the design keeps the blocks few (each pays a
// fixed cost: B10's stop word, its block sum, a fence and an atomic on one
// shared word) and the per-byte work plain. The choices below were timed
// against others on the card, bit-equal all (PERF.md section 6):
//  * B9: 32x64 outputs a block of 256 threads (1,020 blocks at 1080p; a
//    block reads 37x72 bytes of each frame, 1.3x its outputs). A thread's
//    vertical 5-tap pass runs in registers down a strip of three blurred
//    rows and four columns, from 4-byte words of both frames where the
//    block lies inside the frame (no reflect-101 there) and from single
//    bytes with reflect-101 at the edges; the horizontal pass reads the
//    vertical sums from shared memory, a warp a row, and writes the
//    blurred row in their place (19 KB of shared memory a block); the
//    stencils read the blurred tile as 16-byte words and store each plane
//    16 bytes a thread where W is a multiple of 4.
//  * B10: a fixed grid of 528 blocks (four on each of the 132 SMs at 64
//    registers a thread) walks the tiles of 32 columns and 16 rows, block
//    b taking tiles b, b + 528, ... in order (4,080 tiles at 1080p), so
//    the blocks' warps drift apart and keep loads in flight while others
//    compute, and there are 528 partials, not one a tile. In a tile each
//    warp steps a strip of kIterRows (2) rows of 32 columns, a column a
//    lane: it loads the flow rows of its strip and one above and below
//    (rows and columns clamped: the symmetric pad), gets each row's left
//    and right neighbours by warp shuffles (lanes 0 and 31 load the one
//    beyond the warp), loads the planes of its rows, then steps every row.
//    (Strips of 1, 4, 8 and 16 rows, grids of 132-792 blocks, one block a
//    tile and capped registers were all slower.) A thread sums its squares
//    in float64 in tile and row order, then the warp in a shuffle tree,
//    then the block's warps in index order; the last block loads every
//    partial at once (__ldcg, through L2, after the fence), a thread adding
//    slots tid, tid + 256, ... in order, then the same block sum.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;

// B9: 32x64 outputs a block. The blurred tile has one more row and column
// (the stencils' high side); the vertical sums cover image columns j0 - 4
// to j0 + 67 (18 four-byte words: the horizontal taps reach j0 - 2 to
// j0 + 66), in strips of three blurred rows
constexpr int kDerivH = 32;
constexpr int kDerivW = 64;
constexpr int kBlurH = kDerivH + 1;
constexpr int kBlurW = kDerivW + 1;
constexpr int kVertLo = 4;       // vertical sum column c is image column j0 - 4 + c
constexpr int kVertW = 72;
constexpr int kGroups = kVertW / 4;
constexpr int kStripRows = 3;
constexpr int kStrips = kBlurH / kStripRows;
static_assert(kStrips * kStripRows == kBlurH, "strips cover the blurred rows");
static_assert(kGroups * kStrips <= kThreads, "one vertical task a thread");
static_assert(kDerivW == 16 * 4 && kDerivH == 2 * (kThreads / 16),
              "the stencils: 16 threads of 4 columns a row, two rows each");

// B10: a warp's strip of rows; a tile is 32 columns by kWarps strips; a
// fixed grid of blocks walks the tiles, one partial sum a block
// (transflow_hs_iterate_partials gives the count the wrapper allocates)
constexpr int kIterRows = 2;
constexpr int kIterH = kWarps * kIterRows;
constexpr int kIterW = kWarp;
constexpr int kIterBlocks = 4 * 132;
constexpr int kTailLoads = 4;    // partials a thread loads at once in the tail

constexpr int kControlWords = 4;
enum { kStop = 0, kIterations = 1, kBlocksDone = 2 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// numpy's "reflect" (reflect-101) index map for any pad width
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// the binomial taps 1, 4, 6, 4, 1 over 16 (exact in float32)
__device__ __forceinline__ float k5(int k) {
  return k == 0 || k == 4 ? 0.0625f : (k == 2 ? 0.375f : 0.25f);
}

// B9's vertical pass of one thread: both frames' 5-tap sums at blurred rows
// t0 .. t0 + 2 (image rows min(i0 + t, H - 1)) and vertical-sum columns
// 4g .. 4g + 3, into vert. Inside the frame from 4-byte words, rows in
// sequence; at the edges from bytes, every index through reflect-101.
template <bool kInside>
__device__ __forceinline__ void hs_vertical(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ next,
    float (*vert)[kBlurH][kVertW], int i0, int j0, int t0, int g, int H,
    int W) {
  float sums[2][kStripRows][4];
  if (kInside) {
    // raw rows i0 + t0 - 2 .. i0 + t0 + 4, words from column j0 - 4 + 4g
    uint32_t words[2][kStripRows + 4];
#pragma unroll
    for (int k = 0; k < kStripRows + 4; ++k) {
      const long long at = ((long long)(i0 + t0 - 2 + k) * W + j0 - kVertLo) / 4 + g;
      words[0][k] = __ldg(reinterpret_cast<const uint32_t*>(prev) + at);
      words[1][k] = __ldg(reinterpret_cast<const uint32_t*>(next) + at);
    }
#pragma unroll
    for (int img = 0; img < 2; ++img)
#pragma unroll
      for (int r = 0; r < kStripRows; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 5; ++k)
            acc = add(acc, mul((float)((words[img][r + k] >> (8 * c)) & 0xffu), k5(k)));
          sums[img][r][c] = acc;
        }
  } else {
    int cols[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) cols[c] = reflect101(j0 - kVertLo + 4 * g + c, W);
#pragma unroll
    for (int r = 0; r < kStripRows; ++r) {
      const int row = min(i0 + t0 + r, H - 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) sums[0][r][c] = sums[1][r][c] = 0.0f;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const long long base = (long long)reflect101(row - 2 + k, H) * W;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sums[0][r][c] = add(sums[0][r][c], mul((float)__ldg(prev + base + cols[c]), k5(k)));
          sums[1][r][c] = add(sums[1][r][c], mul((float)__ldg(next + base + cols[c]), k5(k)));
        }
      }
    }
  }
#pragma unroll
  for (int img = 0; img < 2; ++img)
#pragma unroll
    for (int r = 0; r < kStripRows; ++r)
      *reinterpret_cast<float4*>(&vert[img][t0 + r][4 * g]) =
          make_float4(sums[img][r][0], sums[img][r][1], sums[img][r][2],
                      sums[img][r][3]);
}

__global__ void __launch_bounds__(kThreads)
    hs_derivatives_kernel(const uint8_t* __restrict__ prev,
                          const uint8_t* __restrict__ next,
                          float* __restrict__ planes,
                          int* __restrict__ control, int H, int W,
                          float alpha2, bool words, bool vector_out) {
  // the vertical sums, then in place the blurred tile (column q at q)
  __shared__ __align__(16) float tile[2][kBlurH][kVertW];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kDerivH;
  const int j0 = blockIdx.x * kDerivW;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid < kControlWords)
    control[tid] = 0;
  // the vertical pass: inside the frame (every raw row and word in it) no
  // index needs reflect-101 and the last blurred row and column need no
  // clamp
  if (tid < kGroups * kStrips) {
    const int g = tid % kGroups, t0 = tid / kGroups * kStripRows;
    const bool inside = words && i0 >= 2 && i0 + kBlurH + 2 <= H &&
                        j0 >= kVertLo && j0 - kVertLo + kVertW <= W;
    if (inside)
      hs_vertical<true>(prev, next, tile, i0, j0, t0, g, H, W);
    else
      hs_vertical<false>(prev, next, tile, i0, j0, t0, g, H, W);
  }
  __syncthreads();
  // the horizontal pass, a warp a row, in place: blurred column q is the
  // blur at image column min(j0 + q, W - 1) (the stencils' symmetric pad
  // repeats the last one), whose taps start at vertical-sum column
  // min(j0 + q, W - 1) - j0 + 2; the warp reads the row's taps before it
  // writes any blurred value
  constexpr int kPerLane = (kBlurW + kWarp - 1) / kWarp;
  const int lane = tid % kWarp;
  for (int row = tid / kWarp; row < 2 * kBlurH; row += kWarps) {
    float* sums = tile[row / kBlurH][row % kBlurH];
    float acc[kPerLane];
#pragma unroll
    for (int n = 0; n < kPerLane; ++n) {
      const int q = lane + n * kWarp;
      const int c = min(j0 + min(q, kBlurW - 1), W - 1) - j0 + kVertLo - 2;
      acc[n] = 0.0f;
#pragma unroll
      for (int k = 0; k < 5; ++k) acc[n] = add(acc[n], mul(sums[c + k], k5(k)));
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < kPerLane; ++n)
      if (lane + n * kWarp < kBlurW) sums[lane + n * kWarp] = acc[n];
  }
  __syncthreads();
  // the stencils: a thread's four columns in two rows, a row at a time
  const long long plane = (long long)H * W;
  const int q0 = 4 * (tid % 16);
  const int j = j0 + q0;
#pragma unroll 1
  for (int t = tid / 16; t < kDerivH; t += kThreads / 16) {
    const int i = i0 + t;
    if (i >= H || j >= W) continue;
    // blurred columns q0 .. q0 + 4 of rows t and t + 1 of both frames
    float win[2][2][5];
#pragma unroll
    for (int img = 0; img < 2; ++img)
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        const float4 v = *reinterpret_cast<const float4*>(&tile[img][t + dt][q0]);
        win[img][dt][0] = v.x;
        win[img][dt][1] = v.y;
        win[img][dt][2] = v.z;
        win[img][dt][3] = v.w;
        win[img][dt][4] = tile[img][t + dt][q0 + 4];
      }
    float ex[4], ey[4], et[4], denom[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float dx[2], dy[2], sum[2];
#pragma unroll
      for (int img = 0; img < 2; ++img) {
        const float a00 = win[img][0][c], a01 = win[img][0][c + 1];
        const float a10 = win[img][1][c], a11 = win[img][1][c + 1];
        // the flipped 2x2 kernels of the JAX module, times 0.25: exact
        dx[img] = add(add(mul(a00, -0.25f), mul(a01, 0.25f)),
                      add(mul(a10, -0.25f), mul(a11, 0.25f)));
        dy[img] = add(add(mul(a00, -0.25f), mul(a01, -0.25f)),
                      add(mul(a10, 0.25f), mul(a11, 0.25f)));
        sum[img] = add(add(mul(a00, 0.25f), mul(a01, 0.25f)),
                       add(mul(a10, 0.25f), mul(a11, 0.25f)));
      }
      ex[c] = add(dx[0], dx[1]);
      ey[c] = add(dy[0], dy[1]);
      et[c] = sub(sum[1], sum[0]);
      denom[c] = fmaf(ey[c], ey[c], fmaf(ex[c], ex[c], alpha2));
    }
    const long long p = (long long)i * W + j;
    if (vector_out) {
      // W is a multiple of 4, so are j and p: the four columns are in the
      // frame and every plane's four values one aligned 16-byte word
      *reinterpret_cast<float4*>(planes + p) = make_float4(ex[0], ex[1], ex[2], ex[3]);
      *reinterpret_cast<float4*>(planes + plane + p) = make_float4(ey[0], ey[1], ey[2], ey[3]);
      *reinterpret_cast<float4*>(planes + 2 * plane + p) = make_float4(et[0], et[1], et[2], et[3]);
      *reinterpret_cast<float4*>(planes + 3 * plane + p) =
          make_float4(denom[0], denom[1], denom[2], denom[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j + c >= W) break;
        planes[p + c] = ex[c];
        planes[plane + p + c] = ey[c];
        planes[2 * plane + p + c] = et[c];
        planes[3 * plane + p + c] = denom[c];
      }
    }
  }
}

// the sum over the block of every thread's ``v``, in a fixed order (warp
// shuffles, then the warps' sums in order); valid in thread 0
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
  const int tid = threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (tid % kWarp == 0) warp_sums[tid / kWarp] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0)
    for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
  return total;
}

// the 3x3 average's weights: 1/12 at the corners, 2/12 at the edges (the
// JAX module's float32 constants), 0 at the centre
constexpr float kCorner = 1.0f / 12.0f;
constexpr float kEdge = 2.0f / 12.0f;

__device__ __forceinline__ float average(float n00, float n01, float n02,
                                         float n10, float n12, float n20,
                                         float n21, float n22) {
  // the eight nonzero taps in row-major order
  float acc = mul(n00, kCorner);
  acc = add(acc, mul(n01, kEdge));
  acc = add(acc, mul(n02, kCorner));
  acc = add(acc, mul(n10, kEdge));
  acc = add(acc, mul(n12, kEdge));
  acc = add(acc, mul(n20, kCorner));
  acc = add(acc, mul(n21, kEdge));
  acc = add(acc, mul(n22, kCorner));
  return acc;
}

// B10's step of one warp's strip, rows r0 .. r0 + kIterRows - 1 (r0 < H)
// at column j, a lane a column: the new flow into out, each squared step
// added to sq in row order. The whole warp calls it: the shuffles see
// every lane.
__device__ __forceinline__ void hs_step_strip(const float* __restrict__ planes,
                                              const float2* __restrict__ flow,
                                              float2* __restrict__ out, int H,
                                              int W, int r0, int j, int lane,
                                              double& sq) {
  // the flow at rows clamp(r0 - 1 + k) and column clamp(j), and the
  // neighbours across columns (a 1-pixel symmetric pad repeats the edge; a
  // lane beyond W holds column W - 1, so W - 1's right neighbour is itself)
  const int jc = min(j, W - 1);
  const int jh = lane == 0 ? max(j - 1, 0) : min(j + 1, W - 1);
  const bool halo = lane == 0 || lane == kWarp - 1;
  float2 mid[kIterRows + 2], left[kIterRows + 2], right[kIterRows + 2];
  float ex[kIterRows], ey[kIterRows], et[kIterRows], denom[kIterRows];
#pragma unroll
  for (int k = 0; k < kIterRows + 2; ++k) {
    const long long row = (long long)min(max(r0 - 1 + k, 0), H - 1) * W;
    mid[k] = flow[row + jc];
    left[k] = right[k] = halo ? flow[row + jh] : make_float2(0.0f, 0.0f);
  }
  const long long plane = (long long)H * W;
#pragma unroll
  for (int r = 0; r < kIterRows; ++r) {
    const long long p = (long long)min(r0 + r, H - 1) * W + jc;
    ex[r] = planes[p];
    ey[r] = planes[plane + p];
    et[r] = planes[2 * plane + p];
    denom[r] = planes[3 * plane + p];
  }
#pragma unroll
  for (int k = 0; k < kIterRows + 2; ++k) {
    const float lx = __shfl_up_sync(0xffffffffu, mid[k].x, 1);
    const float ly = __shfl_up_sync(0xffffffffu, mid[k].y, 1);
    const float rx = __shfl_down_sync(0xffffffffu, mid[k].x, 1);
    const float ry = __shfl_down_sync(0xffffffffu, mid[k].y, 1);
    if (lane != 0) left[k] = make_float2(lx, ly);
    if (lane != kWarp - 1) right[k] = make_float2(rx, ry);
  }
#pragma unroll
  for (int r = 0; r < kIterRows; ++r) {
    if (j >= W || r0 + r >= H) continue;
    const float ua = average(left[r].x, mid[r].x, right[r].x, left[r + 1].x,
                             right[r + 1].x, left[r + 2].x, mid[r + 2].x,
                             right[r + 2].x);
    const float va = average(left[r].y, mid[r].y, right[r].y, left[r + 1].y,
                             right[r + 1].y, left[r + 2].y, mid[r + 2].y,
                             right[r + 2].y);
    const float c = __fdiv_rn(add(add(mul(ex[r], ua), mul(ey[r], va)), et[r]), denom[r]);
    const float nu = sub(ua, mul(ex[r], c));
    const float nv = sub(va, mul(ey[r], c));
    out[(long long)(r0 + r) * W + j] = make_float2(nu, nv);
    const float d = sub(nu, mid[r + 1].x);
    sq += (double)mul(d, d);
  }
}

// tiles: ceil(H / kIterH) rows of tiles_x tiles; block b takes tiles b,
// b + gridDim.x, ... in order, one partial sum a block
__global__ void __launch_bounds__(kThreads)
    hs_iterate_kernel(const float* __restrict__ planes,
                      const float2* __restrict__ flow,
                      float2* __restrict__ out, int* control,
                      double* partials, int H, int W, int tiles_x,
                      int tiles, float delta, int has_delta) {
  __shared__ double warp_sums[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  // set by an earlier launch: every block of this one reads the same word
  // and copies its tiles' flow through
  const bool stopped = *(volatile int*)(control + kStop) != 0;
  double sq = 0.0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ty = tile / tiles_x;
    const int j = (tile - ty * tiles_x) * kIterW + lane;
    // the warp's first row; a strip that starts below the frame does
    // nothing (the same for the whole warp)
    const int r0 = ty * kIterH + tid / kWarp * kIterRows;
    if (r0 >= H) continue;
    if (!stopped) {
      hs_step_strip(planes, flow, out, H, W, r0, j, lane, sq);
    } else if (j < W) {
#pragma unroll
      for (int r = 0; r < kIterRows; ++r)
        if (r0 + r < H) out[(long long)(r0 + r) * W + j] = flow[(long long)(r0 + r) * W + j];
    }
  }
  if (stopped) return;
  const double block_total = block_sum(sq, warp_sums);
  const int blocks = gridDim.x;
  if (tid == 0) {
    partials[blockIdx.x] = block_total;
    __threadfence();
    last = atomicAdd(control + kBlocksDone, 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block's partial is written and fenced. A
  // thread adds slots tid, tid + 256, ... in order, kTailLoads loads in
  // flight before their adds
  __threadfence();
  double acc = 0.0;
  for (int base = 0; base < blocks; base += kThreads * kTailLoads) {
    double v[kTailLoads];
#pragma unroll
    for (int k = 0; k < kTailLoads; ++k) {
      const int b = base + k * kThreads + tid;
      v[k] = b < blocks ? __ldcg(partials + b) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kTailLoads; ++k) acc += v[k];
  }
  const double total = block_sum(acc, warp_sums);
  if (tid == 0) {
    control[kIterations] += 1;
    if (has_delta && sqrt(total) < (double)delta) control[kStop] = 1;
    control[kBlocksDone] = 0;
  }
}

// B10's tiles across a row and in all, and its blocks: kIterBlocks, or
// one a tile where there are fewer
int iterate_tiles_x(int W) { return (W + kIterW - 1) / kIterW; }
int iterate_tiles(int H, int W) { return iterate_tiles_x(W) * ((H + kIterH - 1) / kIterH); }
int iterate_blocks(int H, int W) { return std::min(iterate_tiles(H, W), kIterBlocks); }

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// prev, next: (H, W) uint8; planes: (4, H, W) float32 [ex, ey, et, denom];
// control: 4 int32, zeroed here. alpha2: alpha^2 rounded to float32.
// Returns a cudaError_t.
extern "C" int transflow_hs_derivatives(const void* prev, const void* next,
                                        void* planes, void* control, int H,
                                        int W, float alpha2, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kDerivW - 1) / kDerivW, (H + kDerivH - 1) / kDerivH);
  // 4-byte frame words and 16-byte plane stores where every row starts
  // aligned
  const bool words = W % 4 == 0 && aligned(prev, 4) && aligned(next, 4);
  const bool vector_out = W % 4 == 0 && aligned(planes, 16);
  hs_derivatives_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next),
      static_cast<float*>(planes), static_cast<int*>(control), H, W, alpha2,
      words, vector_out);
  return (int)cudaGetLastError();
}

// The count of float64 partials B10 needs at (H, W): one a block. 0 for an
// empty frame.
extern "C" int transflow_hs_iterate_partials(int H, int W) {
  if (H < 1 || W < 1) return 0;
  return iterate_blocks(H, W);
}

// planes: (4, H, W) float32; flow, out: (H, W, 2) float32; control: B9's 4
// int32; partials: ``num_partials`` float64 of scratch, at least
// transflow_hs_iterate_partials(H, W). delta: the stop threshold as
// float32, used where has_delta. Returns a cudaError_t.
extern "C" int transflow_hs_iterate(const void* planes, const void* flow,
                                    void* out, void* control, void* partials,
                                    int num_partials, int H, int W,
                                    float delta, int has_delta,
                                    void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int blocks = iterate_blocks(H, W);
  if (blocks > num_partials) return (int)cudaErrorInvalidValue;
  hs_iterate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float2*>(flow),
      static_cast<float2*>(out), static_cast<int*>(control),
      static_cast<double*>(partials), H, W, iterate_tiles_x(W),
      iterate_tiles(H, W), delta, has_delta);
  return (int)cudaGetLastError();
}
