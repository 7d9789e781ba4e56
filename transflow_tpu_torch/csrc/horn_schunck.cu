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
// the third word, after a fence) adds the slots in index order with a fixed
// tree, counts the iteration, sets the stop word if sqrt(sum) < delta, and
// resets the count of blocks done for the next launch. Every order is fixed,
// so the kernel is deterministic; the plain version (ops/horn_schunck.py)
// sums the squares in float64 in another order, so the two decisions could
// differ only for a norm within float64 rounding of delta.
//
// Numbers. B9's values are exact in float32: the frames are integers, the
// taps multiples of 1/16, so every blurred value is a multiple of 1/256 and
// every stencil value of 1/1024, far inside 24 bits; only denom rounds. XLA's
// CPU compiler fuses the JAX function's alpha^2 + ex^2 + ey^2 into two
// fused multiply-adds, fma(ey, ey, fma(ex, ex, alpha^2)), and the kernel
// takes the same two fmaf (the plain version emulates them exactly). So B9
// equals the JAX function and its plain version bit for bit. B10 takes the
// average's eight nonzero taps in row-major order, each product and sum
// rounded (__fmul_rn, __fadd_rn: no contraction into FMAs), then the JAX
// expression's products and sums in its order, and the IEEE division
// (built without --use_fast_math): it equals its plain version bit for bit.
// (XLA may fuse the loop body's products as well; the port keeps them
// rounded, and its flows stay within 1e-5 of the JAX function's.)
//
// Bounds on the H100 at 1080x1920 (2.07 Mpixel). B9 reads two bytes a pixel
// and writes four float32 planes, 18 B/pixel, ~0.011 ms at 3.35 TB/s; its
// ~40 operations a pixel take ~0.0013 ms at 67 TFLOP/s. B10 reads the four
// planes and the flow and writes the flow, 32 B/pixel, ~0.020 ms a launch.
// Both are bound by bytes. What the design does: a block stages its tile
// with the halo in shared memory (B9: both frames' bytes with a 2-pixel
// low and 3-pixel high halo, then the vertical and horizontal blur in
// shared memory; B10: the flow's float2 tile with a 1-pixel halo), so every
// input byte is read from device memory about once; the planes are read and
// written coalesced along x. Simple first: one output pixel a thread, 32x8
// threads a block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kWarps = kThreads / 32;

// B9: 16x32 outputs a block; the blurred tile has one more row and column
// (the stencils' high side), the staged frames two more on the low side
// and two more on the high side again (the blur's reach)
constexpr int kDerivH = 2 * kBlockY;
constexpr int kDerivW = kBlockX;
constexpr int kBlurH = kDerivH + 1;
constexpr int kBlurW = kDerivW + 1;
constexpr int kRawH = kBlurH + 4;
constexpr int kRawW = kBlurW + 4;

// B10: 8x32 outputs a block, one partial sum a block; ops/horn_schunck.py
// (ITER_TILE) sizes ``partials`` from these
constexpr int kIterH = kBlockY;
constexpr int kIterW = kBlockX;

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

__global__ void __launch_bounds__(kThreads)
    hs_derivatives_kernel(const uint8_t* __restrict__ prev,
                          const uint8_t* __restrict__ next,
                          float* __restrict__ planes,
                          int* __restrict__ control, int H, int W,
                          float alpha2) {
  __shared__ float raw[2][kRawH][kRawW];
  __shared__ float vert[2][kBlurH][kRawW];
  __shared__ float blur[2][kBlurH][kBlurW];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int i0 = blockIdx.y * kDerivH;
  const int j0 = blockIdx.x * kDerivW;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid < kControlWords)
    control[tid] = 0;
  // raw[.][t][s] holds the frames at (reflect101(i0 - 2 + t),
  // reflect101(j0 - 2 + s))
  for (int e = tid; e < kRawH * kRawW; e += kThreads) {
    const int t = e / kRawW, s = e - t * kRawW;
    const long long src =
        (long long)reflect101(i0 - 2 + t, H) * W + reflect101(j0 - 2 + s, W);
    raw[0][t][s] = (float)prev[src];
    raw[1][t][s] = (float)next[src];
  }
  __syncthreads();
  // blurred row i0 + t is the blur at row min(i0 + t, H - 1): the
  // stencils' symmetric pad repeats the last blurred row; its taps are
  // staged rows r - i0 + k for r that row
  for (int e = tid; e < 2 * kBlurH * kRawW; e += kThreads) {
    const int img = e / (kBlurH * kRawW);
    const int rest = e - img * kBlurH * kRawW;
    const int t = rest / kRawW, s = rest - t * kRawW;
    const int base = min(i0 + t, H - 1) - i0;
    float acc = mul(raw[img][base][s], k5(0));
    for (int k = 1; k < 5; ++k) acc = add(acc, mul(raw[img][base + k][s], k5(k)));
    vert[img][t][s] = acc;
  }
  __syncthreads();
  for (int e = tid; e < 2 * kBlurH * kBlurW; e += kThreads) {
    const int img = e / (kBlurH * kBlurW);
    const int rest = e - img * kBlurH * kBlurW;
    const int t = rest / kBlurW, q = rest - t * kBlurW;
    const int base = min(j0 + q, W - 1) - j0;
    float acc = mul(vert[img][t][base], k5(0));
    for (int k = 1; k < 5; ++k) acc = add(acc, mul(vert[img][t][base + k], k5(k)));
    blur[img][t][q] = acc;
  }
  __syncthreads();
  const long long plane = (long long)H * W;
  for (int e = tid; e < kDerivH * kDerivW; e += kThreads) {
    const int t = e / kDerivW, q = e - t * kDerivW;
    const int i = i0 + t, j = j0 + q;
    if (i >= H || j >= W) continue;
    float dx[2], dy[2], sum[2];
    for (int img = 0; img < 2; ++img) {
      const float a00 = blur[img][t][q], a01 = blur[img][t][q + 1];
      const float a10 = blur[img][t + 1][q], a11 = blur[img][t + 1][q + 1];
      // the flipped 2x2 kernels of the JAX module, times 0.25: exact
      dx[img] = add(add(mul(a00, -0.25f), mul(a01, 0.25f)),
                    add(mul(a10, -0.25f), mul(a11, 0.25f)));
      dy[img] = add(add(mul(a00, -0.25f), mul(a01, -0.25f)),
                    add(mul(a10, 0.25f), mul(a11, 0.25f)));
      sum[img] = add(add(mul(a00, 0.25f), mul(a01, 0.25f)),
                     add(mul(a10, 0.25f), mul(a11, 0.25f)));
    }
    const float ex = add(dx[0], dx[1]);
    const float ey = add(dy[0], dy[1]);
    const float et = sub(sum[1], sum[0]);
    const float denom = fmaf(ey, ey, fmaf(ex, ex, alpha2));
    const long long p = (long long)i * W + j;
    planes[p] = ex;
    planes[plane + p] = ey;
    planes[2 * plane + p] = et;
    planes[3 * plane + p] = denom;
  }
}

// the sum over the block of every thread's ``v``, in a fixed order (warp
// shuffles, then the warps' sums in order); valid in thread 0
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
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

__global__ void __launch_bounds__(kThreads)
    hs_iterate_kernel(const float* __restrict__ planes,
                      const float2* __restrict__ flow,
                      float2* __restrict__ out, int* control,
                      double* partials, int H, int W, float delta,
                      int has_delta) {
  __shared__ float2 tile[kIterH + 2][kIterW + 2];
  __shared__ double warp_sums[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int i0 = blockIdx.y * kIterH, j0 = blockIdx.x * kIterW;
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  const bool inside = i < H && j < W;
  const long long p = (long long)i * W + j;
  // set by an earlier launch: every block of this one reads the same word
  if (*(volatile int*)(control + kStop) != 0) {
    if (inside) out[p] = flow[p];
    return;
  }
  // the flow at (clamp(i0 - 1 + t), clamp(j0 - 1 + s)): a 1-pixel
  // symmetric pad repeats the edge
  for (int e = tid; e < (kIterH + 2) * (kIterW + 2); e += kThreads) {
    const int t = e / (kIterW + 2), s = e - t * (kIterW + 2);
    const int si = min(max(i0 - 1 + t, 0), H - 1);
    const int sj = min(max(j0 - 1 + s, 0), W - 1);
    tile[t][s] = flow[(long long)si * W + sj];
  }
  __syncthreads();
  double sq = 0.0;
  if (inside) {
    const int t = threadIdx.y + 1, s = threadIdx.x + 1;
    // the eight nonzero taps in row-major order
    const float2 n00 = tile[t - 1][s - 1], n01 = tile[t - 1][s],
                 n02 = tile[t - 1][s + 1], n10 = tile[t][s - 1],
                 n12 = tile[t][s + 1], n20 = tile[t + 1][s - 1],
                 n21 = tile[t + 1][s], n22 = tile[t + 1][s + 1];
    float ua = mul(n00.x, kCorner);
    ua = add(ua, mul(n01.x, kEdge));
    ua = add(ua, mul(n02.x, kCorner));
    ua = add(ua, mul(n10.x, kEdge));
    ua = add(ua, mul(n12.x, kEdge));
    ua = add(ua, mul(n20.x, kCorner));
    ua = add(ua, mul(n21.x, kEdge));
    ua = add(ua, mul(n22.x, kCorner));
    float va = mul(n00.y, kCorner);
    va = add(va, mul(n01.y, kEdge));
    va = add(va, mul(n02.y, kCorner));
    va = add(va, mul(n10.y, kEdge));
    va = add(va, mul(n12.y, kEdge));
    va = add(va, mul(n20.y, kCorner));
    va = add(va, mul(n21.y, kEdge));
    va = add(va, mul(n22.y, kCorner));
    const long long plane = (long long)H * W;
    const float ex = planes[p], ey = planes[plane + p];
    const float et = planes[2 * plane + p], denom = planes[3 * plane + p];
    const float c = __fdiv_rn(add(add(mul(ex, ua), mul(ey, va)), et), denom);
    const float nu = sub(ua, mul(ex, c));
    const float nv = sub(va, mul(ey, c));
    out[p] = make_float2(nu, nv);
    const float d = sub(nu, tile[t][s].x);
    sq = (double)mul(d, d);
  }
  const double block_total = block_sum(sq, warp_sums);
  const int blocks = gridDim.x * gridDim.y;
  if (tid == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = block_total;
    __threadfence();
    last = atomicAdd(control + kBlocksDone, 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block's partial is written and fenced
  __threadfence();
  double acc = 0.0;
  for (int b = tid; b < blocks; b += kThreads)
    acc += ((volatile double*)partials)[b];
  const double total = block_sum(acc, warp_sums);
  if (tid == 0) {
    control[kIterations] += 1;
    if (has_delta && sqrt(total) < (double)delta) control[kStop] = 1;
    control[kBlocksDone] = 0;
  }
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
  hs_derivatives_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next),
      static_cast<float*>(planes), static_cast<int*>(control), H, W, alpha2);
  return (int)cudaGetLastError();
}

// planes: (4, H, W) float32; flow, out: (H, W, 2) float32; control: B9's 4
// int32; partials: ``num_partials`` float64 of scratch, one a block (8x32
// outputs). delta: the stop threshold as float32, used where has_delta.
// Returns a cudaError_t.
extern "C" int transflow_hs_iterate(const void* planes, const void* flow,
                                    void* out, void* control, void* partials,
                                    int num_partials, int H, int W,
                                    float delta, int has_delta,
                                    void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kIterW - 1) / kIterW, (H + kIterH - 1) / kIterH);
  if ((long long)grid.x * grid.y > num_partials)
    return (int)cudaErrorInvalidValue;
  hs_iterate_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float2*>(flow),
      static_cast<float2*>(out), static_cast<int*>(control),
      static_cast<double*>(partials), H, W, delta, has_delta);
  return (int)cudaGetLastError();
}
