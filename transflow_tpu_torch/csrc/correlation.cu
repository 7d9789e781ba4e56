// 7x7 cost-volume correlation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of transflow_tpu/ops/pallas_correlation.py
// (pallas_correlation7x7 -> _corr_call -> _kernel). It computes
//
//   out[y, x, (dy+3)*7 + (dx+3)] =
//       (1/C) * sum_c f1[y*s, x*s, c] * f2[(y+dy)*s, (x+dx)*s, c]
//
// for dy, dx in [-3, 3], with zeros outside the frame and stride s >= 1.
// f1 is (H, W, C) and f2 (f2_rows, W, C), row-major, each in its own dtype
// (float32 or bfloat16); the output is (ceil(H/s), ceil(W/s), 49) float32.
// All products and sums are float32, as in the Pallas kernel's staging
// rule.
//
// The row window serves both TPU entry points. f2 row r of the formula is
// buffer row r + f2_row0, and rows outside [0, f2_rows) of the buffer read
// as zeros. The unsharded correlation (pallas_correlation7x7) passes the
// whole f2, (f2_row0, f2_rows) = (0, H). The H-sharded one
// (sharded_pallas_correlation7x7) passes one shard's f1 rows and its
// haloed f2 band, (3s, H/n + 6s): the band holds 3s rows of each
// neighbouring shard, or zeros at the frame's edges, so every output pixel
// sums the same float32 products in the same order as the unsharded call,
// and the two agree bit for bit.
//
// Bound on the H100. At LiteFlowNet's level 2 of a 1088x1920 frame (f1
// 544x960x64 bf16, f2 the same in f32, stride 2) the kernel has to read
// ~17 MB of f1 and ~33 MB of f2 on the even grid and write ~26 MB: ~75 MB,
// ~22 us at 3.35 TB/s. It does 272*480*49*64 = 0.41 G FMAs (0.8 GFLOP)
// of float32, ~12 us at 67 TFLOP/s. So it is bound by device memory, at
// about 20-30 us. What the design does about that:
//  * no padded or subsampled copy of f2 is made: blocks read the unpadded
//    tensor at stride s, with bounds checks standing in for the padding;
//  * a block reads each f2 tap it needs from device memory once, into a
//    haloed (TY+6) x (TX+6) tile in shared memory, one slice of channels at
//    a time, and serves all 49 displacements from there (the Pallas
//    kernel's VMEM row band, cut to a 2-D tile that fits shared memory);
//  * each thread owns one output pixel and keeps its 49 sums in registers,
//    reading its own f1 channels straight into registers;
//  * the 49-wide output rows are staged through shared memory, so device
//    memory is written in contiguous runs.
// The inner loop does one shared-memory load per FMA, so shared-memory
// bandwidth is the next limit; register blocking over dx, TMA and wgmma
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kDisp = 3;
constexpr int kWin = 2 * kDisp + 1;
constexpr int kTaps = kWin * kWin;
constexpr int kTileX = 32;
constexpr int kTileY = 4;
constexpr int kThreads = kTileX * kTileY;
constexpr int kHaloX = kTileX + 2 * kDisp;
constexpr int kHaloY = kTileY + 2 * kDisp;
constexpr int kHaloPix = kHaloX * kHaloY;
constexpr int kChunk = 16;  // channels staged per pass
constexpr int kF2Floats = kChunk * kHaloPix;
constexpr int kOutFloats = kThreads * kTaps;
constexpr int kStageFloats = kF2Floats > kOutFloats ? kF2Floats : kOutFloats;
static_assert(kStageFloats * sizeof(float) <= 48 * 1024,
              "static shared memory is limited to 48 KB");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T1, typename T2>
__global__ void __launch_bounds__(kThreads)
    corr7x7_kernel(const T1* __restrict__ f1, const T2* __restrict__ f2,
                   float* __restrict__ out, int W, int C, int stride,
                   int f2_row0, int f2_rows, int OH, int OW) {
  // f2 halo tile as [channel][halo pixel] while accumulating, then the
  // block's 49-wide output rows as [pixel][tap] for the store
  __shared__ float stage[kStageFloats];
  const int tid = threadIdx.x;
  const int tx = tid % kTileX;
  const int ty = tid / kTileX;
  const int ox0 = blockIdx.x * kTileX;
  const int oy0 = blockIdx.y * kTileY;
  const int ox = ox0 + tx;
  const int oy = oy0 + ty;
  const bool active = ox < OW && oy < OH;
  const size_t f1_base =
      active ? ((size_t)oy * stride * W + (size_t)ox * stride) * C : 0;

  float acc[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous slice's readers are done
    for (int i = tid; i < kF2Floats; i += kThreads) {
      const int c = i % kChunk;
      const int p = i / kChunk;
      const int gy = (oy0 - kDisp + p / kHaloX) * stride + f2_row0;
      const int gx = (ox0 - kDisp + p % kHaloX) * stride;
      float v = 0.f;
      if (c0 + c < C && gy >= 0 && gy < f2_rows && gx >= 0 && gx < W)
        v = to_f32(f2[((size_t)gy * W + gx) * C + c0 + c]);
      stage[c * kHaloPix + p] = v;
    }
    float a[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      a[c] = (active && c0 + c < C) ? to_f32(f1[f1_base + c0 + c]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float* tap = stage + c * kHaloPix + ty * kHaloX + tx;
#pragma unroll
      for (int dy = 0; dy < kWin; ++dy)
#pragma unroll
        for (int dx = 0; dx < kWin; ++dx)
          acc[dy * kWin + dx] =
              fmaf(a[c], tap[dy * kHaloX + dx], acc[dy * kWin + dx]);
    }
  }

  const float inv_c = 1.f / (float)C;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTaps; ++k) stage[tid * kTaps + k] = acc[k] * inv_c;
  __syncthreads();
  // tile row r is kTileX pixels x 49 taps, contiguous in out
  const int row_floats = kTileX * kTaps;
  const int valid = (OW - ox0 < kTileX ? OW - ox0 : kTileX) * kTaps;
  for (int i = tid; i < kOutFloats; i += kThreads) {
    const int r = i / row_floats;
    const int e = i % row_floats;
    if (oy0 + r < OH && e < valid)
      out[((size_t)(oy0 + r) * OW + ox0) * kTaps + e] = stage[i];
  }
}

template <typename T1, typename T2>
cudaError_t launch(const void* f1, const void* f2, void* out, int H, int W,
                   int C, int stride, int f2_row0, int f2_rows,
                   cudaStream_t stream) {
  const int OH = (H + stride - 1) / stride;
  const int OW = (W + stride - 1) / stride;
  const dim3 grid((OW + kTileX - 1) / kTileX, (OH + kTileY - 1) / kTileY);
  corr7x7_kernel<T1, T2><<<grid, kThreads, 0, stream>>>(
      static_cast<const T1*>(f1), static_cast<const T2*>(f2),
      static_cast<float*>(out), W, C, stride, f2_row0, f2_rows, OH, OW);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. f1 is (H, W, C); f2 holds
// f2_rows rows of width W, and its row f2_row0 lines up with f1's row 0.
// Returns a cudaError_t.
extern "C" int transflow_corr7x7(const void* f1, int dtype1, const void* f2,
                                 int dtype2, void* out, int H, int W, int C,
                                 int stride, int f2_row0, int f2_rows,
                                 void* stream) {
  if (H < 1 || W < 1 || C < 1 || stride < 1 || f2_rows < 1 ||
      dtype1 < 0 || dtype1 > 1 || dtype2 < 0 || dtype2 > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype1 * 2 + dtype2) {
    case 0:
      return (int)launch<float, float>(f1, f2, out, H, W, C, stride, f2_row0,
                                       f2_rows, s);
    case 1:
      return (int)launch<float, __nv_bfloat16>(f1, f2, out, H, W, C, stride,
                                               f2_row0, f2_rows, s);
    case 2:
      return (int)launch<__nv_bfloat16, float>(f1, f2, out, H, W, C, stride,
                                               f2_row0, f2_rows, s);
    default:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(
          f1, f2, out, H, W, C, stride, f2_row0, f2_rows, s);
  }
}

extern "C" const char* transflow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
