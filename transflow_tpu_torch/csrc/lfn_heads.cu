// LiteFlowNet's two head loops for Hopper (sm_90a): the phase upsampler
// (B16) and the regularization's softmax tap apply (B17).
//
// Neither replaces a Pallas kernel: the JAX package computes both with jnp
// ops that XLA fuses into one kernel each on the TPU
// (transflow_tpu/flow/estimators/liteflownet.py:220 _upsample2x_phases and
// :420-448, Regularization's fused apply). As plain ATen ops on the card
// they were 33 launches an upsample (6 a frame) and about 6 launches a tap
// plus a softmax tail (117 taps a frame): some 980 launches of a bound-0
// 1088x1920 frame, which these kernels make 11.
//
// B16, upsample2x_phases: torch's ConvTranspose2d(k=4, s=2, p=1,
// groups=C, bias=False) on an (h, w, C) tensor, as its exact phase
// decomposition. Output pixel (2a+r, 2b+s), channel c, is four terms
//
//   for (ki, di) in ((r, r-1), (r+2, r)):      (outer)
//     for (kj, dj) in ((s, s-1), (s+2, s)):    (inner)
//       term = weight[c, 0, 3-ki, 3-kj] * x[a+di, b+dj, c]
//
// with x read as 0 outside the frame; the first term starts the sum and
// each product and sum is rounded in float32, the result once to x's dtype
// (bfloat16 or float32). The taps are the (C, 1, 4, 4) float32 parameter,
// read in place.
//
// B17, reg_apply: for each pixel of the (H, W, S*S) distance output of
// the regularization's last convolution (bfloat16 or float32, widened
// exactly) and the (H, W, 2) flow (float32 or bfloat16, widened exactly),
// with p = (S-1)/2:
//
//   d_k = -(dist_k * dist_k)          m = max_k d_k (NaN if any is NaN)
//   e_k = expf(d_k - m)               s = e_0 + e_1 + ... (k ascending)
//   acc_x = 0; acc_x = acc_x + (wx[k] * e_k) * flow_x[i+dy-p, j+dx-p]
//   (k = dy*S + dx ascending, a tap outside the frame reads 0; acc_y with
//   wy and flow_y)
//   out = ((acc_x + bx) * (1/s), (acc_y + by) * (1/s))   float32
//
// wx, wy (S*S each) and bx, by are the scale convolutions' float32
// parameters, read in place from device memory.
//
// Every product and sum is __fmul_rn / __fadd_rn in the plain versions'
// order (ops/lfn_heads.py), so nvcc contracts none into a multiply-add,
// and the exponential is expf (never __expf, no fast math): both kernels
// equal their plain versions bit for bit.
//
// Bound on the H100. B16 at the cost volume's level 2 (272x480x49 f32 in,
// 544x960x49 f32 out) moves ~128 MB, ~38 us at 3.35 TB/s, against 0.2
// GFLOP: bound by device memory. One thread an output element, channels
// fastest, so that a warp's reads and writes are one contiguous run; each
// input element is read by 16 threads from L1. B17 at level 2 reads 51 MB
// of bf16 distances and writes 4 MB: ~17 us, against ~0.1 GFLOP and 26 M
// exponentials. One thread a pixel: a block of 128 consecutive pixels
// first stages their distance rows (98 bytes each in bf16, unaligned)
// into shared memory with coalesced element loads, then each thread keeps
// its S*S exponentials in registers and reads the flow's S*S taps through
// L1. Tiling with TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRegPixels = 128;  // B17: pixels (threads) a block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// B16: one thread an output element of the (2h, 2w, C) result.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample2x_phases_kernel(const T* __restrict__ x,
                             const float* __restrict__ weight,
                             T* __restrict__ out, int h, int w, int C,
                             unsigned int total) {
  const unsigned int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % (unsigned int)C);
  const unsigned int pix = idx / (unsigned int)C;
  const int ox = (int)(pix % (unsigned int)(2 * w));
  const int oy = (int)(pix / (unsigned int)(2 * w));
  const int a = oy >> 1, r = oy & 1;
  const int b = ox >> 1, s = ox & 1;
  const float* taps = weight + 16 * c;
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int ki = r + 2 * u;
    const int yy = a + r - 1 + u;
    const bool row_in = yy >= 0 && yy < h;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int kj = s + 2 * v;
      const int xx = b + s - 1 + v;
      const float val =
          row_in && xx >= 0 && xx < w
              ? widen(x[((long long)yy * w + xx) * C + c])
              : 0.f;
      const float term = __fmul_rn(__ldg(taps + (3 - ki) * 4 + (3 - kj)), val);
      acc = u == 0 && v == 0 ? term : __fadd_rn(acc, term);
    }
  }
  out[idx] = narrow<T>(acc);
}

// B17: one thread a pixel of the flattened (H, W) grid, kRegPixels a
// block; S the tap window's side.
template <typename TD, typename TF, int S>
__global__ void __launch_bounds__(kRegPixels)
    reg_apply_kernel(const TD* __restrict__ dist, const TF* __restrict__ flow,
                     const float* __restrict__ wx,
                     const float* __restrict__ bx,
                     const float* __restrict__ wy,
                     const float* __restrict__ by, float* __restrict__ out,
                     int H, int W) {
  constexpr int S2 = S * S;
  constexpr int P = (S - 1) / 2;
  __shared__ TD rows[kRegPixels * S2];
  const long long npix = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * kRegPixels;
  const int pixels = (int)min((long long)kRegPixels, npix - p0);
  // stage the block's distance rows: one contiguous run, coalesced
  const TD* src = dist + p0 * S2;
  for (int e = threadIdx.x; e < pixels * S2; e += kRegPixels)
    rows[e] = src[e];
  __syncthreads();
  if ((int)threadIdx.x >= pixels) return;
  const long long p = p0 + threadIdx.x;
  const int i = (int)(p / W);
  const int j = (int)(p % W);
  const TD* row = rows + threadIdx.x * S2;

  float e[S2];
#pragma unroll
  for (int k = 0; k < S2; ++k) {
    const float v = widen(row[k]);
    e[k] = -__fmul_rn(v, v);
  }
  // torch.amax's max: a NaN anywhere makes it NaN
  float m = e[0];
#pragma unroll
  for (int k = 1; k < S2; ++k) m = (e[k] > m || e[k] != e[k]) ? e[k] : m;
#pragma unroll
  for (int k = 0; k < S2; ++k) e[k] = expf(__fsub_rn(e[k], m));
  float sum = e[0];
#pragma unroll
  for (int k = 1; k < S2; ++k) sum = __fadd_rn(sum, e[k]);
  const float divisor = __frcp_rn(sum);

  float acc_x = 0.f, acc_y = 0.f;
#pragma unroll
  for (int dy = 0; dy < S; ++dy) {
    const int yy = i + dy - P;
    const bool row_in = yy >= 0 && yy < H;
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const int k = dy * S + dx;
      const int xx = j + dx - P;
      float fx = 0.f, fy = 0.f;
      if (row_in && xx >= 0 && xx < W) {
        const TF* f = flow + 2 * ((long long)yy * W + xx);
        fx = widen(f[0]);
        fy = widen(f[1]);
      }
      acc_x = __fadd_rn(acc_x, __fmul_rn(__fmul_rn(__ldg(wx + k), e[k]), fx));
      acc_y = __fadd_rn(acc_y, __fmul_rn(__fmul_rn(__ldg(wy + k), e[k]), fy));
    }
  }
  out[2 * p] = __fmul_rn(__fadd_rn(acc_x, __ldg(bx)), divisor);
  out[2 * p + 1] = __fmul_rn(__fadd_rn(acc_y, __ldg(by)), divisor);
}

template <typename T>
cudaError_t launch_upsample(const void* x, const float* weight, void* out,
                            int h, int w, int C, cudaStream_t stream) {
  const long long total = 4LL * h * w * C;
  if (total > 0xffffffffLL - kThreads) return cudaErrorInvalidValue;
  const unsigned int blocks =
      (unsigned int)((total + kThreads - 1) / kThreads);
  upsample2x_phases_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), weight, static_cast<T*>(out), h, w, C,
      (unsigned int)total);
  return cudaGetLastError();
}

template <typename TD, typename TF, int S>
cudaError_t launch_reg(const void* dist, const void* flow, const float* wx,
                       const float* bx, const float* wy, const float* by,
                       float* out, int H, int W, cudaStream_t stream) {
  const long long blocks =
      ((long long)H * W + kRegPixels - 1) / kRegPixels;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  reg_apply_kernel<TD, TF, S><<<(unsigned)blocks, kRegPixels, 0, stream>>>(
      static_cast<const TD*>(dist), static_cast<const TF*>(flow), wx, bx, wy,
      by, out, H, W);
  return cudaGetLastError();
}

template <typename TD, typename TF>
cudaError_t launch_reg_size(int S, const void* dist, const void* flow,
                            const float* wx, const float* bx,
                            const float* wy, const float* by, float* out,
                            int H, int W, cudaStream_t stream) {
  switch (S) {
    case 3:
      return launch_reg<TD, TF, 3>(dist, flow, wx, bx, wy, by, out, H, W,
                                   stream);
    case 5:
      return launch_reg<TD, TF, 5>(dist, flow, wx, bx, wy, by, out, H, W,
                                   stream);
    case 7:
      return launch_reg<TD, TF, 7>(dist, flow, wx, bx, wy, by, out, H, W,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x: (h, w, C) contiguous;
// weight: (C, 1, 4, 4) float32 contiguous; out: (2h, 2w, C) in x's dtype.
// Returns a cudaError_t.
extern "C" int transflow_upsample2x_phases(const void* x, int dtype,
                                           const void* weight, void* out,
                                           int h, int w, int C,
                                           void* stream) {
  if (h < 1 || w < 1 || C < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* taps = static_cast<const float*>(weight);
  if (dtype == 1)
    return (int)launch_upsample<__nv_bfloat16>(x, taps, out, h, w, C, s);
  return (int)launch_upsample<float>(x, taps, out, h, w, C, s);
}

// dist: (H, W, S*S) contiguous in dist_dtype; flow: (H, W, 2) contiguous
// in flow_dtype; wx, wy: S*S float32, bx, by: one float32 each, on the
// device; out: (H, W, 2) float32. S is 3, 5 or 7. Returns a cudaError_t.
extern "C" int transflow_reg_apply(const void* dist, int dist_dtype,
                                   const void* flow, int flow_dtype,
                                   const void* wx, const void* bx,
                                   const void* wy, const void* by, void* out,
                                   int H, int W, int S, void* stream) {
  if (H < 1 || W < 1 || dist_dtype < 0 || dist_dtype > 1 || flow_dtype < 0 ||
      flow_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fwx = static_cast<const float*>(wx);
  const float* fbx = static_cast<const float*>(bx);
  const float* fwy = static_cast<const float*>(wy);
  const float* fby = static_cast<const float*>(by);
  float* o = static_cast<float*>(out);
  if (dist_dtype == 1 && flow_dtype == 1)
    return (int)launch_reg_size<__nv_bfloat16, __nv_bfloat16>(
        S, dist, flow, fwx, fbx, fwy, fby, o, H, W, s);
  if (dist_dtype == 1)
    return (int)launch_reg_size<__nv_bfloat16, float>(S, dist, flow, fwx, fbx,
                                                      fwy, fby, o, H, W, s);
  if (flow_dtype == 1)
    return (int)launch_reg_size<float, __nv_bfloat16>(S, dist, flow, fwx, fbx,
                                                      fwy, fby, o, H, W, s);
  return (int)launch_reg_size<float, float>(S, dist, flow, fwx, fbx, fwy, fby,
                                            o, H, W, s);
}
