// LiteFlowNet's convolution epilogue for Hopper (sm_90a): kernel B18.
//
// Replaces no Pallas kernel: the JAX package leaves it to jnp ops that XLA
// fuses into the convolution on the TPU (transflow_tpu/flow/estimators/
// liteflownet.py:60 _conv, flax's nn.Conv(dtype=bfloat16), adds the bias
// after the rounded convolution; :47 _leaky follows it). As plain ATen ops
// on the card they were a bias cast, a broadcast add on a permuted view and
// a leaky ReLU after each of a 1088x1920 frame's 93 convolutions, some 260
// launches and ~4.7 ms. This kernel makes them one launch a convolution.
//
// For each element y of cuDNN's (N, C, H, W) output (bfloat16 or float32)
// and the float32 bias b[c] of its channel, in y's dtype T:
//
//   v = round_T(y + round_T(b[c]))          (the sum in float32)
//   leaky:  v = v >= 0 ? v : round_T(v * round_T(0.1))
//
// round_T(0.1) is 0.10009765625 in bfloat16 and 0.1f in float32, as JAX
// multiplies by its weak-typed slope converted to x's dtype. The sign test
// keeps -0.0, and NaN stays NaN. Sums and products are __fadd_rn /
// __fmul_rn (nothing contracts) and roundings __float2bfloat16_rn, so the
// result equals the plain version of ops/conv_epilogue.py bit for bit. The
// result is (N, H, W, C) contiguous, the layout the next op reads:
//
// - channels_last input (y's channels contiguous, what cuDNN returns for
//   the port's channels_last operands) is written in place. The tensor is
//   one flat run of N*H*W*C elements; a thread takes 16 bytes (8 bf16 or 4
//   f32) a step of a grid-stride loop, and the channel of its first element
//   is carried from step to step (one modulo a thread, none an element).
//   The block's bias, rounded to T once, lies in shared memory as a table
//   of C + VEC entries, entry k the bias of channel k mod C, so element e
//   of a vector starting at channel c reads entry c + e for any C (2, 9,
//   25, 49 keep 16-byte access). A base off 16 bytes takes the one-element
//   instantiation; the last N*H*W*C mod VEC elements one thread each.
// - contiguous NCHW input is transposed through a 32 x 33 shared-memory
//   tile a block (32 channels by 32 pixels of one image): its reads run
//   along pixels and its writes along channels, both coalesced.
//
// Bound on the H100: device memory. A bound-0 1088x1920 frame's 93
// launches read and write ~1,190 M bf16 elements, 4.76 GB: ~1.42 ms at
// 3.35 TB/s, against 1-3 float32 operations an element. The largest launch
// (the features' first convolution, 2 x 1088 x 1920 x 32) moves 267 MB
// each way; the smallest are a few KB, launch latency either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 2,048 threads: a full SM of 16-byte loads
constexpr int kMaxChannels = 1024;
constexpr int kMaxDevices = 64;
constexpr int kTile = 32;
constexpr int kTileRows = 8;  // a transpose block is kTile x kTileRows

// round_T and the conversions of one element
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float slope() { return 0.1f; }
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // bf16(0.1), exact in float32
  static __device__ __forceinline__ float slope() { return 0.10009765625f; }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// the epilogue of one element; ``b`` is the bias already rounded to T
template <typename T, bool LEAKY>
__device__ __forceinline__ float epilogue(float y, float b) {
  float v = Elem<T>::round(__fadd_rn(y, b));
  if (LEAKY && !(v >= 0.f)) v = Elem<T>::round(__fmul_rn(v, Elem<T>::slope()));
  return v;
}

// VEC consecutive elements as float, and back
template <typename T, int VEC>
struct Vec {
  static __device__ __forceinline__ void load(const T* p, float* v) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = Elem<T>::get(p + e);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) Elem<T>::put(p + e, v[e]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// channels_last: ``src`` and ``dst`` (the same buffer in place) are the
// flat (N*H*W*C) run; element i has channel i mod C
template <typename T, int VEC, bool LEAKY>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_nhwc_kernel(const T* src, const float* bias, T* dst,
                              long long n, int C) {
  __shared__ float table[kMaxChannels + 8];
  for (int k = threadIdx.x; k < C + VEC; k += blockDim.x)
    table[k] = Elem<T>::round(bias[k % C]);
  __syncthreads();
  const long long nvec = n / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the channel of element v * VEC, advanced by ``step`` each step
  int c = (int)((v * VEC) % C);
  const int step = (int)((stride * VEC) % C);
  for (; v < nvec; v += stride) {
    float x[VEC];
    Vec<T, VEC>::load(src + v * VEC, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = epilogue<T, LEAKY>(x[e], table[c + e]);
    Vec<T, VEC>::store(dst + v * VEC, x);
    c += step;
    if (c >= C) c -= C;
  }
  // the elements past the last whole vector
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * VEC) {
    const long long i = nvec * VEC + threadIdx.x;
    Elem<T>::put(dst + i, epilogue<T, LEAKY>(Elem<T>::get(src + i),
                                             table[i % C]));
  }
}

// contiguous NCHW ``src`` into (N, HW, C) ``dst``: a block transposes
// kTile channels by kTile pixels of image blockIdx.z
template <typename T, bool LEAKY>
__global__ void __launch_bounds__(kTile * kTileRows)
    conv_epilogue_nchw_kernel(const T* src, const float* bias, T* dst,
                              int HW, int C) {
  __shared__ float tile[kTile][kTile + 1];
  const int p0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const long long image = (long long)blockIdx.z * C * HW;
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int c = c0 + r, p = p0 + threadIdx.x;
    if (c < C && p < HW)
      tile[r][threadIdx.x] = epilogue<T, LEAKY>(
          Elem<T>::get(src + image + (long long)c * HW + p),
          Elem<T>::round(bias[c]));
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kTile; r += kTileRows) {
    const int p = p0 + r, c = c0 + threadIdx.x;
    if (c < C && p < HW)
      Elem<T>::put(dst + image + (long long)p * C + c, tile[threadIdx.x][r]);
  }
}

// The current device's SM count (asked once a device).
cudaError_t device_sms(int* sms) {
  static int counts[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && counts[device] > 0) {
    *sms = counts[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) counts[device] = *sms;
  return err;
}

template <typename T, int VEC, bool LEAKY>
cudaError_t launch_nhwc(const void* src, const float* bias, void* dst,
                        long long n, int C, cudaStream_t stream) {
  int sms = 0;
  if (const cudaError_t err = device_sms(&sms)) return err;
  const long long vectors = n / VEC > 0 ? n / VEC : 1;
  long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSM) blocks = (long long)sms * kBlocksPerSM;
  conv_epilogue_nhwc_kernel<T, VEC, LEAKY><<<(unsigned)blocks, kThreads, 0,
                                             stream>>>(
      static_cast<const T*>(src), bias, static_cast<T*>(dst), n, C);
  return cudaGetLastError();
}

template <typename T, bool LEAKY>
cudaError_t launch_nchw(const void* src, const float* bias, void* dst, int N,
                        int HW, int C, cudaStream_t stream) {
  const dim3 grid((HW + kTile - 1) / kTile, (C + kTile - 1) / kTile, N);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  conv_epilogue_nchw_kernel<T, LEAKY><<<grid, dim3(kTile, kTileRows), 0,
                                        stream>>>(
      static_cast<const T*>(src), bias, static_cast<T*>(dst), HW, C);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch(const void* y, const float* bias, void* out, int N, int HW,
                   int C, bool nchw, bool leaky, cudaStream_t stream) {
  if (nchw)
    return leaky ? launch_nchw<T, true>(y, bias, out, N, HW, C, stream)
                 : launch_nchw<T, false>(y, bias, out, N, HW, C, stream);
  const long long n = (long long)N * HW * C;
  const bool aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!aligned)
    return leaky ? launch_nhwc<T, 1, true>(y, bias, out, n, C, stream)
                 : launch_nhwc<T, 1, false>(y, bias, out, n, C, stream);
  return leaky ? launch_nhwc<T, VEC, true>(y, bias, out, n, C, stream)
               : launch_nhwc<T, VEC, false>(y, bias, out, n, C, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. ``y`` is (N, C, H, W) with
// HW = H*W, channels_last (``nchw`` 0; ``out`` may be ``y``: in place) or
// contiguous NCHW (``nchw`` 1); ``bias`` C float32 values; ``out`` (N, H,
// W, C) contiguous in y's dtype; ``leaky`` 0 or 1. Returns a cudaError_t.
extern "C" int transflow_conv_epilogue(const void* y, int dtype,
                                       const void* bias, void* out, int N,
                                       int HW, int C, int nchw, int leaky,
                                       void* stream) {
  if (N < 1 || HW < 1 || C < 1 || C > kMaxChannels || dtype < 0 ||
      dtype > 1 || nchw < 0 || nchw > 1 || leaky < 0 || leaky > 1 ||
      y == nullptr || bias == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, 8>(y, b, out, N, HW, C, nchw, leaky, s);
  return (int)launch<float, 4>(y, b, out, N, HW, C, nchw, leaky, s);
}
