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
// equal their plain versions bit for bit. Each output keeps its terms in
// one thread, so no sum is split.
//
// Bounds on the H100. B16 at the cost volume's level 2 (272x480x49 f32 in,
// 544x960x49 f32 out) moves ~128 MB, ~38 us at 3.35 TB/s, against 0.2
// GFLOP: bound by device memory, four fifths of it the output. B17 at
// level 2 reads 51 MB of bf16 distances and writes 4 MB: ~17 us, against
// ~0.1 GFLOP and 26 M exponentials. Its instructions weigh as much as its
// bytes: CUDA's expf alone is 9 instructions (the result must equal it),
// ~1,150 a pixel at S = 7 with the products and sums, ~20 us at one
// instruction a cycle on every scheduler.
//
// B16's design: a thread takes one (column, channel) pair p = b C + c of
// the input row (kThreads consecutive pairs a block, so a warp's loads and
// stores are runs of consecutive channels) and a band of kUpRows input
// rows (halved on frames too small to give each SM two blocks). It finds
// b and c with one division (no division an output element), loads its
// channel's 16 taps into registers once, and walks down the band with a
// 3x3 window of x in registers: each row brings in 3 values, loaded a row
// ahead (the neighbouring columns are the neighbouring pairs' loads, so
// they come from L1), and each row's 2x2 output quad is four stores. No
// shared memory: with the band staged there, or the quads written through
// it, each block's staging, sums and stores ran in series and the kernel
// was slower (PERF.md §6 has the times).
//
// B17's design: a persistent block walks tiles of kRegCols x kRegRows
// pixels (the grid balanced over the resident blocks), staging the next
// tile while it computes the current one: each tile row's distance run
// (32 S*S values, contiguous) by 16-byte cp.async, each staged run
// shifted so that its chunks line up with the device's 16 bytes (element
// copies at its ends, where a row does not start on 16 bytes, as at odd
// W), and the flow's tile with its P-pixel halo by 8- or 4-byte cp.async
// (zeros outside the frame), so each tap reads shared memory. A thread
// keeps its pixel's S*S squared distances in registers, takes their max
// in 8 independent chains (the max of values <= -0 is the same in any
// order; NaN from a sum of them), then makes each exponential once and
// uses it at once for the softmax's sum and both axes' taps, the sums in
// their order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// B16: input rows a band
constexpr int kUpRows = 8;
// B17: a tile's pixels a row and rows
constexpr int kRegCols = 32;
constexpr int kRegRows = 4;

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

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The element offset, modulo 16 bytes, of element e of an array at base:
// where a staged run starting at e sits in its 16-byte aligned slot, so
// that its 16-byte chunks line up with the device's.
template <typename T>
__device__ __forceinline__ int run_shift(const T* base, long long e) {
  constexpr int V = 16 / (int)sizeof(T);
  return (int)((reinterpret_cast<uintptr_t>(base) / sizeof(T) +
                (unsigned long long)e) &
               (V - 1));
}

// Stage the n elements from src into dst + shift (dst 16-byte aligned,
// shift = run_shift of src's first element) with the block's threads,
// thread ``tid`` of ``threads``: 16-byte cp.async chunks where a chunk
// lies inside the run, element copies at its ends.
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, int shift,
                                          int n, int tid, int threads) {
  constexpr int V = 16 / (int)sizeof(T);
  for (int q = tid; q < (shift + n + V - 1) / V; q += threads) {
    const int j = q * V - shift;
    if (j >= 0 && j + V <= n) {
      cp_async16(dst + q * V, src + j);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (j + t >= 0 && j + t < n) dst[shift + j + t] = src[j + t];
    }
  }
}

// B16: a thread takes one (column, channel) pair p = b C + c of the input
// row (kThreads consecutive pairs a block) and a band of ``band`` input
// rows (blockIdx.y), and walks down it with a 3x3 window of x in
// registers: each row brings in 3 values (from L1: the neighbouring
// columns are the neighbouring pairs' loads), the next row's loaded while
// this one's quad is made and stored.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample2x_phases_kernel(const T* __restrict__ x,
                             const float* __restrict__ weight,
                             T* __restrict__ out, int h, int w, int C,
                             int band) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)w * C) return;
  const int b = (int)(p / C), c = (int)(p - (long long)b * C);
  const int a0 = blockIdx.y * band, rows = min(band, h - a0);
  const bool left = b > 0, right = b + 1 < w;
  float tap[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) tap[k] = __ldg(weight + 16 * c + k);
  // input row y's three values around column b, zeros outside the frame
  const T* col = x + p;
  auto load = [&](int y, float* v) {
    const bool in = y >= 0 && y < h;
    const T* at = col + (long long)y * w * C;
    v[0] = in && left ? widen(at[-C]) : 0.f;
    v[1] = in ? widen(at[0]) : 0.f;
    v[2] = in && right ? widen(at[C]) : 0.f;
  };
  float win[3][3], next[3];
  load(a0 - 1, win[1]);
  load(a0, win[2]);
  load(a0 + 1, next);
  const long long out_row = 2LL * w * C;  // elements an output row
  T* o = out + 2LL * a0 * out_row + 2LL * b * C + c;
  for (int a = 0; a < rows; ++a) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      win[0][dx] = win[1][dx];
      win[1][dx] = win[2][dx];
      win[2][dx] = next[dx];
    }
    if (a + 1 < rows) load(a0 + a + 2, next);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int ki = r + 2 * u, kj = s + 2 * v;
            const float term =
                __fmul_rn(tap[(3 - ki) * 4 + (3 - kj)], win[r + u][s + v]);
            acc = u == 0 && v == 0 ? term : __fadd_rn(acc, term);
          }
        }
        o[r * out_row + s * C] = narrow<T>(acc);
      }
    }
    o += 2 * out_row;
  }
}

// B17: a persistent block walks tiles of kRegCols x kRegRows
// pixels, blockIdx.x + k gridDim.x, staging the next tile's distances and
// flow (cp.async) while it computes the current one; S the window's side.
template <typename TD, typename TF, int S>
struct RegLayout {
  static constexpr int S2 = S * S, P = (S - 1) / 2;
  static constexpr int TX = kRegCols, TY = kRegRows;
  static constexpr int V = 16 / (int)sizeof(TD);
  static constexpr int kPitch = (TX * S2 + 2 * V - 2) / V * V;
  static constexpr int FX = TX + 2 * P, FY = TY + 2 * P;
  static constexpr int kDist = TY * kPitch * (int)sizeof(TD);
  static constexpr int kFlow =
      (FY * FX * 2 * (int)sizeof(TF) + 15) / 16 * 16;
  static constexpr int kStage = kDist + kFlow;
  static constexpr int kSmem = 2 * kStage + S2 * 8;
};

// cp.async of ``bytes`` (8 or 4) from src, or zeros where ``in`` is false.
__device__ __forceinline__ void cp_async_zfill(void* smem_dst, const void* src,
                                               bool in, int bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

template <typename TD, typename TF, int S>
__device__ __forceinline__ void reg_stage(unsigned char* buf,
                                          const TD* __restrict__ dist,
                                          const TF* __restrict__ flow, int H,
                                          int W, int i0, int j0, int tid) {
  using L = RegLayout<TD, TF, S>;
  TD* rows = reinterpret_cast<TD*>(buf);
  TF* fl = reinterpret_cast<TF*>(buf + L::kDist);
  const int n = min(L::TX, W - j0);
  for (int ty = 0; ty < L::TY && i0 + ty < H; ++ty) {
    const long long e = ((long long)(i0 + ty) * W + j0) * L::S2;
    stage_run(rows + ty * L::kPitch, dist + e, run_shift(dist, e),
              n * L::S2, tid, L::TX * L::TY);
  }
  for (int k = tid; k < L::FY * L::FX; k += L::TX * L::TY) {
    const int y = i0 - L::P + k / L::FX, xx = j0 - L::P + k % L::FX;
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    cp_async_zfill(fl + 2 * k, in ? flow + 2 * ((long long)y * W + xx) : flow,
                   in, 2 * (int)sizeof(TF));
  }
}

template <typename TD, typename TF, int S>
__global__ void __launch_bounds__(kRegCols * kRegRows)
    reg_apply_kernel(const TD* __restrict__ dist, const TF* __restrict__ flow,
                     const float* __restrict__ wx,
                     const float* __restrict__ bx,
                     const float* __restrict__ wy,
                     const float* __restrict__ by, float* __restrict__ out,
                     int H, int W) {
  using L = RegLayout<TD, TF, S>;
  constexpr int S2 = L::S2;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* taps = reinterpret_cast<float2*>(smem + 2 * L::kStage);
  const int tid = threadIdx.x;
  const int tiles_x = (W + L::TX - 1) / L::TX;
  const int tiles = tiles_x * ((H + L::TY - 1) / L::TY);
  if (tid < S2) taps[tid] = make_float2(__ldg(wx + tid), __ldg(wy + tid));
  int t = blockIdx.x;
  if (t < tiles)
    reg_stage<TD, TF, S>(smem, dist, flow, H, W, t / tiles_x * L::TY,
                         t % tiles_x * L::TX, tid);
  cp_async_commit();
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    const int next = t + gridDim.x;
    if (next < tiles)
      reg_stage<TD, TF, S>(smem + ((it + 1) & 1) * L::kStage, dist, flow, H,
                           W, next / tiles_x * L::TY, next % tiles_x * L::TX,
                           tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* buf = smem + (it & 1) * L::kStage;
    const TD* rows = reinterpret_cast<const TD*>(buf);
    const TF* fl = reinterpret_cast<const TF*>(buf + L::kDist);
    const int i0 = t / tiles_x * L::TY, j0 = t % tiles_x * L::TX;
    const int tx = tid % L::TX, ty = tid / L::TX;
    const int i = i0 + ty, j = j0 + tx;
    if (i < H && j < W) {
      const long long e = ((long long)i * W + j0) * S2;
      const TD* row = rows + ty * L::kPitch + run_shift(dist, e) + tx * S2;
      float d[S2];
#pragma unroll
      for (int k = 0; k < S2; ++k) {
        const float v = widen(row[k]);
        d[k] = -__fmul_rn(v, v);
      }
      // torch.amax's max, NaN if any is NaN. Every d_k is -0 or negative,
      // so the max of the non-NaN values is the same in any order, and the
      // sum of all of them is NaN only where one is: both are taken in 8
      // independent chains, then folded
      float most[8], sum_d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) most[k] = sum_d[k] = d[k];
#pragma unroll
      for (int k = 8; k < S2; ++k) {
        most[k % 8] = fmaxf(most[k % 8], d[k]);
        sum_d[k % 8] = __fadd_rn(sum_d[k % 8], d[k]);
      }
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        most[0] = fmaxf(most[0], most[k]);
        sum_d[0] = __fadd_rn(sum_d[0], sum_d[k]);
      }
      const float m = sum_d[0] != sum_d[0] ? sum_d[0] : most[0];
      float sum = 0.f, acc_x = 0.f, acc_y = 0.f;
      const TF* f = fl + 2 * (ty * L::FX + tx);
#pragma unroll
      for (int dy = 0; dy < S; ++dy) {
#pragma unroll
        for (int dx = 0; dx < S; ++dx) {
          const int k = dy * S + dx;
          const float ek = expf(__fsub_rn(d[k], m));
          sum = k == 0 ? ek : __fadd_rn(sum, ek);
          const float2 tk = taps[k];
          const TF* v = f + 2 * (dy * L::FX + dx);
          acc_x =
              __fadd_rn(acc_x, __fmul_rn(__fmul_rn(tk.x, ek), widen(v[0])));
          acc_y =
              __fadd_rn(acc_y, __fmul_rn(__fmul_rn(tk.y, ek), widen(v[1])));
        }
      }
      const float divisor = __frcp_rn(sum);
      reinterpret_cast<float2*>(out)[(long long)i * W + j] =
          make_float2(__fmul_rn(__fadd_rn(acc_x, __ldg(bx)), divisor),
                      __fmul_rn(__fadd_rn(acc_y, __ldg(by)), divisor));
    }
    __syncthreads();
  }
}

// B16's band: kUpRows input rows a block, halved until the grid gives
// each of the ``sms`` SMs two blocks.
int up_band(int h, int w, int C, int sms) {
  const long long across = ((long long)w * C + kThreads - 1) / kThreads;
  int band = kUpRows;
  while (band > 1 && across * ((h + band - 1) / band) < 2LL * sms) band /= 2;
  return band;
}

// The blocks of a persistent grid over ``tiles`` tiles with at most
// ``slots`` resident: every block takes the same number of tiles, but
// for the last ones.
int balanced_grid(long long tiles, long long slots) {
  const long long each = (tiles + slots - 1) / slots;
  return (int)((tiles + each - 1) / each);
}

// The current device, its SM count (asked once a device).
cudaError_t device_sms(int* device, int* sms) {
  static int counts[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < kMaxDevices && counts[*device] > 0) {
    *sms = counts[*device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *device);
  if (err == cudaSuccess && *device < kMaxDevices) counts[*device] = *sms;
  return err;
}

template <typename T>
cudaError_t launch_upsample(const void* x, const float* weight, void* out,
                            int h, int w, int C, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return err;
  const int band = up_band(h, w, C, sms);
  const long long across = ((long long)w * C + kThreads - 1) / kThreads;
  const long long down = (h + band - 1) / band;
  if (across > 0x7fffffffLL || down > 65535) return cudaErrorInvalidValue;
  upsample2x_phases_kernel<T>
      <<<dim3((unsigned)across, (unsigned)down), kThreads, 0, stream>>>(
          static_cast<const T*>(x), weight, static_cast<T*>(out), h, w, C,
          band);
  return cudaGetLastError();
}

template <typename TD, typename TF, int S>
cudaError_t launch_reg(const void* dist, const void* flow, const float* wx,
                       const float* bx, const float* wy, const float* by,
                       float* out, int H, int W, cudaStream_t stream) {
  using L = RegLayout<TD, TF, S>;
  // the blocks an SM holds, found once a device with the shared-memory
  // limit raised where needed: both calls cost host time on every launch
  static int resident[kMaxDevices] = {};
  int device = 0, sms = 0;
  cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return err;
  int per_sm = device < kMaxDevices ? resident[device] : 0;
  if (per_sm == 0) {
    if (L::kSmem > 48 * 1024) {
      err = cudaFuncSetAttribute(reg_apply_kernel<TD, TF, S>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::kSmem);
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reg_apply_kernel<TD, TF, S>, L::TX * L::TY, L::kSmem);
    if (err != cudaSuccess) return err;
    per_sm = per_sm > 0 ? per_sm : 1;
    if (device < kMaxDevices) resident[device] = per_sm;
  }
  const long long tiles = (long long)((W + L::TX - 1) / L::TX) *
                          ((H + L::TY - 1) / L::TY);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = balanced_grid(tiles, (long long)per_sm * sms);
  reg_apply_kernel<TD, TF, S><<<grid, L::TX * L::TY, L::kSmem, stream>>>(
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
// Returns a cudaError_t (cudaErrorInvalidValue where three rows of one
// column exceed a block's shared memory: C above ~6,400 in float32).
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
