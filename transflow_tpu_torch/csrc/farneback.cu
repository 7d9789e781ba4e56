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
// where the JAX function rounds it, and every sum is taken in tap order
// with each addition rounded to float32, which is the order of the plain
// versions in ops/farneback.py: a kernel and its plain version agree bit
// for bit. Products are __fmul_rn and sums __fadd_rn (no contraction),
// except where a fused multiply-add is exact (``mac`` below). Built
// without --use_fast_math, so 1 / det is the IEEE division.
//
// Bounds on the H100 at a 1080x1920 frame's four levels (2.75 Mpixel), bf16
// storage: B1 moves 12 bytes per pixel and image (the image in, five planes
// out) and does ~254 float32 operations (9 correlations of 11 taps and the
// fit), so it is bound by operations, ~21 us per frame for both images; B2a
// moves ~40 bytes (flow, both images' planes, six planes out), ~99 us for
// 12 launches; B2b 28 bytes (six planes and the flow in, the flow out), ~69
// us for 12, bound by bytes.
//
// What the design does about it. B1 and B2b at cv2's defaults (poly_n 5 or
// 7, a 15-tap window) are register-window kernels, with the tap count a
// template parameter so every loop unrolls and every pitch is a constant:
//  * a block stages its tile of a plane with the window's halo in shared
//    memory by 16-byte cp.async copies of rows aligned to 16 bytes; only
//    blocks whose window crosses the frame's edge test each chunk and pad
//    (zeros, or numpy's symmetric map, the one integer modulo left);
//  * the vertical pass gives each thread a column strip of R rows: it loads
//    the R + taps - 1 staged values into registers once and makes R
//    ordered sums from them (B1: the three correlations with g, x*g and
//    x^2*g share that one window) into a float tile;
//  * the horizontal pass gives each thread a row strip of K outputs: it
//    loads K + taps - 1 values of each row once and makes every sum of its
//    outputs from registers (B1: all six moments from three rows, then the
//    fit; B2b: the aggregates of all six planes stay in registers across
//    the plane loop, and the solve runs from them);
//  * B2b double-buffers the staging: plane c + 1's copies are in flight
//    while plane c is summed, two barriers per plane;
//  * outputs leave through shared memory, coalesced along x: B1's (H, W, 5)
//    rows as 16-byte stores, B2b's flow as float2;
//  * tiles: 32x64 outputs per 256-thread block where that grid gives every
//    SM a block per image (1080p's L0 and L1: the staged tile is 1.75x the
//    outputs, against 2.7x for 16x32), else 16x32 outputs per 128-thread
//    block, so that L2 and L3 keep the block count of the 16x32 tiles;
//  * B1 takes both images of a level in one launch (``blockIdx.z``).
// Other tap counts run ``*_kernel_rt``: the same sums from a 16x32 tile in
// shared memory, walking the taps there, with the padding in edge blocks
// only and no division in its loops.
//
// B2a is bound by bytes too, but its taps are a gather: the 2x2 pixels of
// image 2's (H, W, 5) stack around x + d, a different place for every
// pixel. It keeps one thread a pixel (32x8 blocks, 32 registers) reading
// each tap's five values as 2-byte loads through L1. On smooth flows, the
// main path's, a warp's samples fall on two or three neighbouring rows and
// its loads share a few lines, so it reads near the bound at the large
// levels; at the small ones it is launch latency. Measured on the H100
// (PERF.md §6), each bit-equal: staging image 2's tile with a margin in
// shared memory with several outputs a thread, wide flow loads and plane
// stores; 2 or 4 outputs a thread with 8-byte tap words; and a per-warp
// choice between 8-byte tap words and these loads. Each took more
// registers or instructions and was no faster on the main path's flows;
// only scattered flows, whose lanes touch a line each, gained.
//
// Fused multiply-adds. In bf16 storage both factors of every product of
// B1's correlations are bf16 (the image is rounded to bf16 at staging, the
// fy planes are rounded to bf16, the taps are ``rounded_taps(..., bf16)``),
// and so are those of B2b's Gaussian vertical pass (bf16 planes, vertical
// taps rounded to storage). A product of two bf16 values has at most 16
// significant bits, so it is exact in float32 short of a subnormal product
// (these planes do not reach one), and fmaf(a, b, acc) then equals
// __fadd_rn(__fmul_rn(a, b), acc) bit for bit. ``mac<true>`` is used only
// there. float32 storage, B1's fit (bf16 moments times float32 ginv) and
// B2b's horizontal Gaussian pass (float32 sums times float32 taps) keep
// __fmul_rn/__fadd_rn. The box's taps are 1.0, and v * 1.f is v, so its
// passes are adds only. The launchers check that the taps given for an
// exact product are bf16 values, and run the runtime kernel otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// the runtime-count kernels and B2a: 32x8 threads, 16x32 outputs
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kTileW = kBlockX;
constexpr int kTileH = 2 * kBlockY;
constexpr int kMaxPolyN = 12;
constexpr int kMaxPolyTaps = 2 * kMaxPolyN + 1;
constexpr int kMaxWinTaps = 63;
constexpr int kWinTaps = 15;  // cv2's default winsize

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// acc + a * b: one fused multiply-add where the caller knows a * b exact in
// float32 (see the head of the file), else rounded product, rounded sum
template <bool kFma>
__device__ __forceinline__ float mac(float a, float b, float acc) {
  return kFma ? fmaf(a, b, acc) : add(acc, mul(a, b));
}

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load<bf16>(const bf16* p) {
  return __bfloat162float(*p);
}

// ``v`` as the storage dtype T holds it
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T stored(float v);
template <>
__device__ __forceinline__ float stored<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 stored<bf16>(float v) {
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

// sum_k w[j + k] * taps[k] over kTaps taps of a register window, in tap
// order (kOnes: every tap is 1, so the products are the values)
template <int kTaps, bool kFma, bool kOnes, int kLen>
__device__ __forceinline__ float window_sum(const float (&w)[kLen], int j,
                                            const float* taps) {
  float acc = kOnes ? w[j] : mul(w[j], taps[0]);
#pragma unroll
  for (int k = 1; k < kTaps; ++k)
    acc = kOnes ? add(acc, w[j + k]) : mac<kFma>(w[j + k], taps[k], acc);
  return acc;
}

// ---------------------------------------------------------------------------
// Tiles and staging of the register-window kernels
// ---------------------------------------------------------------------------

// kH x kW outputs per block of kThreadCount threads; a vertical strip is
// kR rows of one column, a horizontal strip kK outputs of one row, one per
// thread. Blocks of 512 threads per SM at most 128 registers a thread
// (``min_blocks``, for __launch_bounds__).
template <int kH, int kW, int kThreadCount, int kR, int kK>
struct Tile {
  static constexpr int H = kH;
  static constexpr int W = kW;
  static constexpr int threads = kThreadCount;
  static constexpr int min_blocks = 512 / kThreadCount;
  static constexpr int R = kR;
  static constexpr int K = kK;
  static constexpr int strips = kW / kK;  // horizontal strips of a row
  static_assert(kH % kR == 0 && kW % kK == 0 && kH * strips == kThreadCount,
                "one horizontal strip per thread");
  static_assert(kW % 8 == 0, "tile columns start on 16 bytes");
};
using BigTile = Tile<32, 64, 256, 8, 8>;
using SmallTile = Tile<16, 32, 128, 4, 4>;

// The staged window of a plane of T for a tile kTileW outputs wide with a
// halo of kLo columns on the left and kSpan in all, kRows rows: it starts
// ``shift`` columns before x0 - kLo, on a multiple of a 16-byte chunk's V
// elements, and its pitch holds whole chunks.
template <typename T, int kTileW, int kLo, int kSpan, int kRows>
struct Staged {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int shift = (kLo + V - 1) / V * V - kLo;
  static constexpr int cols = kTileW + kSpan;  // the columns the sums read
  static constexpr int pitch = (shift + cols + V - 1) / V * V;
  static constexpr int chunks = pitch / V;
  static constexpr int rows = kRows;
  static constexpr int bytes = rows * pitch * (int)sizeof(T);
};

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

// plane[y][x] under the padding: numpy's symmetric, or zeros outside
template <typename T, bool kSymmetric>
__device__ __forceinline__ T padded(const T* __restrict__ plane, int H, int W,
                                    int y, int x) {
  if (kSymmetric)
    return plane[(long long)symmetric(y, H) * W + symmetric(x, W)];
  if (y < 0 || y >= H || x < 0 || x >= W) return stored<T>(0.f);
  return plane[(long long)y * W + x];
}

// Stage rows [y, y + S::rows) and columns [x, x + S::pitch) of an H x W
// plane at dst. ``interior``: the window lies in the frame and rows start
// on 16 bytes, so every chunk is a cp.async with no test. Else a chunk
// inside the frame is a cp.async where rows start on 16 bytes
// (``row16``), and the rest are padded element by element. The caller
// commits and waits.
template <typename S, int kThreadCount, bool kSymmetric, typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ plane,
                                      int H, int W, int y, int x,
                                      bool interior, bool row16, int tid) {
  constexpr int V = S::V;
  if (interior) {
    for (int e = tid; e < S::rows * S::chunks; e += kThreadCount) {
      const int r = e / S::chunks;
      const int j = e - r * S::chunks;
      cp_async16(dst + r * S::pitch + j * V,
                 plane + (long long)(y + r) * W + x + j * V);
    }
    return;
  }
  for (int e = tid; e < S::rows * S::chunks; e += kThreadCount) {
    const int r = e / S::chunks;
    const int j = e - r * S::chunks;
    const int gy = y + r;
    const int gx = x + j * V;
    T* d = dst + r * S::pitch + j * V;
    if (row16 && gy >= 0 && gy < H && gx >= 0 && gx + V <= W) {
      cp_async16(d, plane + (long long)gy * W + gx);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        d[i] = padded<T, kSymmetric>(plane, H, W, gy, gx + i);
    }
  }
}

template <typename Tl>
dim3 tile_grid(int H, int W, int images) {
  return dim3((W + Tl::W - 1) / Tl::W, (H + Tl::H - 1) / Tl::H, images);
}

int sm_count() {
  int device = 0;
  int count = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
  return count;
}

// BigTile where its grid gives every SM a block per image, else SmallTile
bool big_tiles(int H, int W) {
  const dim3 grid = tile_grid<BigTile>(H, W, 1);
  return (long long)grid.x * grid.y >= sm_count();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// every value of v is a bf16 value (its low 16 bits are 0)
bool bf16_values(const float* v, int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t bits;
    memcpy(&bits, v + i, sizeof(bits));
    if (bits & 0xffffu) return false;
  }
  return true;
}

bool all_ones(const float* v, int n) {
  for (int i = 0; i < n; ++i)
    if (v[i] != 1.f) return false;
  return true;
}

// ---------------------------------------------------------------------------
// B1: polynomial expansion
// ---------------------------------------------------------------------------

struct PolyParams {
  float taps[3][kMaxPolyTaps];  // g, x*g, x^2*g, rounded to the storage dtype
  float ginv[36];
};

// Register windows, poly_n = kN. Block: a Tl::H x Tl::W tile of output
// pixels of image 1 (blockIdx.z 0) or 2. The image tile with a halo of kN
// is staged as it is stored (rounded to Tout when read); the vertical pass
// writes fy0, fy1, fy2 for the tile's rows and every staged column; each
// thread then makes the six moments and the fit of its K pixels, and the
// coefficients leave through shared memory in 16-byte row stores.
template <typename Tin, typename Tout, int kN, typename Tl>
__global__ void __launch_bounds__(Tl::threads, Tl::min_blocks)
    poly_expansion_kernel(const Tin* __restrict__ image1,
                          const Tin* __restrict__ image2,
                          Tout* __restrict__ out1, Tout* __restrict__ out2,
                          int H, int W, int row16_in, int row16_out,
                          const __grid_constant__ PolyParams p) {
  constexpr int kTaps = 2 * kN + 1;
  constexpr int kSpan = 2 * kN;
  using S = Staged<Tin, Tl::W, kN, kSpan, Tl::H + kSpan>;
  // bf16 values times bf16 taps: exact products
  constexpr bool kFma = std::is_same<Tout, bf16>::value;
  constexpr int kFyPlane = Tl::H * S::cols;  // floats of one fy plane
  constexpr int kWork = S::bytes + 3 * kFyPlane * (int)sizeof(float);
  constexpr int kRowValues = Tl::W * 5;  // a tile row of the (H, W, 5) stack
  constexpr int kOut = Tl::H * kRowValues * (int)sizeof(Tout);
  __shared__ __align__(16) unsigned char smem[kWork > kOut ? kWork : kOut];
  Tin* staged = reinterpret_cast<Tin*>(smem);
  float* fy = reinterpret_cast<float*>(smem + S::bytes);

  const Tin* image = blockIdx.z ? image2 : image1;
  Tout* out = blockIdx.z ? out2 : out1;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * Tl::W;
  const int y0 = blockIdx.y * Tl::H;
  const int sy = y0 - kN;
  const int sx = x0 - kN - S::shift;
  const bool interior = row16_in && sy >= 0 && sy + S::rows <= H &&
                        sx >= 0 && sx + S::pitch <= W;
  stage<S, Tl::threads, true>(staged, image, H, W, sy, sx, interior,
                              row16_in, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // fy0, fy1, fy2 = the columns against g, x*g, x^2*g
  for (int t = tid; t < S::cols * (Tl::H / Tl::R); t += Tl::threads) {
    const int strip = t / S::cols;
    const int col = t - strip * S::cols;
    const Tin* src = staged + strip * Tl::R * S::pitch + S::shift + col;
    float v[Tl::R + kSpan];
#pragma unroll
    for (int i = 0; i < Tl::R + kSpan; ++i) {
      const float value = load(src + i * S::pitch);
      v[i] = std::is_same<Tin, Tout>::value ? value : rounded<Tout>(value);
    }
    float* dst = fy + strip * Tl::R * S::cols + col;
#pragma unroll
    for (int j = 0; j < Tl::R; ++j) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
        dst[m * kFyPlane + j * S::cols] =
            rounded<Tout>(window_sum<kTaps, kFma, false>(v, j, p.taps[m]));
    }
  }
  __syncthreads();

  const int hr = tid / Tl::strips;
  const int hx = (tid - hr * Tl::strips) * Tl::K;
  float coef[Tl::K][5];
  {
    float w[3][Tl::K + kSpan];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float* src = fy + m * kFyPlane + hr * S::cols + hx;
#pragma unroll
      for (int i = 0; i < Tl::K + kSpan; ++i) w[m][i] = src[i];
    }
    const float* g = p.taps[0];
    const float* xg = p.taps[1];
    const float* xxg = p.taps[2];
#pragma unroll
    for (int j = 0; j < Tl::K; ++j) {
      // [m00, m10, m01, m20, m02, m11]
      float m[6];
      m[0] = window_sum<kTaps, kFma, false>(w[0], j, g);
      m[1] = window_sum<kTaps, kFma, false>(w[0], j, xg);
      m[2] = window_sum<kTaps, kFma, false>(w[1], j, g);
      m[3] = window_sum<kTaps, kFma, false>(w[0], j, xxg);
      m[4] = window_sum<kTaps, kFma, false>(w[2], j, g);
      m[5] = window_sum<kTaps, kFma, false>(w[1], j, xg);
#pragma unroll
      for (int k = 0; k < 6; ++k) m[k] = rounded<Tout>(m[k]);
      // coefficients 1..5 of m @ ginv.T: [bx, by, axx, ayy, axy]
#pragma unroll
      for (int k = 1; k < 6; ++k) {
        float c = mul(m[0], p.ginv[k * 6]);
#pragma unroll
        for (int l = 1; l < 6; ++l) c = add(c, mul(m[l], p.ginv[k * 6 + l]));
        c = rounded<Tout>(c);
        if (k == 5) c = mul(c, 0.5f);  // exact in either dtype
        coef[j][k - 1] = c;
      }
    }
  }
  __syncthreads();  // the coefficients overwrite the staged tile and fy

  Tout* tile = reinterpret_cast<Tout*>(smem);
#pragma unroll
  for (int j = 0; j < Tl::K; ++j)
#pragma unroll
    for (int k = 0; k < 5; ++k)
      tile[(hr * Tl::W + hx + j) * 5 + k] = stored<Tout>(coef[j][k]);
  __syncthreads();

  Tout* row0 = out + ((long long)y0 * W + x0) * 5;
  if (row16_out && x0 + Tl::W <= W) {
    constexpr int V = 16 / (int)sizeof(Tout);
    constexpr int kChunks = kRowValues / V;
    for (int e = tid; e < Tl::H * kChunks; e += Tl::threads) {
      const int r = e / kChunks;
      const int j = e - r * kChunks;
      if (y0 + r >= H) continue;
      *reinterpret_cast<uint4*>(row0 + (long long)r * W * 5 + j * V) =
          *reinterpret_cast<const uint4*>(tile + r * kRowValues + j * V);
    }
  } else {
    for (int e = tid; e < Tl::H * kRowValues; e += Tl::threads) {
      const int r = e / kRowValues;
      const int i = e - r * kRowValues;
      if (y0 + r >= H || x0 + i / 5 >= W) continue;
      row0[(long long)r * W * 5 + i] = tile[e];
    }
  }
}

// Runtime poly_n (1 to kMaxPolyN). Block: a kTileH x kTileW tile of output
// pixels of image 1 (blockIdx.z 0) or 2. The image tile with a halo of n
// (symmetric in edge blocks) is staged rounded to storage; the vertical
// passes cover every staged column of the tile's rows; each thread then
// runs the six horizontal passes and the fit for its two pixels.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    poly_expansion_kernel_rt(const Tin* __restrict__ image1,
                             const Tin* __restrict__ image2,
                             Tout* __restrict__ out1,
                             Tout* __restrict__ out2, int H, int W, int n,
                             const __grid_constant__ PolyParams p) {
  __shared__ float tile[(kTileH + 2 * kMaxPolyN) * (kTileW + 2 * kMaxPolyN)];
  __shared__ float fy[3][kTileH * (kTileW + 2 * kMaxPolyN)];
  const Tin* image = blockIdx.z ? image2 : image1;
  Tout* out = blockIdx.z ? out2 : out1;
  const int taps = 2 * n + 1;
  const int pitch = kTileW + 2 * n;
  const int rows = kTileH + 2 * n;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const bool interior = y0 - n >= 0 && y0 + kTileH + n <= H && x0 - n >= 0 &&
                        x0 + kTileW + n <= W;

  for (int r = threadIdx.y; r < rows; r += kBlockY) {
    for (int c = threadIdx.x; c < pitch; c += kBlockX) {
      int y = y0 - n + r;
      int x = x0 - n + c;
      if (!interior) {
        y = symmetric(y, H);
        x = symmetric(x, W);
      }
      tile[r * pitch + c] = rounded<Tout>(load(image + (long long)y * W + x));
    }
  }
  __syncthreads();

  // fy0, fy1, fy2 = the columns against g, x*g, x^2*g
  for (int r = threadIdx.y; r < kTileH; r += kBlockY) {
    for (int c = threadIdx.x; c < pitch; c += kBlockX) {
      const float* col = tile + r * pitch + c;
#pragma unroll
      for (int m = 0; m < 3; ++m)
        fy[m][r * pitch + c] =
            rounded<Tout>(correlate(col, pitch, p.taps[m], taps));
    }
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

// one or two images of one shape and dtype, each with its output
struct PolyArgs {
  const void* image[2];
  void* out[2];
  int images;
  int H;
  int W;
};

template <typename Tin, typename Tout, int kN, typename Tl>
cudaError_t launch_poly_windows(const PolyArgs& a, const PolyParams& p,
                                cudaStream_t stream) {
  const Tin* i1 = static_cast<const Tin*>(a.image[0]);
  const Tin* i2 = static_cast<const Tin*>(a.image[a.images - 1]);
  Tout* o1 = static_cast<Tout*>(a.out[0]);
  Tout* o2 = static_cast<Tout*>(a.out[a.images - 1]);
  const int row16_in = (a.W * sizeof(Tin)) % 16 == 0 && aligned16(i1) &&
                       aligned16(i2);
  const int row16_out = (a.W * 5 * sizeof(Tout)) % 16 == 0 &&
                        aligned16(o1) && aligned16(o2);
  poly_expansion_kernel<Tin, Tout, kN, Tl>
      <<<tile_grid<Tl>(a.H, a.W, a.images), Tl::threads, 0, stream>>>(
          i1, i2, o1, o2, a.H, a.W, row16_in, row16_out, p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int kN>
cudaError_t launch_poly_n(const PolyArgs& a, const PolyParams& p,
                          cudaStream_t stream) {
  if (big_tiles(a.H, a.W))
    return launch_poly_windows<Tin, Tout, kN, BigTile>(a, p, stream);
  return launch_poly_windows<Tin, Tout, kN, SmallTile>(a, p, stream);
}

template <typename Tin, typename Tout>
cudaError_t launch_poly(const PolyArgs& a, int n, const PolyParams& p,
                        cudaStream_t stream) {
  // the windowed kernels' fused multiply-adds need bf16 taps in bf16
  const bool exact = !std::is_same<Tout, bf16>::value ||
                     bf16_values(&p.taps[0][0], 3 * kMaxPolyTaps);
  if (n == 5 && exact) return launch_poly_n<Tin, Tout, 5>(a, p, stream);
  if (n == 7 && exact) return launch_poly_n<Tin, Tout, 7>(a, p, stream);
  const dim3 grid((a.W + kTileW - 1) / kTileW, (a.H + kTileH - 1) / kTileH,
                  a.images);
  poly_expansion_kernel_rt<Tin, Tout>
      <<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
          static_cast<const Tin*>(a.image[0]),
          static_cast<const Tin*>(a.image[a.images - 1]),
          static_cast<Tout*>(a.out[0]),
          static_cast<Tout*>(a.out[a.images - 1]), a.H, a.W, n, p);
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

// the flow at q: the solve where det > 1e-9 and the window's weight is
// positive, else the old flow (flag ``keep``)
__device__ __forceinline__ float2 solve(const float* agg, bool* keep) {
  const float g11 = agg[0], g12 = agg[1], g22 = agg[2];
  const float h1 = agg[3], h2 = agg[4], weight = agg[5];
  const float det = sub(mul(g11, g22), mul(g12, g12));
  *keep = !(det > 1e-9f && weight > 0.f);
  if (*keep) return make_float2(0.f, 0.f);
  const float inv_det = __fdiv_rn(1.f, det);
  return make_float2(mul(sub(mul(g22, h1), mul(g12, h2)), inv_det),
                     mul(sub(mul(g11, h2), mul(g12, h1)), inv_det));
}

// Register windows, a window of kWinTaps taps: a box (zero padding, the
// vertical sum rounded to bf16 in bf16 storage) or, with kGauss, a
// Gaussian (symmetric padding). Block: a Tl::H x Tl::W tile of output
// pixels. Per plane: the staged tile (plane c + 1's copies in flight
// meanwhile), the vertical pass into ``mid``, the horizontal pass into the
// thread's aggregates; then the solve, and the flow leaves through shared
// memory along x.
template <typename T, bool kGauss, typename Tl>
__global__ void __launch_bounds__(Tl::threads, Tl::min_blocks)
    aggregate_solve_kernel(const T* __restrict__ planes,
                           const float* __restrict__ flow,
                           float* __restrict__ out, int H, int W, int row16,
                           const __grid_constant__ WindowParams p) {
  constexpr int kLo = (kWinTaps - 1) / 2;
  constexpr int kSpan = kWinTaps - 1;
  using S = Staged<T, Tl::W, kLo, kSpan, Tl::H + kSpan>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // bf16 planes times bf16 vertical taps: exact products
  constexpr bool kFma = kGauss && kBf16;
  constexpr bool kRoundMid = !kGauss && kBf16;
  constexpr int kMid = 2 * S::bytes;  // offset of mid
  constexpr int kWork = kMid + Tl::H * S::cols * (int)sizeof(float);
  constexpr int kOut = Tl::H * Tl::W * ((int)sizeof(float2) + 1);
  __shared__ __align__(16) unsigned char smem[kWork > kOut ? kWork : kOut];
  float* mid = reinterpret_cast<float*>(smem + kMid);

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * Tl::W;
  const int y0 = blockIdx.y * Tl::H;
  const int sy = y0 - kLo;
  const int sx = x0 - kLo - S::shift;
  const bool interior = row16 && sy >= 0 && sy + S::rows <= H && sx >= 0 &&
                        sx + S::pitch <= W;
  const long long hw = (long long)H * W;
  const int hr = tid / Tl::strips;
  const int hx = (tid - hr * Tl::strips) * Tl::K;
  float agg[Tl::K][6];

  stage<S, Tl::threads, kGauss>(reinterpret_cast<T*>(smem), planes, H, W, sy,
                                sx, interior, row16, tid);
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    if (c < 5) {
      stage<S, Tl::threads, kGauss>(
          reinterpret_cast<T*>(smem + ((c + 1) & 1) * S::bytes),
          planes + (c + 1) * hw, H, W, sy, sx, interior, row16, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // plane c is staged; mid is free
    const T* staged = reinterpret_cast<const T*>(smem + (c & 1) * S::bytes);
    for (int t = tid; t < S::cols * (Tl::H / Tl::R); t += Tl::threads) {
      const int strip = t / S::cols;
      const int col = t - strip * S::cols;
      const T* src = staged + strip * Tl::R * S::pitch + S::shift + col;
      float v[Tl::R + kSpan];
#pragma unroll
      for (int i = 0; i < Tl::R + kSpan; ++i) v[i] = load(src + i * S::pitch);
      float* dst = mid + strip * Tl::R * S::cols + col;
#pragma unroll
      for (int j = 0; j < Tl::R; ++j) {
        const float sum = window_sum<kWinTaps, kFma, !kGauss>(v, j, p.vtaps);
        dst[j * S::cols] = kRoundMid ? rounded<T>(sum) : sum;
      }
    }
    __syncthreads();  // mid is summed; the staged plane c is free
    float m[Tl::K + kSpan];
    const float* src = mid + hr * S::cols + hx;
#pragma unroll
    for (int i = 0; i < Tl::K + kSpan; ++i) m[i] = src[i];
#pragma unroll
    for (int j = 0; j < Tl::K; ++j)
      agg[j][c] = window_sum<kWinTaps, false, !kGauss>(m, j, p.htaps);
  }
  __syncthreads();  // the flow tile overwrites the staged planes and mid

  float2* tile = reinterpret_cast<float2*>(smem);
  bool* keep = reinterpret_cast<bool*>(smem + Tl::H * Tl::W * sizeof(float2));
#pragma unroll
  for (int j = 0; j < Tl::K; ++j) {
    const int at = hr * Tl::W + hx + j;
    bool k;
    tile[at] = solve(agg[j], &k);
    keep[at] = k;
  }
  __syncthreads();
  for (int e = tid; e < Tl::H * Tl::W; e += Tl::threads) {
    const int r = e / Tl::W;
    const int y = y0 + r;
    const int x = x0 + e - r * Tl::W;
    if (y >= H || x >= W) continue;
    const long long q = (long long)y * W + x;
    reinterpret_cast<float2*>(out)[q] =
        keep[e] ? make_float2(flow[2 * q], flow[2 * q + 1]) : tile[e];
  }
}

// Runtime tap count (1 to kMaxWinTaps). Block: a kTileH x kTileW tile of
// output pixels. Per plane: the tile with the window's halo is staged
// (zeros or symmetric outside the frame, in edge blocks), its columns are
// summed into ``mid`` (rounded to storage where the box asks), and each
// thread sums its two pixels' rows into registers. Dynamic shared memory:
// (kTileH + taps - 1 + kTileH) x (kTileW + taps - 1) floats.
template <typename T, bool kRoundMid>
__global__ void __launch_bounds__(kThreads)
    aggregate_solve_kernel_rt(const T* __restrict__ planes,
                              const float* __restrict__ flow,
                              float* __restrict__ out, int H, int W, int taps,
                              int symmetric_pad,
                              const __grid_constant__ WindowParams p) {
  extern __shared__ float smem_rt[];
  const int lo = (taps - 1) / 2;
  const int pitch = kTileW + taps - 1;
  const int rows = kTileH + taps - 1;
  float* tile = smem_rt;
  float* mid = smem_rt + rows * pitch;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const bool interior = y0 - lo >= 0 && y0 - lo + rows <= H && x0 - lo >= 0 &&
                        x0 - lo + pitch <= W;
  const long long hw = (long long)H * W;
  float agg[kTileH / kBlockY][6];

#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T* plane = planes + c * hw;
    for (int r = threadIdx.y; r < rows; r += kBlockY) {
      for (int col = threadIdx.x; col < pitch; col += kBlockX) {
        const int y = y0 - lo + r;
        const int x = x0 - lo + col;
        float v;
        if (interior)
          v = load(plane + (long long)y * W + x);
        else if (symmetric_pad)
          v = load(plane + (long long)symmetric(y, H) * W + symmetric(x, W));
        else
          v = (y >= 0 && y < H && x >= 0 && x < W)
                  ? load(plane + (long long)y * W + x)
                  : 0.f;
        tile[r * pitch + col] = v;
      }
    }
    __syncthreads();
    for (int r = threadIdx.y; r < kTileH; r += kBlockY) {
      for (int col = threadIdx.x; col < pitch; col += kBlockX) {
        const float s = correlate(tile + r * pitch + col, pitch, p.vtaps, taps);
        mid[r * pitch + col] = kRoundMid ? rounded<T>(s) : s;
      }
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
    const long long q = (long long)y * W + x;
    bool keep;
    const float2 d = solve(agg[half], &keep);
    out[2 * q] = keep ? flow[2 * q] : d.x;
    out[2 * q + 1] = keep ? flow[2 * q + 1] : d.y;
  }
}

template <typename T, bool kGauss>
cudaError_t launch_solve_windows(const void* planes, const float* flow,
                                 float* out, int H, int W,
                                 const WindowParams& p, cudaStream_t stream) {
  const T* src = static_cast<const T*>(planes);
  const int row16 = (W * sizeof(T)) % 16 == 0 && aligned16(src);
  if (big_tiles(H, W)) {
    aggregate_solve_kernel<T, kGauss, BigTile>
        <<<tile_grid<BigTile>(H, W, 1), BigTile::threads, 0, stream>>>(
            src, flow, out, H, W, row16, p);
  } else {
    aggregate_solve_kernel<T, kGauss, SmallTile>
        <<<tile_grid<SmallTile>(H, W, 1), SmallTile::threads, 0, stream>>>(
            src, flow, out, H, W, row16, p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_solve(const void* planes, const float* flow, float* out,
                         int H, int W, int taps, int symmetric_pad,
                         int round_mid, const WindowParams& p,
                         cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  if (taps == kWinTaps) {
    // the box: ones, zero padding, the vertical sum rounded in bf16
    if (!symmetric_pad && (round_mid || !kBf16) &&
        all_ones(p.vtaps, taps) && all_ones(p.htaps, taps))
      return launch_solve_windows<T, false>(planes, flow, out, H, W, p,
                                            stream);
    // the Gaussian: symmetric padding, bf16 vertical taps in bf16
    if (symmetric_pad && !round_mid && (!kBf16 || bf16_values(p.vtaps, taps)))
      return launch_solve_windows<T, true>(planes, flow, out, H, W, p,
                                           stream);
  }
  const size_t smem = sizeof(float) * (size_t)(2 * kTileH + taps - 1) *
                      (size_t)(kTileW + taps - 1);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const T* src = static_cast<const T*>(planes);
  if (kBf16 && round_mid)
    aggregate_solve_kernel_rt<T, true>
        <<<grid, dim3(kBlockX, kBlockY), smem, stream>>>(
            src, flow, out, H, W, taps, symmetric_pad, p);
  else
    aggregate_solve_kernel_rt<T, false>
        <<<grid, dim3(kBlockX, kBlockY), smem, stream>>>(
            src, flow, out, H, W, taps, symmetric_pad, p);
  return cudaGetLastError();
}

int poly_entry(const PolyArgs& a, int dtype, int out_dtype, int n,
               const float* params, void* stream) {
  if (a.H < 1 || a.W < 1 || n < 1 || n > kMaxPolyN || dtype < 0 ||
      dtype > 1 || out_dtype < 0 || out_dtype > 1 || params == nullptr)
    return (int)cudaErrorInvalidValue;
  PolyParams p;
  memset(&p, 0, sizeof(p));
  const int taps = 2 * n + 1;
  for (int m = 0; m < 3; ++m)
    memcpy(p.taps[m], params + m * taps, sizeof(float) * taps);
  memcpy(p.ginv, params + 3 * taps, sizeof(p.ginv));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return (int)launch_poly<float, float>(a, n, p, s);
  if (dtype == 0) return (int)launch_poly<float, bf16>(a, n, p, s);
  if (out_dtype == 0) return (int)launch_poly<bf16, float>(a, n, p, s);
  return (int)launch_poly<bf16, bf16>(a, n, p, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each returns a cudaError_t.

// params (host): the three rows of 2n+1 taps, then ginv's 36 entries
extern "C" int transflow_poly_expansion(const void* image, int dtype,
                                        void* out, int out_dtype, int H,
                                        int W, int n, const float* params,
                                        void* stream) {
  const PolyArgs a = {{image, image}, {out, out}, 1, H, W};
  return poly_entry(a, dtype, out_dtype, n, params, stream);
}

// both images of a level (one shape, one dtype) in one launch
extern "C" int transflow_poly_expansion_pair(const void* image1,
                                             const void* image2, int dtype,
                                             void* out1, void* out2,
                                             int out_dtype, int H, int W,
                                             int n, const float* params,
                                             void* stream) {
  const PolyArgs a = {{image1, image2}, {out1, out2}, 2, H, W};
  return poly_entry(a, dtype, out_dtype, n, params, stream);
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
    return (int)launch_equations<bf16>(poly1, poly2, f, planes, H, W, radius,
                                       s);
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
  if (dtype == 1)
    return (int)launch_solve<bf16>(planes, f, o, H, W, taps, symmetric_pad,
                                   round_mid, p, s);
  return (int)launch_solve<float>(planes, f, o, H, W, taps, symmetric_pad,
                                  round_mid, p, s);
}
