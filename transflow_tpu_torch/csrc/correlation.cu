// 7x7 cost-volume correlation for Hopper (sm_90a): kernels A1 and A2.
//
// Replaces the Pallas TPU kernels of transflow_tpu/ops/pallas_correlation.py:
// pallas_correlation7x7 (-> _corr_call -> _kernel) and its H-sharded form
// sharded_pallas_correlation7x7. It computes
//
//   out[y, x, (dy+3)*7 + (dx+3)] =
//       (1/C) * sum_c f1[y*s, x*s, c] * f2[(y+dy)*s, (x+dx)*s, c]
//
// for dy, dx in [-3, 3], with zeros outside the frame and stride s >= 1.
// f1 is (rows, W, C), row-major, float32 or bfloat16; f2 has the same
// width and depth, in its own dtype; the output is (ceil(rows/s),
// ceil(W/s), 49) float32. All products and sums are float32.
//
// f2 rows come from up to three row segments, each a pointer and a row
// count placed at frame rows [first, first + rows) relative to f1's row 0;
// a row that no segment holds reads as zeros. The unsharded call
// (transflow_corr7x7) passes one segment, the row window (f2_row0,
// f2_rows): frame row r is buffer row r + f2_row0. The sharded call
// (transflow_corr7x7_shards) passes, for each of up to 8 shards on one
// device, the top halo (the previous shard's last 3s rows, or none at the
// frame's edge), the shard's own rows and the bottom halo, read where they
// lie; one launch covers every shard, blockIdx.z = shard.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores).
// At LiteFlowNet's level 2 of a 1088x1920 frame (f1 544x960x64 bf16, f2
// the same in f32, stride 2) the even grid holds ~17 MB of f1 and ~33 MB of
// f2, and the output is ~26 MB: ~75 MB, ~22.6 us; the 0.41 G FMAs take
// ~12 us. Every level is bound by device memory. What the design does:
//  * work units: a block of four warps owns an output tile and splits
//    the channels over K groups of warps, K = 4 where C >= 128, 2 where
//    C >= 64, else 1 (tiles of 8x8, 8x16 and 16x16 pixels), so the small
//    levels fill more of the card. Each group sums its channel range in
//    order; the groups' partial sums are then added in shared memory in a
//    fixed order, ((g0 + g1) + g2) + g3. K depends on C alone, never on
//    the frame or shard size, so a shard's pixel sums A1's products in
//    A1's order and the two agree bit for bit;
//  * copies overlap compute: each group stages 8 channels at a time, f2
//    over the (tile+6)^2 halo and f1 over the tile, in a ring of three
//    buffers with 16-byte cp.async (src-size 0 reads taps outside the
//    frame as zeros); each operand stays in its own dtype in shared
//    memory and is widened when read. Where a row is not a multiple of 16
//    bytes or a base is not 16-byte aligned, the same buffers are filled
//    element by element: the shared-memory image, and so every sum, is
//    the same;
//  * each thread owns 2 neighbouring output pixels of one row (98 sums in
//    registers): per (dy, 16-byte chunk) it reads 8 taps with LDS.128 and
//    does 4 x 14 (f32) or 8 x 14 (bf16) FMAs with them;
//  * the eight lanes of a quarter warp hold eight tile rows, and a halo
//    row's pitch is an odd multiple of 16 bytes, so their 16-byte loads
//    hit distinct banks;
//  * the output tile is staged through shared memory and written to
//    device memory in contiguous runs of TX x 49 floats per row.
// Measured on an H100 it still runs at about a quarter of that bound at
// levels 2-4: the 16-byte shared-memory loads of the inner loop (7 FMAs
// each for an f32 f2) and the staging copies, which do not overlap it,
// set its time (chip_corr_compare.py --ablate cuts each out; PERF.md
// holds the figures). Fewer loads per FMA and TMA copies are next.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kDisp = 3;
constexpr int kWin = 2 * kDisp + 1;
constexpr int kTaps = kWin * kWin;
constexpr int kThreads = 128;             // four warps per block
constexpr int kWarpRows = 8;              // a warp's tile: 8 rows x 8 columns
constexpr int kWarpCols = 8;
constexpr int kPix = 2;                   // output pixels per thread, in x
constexpr int kRun = kPix + 2 * kDisp;    // f2 taps per thread and halo row
constexpr int kSlice = 8;                 // channels per stage and group
constexpr int kStages = 3;
constexpr int kMaxShards = 8;
constexpr int kSegments = 3;
constexpr int kMaxDevices = 64;

struct Segment {
  const char* ptr;  // nullptr: no rows
  int first;        // frame row of the segment's row 0
  int rows;
};

struct Shard {
  const char* f1;
  float* out;
  int rows;  // f1 rows
  Segment seg[kSegments];
};

struct Shards {
  Shard s[kMaxShards];
};

struct Bf16 {
  unsigned short bits;
};

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kBytes = 4;
};
template <>
struct Elem<Bf16> {
  static constexpr int kBytes = 2;
};

// The channel split: depends on C only (see the header).
__host__ __device__ constexpr int channel_groups(int C) {
  return C >= 128 ? 4 : C >= 64 ? 2 : 1;
}

// Channels per group, a whole number of slices.
__host__ __device__ constexpr int group_channels(int C, int K) {
  return ((C + K - 1) / K + kSlice - 1) / kSlice * kSlice;
}

__host__ __device__ constexpr int odd_pitch(int bytes) {
  return (bytes / 16) % 2 == 0 ? bytes + 16 : bytes;
}

// The block's tile and shared-memory layout for K channel groups and
// element sizes B1 (f1) and B2 (f2).
template <int K, int B1, int B2>
struct Tile {
  static constexpr int kWarps = 4 / K;  // warps of one group
  static constexpr int WX = kWarps >= 2 ? 2 : 1;
  static constexpr int TY = kWarpRows * (kWarps / WX);
  static constexpr int TX = kWarpCols * WX;
  static constexpr int HY = TY + 2 * kDisp;
  static constexpr int HX = TX + 2 * kDisp;
  static constexpr int kTapBytes = kSlice * B2;
  static constexpr int kRowPitch = odd_pitch(HX * kTapBytes);
  static constexpr int kF2Group = HY * kRowPitch;
  static constexpr int kF1Group = TY * TX * kSlice * B1;
  static constexpr int kGroup = kF2Group + kF1Group;
  static constexpr int kStage = K * kGroup;
  // a group's sums, staged as [row][pixel][52] floats with a row pitch of
  // 1 mod 32 words: a warp's 32 lanes (8 rows x 4 column pairs) store to
  // 32 distinct banks
  static constexpr int kSumPix = 52;
  static constexpr int kSumRow = TX * kSumPix + 1;
  static constexpr int kSums = TY * kSumRow;
  static constexpr int kData = kStages * kStage > K * kSums * 4
                                   ? kStages * kStage
                                   : (K * kSums * 4 + 15) / 16 * 16;
  // the staging plan: per item (an f2 halo tap, then an f1 tile pixel)
  // the address of its channel 0, nullptr for zeros, and its offset in a
  // group's buffer
  static constexpr int kItems2 = HY * HX;
  static constexpr int kItems = kItems2 + TY * TX;
  static constexpr int kSmem = kData + kItems * (int)(sizeof(const char*) +
                                                      sizeof(int));
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Value i of a 16-byte chunk, widened to float.
template <typename T>
__device__ __forceinline__ float chunk_value(const uint4& v, int i);
template <>
__device__ __forceinline__ float chunk_value<float>(const uint4& v, int i) {
  return __uint_as_float(word(v, i));
}
template <>
__device__ __forceinline__ float chunk_value<Bf16>(const uint4& v, int i) {
  const unsigned w = word(v, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// One run of kSlice channels (lo.. of a pixel whose row of C channels
// starts at src) staged at dst: 16-byte cp.async chunks where ``vec``,
// else element by element; channels at or past ``hi``, and every channel
// where ``ok`` is false, read as zeros. ``safe`` is any valid address.
template <int B>
__device__ __forceinline__ void stage_run(unsigned char* dst, const char* src,
                                          bool ok, int lo, int hi, int vec,
                                          const char* safe) {
  if (vec) {
    constexpr int kPer = 16 / B;
#pragma unroll
    for (int j = 0; j < kSlice * B / 16; ++j) {
      const bool in = ok && lo + j * kPer < hi;
      cp_async16(dst + j * 16, in ? src + j * 16 : safe, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSlice; ++j) {
      const bool in = ok && lo + j < hi;
      if (B == 4)
        *reinterpret_cast<unsigned*>(dst + j * B) =
            in ? *reinterpret_cast<const unsigned*>(src + j * B) : 0u;
      else
        *reinterpret_cast<unsigned short*>(dst + j * B) =
            in ? *reinterpret_cast<const unsigned short*>(src + j * B)
               : static_cast<unsigned short>(0);
    }
  }
}

template <typename T1, typename T2, int K>
__global__ void __launch_bounds__(kThreads)
    corr7x7_kernel(const __grid_constant__ Shards shards, int W, int C,
                   int stride, int vec) {
  constexpr int B1 = Elem<T1>::kBytes;
  constexpr int B2 = Elem<T2>::kBytes;
  using L = Tile<K, B1, B2>;
  constexpr int kChunks1 = kSlice * B1 / 16;  // 16-byte chunks of f1
  constexpr int kChunks2 = kSlice * B2 / 16;  // ... and of one f2 tap
  constexpr int kPer1 = 16 / B1;              // values per chunk
  constexpr int kPer2 = 16 / B2;
  extern __shared__ __align__(16) unsigned char smem[];

  const Shard& sh = shards.s[blockIdx.z];
  const int OH = (sh.rows + stride - 1) / stride;
  const int OW = (W + stride - 1) / stride;
  const int oy0 = blockIdx.y * L::TY;
  const int ox0 = blockIdx.x * L::TX;
  if (oy0 >= OH) return;  // a shorter shard; uniform over the block
  const int tid = threadIdx.x;
  const size_t row_elems = (size_t)W * C;

  // the staging plan, once per block: each halo tap of f2 from the
  // segment that holds its row, each tile pixel of f1
  const char** src0 = reinterpret_cast<const char**>(smem + L::kData);
  int* dst0 = reinterpret_cast<int*>(src0 + L::kItems);
  for (int r = tid; r < L::kItems; r += kThreads) {
    const char* p = nullptr;
    if (r < L::kItems2) {
      const int hx = r % L::HX;
      const int hy = r / L::HX;
      const int fy = (oy0 - kDisp + hy) * stride;
      const int gx = (ox0 - kDisp + hx) * stride;
#pragma unroll
      for (int j = 0; j < kSegments; ++j) {
        const Segment& sg = sh.seg[j];
        if (sg.ptr != nullptr && fy >= sg.first && fy < sg.first + sg.rows &&
            gx >= 0 && gx < W)
          p = sg.ptr + ((size_t)(fy - sg.first) * row_elems +
                        (size_t)gx * C) * B2;
      }
      dst0[r] = hy * L::kRowPitch + hx * L::kTapBytes;
    } else {
      const int q = r - L::kItems2;
      const int oy = oy0 + q / L::TX;
      const int ox = ox0 + q % L::TX;
      if (oy < OH && ox < OW)
        p = sh.f1 + ((size_t)oy * stride * row_elems + (size_t)ox * stride *
                     C) * B1;
      dst0[r] = L::kF2Group + q * kSlice * B1;
    }
    src0[r] = p;
  }
  __syncthreads();

  const int cg = group_channels(C, K);
  const int slices = cg / kSlice;

  // stage slice k of every group into ring buffer k % kStages
  auto issue = [&](int k) {
    if (k < slices) {
      unsigned char* ring = smem + (k % kStages) * L::kStage;
      for (int i = tid; i < K * L::kItems; i += kThreads) {
        const int g = i / L::kItems;
        const int r = i - g * L::kItems;
        const int lo = g * cg + k * kSlice;
        const int hi = min(C, (g + 1) * cg);
        const char* p = src0[r];
        unsigned char* dst = ring + g * L::kGroup + dst0[r];
        if (r < L::kItems2)
          stage_run<B2>(dst, p != nullptr ? p + lo * B2 : sh.f1,
                        p != nullptr, lo, hi, vec, sh.f1);
        else
          stage_run<B1>(dst, p != nullptr ? p + lo * B1 : sh.f1,
                        p != nullptr, lo, hi, vec, sh.f1);
      }
    }
    cp_async_commit();
  };

  // this thread: channel group g, tile row ``row``, tile columns col, col+1
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = warp / L::kWarps;
  const int sw = warp % L::kWarps;
  const int row = (sw / L::WX) * kWarpRows + (lane & 7);
  const int col = (sw % L::WX) * kWarpCols + (lane >> 3) * kPix;

  float acc[kPix][kTaps];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc[p][k] = 0.f;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < slices; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice k is in; every reader of slice k-1 is done
    issue(k + kStages - 1);
    const unsigned char* gbase =
        smem + (k % kStages) * L::kStage + g * L::kGroup;
    const unsigned char* f1s =
        gbase + L::kF2Group + (row * L::TX + col) * kSlice * B1;
    float a[kPix][kSlice];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int j = 0; j < kChunks1; ++j) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            f1s + p * kSlice * B1 + j * 16);
#pragma unroll
        for (int i = 0; i < kPer1; ++i)
          a[p][j * kPer1 + i] = chunk_value<T1>(v, i);
      }
#pragma unroll
    for (int dy = 0; dy < kWin; ++dy) {
      const unsigned char* rp =
          gbase + (row + dy) * L::kRowPitch + col * L::kTapBytes;
#pragma unroll
      for (int j = 0; j < kChunks2; ++j) {
        uint4 t[kRun];
#pragma unroll
        for (int h = 0; h < kRun; ++h)
          t[h] = *reinterpret_cast<const uint4*>(rp + h * L::kTapBytes +
                                                 j * 16);
#pragma unroll
        for (int i = 0; i < kPer2; ++i) {
          const int c = j * kPer2 + i;
          float v[kRun];
#pragma unroll
          for (int h = 0; h < kRun; ++h) v[h] = chunk_value<T2>(t[h], i);
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int dx = 0; dx < kWin; ++dx)
              acc[p][dy * kWin + dx] =
                  fmaf(a[p][c], v[p + dx], acc[p][dy * kWin + dx]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the groups' sums over it

  float* sums = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      sums[g * L::kSums + row * L::kSumRow + (col + p) * L::kSumPix + k] =
          acc[p][k];
  __syncthreads();
  // tile row r is TX pixels x 49 taps, contiguous in out
  const float inv_c = 1.f / (float)C;
  constexpr int kRowFloats = L::TX * kTaps;
  const int valid = (OW - ox0 < L::TX ? OW - ox0 : L::TX) * kTaps;
  for (int i = tid; i < L::TY * kRowFloats; i += kThreads) {
    const int r = i / kRowFloats;
    const int e = i - r * kRowFloats;
    if (oy0 + r < OH && e < valid) {
      const int px = e / kTaps;
      const int at = r * L::kSumRow + px * L::kSumPix + (e - px * kTaps);
      float v = sums[at];
#pragma unroll
      for (int gg = 1; gg < K; ++gg) v += sums[gg * L::kSums + at];
      sh.out[((size_t)(oy0 + r) * OW + ox0) * kTaps + e] = v * inv_c;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T1, typename T2, int K>
cudaError_t launch(const Shards& shards, int n, int W, int C, int stride,
                   cudaStream_t stream) {
  constexpr int B1 = Elem<T1>::kBytes;
  constexpr int B2 = Elem<T2>::kBytes;
  using L = Tile<K, B1, B2>;
  // the vector path needs every f1 and f2 row to start on 16 bytes
  bool vec = (C * B1) % 16 == 0 && (C * B2) % 16 == 0;
  int max_rows = 0;
  for (int i = 0; i < n; ++i) {
    const Shard& s = shards.s[i];
    vec = vec && aligned16(s.f1);
    for (int j = 0; j < kSegments; ++j)
      vec = vec && (s.seg[j].ptr == nullptr || aligned16(s.seg[j].ptr));
    max_rows = s.rows > max_rows ? s.rows : max_rows;
  }
  if (L::kSmem > 48 * 1024) {
    // once per device: the attribute call costs host time on every launch
    static bool raised[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices || !raised[device]) {
      err = cudaFuncSetAttribute(corr7x7_kernel<T1, T2, K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::kSmem);
      if (err != cudaSuccess) return err;
      if (device < kMaxDevices) raised[device] = true;
    }
  }
  const int OH = (max_rows + stride - 1) / stride;
  const int OW = (W + stride - 1) / stride;
  const dim3 grid((OW + L::TX - 1) / L::TX, (OH + L::TY - 1) / L::TY, n);
  corr7x7_kernel<T1, T2, K><<<grid, kThreads, L::kSmem, stream>>>(
      shards, W, C, stride, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T1, typename T2>
cudaError_t launch_groups(const Shards& shards, int n, int W, int C,
                          int stride, cudaStream_t stream) {
  switch (channel_groups(C)) {
    case 4:
      return launch<T1, T2, 4>(shards, n, W, C, stride, stream);
    case 2:
      return launch<T1, T2, 2>(shards, n, W, C, stride, stream);
    default:
      return launch<T1, T2, 1>(shards, n, W, C, stride, stream);
  }
}

int dispatch(const Shards& shards, int n, int dtype1, int dtype2, int W,
             int C, int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype1 * 2 + dtype2) {
    case 0:
      return (int)launch_groups<float, float>(shards, n, W, C, stride, s);
    case 1:
      return (int)launch_groups<float, Bf16>(shards, n, W, C, stride, s);
    case 2:
      return (int)launch_groups<Bf16, float>(shards, n, W, C, stride, s);
    default:
      return (int)launch_groups<Bf16, Bf16>(shards, n, W, C, stride, s);
  }
}

bool valid_args(int dtype1, int dtype2, int W, int C, int stride) {
  return W >= 1 && C >= 1 && stride >= 1 && dtype1 >= 0 && dtype1 <= 1 &&
         dtype2 >= 0 && dtype2 <= 1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. f1 is (H, W, C); f2 holds
// f2_rows rows of width W, and its row f2_row0 lines up with f1's row 0.
// Returns a cudaError_t.
extern "C" int transflow_corr7x7(const void* f1, int dtype1, const void* f2,
                                 int dtype2, void* out, int H, int W, int C,
                                 int stride, int f2_row0, int f2_rows,
                                 void* stream) {
  if (H < 1 || f2_rows < 1 || f1 == nullptr || f2 == nullptr ||
      out == nullptr || !valid_args(dtype1, dtype2, W, C, stride))
    return (int)cudaErrorInvalidValue;
  Shards shards = {};
  Shard& s = shards.s[0];
  s.f1 = static_cast<const char*>(f1);
  s.out = static_cast<float*>(out);
  s.rows = H;
  s.seg[1] = {static_cast<const char*>(f2), -f2_row0, f2_rows};
  return dispatch(shards, 1, dtype1, dtype2, W, C, stride, stream);
}

// Up to 8 shards on one device in one launch. ``table`` holds 9 int64 per
// shard: f1, f1 rows, top halo, its rows, the shard's own f2 rows, their
// count, bottom halo, its rows, out (pointers as integers; a halo pointer
// of 0 reads as zeros). The top halo's rows end at frame row 0 of the
// shard, the bottom's start after its own rows. Returns a cudaError_t.
extern "C" int transflow_corr7x7_shards(const long long* table, int n,
                                        int dtype1, int dtype2, int W, int C,
                                        int stride, void* stream) {
  if (table == nullptr || n < 1 || n > kMaxShards ||
      !valid_args(dtype1, dtype2, W, C, stride))
    return (int)cudaErrorInvalidValue;
  Shards shards = {};
  for (int i = 0; i < n; ++i) {
    const long long* e = table + 9 * i;
    Shard& s = shards.s[i];
    s.f1 = reinterpret_cast<const char*>(e[0]);
    s.rows = static_cast<int>(e[1]);
    const int top = static_cast<int>(e[3]);
    const int body = static_cast<int>(e[5]);
    s.seg[0] = {reinterpret_cast<const char*>(e[2]), -top, top};
    s.seg[1] = {reinterpret_cast<const char*>(e[4]), 0, body};
    s.seg[2] = {reinterpret_cast<const char*>(e[6]), body,
                static_cast<int>(e[7])};
    s.out = reinterpret_cast<float*>(e[8]);
    if (s.f1 == nullptr || s.out == nullptr || s.seg[1].ptr == nullptr ||
        s.rows < 1 || body < 1 || top < 0 || e[7] < 0)
      return (int)cudaErrorInvalidValue;
  }
  return dispatch(shards, n, dtype1, dtype2, W, C, stride, stream);
}

extern "C" const char* transflow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
