// The image pyramids' level construction for Hopper (sm_90a): B8, every
// level of a Farneback pyramid in one launch, and B14, every level of a
// Lucas-Kanade pyramid in one launch.
//
// It replaces jnp code that XLA fuses (there is no Pallas source):
//  * B8: Farneback's pyramid levels,
//    transflow_tpu/flow/estimators/farneback.py:243-248 (and :211-213, the
//    fb_downscale pre-resize), jax.image.resize(gaussian_blur(img, sigma),
//    (lh, lw), "linear") for each level below L0: a separable Gaussian of
//    radius R with numpy's symmetric padding (a bf16 image meets taps
//    rounded to bf16 along its rows' axis, then float32 taps) and JAX's
//    anti-aliased linear resize, each output from its band of K weights
//    (ops/pyramid.py::resize_weights). The four passes are linear and each
//    acts along one axis, so they run in the order that does the least
//    work: the vertical blur, the row resize, the horizontal blur (at the
//    level's height, not the frame's), the column resize;
//  * B14: Lucas-Kanade's pyramid, transflow_tpu/flow/estimators/
//    lucas_kanade.py:71-78: both uint8 frames cast to float32, then
//    transflow_tpu/ops/image.py:234 downsample2x repeated (the binomial
//    [1, 4, 6, 4, 1] / 16 along each axis with symmetric padding, then
//    [::2, ::2]); also downsample2x alone on a float32 image.
//
// Numbers. Every sum is taken in tap (or band) order from its first term,
// each product __fmul_rn and each sum __fadd_rn (no contraction), the
// order of the plain versions in ops/pyramid.py: a kernel and its plain
// version agree bit for bit.
//
// Bounds on the H100 at 1080x1920, cv2's defaults (pyr_scale 0.5, 3
// levels): the pyramid reads both bf16 frames once (8.3 MB) and writes its
// six float32 levels (5.4 MB), 4.1 us at 3.35 TB/s; the vertical blur at
// full resolution costs 2 (2R + 1) float32 operations a pixel and image
// (R = 2, 5, 11), the rest less: 455 M operations, 6.8 us at 67 TFLOP/s,
// so the pyramid is bound by operations (chip_smoke prints each bound).
// B14 at 1080x1920 under lukas-kanade.json reads both uint8 frames (4.1
// MB) and writes their float32 levels L0-L2 (21.8 MB): 7.7 us at 3.35
// TB/s, bound by bytes.
//
// What the design does about it. B8: one launch makes every level of both
// images: the grid enumerates (level, image, tile), the levels with the
// largest blur (the longest tiles) first, so the card fills once; every
// level reads the same frames, which stay in L2. A block of 256 threads
// makes a tile of up to 16 output rows by tile_w output columns:
//  1. it copies the input rows its tile reads (the row bands with the
//     blur's margin, each row index reflected) by the segment of columns
//     the tile's column bands read (with the blur's margin) into a ring of
//     staged rows in shared memory, a warp a row: cp.async 16-byte copies
//     where the frame's rows are 16-byte aligned, a reflected copy of each
//     value at the left and right edges (TMA would fill them with zeros).
//     A tile whose rows do not fit one slab sums them a slab at a time,
//     the next slab's rows copied while one is summed. A segment column a
//     thread, each thread makes its column's vertical sums 8 at a time
//     from a register window (the main path's 5, 11 and 23 taps unrolled;
//     a bf16 frame's exact products as fused multiply-adds), keeps them in
//     a ring, and makes each output row's row resize from the ring once
//     its band is summed (the main path's 4, 8 and 16 terms unrolled);
//  2. the horizontal blur of those rows, 4 outputs a thread from a
//     register window of 16-byte shared-memory loads;
//  3. the column resize, stored coalesced along x.
// The host (ops/pyramid.py::level_plan) picks the widest tile whose
// segment fits 256 columns and the height that makes the fewest vertical
// sums an output row within 64 KB of shared memory (three blocks an SM,
// as the registers allow: more blocks of shorter tiles were slower). A
// deep level, whose one-column segment does not fit 256 columns (radius
// 95 at fb_levels 8 on a 1080p frame) or whose one-row tile of float32
// rows exceeds 96 KB (radius 23 there), takes a second route: a launch
// before the pyramid's makes its rows (step 1 over all the frame's
// columns, 256 a block, each sum folded at once into the output rows
// whose long bands hold it, written to an (lh, W) float32 scratch), and
// its tiles in the pyramid's launch make steps 2 and 3 from that scratch,
// so each vertical sum is made once.
// B14: one launch makes every level of both frames: the source's float32
// copy and up to two reduces (a third and fourth reduce take a second
// launch from level 2, and so on). A block of 256 threads makes a tile of
// 64 x 128 source values and the 32 x 64 and 16 x 32 values below them:
//  1. it copies the source rows and columns its tile reads (level 2's
//     sources' sources, 73 x 137 at most; as uint8, a quarter of the
//     float32 bytes) into shared memory, cp.async 16-byte copies where the
//     rows are 16-byte aligned; indices are reflected against each level's
//     own size, so every one lies inside the rows and columns copied;
//  2. it stores its 64 x 128 float32 copy as float4, coalesced;
//  3. level 1 in shared memory (its values under level 2's tile and their
//     halo, each recomputed by every block that needs it, with the same
//     sums in the same order): the vertical pass at its rows, 4 rows of 4
//     columns a thread from a window of 11 words (each byte read as a
//     float without a conversion instruction), into even and odd column
//     planes; then the horizontal pass, 4 values a thread from 4 vector
//     loads of the planes;
//  4. level 2 from level 1, the same two passes (a row of 4 columns, then
//     a value, a thread).
// PERF.md times copies of this kernel cut after each step. A float32 image
// (ops/image.py's downsample2x) takes the same kernel without the copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRun = 8;      // B8: vertical sums a thread makes at once
constexpr int kBlurRun = 4;  // B8: horizontal sums a thread makes at once
constexpr int kMaxTileH = 16;
// B8: the blocks an SM its registers must allow (at most 85 a thread)
constexpr int kLevelBlocks = 3;
constexpr int kMaxLevels = 24;  // B8: levels (or routes' passes) a launch
constexpr int kFields = 23;     // B8: int64 fields of a level in the table
// B8's kinds of level: the whole level from the frames; a deep level's
// rows (steps 1) into its scratch; its columns (steps 2-3) from there
constexpr int kWhole = 0;
constexpr int kRows = 1;
constexpr int kColumns = 2;
constexpr int kLkMaxDown = 2;  // B14: reduces a launch
// B14: a block's rows and columns of its launch's first level (the
// source), halved at each level below (510 blocks at 1080p, one wave of
// four blocks an SM: 32-row tiles, more blocks of shorter tiles and
// persistent blocks that copy their next tile's rows while making one
// were all slower)
constexpr int kLkRows = 64;
constexpr int kLkCols = 128;
// B14: a thread's rows of vertical sums at level 1 (4 columns at once) and
// at level 2
constexpr int kLkRun = 4;
constexpr int kLkRun2 = 1;
// B14: the most rows and columns a block needs of level 1 (the sources of
// level 2's 16 x 32) and of the source (those of level 1's)
constexpr int kLkMidRows = 2 * ((kLkRows >> 2) - 1) + 5;
constexpr int kLkMidCols = 2 * ((kLkCols >> 2) - 1) + 5;
constexpr int kLkSrcRows = 2 * (kLkMidRows - 1) + 5;
constexpr int kLkSrcCols = 2 * (kLkMidCols - 1) + 5;
constexpr int kLkMidPitch = (kLkMidCols + 6 + 3) / 4 * 4;
// B14: the floats of a plane of vertical sums (even or odd columns), 16
// more than a multiple of 32
constexpr int kLkHalf1 = ((kLkSrcCols + 15 + 3) / 2 + 15) / 32 * 32 + 16;
constexpr int kLkHalf2 = ((kLkMidCols + 7) / 2 + 15) / 32 * 32 + 16;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

// shared-memory values; a bf16 value's bits are a float32's upper half,
// so its conversion is exact
__device__ __forceinline__ float lds(const float* p) { return *p; }
__device__ __forceinline__ float lds(const bf16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// B8
// ---------------------------------------------------------------------------

// One level (or one pass of a deep level's route) of a B8 launch. kWhole:
// frames (H, W) -> level (OH, OW); kRows: frames (H, W) -> rows (OH, W),
// the vertical blur and the row resize; kColumns: rows (OH, W) float32 ->
// level (OH, OW), the horizontal blur and the column resize.
struct Level {
  const void* src[2];
  float* dst[2];
  const float* vtaps;     // the vertical (first) pass's 2R + 1 taps
  const float* htaps;     // the horizontal (second) pass's
  const int* ystart;      // each output row's first input row
  const float* yweights;  // (OH, ky)
  const int* xstart;      // each output column's first input column
  const float* xweights;  // (OW, kx)
  int kind, H, W, OH, OW, radius, ky, kx;
  int tile_h, tile_w;
  int seg;         // the most segment columns a tile reads (margin in)
  int slab;        // the vertical sums a column makes from a slab of rows
  int stage_rows;  // the ring of staged rows (a multiple of 8)
  int tiles_x, tiles, first_block;
  int vec;  // the frames' rows are 16-byte aligned: cp.async copies
};

struct LevelsArgs {
  Level level[kMaxLevels];
  int n_levels;
};

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// B8's shared memory, offsets in bytes: the stage of input rows (or,
// once the vertical pass is done, the blurred rows), the ring of the
// segment's last vertical sums, the segment's rows (row-resized), both
// passes' taps, the tile's row bands and its column bands' starts (their
// weights are read through the L1 cache)
struct Layout {
  int stage_pitch;    // elements of a staged row
  int ring_rows;      // vertical sums a segment column keeps
  int ring_pitch;     // floats of a ring row
  int rowsum_pitch;   // floats of a segment row
  int blurred_pitch;  // floats of a blurred row
  int ring, rowsum, vt, ht, ys, yw, xs, bytes;
};

__host__ __device__ inline Layout level_layout(int kind, int itemsize,
                                               int radius, int ky, int kx,
                                               int tile_h, int tile_w,
                                               int seg, int stage_rows) {
  Layout l;
  const int v = 16 / itemsize;  // values of a 16-byte copy
  const int taps = 2 * radius + 1;
  const int cols = kind == kRows ? 0 : seg - 2 * radius;
  l.stage_pitch = (seg + v - 1) / v * v + v;
  // a band of ky rows completes at the end of a run of 8 that it may have
  // begun 7 rows before; a deep level's long bands (kRows) accumulate in
  // the segment's rows instead
  l.ring_rows = kind == kWhole ? (ky + 7 + kRun - 1) / kRun * kRun : 0;
  l.ring_pitch = (seg + 3) / 4 * 4;
  // the horizontal window reads up to 7 columns past the segment
  l.rowsum_pitch = (seg + 7 + 3) / 4 * 4;
  l.blurred_pitch = (cols + 3) / 4 * 4;
  const int stage =
      kind == kColumns ? 0 : stage_rows * l.stage_pitch * itemsize;
  const int blurred = kind == kRows ? 0 : tile_h * l.blurred_pitch * 4;
  int off = align16(stage > blurred ? stage : blurred);
  l.ring = off;
  off += align16(l.ring_rows * l.ring_pitch * 4);
  l.rowsum = off;
  off += align16(tile_h * l.rowsum_pitch * 4);
  l.vt = off;
  off += kind == kColumns ? 0 : align16(taps * 4);
  l.ht = off;
  off += kind == kRows ? 0 : align16(taps * 4);
  l.ys = off;
  off += kind == kColumns ? 0 : align16(tile_h * 4);
  l.yw = off;
  off += kind == kColumns ? 0 : align16(tile_h * ky * 4);
  l.xs = off;
  off += kind == kRows ? 0 : align16(tile_w * 4);
  l.bytes = off;
  return l;
}

// Copy input rows first .. first + count - 1 of the tile (row j is frame
// row reflect(r0 + j)) by the segment's columns reflect(sx0 + c), c <
// nseg, into the stage, a ring of nrows rows (row j at j % nrows): the
// stage's column p holds frame column reflect(a0 + p), a0 being sx0
// rounded down to a whole 16-byte copy. Issues the copies; the caller
// commits, waits for them and syncs.
template <typename T>
__device__ __forceinline__ void copy_rows(const Level& L,
                                          const T* __restrict__ src,
                                          T* __restrict__ stage, int ps,
                                          int nrows, int r0, int first,
                                          int count, int sx0, int nseg) {
  constexpr int v = 16 / static_cast<int>(sizeof(T));
  const int a0 = sx0 >= 0 ? sx0 / v * v : -((v - 1 - sx0) / v) * v;
  const int off = sx0 - a0;
  const int H = L.H, W = L.W;
  // a warp a row, its lanes along the row
  const int lane = threadIdx.x % 32;
  for (int q = threadIdx.x / 32; q < count; q += kThreads / 32) {
    const T* grow = src + (long long)reflect(r0 + first + q, H) * W;
    T* srow = stage + (first + q) % nrows * ps;
    if (L.vec) {
      const int chunks = (off + nseg + v - 1) / v;
      for (int k = lane; k < chunks; k += 32) {
        const int x = a0 + k * v;
        if (x >= 0 && x + v <= W) {
          cp_async16(srow + k * v, grow + x);
        } else {
          for (int e = 0; e < v; ++e)
            srow[k * v + e] = grow[reflect(x + e, W)];
        }
      }
    } else {
      for (int c = lane; c < nseg; c += 32)
        srow[off + c] = grow[reflect(sx0 + c, W)];
    }
  }
}

// The stage's rows j .. j + 7 of one column, j a multiple of 8 (the ring
// holds whole groups of 8 rows): ``col`` is the column's first element,
// ``base`` the ring row of row j, rows ``ps`` elements apart
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ col,
                                           int ps, int base,
                                           float (&x)[kRun]) {
#pragma unroll
  for (int m = 0; m < kRun; ++m) x[m] = lds(col + (base + m) * ps);
}

// The vertical sums of the stage's rows g + m .. g + m + taps - 1 of one
// column for m < 8, g a multiple of 8, each from its first tap: a
// register window, the taps 8 at a time with their 8 rows' loads issued
// together; sum m takes tap t0 + u from row g + m + t0 + u, win[m + u +
// 1] or nxt[m + u + 1 - 8]. ``base`` is the ring row of row g, nring the
// ring's rows.
template <typename T>
__device__ __forceinline__ void run_sums(const T* __restrict__ col, int ps,
                                         int base, int nring,
                                         const float* __restrict__ vt,
                                         int taps, float (&acc)[kRun]) {
  float win[kRun];
  load_group(col, ps, base, win);
#pragma unroll
  for (int m = 0; m < kRun; ++m) acc[m] = mul(win[m], vt[0]);
  for (int t0 = 1; t0 < taps; t0 += kRun) {
    float nxt[kRun];
    base += kRun;
    if (base == nring) base = 0;
    load_group(col, ps, base, nxt);
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      if (t0 + u < taps) {
        const float tk = vt[t0 + u];
#pragma unroll
        for (int m = 0; m < kRun; ++m)
          acc[m] = tap_mac<T>(acc[m],
                              m + u + 1 < kRun
                                  ? win[min(m + u + 1, kRun - 1)]
                                  : nxt[max(m + u + 1 - kRun, 0)],
                              tk);
      }
    }
#pragma unroll
    for (int m = 0; m < kRun; ++m) win[m] = nxt[m];
  }
}

// run_sums with kTaps taps known at compile time: all 8 + kTaps - 1 rows
// loaded at once, every product unrolled
template <typename T, int kTaps>
__device__ __forceinline__ void run_sums_fixed(const T* __restrict__ col,
                                               int ps, int base, int nring,
                                               const float* __restrict__ vt,
                                               float (&acc)[kRun]) {
  constexpr int kGroups = (kRun + kTaps - 1 + kRun - 1) / kRun;
  float x[kGroups * kRun];
#pragma unroll
  for (int a = 0; a < kGroups; ++a) {
    float g[kRun];
    load_group(col, ps, base, g);
#pragma unroll
    for (int m = 0; m < kRun; ++m) x[a * kRun + m] = g[m];
    base += kRun;
    if (base == nring) base = 0;
  }
#pragma unroll
  for (int m = 0; m < kRun; ++m) acc[m] = mul(x[m], vt[0]);
#pragma unroll
  for (int t = 1; t < kTaps; ++t) {
    const float tk = vt[t];
#pragma unroll
    for (int m = 0; m < kRun; ++m) acc[m] = tap_mac<T>(acc[m], x[m + t], tk);
  }
}

// An output row's row resize: its band's ky sums from ring row q on
// (``ringcol``, rows ``pitch`` floats apart, wrapping at nring) times
// the band's weights ``w`` (shared memory), added from the first
__device__ __forceinline__ float band_sum(const float* __restrict__ ringcol,
                                          int pitch, int q, int nring,
                                          const float* __restrict__ w,
                                          int ky) {
  float y = mul(ringcol[q * pitch], w[0]);
  for (int k = 1; k < ky; ++k) {
    if (++q == nring) q = 0;
    y = add(y, mul(ringcol[q * pitch], w[k]));
  }
  return y;
}

// band_sum with kKy terms known at compile time: every load issued first
template <int kKy>
__device__ __forceinline__ float band_sum_fixed(
    const float* __restrict__ ringcol, int pitch, int q, int nring,
    const float* __restrict__ w) {
  float v[kKy], wk[kKy];
#pragma unroll
  for (int k = 0; k < kKy; ++k) {
    v[k] = ringcol[q * pitch];
    wk[k] = w[k];
    if (++q == nring) q = 0;
  }
  float y = mul(v[0], wk[0]);
#pragma unroll
  for (int k = 1; k < kKy; ++k) y = add(y, mul(v[k], wk[k]));
  return y;
}

// B8 step 1 for a tile, the stage's first slab issued and committed:
// the vertical sums of segment column ``tid`` (of nseg, frame columns
// reflect(sx0 + c)) at the tile's nrows input rows from ry0 on, a slab
// of L.slab at a time, 8 at a time (run_sums), kept in a ring; each
// output row's row resize from the ring once its band is summed, into
// rowsum[i * pitch + c]. Without a ring (a deep level's rows), each sum
// is folded at once into the output rows whose bands hold it,
// accumulated in rowsum. The stage is a ring of input rows: the next
// slab's new rows are copied while a slab is summed.
template <typename T>
__device__ __forceinline__ void vertical_pass(
    const Level& L, const T* __restrict__ src, T* __restrict__ stage,
    const Layout& lay, const float* __restrict__ vt,
    const int* __restrict__ ys, const float* __restrict__ yw,
    float* __restrict__ ring, float* __restrict__ rowsum, int th, int ry0,
    int nrows, int sx0, int nseg) {
  const int tid = threadIdx.x;
  const int R = L.radius, taps = 2 * R + 1, ky = L.ky, S = L.slab;
  const int ps = lay.stage_pitch, nstage = L.stage_rows;
  const int nring = lay.ring_rows;
  constexpr int v = 16 / static_cast<int>(sizeof(T));
  const int off = sx0 - (sx0 >= 0 ? sx0 / v * v : -((v - 1 - sx0) / v) * v);
  const T* col = stage + off + tid;
  float* ringcol = ring + tid;
  // the first output row not yet resized (with a ring), or not yet begun
  // (without); the first whose band may still hold a row (without)
  int next = 0, lo = 0;
  int staged = min(S, nrows) + 2 * R;  // the rows the caller issued
  for (int s0 = 0; s0 < nrows; s0 += S) {
    const int sums = min(S, nrows - s0);
    // the next slab's new rows: their ring rows held slabs already summed
    const int need = min(s0 + 2 * S, nrows) + 2 * R;
    if (need > staged) {
      copy_rows<T>(L, src, stage, ps, nstage, ry0 - R, staged,
                   need - staged, sx0, nseg);
      staged = need;
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    for (int r = 0; tid < nseg && r < sums; r += kRun) {
      const int g = s0 + r;
      const int base = g % nstage;
      float acc[kRun];
      // the main path's blurs with their taps unrolled
      switch (taps) {
        case 5:
          run_sums_fixed<T, 5>(col, ps, base, nstage, vt, acc);
          break;
        case 11:
          run_sums_fixed<T, 11>(col, ps, base, nstage, vt, acc);
          break;
        case 23:
          run_sums_fixed<T, 23>(col, ps, base, nstage, vt, acc);
          break;
        default:
          run_sums<T>(col, ps, base, nstage, vt, taps, acc);
      }
      if (!nring) {
        // rows in ascending order: each output row's band terms arrive
        // in band order
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
          if (r + m < sums) {
            const int row = ry0 + g + m;
            while (next < th && ys[next] <= row) ++next;
            for (int i = lo; i < next; ++i) {
              const int k = row - ys[i];
              if (k >= ky) {
                lo = i + 1;
                continue;
              }
              const float y = mul(acc[m], yw[i * ky + k]);
              float* out = rowsum + i * lay.rowsum_pitch + tid;
              *out = k == 0 ? y : add(*out, y);
            }
          }
        }
        continue;
      }
      // the run's sums into the ring (a run never wraps: the ring holds
      // whole runs), then the row resize of every output row whose band
      // they complete, its terms in band order
      float* slot = ringcol + g % nring * lay.ring_pitch;
#pragma unroll
      for (int m = 0; m < kRun; ++m) slot[m * lay.ring_pitch] = acc[m];
      const int done = min(g + kRun, nrows);
      for (; next < th && ys[next] - ry0 + ky <= done; ++next) {
        const float* w = yw + next * ky;
        const int q = (ys[next] - ry0) % nring;
        float y;
        // the main path's bands with their terms unrolled
        switch (ky) {
          case 4:
            y = band_sum_fixed<4>(ringcol, lay.ring_pitch, q, nring, w);
            break;
          case 8:
            y = band_sum_fixed<8>(ringcol, lay.ring_pitch, q, nring, w);
            break;
          case 16:
            y = band_sum_fixed<16>(ringcol, lay.ring_pitch, q, nring, w);
            break;
          default:
            y = band_sum(ringcol, lay.ring_pitch, q, nring, w, ky);
        }
        rowsum[next * lay.rowsum_pitch + tid] = y;
      }
    }
    // every thread is done with this slab's rows before the next slab's
    // copies reuse them
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kLevelBlocks)
    pyramid_levels_kernel(const __grid_constant__ LevelsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int l = 0;
  while (l + 1 < a.n_levels &&
         a.level[l + 1].first_block <= static_cast<int>(blockIdx.x))
    ++l;
  const Level& L = a.level[l];
  const int local = blockIdx.x - L.first_block;
  const int image = local / L.tiles;
  const int tile = local % L.tiles;
  const int i0 = tile / L.tiles_x * L.tile_h;
  const int j0 = tile % L.tiles_x * L.tile_w;
  const int th = min(L.tile_h, L.OH - i0);
  const int tw = min(L.tile_w, (L.kind == kRows ? L.W : L.OW) - j0);
  const int tid = threadIdx.x;
  const int R = L.radius, taps = 2 * R + 1;
  const Layout lay = level_layout(L.kind, sizeof(T), R, L.ky, L.kx,
                                  L.tile_h, L.tile_w, L.seg, L.stage_rows);
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  float* rowsum = reinterpret_cast<float*>(smem + lay.rowsum);
  float* vt = reinterpret_cast<float*>(smem + lay.vt);
  float* ht = reinterpret_cast<float*>(smem + lay.ht);
  int* ys = reinterpret_cast<int*>(smem + lay.ys);
  float* yw = reinterpret_cast<float*>(smem + lay.yw);  // (th, ky)
  int* xs = reinterpret_cast<int*>(smem + lay.xs);
  // the tile's extent from its bands' ends: input rows ry0 .. ry0 + nrows
  // - 1; segment columns reflect(sx0 + c), c < nseg; blurred columns cx0
  // .. cx0 + ncols - 1 (the segment without the blur's margin)
  int sx0 = j0, nseg = tw, cx0 = 0, ncols = 0, ry0 = 0, nrows = 0;
  if (L.kind != kRows) {
    cx0 = __ldg(L.xstart + j0);
    ncols = __ldg(L.xstart + j0 + tw - 1) + L.kx - cx0;
    sx0 = cx0 - R;
    nseg = ncols + 2 * R;
  }
  const T* __restrict__ frame = static_cast<const T*>(L.src[image]);
  if (L.kind != kColumns) {
    ry0 = __ldg(L.ystart + i0);
    nrows = __ldg(L.ystart + i0 + th - 1) + L.ky - ry0;
    // the first slab's copies fly while the taps are copied
    copy_rows<T>(L, frame, reinterpret_cast<T*>(smem), lay.stage_pitch,
                 L.stage_rows, ry0 - R, 0, min(L.slab, nrows) + 2 * R, sx0,
                 nseg);
    cp_async_commit();
    for (int p = tid; p < taps; p += kThreads) vt[p] = L.vtaps[p];
    if (tid < th) ys[tid] = L.ystart[i0 + tid];
    for (int p = tid; p < th * L.ky; p += kThreads)
      yw[p] = L.yweights[(long long)i0 * L.ky + p];
  }
  if (L.kind != kRows) {
    for (int p = tid; p < taps; p += kThreads) ht[p] = L.htaps[p];
    for (int p = tid; p < tw; p += kThreads) xs[p] = L.xstart[j0 + p];
  }
  if (L.kind == kColumns) {
    const float* __restrict__ rows = static_cast<const float*>(L.src[image]);
    for (int p = tid; p < th * nseg; p += kThreads) {
      const int i = p / nseg, c = p % nseg;
      rowsum[i * lay.rowsum_pitch + c] =
          load(rows + (long long)(i0 + i) * L.W + reflect(sx0 + c, L.W));
    }
  }
  if (L.kind != kColumns)
    vertical_pass<T>(L, frame, reinterpret_cast<T*>(smem), lay, vt, ys, yw,
                     ring, rowsum, th, ry0, nrows, sx0, nseg);
  __syncthreads();
  float* __restrict__ dst = L.dst[image];
  if (L.kind == kRows) {
    for (int p = tid; p < th * tw; p += kThreads) {
      const int i = p / tw, c = p % tw;
      dst[(long long)(i0 + i) * L.W + j0 + c] =
          rowsum[i * lay.rowsum_pitch + c];
    }
    return;
  }
  // 2. the horizontal blur of the tile's rows, 4 outputs a thread: sum m
  // takes tap t0 + u from column c0 + m + t0 + u, win[m + u + 1] or
  // next[m + u + 1 - 4]; the stage's memory holds the blurred rows
  float* blurred = reinterpret_cast<float*>(smem);
  const int runs = (ncols + kBlurRun - 1) / kBlurRun;
  for (int p = tid; p < th * runs; p += kThreads) {
    const int i = p / runs, c0 = p % runs * kBlurRun;
    const float* row = rowsum + i * lay.rowsum_pitch + c0;
    const float4 w4 = *reinterpret_cast<const float4*>(row);
    float win[kBlurRun] = {w4.x, w4.y, w4.z, w4.w}, acc[kBlurRun];
#pragma unroll
    for (int m = 0; m < kBlurRun; ++m) acc[m] = mul(win[m], ht[0]);
    for (int t0 = 1; t0 < taps; t0 += kBlurRun) {
      const float4 n4 =
          *reinterpret_cast<const float4*>(row + t0 + kBlurRun - 1);
      const float next[kBlurRun] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
      for (int u = 0; u < kBlurRun; ++u) {
        if (t0 + u < taps) {
          const float tk = ht[t0 + u];
#pragma unroll
          for (int m = 0; m < kBlurRun; ++m)
            acc[m] = add(acc[m],
                         mul(m + u + 1 < kBlurRun
                                 ? win[min(m + u + 1, kBlurRun - 1)]
                                 : next[max(m + u + 1 - kBlurRun, 0)],
                             tk));
        }
      }
#pragma unroll
      for (int m = 0; m < kBlurRun; ++m) win[m] = next[m];
    }
    *reinterpret_cast<float4*>(blurred + i * lay.blurred_pitch + c0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
  // 3. the column resize: output (i, j) from its band of kx columns
  for (int p = tid; p < th * tw; p += kThreads) {
    const int i = p / tw, jj = p % tw;
    const float* row = blurred + i * lay.blurred_pitch + (xs[jj] - cx0);
    const float* w = L.xweights + (long long)(j0 + jj) * L.kx;
    float acc = mul(row[0], load(w));
    for (int k = 1; k < L.kx; ++k) acc = add(acc, mul(row[k], load(w + k)));
    dst[(long long)(i0 + i) * L.OW + j0 + jj] = acc;
  }
}

// ---------------------------------------------------------------------------
// B14
// ---------------------------------------------------------------------------

constexpr int lk_round(int n, int m) { return (n + m - 1) / m * m; }

// B14's shared memory, offsets in bytes: the stage of the source's rows
// (16-byte copies from a column rounded down to a whole copy); level 1's
// vertical sums at the stage's columns, each row two planes (even and odd
// columns, kLkHalf1 floats apart, 16 more than a multiple of 32, so the
// two planes' halves of a warp's accesses fall on different banks);
// level 1's values where level 2 reads them (from lk_pyramid_kernel's
// column s1lo on, stored and read as float4); level 2's vertical sums, in
// planes as level 1's
template <typename T>
struct LkLayout {
  static constexpr int v = 16 / static_cast<int>(sizeof(T));
  static constexpr int pitch = lk_round(kLkSrcCols + 2 * (v - 1), v);
  static constexpr int v1 = lk_round(kLkSrcRows * pitch * sizeof(T), 16);
  static constexpr int s1 = v1 + kLkMidRows * 2 * kLkHalf1 * 4;
  static constexpr int v2 = s1 + kLkMidRows * kLkMidPitch * 4;
  static constexpr int bytes = v2 + (kLkRows >> 2) * 2 * kLkHalf2 * 4;
};

// A launch's levels: the source (level 0, uint8 frames or a float32
// level) and the n_down levels below it, each (H[l], W[l]); dst[l][k] is
// image k's level l (dst[0]: a uint8 source's float32 copy)
struct LkArgs {
  const void* src[2];
  float* dst[kLkMaxDown + 1][2];
  int H[kLkMaxDown + 1], W[kLkMaxDown + 1];
  int n_down;
  int vec;   // the source's rows are 16-byte aligned: cp.async copies
  int wide;  // the float32 copy's rows are 16-byte aligned: float4 stores
};

// the binomial [1, 4, 6, 4, 1] / 16 (exact in float32) added from the
// first tap, each product and sum rounded
__device__ __forceinline__ float reduce5(float a, float b, float c, float d,
                                         float e) {
  float acc = mul(a, 0.0625f);
  acc = add(acc, mul(b, 0.25f));
  acc = add(acc, mul(c, 0.375f));
  acc = add(acc, mul(d, 0.25f));
  return add(acc, mul(e, 0.0625f));
}

// A thread's items (q, j) of a grid nc wide, j first: item p = q nc + j
// for p = threadIdx.x, + kThreads, ... (two divisions a pass, none an
// item)
struct Walk {
  int q, j, dq, dj, nc;
  __device__ __forceinline__ explicit Walk(int n) : nc(n) {
    q = threadIdx.x / nc;
    j = threadIdx.x - q * nc;
    dq = kThreads / nc;
    dj = kThreads - dq * nc;
  }
  __device__ __forceinline__ void next() {
    q += dq;
    j += dj;
    if (j >= nc) {
      j -= nc;
      ++q;
    }
  }
};

// Four consecutive values in shared memory: a word of four uint8, each
// read as a float by at(e) (2^23 + b, less 2^23: exact, with no
// conversion instruction), or a float4
template <typename S>
struct Quad;
template <>
struct Quad<unsigned char> {
  unsigned w;
  __device__ __forceinline__ void load(const unsigned char* p) {
    w = *reinterpret_cast<const unsigned*>(p);
  }
  __device__ __forceinline__ float at(int e) const {
    return __fsub_rn(__int_as_float(__byte_perm(w, 0x4b000000u, 0x7540 + e)),
                     8388608.0f);
  }
};
template <>
struct Quad<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

// The vertical sums of a level's rows rlo .. rlo + nr - 1 (each from the
// level above's rows 2r - 2 .. 2r + 2, reflected against its height H) at
// the level above's columns in ``in``, four at once. ``in`` holds the
// level above's rows from row in_lo on (in_rows of them, ``pitch``
// elements apart), its columns 4 g .. 4 g + 3 for g < ng 16-byte
// aligned. Sum (r, c) for local column c goes to ``out`` row r - rlo,
// plane c & 1, entry c >> 1 (kHalf floats a plane): each thread kRun rows
// of four columns from one window of 2 kRun + 3 quads (rows read in place
// where the window lies inside the level), columns 0 and 2 stored as a
// float2 to the even plane, 1 and 3 to the odd one.
template <int kHalf, int kRun, typename S>
__device__ __forceinline__ void lk_vertical_quads(
    const S* __restrict__ in, int pitch, int in_lo, int in_rows, int H,
    int rlo, int nr, int ng, float* __restrict__ out) {
  constexpr int kWin = 2 * kRun + 3;
  const int runs = (nr + kRun - 1) / kRun;
  for (Walk w(ng); w.q < runs; w.next()) {
    const int r0 = w.q * kRun;
    const int first = 2 * (rlo + r0) - 2;  // the window's first row
    const S* col = in + 4 * w.j;
    Quad<S> x[kWin];
    if (r0 + kRun <= nr && first >= 0 && first + kWin <= H) {
#pragma unroll
      for (int k = 0; k < kWin; ++k)
        x[k].load(col + (first - in_lo + k) * pitch);
    } else {
#pragma unroll
      for (int k = 0; k < kWin; ++k) {
        // a run cut short at the level's last row reads any staged row
        const int row =
            min(max(reflect(first + k, H) - in_lo, 0), in_rows - 1);
        x[k].load(col + row * pitch);
      }
    }
    float* o = out + r0 * 2 * kHalf + 2 * w.j;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float y[kRun][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[kWin];
#pragma unroll
        for (int k = 0; k < kWin; ++k) v[k] = x[k].at(e + 2 * h);
#pragma unroll
        for (int m = 0; m < kRun; ++m)
          y[m][h] = reduce5(v[2 * m], v[2 * m + 1], v[2 * m + 2],
                            v[2 * m + 3], v[2 * m + 4]);
      }
#pragma unroll
      for (int m = 0; m < kRun; ++m)
        if (r0 + m < nr)
          *reinterpret_cast<float2*>(o + m * 2 * kHalf + e * kHalf) =
              make_float2(y[m][0], y[m][1]);
    }
  }
}

// floor(a / 4)
__device__ __forceinline__ int floor4(int a) { return a >> 2; }

// Level 1's values at rows 0 .. nr - 1 of ``sums`` (lk_vertical_quads',
// planes from the level above's column 2 b) and columns clo .. clo + nc -
// 1, four a thread: the group c0 .. c0 + 3, c0 = b + 1 + 4 g, reads the
// even plane's entries 4 g .. 4 g + 5 and the odd one's 4 g .. 4 g + 4 (a
// float4 and a float2, a float4 and a float) where its sources lie inside
// the width W, else each value's five reflected columns. The group's
// values go to emit(i, g - g0, y) (g0 the first group), those inside clo
// .. clo + nc - 1 flagged by ``valid``.
template <typename Emit>
__device__ __forceinline__ void lk_horizontal_quads(
    const float* __restrict__ sums, int b, int W, int nr, int clo, int nc,
    Emit emit) {
  const int g0 = floor4(clo - b - 1);
  const int ng = floor4(clo + nc - 1 - b - 1) - g0 + 1;
  for (Walk w(ng); w.q < nr; w.next()) {
    const int g = g0 + w.j, c0 = b + 1 + 4 * g;
    const float* even = sums + w.q * 2 * kLkHalf1;
    const float* odd = even + kLkHalf1;
    float y[4];
    if (g >= 0 && 2 * c0 + 8 < W) {
      const float4 e0 = *reinterpret_cast<const float4*>(even + 4 * g);
      const float2 e1 = *reinterpret_cast<const float2*>(even + 4 * g + 4);
      const float4 o0 = *reinterpret_cast<const float4*>(odd + 4 * g);
      const float o1 = odd[4 * g + 4];
      y[0] = reduce5(e0.x, o0.x, e0.y, o0.y, e0.z);
      y[1] = reduce5(e0.y, o0.y, e0.z, o0.z, e0.w);
      y[2] = reduce5(e0.z, o0.z, e0.w, o0.w, e1.x);
      y[3] = reduce5(e0.w, o0.w, e1.x, o1, e1.y);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u;
        y[u] = 0.0f;
        if (c >= clo && c < clo + nc) {
          float x[5];
#pragma unroll
          for (int t = 0; t < 5; ++t) {
            const int s = reflect(2 * c - 2 + t, W);
            x[t] = even[(s & 1) * kLkHalf1 + (s >> 1) - b];
          }
          y[u] = reduce5(x[0], x[1], x[2], x[3], x[4]);
        }
      }
    }
    emit(w.q, w.j, c0, y);
  }
}

// A level's values at rows 0 .. nr - 1 of ``sums`` (lk_vertical_quads',
// whose local column 0 is the level above's column sclo) and columns clo
// .. clo + nc - 1, each from the level above's columns 2c - 2 .. 2c + 2
// reflected against its width W, a value a thread; value (i, j) goes to
// emit(i, j, value)
template <int kHalf, typename Emit>
__device__ __forceinline__ void lk_horizontal(const float* __restrict__ sums,
                                              int sclo, int W, int nr,
                                              int clo, int nc, Emit emit) {
  for (Walk w(nc); w.q < nr; w.next()) {
    const int i = w.q, c = clo + w.j;
    const float* row = sums + i * 2 * kHalf;
    float x[5];
    if (c >= 1 && 2 * c + 2 < W) {
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int s = 2 * c - 2 + t - sclo;
        x[t] = row[(s & 1) * kHalf + (s >> 1)];
      }
    } else {
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int s = reflect(2 * c - 2 + t, W) - sclo;
        x[t] = row[(s & 1) * kHalf + (s >> 1)];
      }
    }
    emit(i, w.j, reduce5(x[0], x[1], x[2], x[3], x[4]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lk_pyramid_kernel(const __grid_constant__ LkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Lay = LkLayout<T>;
  constexpr int v = Lay::v;
  T* stage = reinterpret_cast<T*>(smem);
  float* v1 = reinterpret_cast<float*>(smem + Lay::v1);
  float* s1 = reinterpret_cast<float*>(smem + Lay::s1);
  float* v2 = reinterpret_cast<float*>(smem + Lay::v2);
  const int n = a.n_down, image = blockIdx.z, tid = threadIdx.x;
  // the rows rlo .. rhi and columns clo .. chi of each level the tile
  // needs: at level n its own, above it the sources of the level below
  // (every reflected index of them lies inside)
  int rlo[kLkMaxDown + 1], rhi[kLkMaxDown + 1];
  int clo[kLkMaxDown + 1], chi[kLkMaxDown + 1];
#pragma unroll
  for (int l = kLkMaxDown; l >= 0; --l) {
    if (l == n) {
      rlo[l] = blockIdx.y * (kLkRows >> l);
      clo[l] = blockIdx.x * (kLkCols >> l);
      rhi[l] = min(rlo[l] + (kLkRows >> l), a.H[l]) - 1;
      chi[l] = min(clo[l] + (kLkCols >> l), a.W[l]) - 1;
    } else if (l < n) {
      const int b = min(l + 1, kLkMaxDown);
      rlo[l] = max(2 * rlo[b] - 2, 0);
      clo[l] = max(2 * clo[b] - 2, 0);
      rhi[l] = min(2 * rhi[b] + 2, a.H[l] - 1);
      chi[l] = min(2 * chi[b] + 2, a.W[l] - 1);
    }
  }
  // 1. the source's rows rlo[0] .. rhi[0], columns a0 .. chi[0]
  const T* __restrict__ src = static_cast<const T*>(a.src[image]);
  const int a0 = clo[0] / v * v, rows0 = rhi[0] - rlo[0] + 1;
  if (a.vec) {
    const int chunks = (chi[0] - a0) / v + 1;
    for (int p = tid; p < rows0 * chunks; p += kThreads) {
      const int r = p / chunks, k = p - r * chunks;
      cp_async16(stage + r * Lay::pitch + k * v,
                 src + (long long)(rlo[0] + r) * a.W[0] + a0 + k * v);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    const int cols = chi[0] - clo[0] + 1;
    for (int p = tid; p < rows0 * cols; p += kThreads) {
      const int r = p / cols, c = p - r * cols;
      stage[r * Lay::pitch + clo[0] - a0 + c] =
          src[(long long)(rlo[0] + r) * a.W[0] + clo[0] + c];
    }
  }
  __syncthreads();
  // 2. a uint8 source's float32 copy of the tile, coalesced
  if constexpr (std::is_same_v<T, unsigned char>) {
    float* __restrict__ dst = a.dst[0][image];
    const int i0 = blockIdx.y * kLkRows, j0 = blockIdx.x * kLkCols;
    const int rows = min(kLkRows, a.H[0] - i0);
    const int cols = min(kLkCols, a.W[0] - j0);
    const unsigned char* s = stage + (i0 - rlo[0]) * Lay::pitch + j0 - a0;
    if (a.wide) {
      // a thread's four columns j, its rows i, i + kStep, ...
      constexpr int kQuads = kLkCols / 4, kStep = kThreads / kQuads;
      const int i = tid / kQuads, j = tid % kQuads * 4;
      if (j < cols) {
        const unsigned char* from = s + i * Lay::pitch + j;
        float* to = dst + (long long)(i0 + i) * a.W[0] + j0 + j;
        for (int r = i; r < rows; r += kStep) {
          Quad<unsigned char> u;
          u.load(from);
          *reinterpret_cast<float4*>(to) =
              make_float4(u.at(0), u.at(1), u.at(2), u.at(3));
          from += kStep * Lay::pitch;
          to += (long long)kStep * a.W[0];
        }
      }
    } else {
      for (int p = tid; p < rows * kLkCols; p += kThreads) {
        const int i = p / kLkCols, j = p % kLkCols;
        if (j < cols)
          dst[(long long)(i0 + i) * a.W[0] + j0 + j] =
              static_cast<float>(s[i * Lay::pitch + j]);
      }
    }
  }
  if (n == 0) return;
  // 3. level 1: the vertical sums at the source's columns, then each
  // value, kept where level 2 reads it and stored where the tile owns it
  const int rlo1 = rlo[1], clo1 = clo[1];
  const int rows1 = rhi[1] - rlo1 + 1, cols1 = chi[1] - clo1 + 1;
  lk_vertical_quads<kLkHalf1, kLkRun>(stage, Lay::pitch, rlo[0], rows0,
                                      a.H[0], rlo1, rows1,
                                      (chi[0] - a0) / 4 + 1, v1);
  __syncthreads();
  // level 1's kept values from column s1lo on, the first group's first
  const int b1 = a0 >> 1, s1lo = b1 + 1 + 4 * floor4(clo1 - b1 - 1);
  {
    float* __restrict__ dst = a.dst[1][image];
    const int i0 = blockIdx.y * (kLkRows >> 1) - rlo1;
    const int j0 = blockIdx.x * (kLkCols >> 1);
    const int W1 = a.W[1], chi1 = chi[1];
    const bool keep = n > 1;
    lk_horizontal_quads(v1, b1, a.W[0], rows1, clo1, cols1,
                        [=](int i, int g, int c0, const float (&y)[4]) {
      if (keep)
        *reinterpret_cast<float4*>(s1 + i * kLkMidPitch + 4 * g) =
            make_float4(y[0], y[1], y[2], y[3]);
      if (i >= i0 && i < i0 + (kLkRows >> 1)) {
        float* row = dst + (long long)(rlo1 + i) * W1;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + u;
          if (c >= max(clo1, j0) && c <= min(chi1, j0 + (kLkCols >> 1) - 1))
            row[c] = y[u];
        }
      }
    });
  }
  if (n == 1) return;
  // 4. level 2 from level 1's values, every one the tile's own
  __syncthreads();
  const int rlo2 = rlo[2], clo2 = clo[2], rows2 = rhi[2] - rlo2 + 1;
  lk_vertical_quads<kLkHalf2, kLkRun2>(s1, kLkMidPitch, rlo1, rows1,
                                       a.H[1], rlo2, rows2,
                                       (chi[1] - s1lo) / 4 + 1, v2);
  __syncthreads();
  float* __restrict__ dst = a.dst[2][image];
  const int W2 = a.W[2];
  lk_horizontal<kLkHalf2>(v2, s1lo, a.W[1], rows2, clo2, chi[2] - clo2 + 1,
                          [=](int i, int j, float y) {
    dst[(long long)(rlo2 + i) * W2 + clo2 + j] = y;
  });
}

// raise a kernel's dynamic shared memory limit to the H100's, once per
// device (the call costs host time)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* raised) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && raised[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && device < kMaxDevices) raised[device] = true;
  return err;
}

template <typename T>
int launch_levels(const LevelsArgs& a, int blocks, int smem,
                  cudaStream_t stream) {
  if (smem > kSmemDefault) {
    static bool raised[kMaxDevices] = {};
    const cudaError_t err = allow_smem(pyramid_levels_kernel<T>, raised);
    if (err != cudaSuccess) return (int)err;
  }
  pyramid_levels_kernel<T><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lk(const LkArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = LkLayout<T>::bytes;
  if constexpr (bytes > kSmemDefault) {
    static bool raised[kMaxDevices] = {};
    const cudaError_t err = allow_smem(lk_pyramid_kernel<T>, raised);
    if (err != cudaSuccess) return (int)err;
  }
  lk_pyramid_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// B8: one launch over ``n_levels`` levels of one or two images (dtype 0
// float32 or 1 bf16 frames; a kColumns level's source is always float32
// rows). ``table`` (host memory) holds kFields int64 a level: src0, src1,
// dst0, dst1, vtaps, htaps, ystart, yweights, xstart, xweights (device
// pointers; src1 and dst1 unused for one image), kind, H, W, OH, OW,
// radius, ky, kx, tile_h, tile_w (<= 16 rows), seg (the most segment
// columns a tile reads, <= 256 unless kColumns), slab (a multiple of 8:
// the sums a column makes from one slab of staged rows), stage_rows (a
// multiple of 8: the ring of staged rows, at least 2 slabs and the
// blur's margin where a tile has more than one slab);
// the levels with the longest tiles first (ops/pyramid.py::level_plan).
// ``smem`` is the most bytes of shared memory a level's tile takes
// (level_layout). Returns a cudaError_t.
extern "C" int transflow_pyramid_levels(const void* table, int n_levels,
                                        int n_images, int dtype, int smem,
                                        void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_images < 1 ||
      n_images > 2 || (dtype != 0 && dtype != 1) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const long long* t = static_cast<const long long*>(table);
  LevelsArgs a = {};
  a.n_levels = n_levels;
  long long blocks = 0;
  int need = 0;
  for (int e = 0; e < n_levels; ++e) {
    const long long* f = t + (long long)e * kFields;
    Level& L = a.level[e];
    for (int k = 0; k < 2; ++k) {
      L.src[k] = reinterpret_cast<const void*>(f[k]);
      L.dst[k] = reinterpret_cast<float*>(f[2 + k]);
    }
    L.vtaps = reinterpret_cast<const float*>(f[4]);
    L.htaps = reinterpret_cast<const float*>(f[5]);
    L.ystart = reinterpret_cast<const int*>(f[6]);
    L.yweights = reinterpret_cast<const float*>(f[7]);
    L.xstart = reinterpret_cast<const int*>(f[8]);
    L.xweights = reinterpret_cast<const float*>(f[9]);
    L.kind = (int)f[10];
    L.H = (int)f[11];
    L.W = (int)f[12];
    L.OH = (int)f[13];
    L.OW = (int)f[14];
    L.radius = (int)f[15];
    L.ky = (int)f[16];
    L.kx = (int)f[17];
    L.tile_h = (int)f[18];
    L.tile_w = (int)f[19];
    L.seg = (int)f[20];
    L.slab = (int)f[21];
    L.stage_rows = (int)f[22];
    if (L.kind < kWhole || L.kind > kColumns || L.H < 1 || L.W < 1 ||
        L.OH < 1 || L.OW < 1 || L.radius < 0 || L.tile_h < 1 ||
        L.tile_h > kMaxTileH || L.tile_w < 1)
      return (int)cudaErrorInvalidValue;
    const int out_w = L.kind == kRows ? L.W : L.OW;
    if (L.kind != kColumns) {
      // a thread a segment column
      if (L.ky < 1 || L.ky > L.H || L.seg > kThreads ||
          (L.kind == kRows && L.seg != L.tile_w))
        return (int)cudaErrorInvalidValue;
    }
    if (L.kind != kRows &&
        (L.kx < 1 || L.kx > L.W || L.seg < L.kx + 2 * L.radius))
      return (int)cudaErrorInvalidValue;
    if (L.kind != kColumns &&
        (L.slab < kRun || L.slab % kRun || L.stage_rows % kRun ||
         L.stage_rows < L.slab + 2 * L.radius))
      return (int)cudaErrorInvalidValue;
    const int bytes = level_layout(L.kind, itemsize, L.radius, L.ky, L.kx,
                                   L.tile_h, L.tile_w, L.seg, L.stage_rows)
                          .bytes;
    need = need > bytes ? need : bytes;
    L.tiles_x = (out_w + L.tile_w - 1) / L.tile_w;
    L.tiles = L.tiles_x * ((L.OH + L.tile_h - 1) / L.tile_h);
    L.first_block = (int)blocks;
    blocks += (long long)L.tiles * n_images;
    const uintptr_t mask = 15;
    L.vec = L.kind != kColumns && (L.W * itemsize) % 16 == 0 &&
            (reinterpret_cast<uintptr_t>(L.src[0]) & mask) == 0 &&
            (n_images < 2 ||
             (reinterpret_cast<uintptr_t>(L.src[1]) & mask) == 0);
  }
  if (need != smem || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_levels<float>(a, (int)blocks, smem, s);
  return launch_levels<bf16>(a, (int)blocks, smem, s);
}

// B14: ``n_down`` (0 to kLkMaxDown) reduces of one or two (H, W) images
// (dtype 0 float32 or 2 uint8) in one launch. ``dst_table`` (host memory)
// holds 2 (kLkMaxDown + 1) int64: image k's level l at [2 l + k], level l
// ((H_{l-1} + 1) / 2, (W_{l-1} + 1) / 2) float32, level 0 a uint8
// source's float32 copy (unused for a float32 source, which needs at
// least one reduce). Returns a cudaError_t.
extern "C" int transflow_lk_pyramid(const void* src0, const void* src1,
                                    int n_images, int dtype,
                                    const void* dst_table, int H, int W,
                                    int n_down, void* stream) {
  if (n_images < 1 || n_images > 2 || H < 1 || W < 1 || n_down < 0 ||
      n_down > kLkMaxDown || (dtype != 0 && dtype != 2) ||
      (dtype == 0 && n_down < 1) || !src0 || (n_images == 2 && !src1))
    return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(dst_table);
  LkArgs a = {};
  a.src[0] = src0;
  a.src[1] = src1;
  a.n_down = n_down;
  for (int l = 0; l <= kLkMaxDown; ++l) {
    a.H[l] = l ? (a.H[l - 1] + 1) / 2 : H;
    a.W[l] = l ? (a.W[l - 1] + 1) / 2 : W;
    for (int k = 0; k < 2; ++k)
      a.dst[l][k] = reinterpret_cast<float*>(t[2 * l + k]);
  }
  for (int l = dtype == 0 ? 1 : 0; l <= n_down; ++l)
    for (int k = 0; k < n_images; ++k)
      if (!a.dst[l][k]) return (int)cudaErrorInvalidValue;
  const uintptr_t mask = 15;
  const auto aligned = [&](const void* p0, const void* p1) {
    return (reinterpret_cast<uintptr_t>(p0) & mask) == 0 &&
           (n_images < 2 || (reinterpret_cast<uintptr_t>(p1) & mask) == 0);
  };
  const int itemsize = dtype == 0 ? 4 : 1;
  a.vec = (W * itemsize) % 16 == 0 && aligned(src0, src1);
  a.wide = dtype == 2 && W % 4 == 0 && aligned(a.dst[0][0], a.dst[0][1]);
  const dim3 grid((a.W[n_down] + (kLkCols >> n_down) - 1) /
                      (kLkCols >> n_down),
                  (a.H[n_down] + (kLkRows >> n_down) - 1) /
                      (kLkRows >> n_down),
                  n_images);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_lk<float>(a, grid, s);
  return launch_lk<unsigned char>(a, grid, s);
}
