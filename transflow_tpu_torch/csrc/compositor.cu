// The compositor's layer updates and render for Hopper (sm_90a): kernels
// K0-K4.
//
// They replace jnp code that XLA compiles (there is no Pallas source) in
// transflow_tpu/compositor/core.py, as the port's compositor/core.py runs
// it; ``build_compositor`` sends every layer class through them on the
// card, with or without a mesh:
//  * K1 ``layer_update_kernel``: a moveref or sum layer's update,
//    ``update_moveref`` (:351) or ``update_sum`` (:363), in one pass a
//    pixel:
//    - the movement (``_movement``, :154-241): the flow rounded half to
//      even, src = clip(base + d), with a halo the row clamped to the halo
//      window (ops/halo_gather.py:27), alpha, pos_i, pos_j, source and
//      ``mask_src`` gathered at src, the four movement flags and
//      ``mask_dst``, then the selection; a sum layer instead adds the
//      floored flow to its int32 positions, never clipped (:363-376);
//    - the reset (``_reset``, :268-318): the random mode's draw, threefry2x32
//      of the pixel's flat index under the layer's key (as
//      ``jax.random.uniform``, the port's ``prng.uniform``) in registers,
//      ``rand < factor``, with ``reset_source``; the constant and linear
//      steps toward the base, in float32 in the plain version's order;
//    - the regather (``_reference_rgba``, :321-348): each source of the
//      launch's group in order, the selected source's pixmap read at the
//      clipped position, and the reference's sequential alpha of 3-channel
//      sources (``a = sel`` for every pixel, so the last 3-channel source
//      decides where no later 4-channel source selects).
//    It writes new state tensors and never writes in place: a pixel's
//    source may be another pixel's target.
//  * K0 ``leave_empty_kernel``: ``moving_pixels_leave_empty_spot``'s
//    occupancy scatter (transflow_tpu/ops/scatter.py:13 scatter_any, as
//    ``_movement`` runs it, :224-230) of a moveref or an introduction
//    layer. It computes each pixel's target flag from the old state, as
//    K1 and K3 do, and marks the (halo-clamped) source of each target with
//    a byte. Every writer writes the same 1, so the order the stores land
//    in does not matter. K1 and K3 read their pixel's mark (alpha 0, then
//    ``arrived`` sets 1: JAX's order). The wrapper zeroes a new buffer for
//    each K0 launch.
//  * K3 ``introduction_update_kernel``: an introduction layer's update,
//    ``update_introduction`` (:393), in one pass a pixel: the same
//    movement as K1's, carrying rgb, source, pos_i, pos_j and frame; the
//    eligibility mask from the moved alpha, ``moving`` and the six
//    ``introduce_*`` flags in JAX's order (:410-425), ``introduce_once``
//    reading the old ``introduced_once`` on the device; then each source of
//    the launch's group in order, where the mask and its introduction mask
//    hold: rgb from the pixmap at the gather point (src, not halo-clamped,
//    or the base with ``introduce_on_all_*``), alpha its 4th byte or 1,
//    the source index, the gather point as positions and the source's
//    frame number. The mask is computed once, before any source: a launch
//    of a later group (kContinue) reads it from the plane the first launch
//    wrote, and the new state in place. It never writes the old state.
//  * K4 ``static_blit_kernel``: ``update_static`` (:378): each source's rgb
//    (and alpha, for a 4-channel source) copied where its introduction mask
//    holds, in source order, into a new rgba; a later group reads the
//    running rgba in place.
//  * K2 ``composite_kernel``: ``render_layer`` (:457) over the layer stack
//    and ``build_compositor``'s ``render_fn`` (:533): alpha *= mask_alpha
//    (the product in float32, then the cast to uint8 through int64 as
//    PyTorch casts float to uint8; introduction clips to [0, 255] first),
//    written to a new state tensor where a mask is set, and the image
//    ``where(alpha != 0, rgb, image)`` over the background.
//
// Launch arguments. A launch takes its sources (K1, K3, K4) or layers (K2)
// in a struct passed by value, at most kMaxSources or kMaxLayers of them.
// More go over several launches (ops/compositor.py): K1's later launches
// (kContinue) only regather over their group of sources, reading the new
// state and carrying the running rgba in place; K3's only introduce their
// group, K4's only blit theirs; K2's later launches carry the running
// image. Every loop over sources or layers is a sequential selection, so
// the groups give the one-pass result exactly.
//
// Meshes. Under a mesh whose ``space`` axis splits H the JAX package
// gathers through ``sharded_bounded_gather``; in the port's one process the
// state is whole on one device, and that gather equals
// ``bounded_row_gather``, which the halo argument computes. So a mesh
// changes nothing here.
//
// Numbers. Every value but the reset steps and the alpha product is an
// integer or a selection. The steps and the product are single IEEE
// operations (__fdiv_rn, __fmul_rn: nothing contracts into an FMA), the
// conversions are the ones PyTorch's own CUDA kernels compile
// ((int)rintf, (int)floorf, (float)int, (int64)float), and integer sums
// wrap as torch's int32 sums do. So each kernel equals its plain version
// (ops/compositor.py) on the card bit for bit.
//
// Bounds on the H100 at 1080x1920 (2.07 Mpixel). K1 on one moveref layer
// with one 3-channel source and no mask reads the flow (8 B), the own
// state (6 B), the gathered state (6 B), the old rgba (4 B) and one pixmap
// pixel (3 B), and writes the state (6 B) and the rgba (4 B): 37 B/pixel,
// 76.7 MB, ~0.023 ms at 3.35 TB/s. The draw's ~100 integer operations a
// pixel are ~0.2 G, ~0.003 ms even at the f32 rate. K3 reads at most the
// flow (8 B), the own and the gathered state (13 B each), the masks and
// the mark (3 B), a pixmap pixel (3 B) and writes 13 B: ~50 B/pixel, ~0.03
// ms. K4 on one 3-channel source reads the rgba, the mask and the pixmap
// and writes the rgba: 12 B/pixel, ~0.0074 ms. K2 on one unmasked layer
// reads 4 B and writes 3 B a pixel: ~0.0043 ms. The design is the simple
// one: a thread a pixel, byte loads, rgba as one 4-byte word; the gathers
// follow the flow, so a smooth flow keeps a warp's reads in a few lines.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSources = 8;  // ops/compositor.py MAX_SOURCES
constexpr int kMaxLayers = 8;   // ops/compositor.py MAX_LAYERS

// flag bits, shared with ops/compositor.py
constexpr int kSum = 1 << 0;          // sum layer: no gather, int32 out
constexpr int kContinue = 1 << 1;     // regather only, a later group
constexpr int kTransparent = 1 << 2;  // transparent_pixels_can_move
constexpr int kToEmpty = 1 << 3;      // pixels_can_move_to_empty_spot
constexpr int kToFilled = 1 << 4;     // pixels_can_move_to_filled_spot
constexpr int kLeaveEmpty = 1 << 5;   // moving_pixels_leave_empty_spot
constexpr int kResetSource = 1 << 6;  // reset_source
constexpr int kPosIn32 = 1 << 7;      // the state's positions are int32
constexpr int kPosOut32 = 1 << 8;     // the new positions are int32
constexpr int kModeShift = 9;         // 2 bits: the reset mode
constexpr int kModeRandom = 1, kModeConstant = 2, kModeLinear = 3;
// K3's eligibility flags (the layer's introduce_* settings)
constexpr int kOnEmpty = 1 << 11;    // introduce_pixels_on_empty_spots
constexpr int kOnFilled = 1 << 12;   // introduce_pixels_on_filled_spots
constexpr int kMovingOk = 1 << 13;   // introduce_moving_pixels
constexpr int kUnmovingOk = 1 << 14;  // introduce_unmoving_pixels
constexpr int kAllFilled = 1 << 15;  // introduce_on_all_filled_spots
constexpr int kAllEmpty = 1 << 16;   // introduce_on_all_empty_spots
constexpr int kOnce = 1 << 17;       // introduce_once
constexpr uint8_t kNoSource = 255;    // reset_source plane: no source

// One layer's update (K0, K1). Pointers first, so the layout is the same
// under any C ABI that aligns pointers to 8; ops/compositor.py mirrors it
// and checks its size against transflow_compositor_args_size.
struct UpdateArgs {
  const float2* flow;     // (H, W, 2) float32 (dx, dy)
  const void* pos_i;      // (H, W) int16 or int32 (kPosIn32)
  const void* pos_j;
  const uint8_t* alpha;   // (H, W)
  const uint8_t* source;  // (H, W)
  const uchar4* rgba;     // (H, W, 4); kContinue: the running rgba
  void* out_pos_i;        // (H, W) int16 or int32 (kPosOut32)
  void* out_pos_j;
  uint8_t* out_alpha;
  uint8_t* out_source;
  uchar4* out_rgba;
  const uint8_t* mask_src;      // bool (H, W), or null: all true
  const uint8_t* mask_dst;      // bool (H, W), or null
  const float* reset_factor;    // (H, W), or one value; the reset modes
  const uint8_t* reset_source;  // the last source whose introduction mask
                                // holds the pixel, kNoSource for none
  uint8_t* marks;               // K0's occupancy, kLeaveEmpty only
  const uint8_t* pixmaps[kMaxSources];  // (H, W, channels) uint8
  int channels[kMaxSources];            // 3 or 4
  int num_sources;   // of this launch's group
  int first_source;  // the group's first source index
  int H, W;
  int halo;          // < 0: none
  int flags;
  int factor_plane;  // reset_factor is (H, W), else one value
  unsigned key0, key1;  // the layer's threefry key (random mode)
};

// An introduction layer's update (K3); the same layout rules.
struct IntroArgs {
  const float2* flow;     // (H, W, 2) float32 (dx, dy)
  const uint8_t* rgb;     // (H, W, 3); kContinue: the new state, as below
  const uint8_t* alpha;   // (H, W)
  const uint8_t* source;  // (H, W)
  const int16_t* pos_i;   // (H, W)
  const int16_t* pos_j;
  const int* frame;       // (H, W) int32
  uint8_t* out_rgb;
  uint8_t* out_alpha;
  uint8_t* out_source;
  int16_t* out_pos_i;
  int16_t* out_pos_j;
  int* out_frame;
  const uint8_t* mask_src;         // bool (H, W), or null: all true
  const uint8_t* mask_dst;         // bool (H, W), or null
  const uint8_t* marks;            // K0's occupancy, kLeaveEmpty only
  const uint8_t* introduced_once;  // the old state's 0-d bool, kOnce only
  uint8_t* eligible;  // (H, W): the eligibility mask, written by the first
                      // launch and read by kContinue; null for one launch
  const uint8_t* intro_masks[kMaxSources];  // bool (H, W)
  const uint8_t* pixmaps[kMaxSources];      // (H, W, channels) uint8
  int channels[kMaxSources];                // 3 or 4
  int frames[kMaxSources];                  // the sources' frame numbers
  int num_sources;   // of this launch's group
  int first_source;  // the group's first source index
  int H, W;
  int halo;          // < 0: none
  int flags;
};

// A static layer's blit (K4).
struct BlitArgs {
  const uchar4* rgba;  // (H, W, 4): the old rgba, or the running one
  uchar4* out;         // (H, W, 4)
  const uint8_t* masks[kMaxSources];    // bool (H, W): introduction masks
  const uint8_t* pixmaps[kMaxSources];  // (H, W, channels) uint8
  int channels[kMaxSources];            // 3 or 4
  int num_sources;
  int n;  // H * W
};

struct RenderLayer {
  const uint8_t* rgb;    // rgb_stride bytes a pixel: rgba (4) or rgb (3)
  const uint8_t* alpha;  // alpha_stride bytes a pixel: rgba + 3 (4) or 1
  const float* mask;     // mask_alpha (H, W), or null: pass through
  uint8_t* out;          // masked: the new rgba (stride 4) or alpha (1)
  int rgb_stride;
  int alpha_stride;
  int clip;  // introduction: clip to [0, 255] before the cast
};

struct CompositeArgs {
  RenderLayer layers[kMaxLayers];
  const uint8_t* background;  // 3 bytes
  const uint8_t* image;       // (H, W, 3) running image, or null
  uint8_t* out;               // (H, W, 3)
  int num_layers;
  int n;  // H * W
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int load_pos(const void* p, int idx, bool wide) {
  return wide ? static_cast<const int*>(p)[idx]
              : (int)static_cast<const int16_t*>(p)[idx];
}

__device__ __forceinline__ void store_pos(void* p, int idx, int v,
                                          bool wide) {
  if (wide)
    static_cast<int*>(p)[idx] = v;
  else
    static_cast<int16_t*>(p)[idx] = (int16_t)v;  // the low 16 bits
}

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax.random.uniform's float of the flat counter idx under (k0, k1):
// threefry2x32 of (idx >> 32, idx), 20 rounds, a key injection every 4
// (prng.py _threefry2x32), then 23 mantissa bits under 1.0's exponent,
// minus 1.0 (exact, in [0, 1)).
__device__ __forceinline__ float uniform_at(unsigned k0, unsigned k1,
                                            long long idx) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned x0 = (unsigned)((unsigned long long)idx >> 32) + ks[0];
  unsigned x1 = (unsigned)idx + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][k]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

// The movement's gather for pixel p = (i, j): the flat pixel q it reads,
// whether p moves, and whether p takes q's state (the target flag).
struct Target {
  int q;
  bool moving;
  bool is_target;
};

// Args: UpdateArgs (K0, K1) or IntroArgs (K3), which share the fields read
// here.
template <class Args>
__device__ __forceinline__ Target movement_target(const Args& a, int p,
                                                  int i, int j,
                                                  bool filled) {
  const float2 f = a.flow[p];
  // torch.round(...).to(int32): round half to even, then the cast
  const int di = (int)rintf(f.y), dj = (int)rintf(f.x);
  Target t;
  t.moving = di != 0 || dj != 0;
  const int si = clampi(wrap_add(i, di), 0, a.H - 1);
  const int sj = clampi(wrap_add(j, dj), 0, a.W - 1);
  const int ei = a.halo < 0
                     ? si
                     : clampi(i + clampi(si - i, -a.halo, a.halo), 0, a.H - 1);
  t.q = ei * a.W + sj;
  bool target = t.moving;
  if (a.mask_src != nullptr) target = target && a.mask_src[t.q] != 0;
  if (!(a.flags & kTransparent)) target = target && a.alpha[t.q] != 0;
  if (a.mask_dst != nullptr) target = target && a.mask_dst[p] != 0;
  if (!(a.flags & kToEmpty)) target = target && filled;
  if (!(a.flags & kToFilled)) target = target && !filled;
  t.is_target = target;
  return t;
}

__global__ void __launch_bounds__(kThreads)
    leave_empty_kernel(const UpdateArgs a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.H * a.W) return;
  const int i = p / a.W, j = p - i * a.W;
  const Target t = movement_target(a, p, i, j, a.alpha[p] != 0);
  if (t.is_target) a.marks[t.q] = 1;
}

__global__ void __launch_bounds__(kThreads)
    layer_update_kernel(const UpdateArgs a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.H * a.W) return;
  const int i = p / a.W, j = p - i * a.W;
  const bool in32 = a.flags & kPosIn32, out32 = a.flags & kPosOut32;
  int pi = load_pos(a.pos_i, p, in32), pj = load_pos(a.pos_j, p, in32);
  uint8_t alpha = a.alpha[p], source = a.source[p];
  if (!(a.flags & kContinue)) {
    if (a.flags & kSum) {
      // pos + torch.floor(flow).to(int32), never clipped
      const float2 f = a.flow[p];
      pi = wrap_add(pi, (int)floorf(f.y));
      pj = wrap_add(pj, (int)floorf(f.x));
    } else {
      const Target t = movement_target(a, p, i, j, alpha != 0);
      const uint8_t g_alpha = a.alpha[t.q];
      uint8_t new_alpha = alpha;
      if (t.is_target) {
        pi = load_pos(a.pos_i, t.q, in32);
        pj = load_pos(a.pos_j, t.q, in32);
        source = a.source[t.q];
        new_alpha = g_alpha;
      }
      if (a.flags & kLeaveEmpty) {
        if (a.marks[p] != 0) new_alpha = 0;
      }
      const bool arrived =
          (a.flags & kTransparent) ? t.is_target && g_alpha != 0 : t.is_target;
      alpha = arrived ? 1 : new_alpha;
    }
    const int mode = (a.flags >> kModeShift) & 3;
    if (mode == kModeRandom) {
      const float factor = a.reset_factor[a.factor_plane ? p : 0];
      if (uniform_at(a.key0, a.key1, p) < factor) {
        pi = i;
        pj = j;
        alpha = 1;
        if (a.flags & kResetSource) {
          const uint8_t s = a.reset_source[p];
          if (s != kNoSource) source = s;
        }
      }
    } else if (mode != 0) {
      const float factor = a.reset_factor[a.factor_plane ? p : 0];
      // (ii - pos).float(): an int32 difference, then rounded to float32
      const float d_i = (float)wrap_add(i, -pi);
      const float d_j = (float)wrap_add(j, -pj);
      float step_i, step_j;
      if (mode == kModeConstant) {
        const float norm = fmaxf(fabsf(d_i), fabsf(d_j));
        step_i = norm > 0.f ? __fdiv_rn(d_i, norm) : d_i;
        step_j = norm > 0.f ? __fdiv_rn(d_j, norm) : d_j;
        step_i = __fmul_rn(step_i, factor);
        step_j = __fmul_rn(step_j, factor);
        if (fmaxf(fabsf(step_i), fabsf(step_j)) > norm) {
          step_i = d_i;
          step_j = d_j;
        }
      } else {
        step_i = __fmul_rn(factor, d_i);
        step_j = __fmul_rn(factor, d_j);
      }
      pi = wrap_add(pi, (int)rintf(step_i));
      pj = wrap_add(pj, (int)rintf(step_j));
    }
    if (!out32) {  // the state's carry dtype: the low 16 bits
      pi = (int16_t)pi;
      pj = (int16_t)pj;
    }
    store_pos(a.out_pos_i, p, pi, out32);
    store_pos(a.out_pos_j, p, pj, out32);
    a.out_alpha[p] = alpha;
    a.out_source[p] = source;
  }
  // the regather over this launch's sources, from the old (or running)
  // rgba
  const uchar4 old = a.rgba[p];
  uchar4 px = old;
  const int mi = clampi(pi, 0, a.H - 1), mj = clampi(pj, 0, a.W - 1);
  const size_t m = (size_t)mi * a.W + mj;
  const bool visible = alpha != 0;
#pragma unroll
  for (int k = 0; k < kMaxSources; ++k) {
    if (k >= a.num_sources) break;
    const int ch = a.channels[k];
    const bool sel = visible && (int)source == a.first_source + k;
    if (sel) {
      const uint8_t* q = a.pixmaps[k] + m * ch;
      px.x = q[0];
      px.y = q[1];
      px.z = q[2];
      if (ch == 4) px.w = q[3];
    }
    if (ch != 4) px.w = sel ? 1 : 0;
  }
  a.out_rgba[p] = px;
}

__global__ void __launch_bounds__(kThreads)
    introduction_update_kernel(const IntroArgs a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.H * a.W) return;
  const int i = p / a.W, j = p - i * a.W;
  // the gather point of the pixmaps: the movement's source (clipped to the
  // frame, never to the halo) or, with introduce_on_all_*, the base
  int gi = i, gj = j;
  if (!(a.flags & (kAllFilled | kAllEmpty))) {
    const float2 f = a.flow[p];
    gi = clampi(wrap_add(i, (int)rintf(f.y)), 0, a.H - 1);
    gj = clampi(wrap_add(j, (int)rintf(f.x)), 0, a.W - 1);
  }
  uint8_t r, g, b, alpha, source;
  int16_t pi, pj;
  int frame;
  bool eligible;
  if (!(a.flags & kContinue)) {
    const uint8_t own_alpha = a.alpha[p];
    const Target t = movement_target(a, p, i, j, own_alpha != 0);
    const int q = t.is_target ? t.q : p;
    r = a.rgb[3 * (size_t)q];
    g = a.rgb[3 * (size_t)q + 1];
    b = a.rgb[3 * (size_t)q + 2];
    source = a.source[q];
    pi = a.pos_i[q];
    pj = a.pos_j[q];
    frame = a.frame[q];
    const uint8_t g_alpha = a.alpha[t.q];
    uint8_t new_alpha = t.is_target ? g_alpha : own_alpha;
    if ((a.flags & kLeaveEmpty) && a.marks[p] != 0) new_alpha = 0;
    const bool arrived =
        (a.flags & kTransparent) ? t.is_target && g_alpha != 0 : t.is_target;
    alpha = arrived ? 1 : new_alpha;
    // the eligibility mask from the moved alpha, in JAX's order
    const bool filled = alpha != 0;
    bool m = true;
    if (!(a.flags & kOnEmpty)) m = m && filled;
    if (!(a.flags & kOnFilled)) m = m && !filled;
    if (!(a.flags & kMovingOk)) m = m && !t.moving;
    if (!(a.flags & kUnmovingOk)) m = m && t.moving;
    if (a.flags & kAllFilled) m = m || filled;
    if (a.flags & kAllEmpty) m = m || !filled;
    if ((a.flags & kOnce) && *a.introduced_once != 0) m = false;
    eligible = m;
    if (a.eligible != nullptr) a.eligible[p] = m;
  } else {
    // a later group: the new state in place, the mask the first launch
    // wrote
    r = a.rgb[3 * (size_t)p];
    g = a.rgb[3 * (size_t)p + 1];
    b = a.rgb[3 * (size_t)p + 2];
    alpha = a.alpha[p];
    source = a.source[p];
    pi = a.pos_i[p];
    pj = a.pos_j[p];
    frame = a.frame[p];
    eligible = a.eligible[p] != 0;
  }
  if (eligible) {
    const size_t m = (size_t)gi * a.W + gj;
#pragma unroll
    for (int k = 0; k < kMaxSources; ++k) {
      if (k >= a.num_sources) break;
      if (a.intro_masks[k][p] == 0) continue;
      const int ch = a.channels[k];
      const uint8_t* px = a.pixmaps[k] + m * ch;
      r = px[0];
      g = px[1];
      b = px[2];
      alpha = ch == 4 ? px[3] : 1;
      source = (uint8_t)(a.first_source + k);
      pi = (int16_t)gi;
      pj = (int16_t)gj;
      frame = a.frames[k];
    }
  }
  a.out_rgb[3 * (size_t)p] = r;
  a.out_rgb[3 * (size_t)p + 1] = g;
  a.out_rgb[3 * (size_t)p + 2] = b;
  a.out_alpha[p] = alpha;
  a.out_source[p] = source;
  a.out_pos_i[p] = pi;
  a.out_pos_j[p] = pj;
  a.out_frame[p] = frame;
}

__global__ void __launch_bounds__(kThreads)
    static_blit_kernel(const BlitArgs a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.n) return;
  uchar4 px = a.rgba[p];
#pragma unroll
  for (int k = 0; k < kMaxSources; ++k) {
    if (k >= a.num_sources) break;
    if (a.masks[k][p] == 0) continue;
    const int ch = a.channels[k];
    const uint8_t* q = a.pixmaps[k] + (size_t)p * ch;
    px.x = q[0];
    px.y = q[1];
    px.z = q[2];
    if (ch == 4) px.w = q[3];
  }
  a.out[p] = px;
}

__global__ void __launch_bounds__(kThreads)
    composite_kernel(const CompositeArgs a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.n) return;
  uint8_t r, g, b;
  if (a.image != nullptr) {
    r = a.image[3 * (size_t)p];
    g = a.image[3 * (size_t)p + 1];
    b = a.image[3 * (size_t)p + 2];
  } else {
    r = a.background[0];
    g = a.background[1];
    b = a.background[2];
  }
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l >= a.num_layers) break;
    const RenderLayer& L = a.layers[l];
    const uint8_t* rgb = L.rgb + (size_t)p * L.rgb_stride;
    uint8_t alpha = L.alpha[(size_t)p * L.alpha_stride];
    if (L.mask != nullptr) {
      float x = __fmul_rn(L.mask[p], (float)alpha);
      if (L.clip) x = fminf(fmaxf(x, 0.f), 255.f);
      // PyTorch's float -> uint8: through int64, then the low byte
      alpha = (uint8_t)(long long)x;
      if (L.alpha_stride == 4) {
        uint8_t* o = L.out + 4 * (size_t)p;
        o[0] = rgb[0];
        o[1] = rgb[1];
        o[2] = rgb[2];
        o[3] = alpha;
      } else {
        L.out[p] = alpha;
      }
    }
    if (alpha != 0) {
      r = rgb[0];
      g = rgb[1];
      b = rgb[2];
    }
  }
  a.out[3 * (size_t)p] = r;
  a.out[3 * (size_t)p + 1] = g;
  a.out[3 * (size_t)p + 2] = b;
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

bool channels_ok(const int* channels, int n) {
  for (int k = 0; k < n; ++k)
    if (channels[k] != 3 && channels[k] != 4) return false;
  return true;
}

int check_update(const UpdateArgs* a) {
  if (a == nullptr || a->H < 1 || a->W < 1 ||
      (long long)a->H * a->W > 0x7fffffffLL || a->num_sources < 0 ||
      a->num_sources > kMaxSources ||
      !channels_ok(a->channels, a->num_sources))
    return (int)cudaErrorInvalidValue;
  if (!aligned(a->flow, 8) || !aligned(a->rgba, 4) ||
      !aligned(a->out_rgba, 4))
    return (int)cudaErrorMisalignedAddress;
  if ((a->flags & kLeaveEmpty) && a->marks == nullptr)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int check_intro(const IntroArgs* a) {
  if (a == nullptr || a->H < 1 || a->W < 1 ||
      (long long)a->H * a->W > 0x7fffffffLL || a->num_sources < 0 ||
      a->num_sources > kMaxSources ||
      !channels_ok(a->channels, a->num_sources))
    return (int)cudaErrorInvalidValue;
  if (!aligned(a->flow, 8) || !aligned(a->pos_i, 2) ||
      !aligned(a->pos_j, 2) || !aligned(a->frame, 4) ||
      !aligned(a->out_pos_i, 2) || !aligned(a->out_pos_j, 2) ||
      !aligned(a->out_frame, 4))
    return (int)cudaErrorMisalignedAddress;
  if (((a->flags & kLeaveEmpty) && a->marks == nullptr) ||
      ((a->flags & kOnce) && a->introduced_once == nullptr) ||
      ((a->flags & kContinue) && a->eligible == nullptr))
    return (int)cudaErrorInvalidValue;
  return 0;
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// sizeof(UpdateArgs) (which 0), sizeof(CompositeArgs) (1), sizeof(IntroArgs)
// (2) or sizeof(BlitArgs) (3), -1 for another ``which``: the wrapper checks
// its ctypes mirrors against them.
extern "C" int transflow_compositor_args_size(int which) {
  switch (which) {
    case 0: return (int)sizeof(UpdateArgs);
    case 1: return (int)sizeof(CompositeArgs);
    case 2: return (int)sizeof(IntroArgs);
    case 3: return (int)sizeof(BlitArgs);
    default: return -1;
  }
}

// K0 over a moveref or an introduction layer's old state (its flow, alpha
// and masks): marks[q] = 1 for the source q of every target pixel. marks:
// H*W bytes, all zero before the launch. Returns a cudaError_t.
extern "C" int transflow_leave_empty_sources(const void* args, void* stream) {
  const UpdateArgs* a = static_cast<const UpdateArgs*>(args);
  if (const int err = check_update(a)) return err;
  if (a->marks == nullptr || (a->flags & kSum))
    return (int)cudaErrorInvalidValue;
  leave_empty_kernel<<<blocks_for((long long)a->H * a->W), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}


// K1: the layer's new state (kContinue: only the regather of a later
// group, into out_rgba, reading rgba == out_rgba). Returns a cudaError_t.
extern "C" int transflow_layer_update(const void* args, void* stream) {
  const UpdateArgs* a = static_cast<const UpdateArgs*>(args);
  if (const int err = check_update(a)) return err;
  layer_update_kernel<<<blocks_for((long long)a->H * a->W), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// K3: an introduction layer's new state (kContinue: only the introduction
// of a later group, reading and writing the new state in place, with the
// mask the first launch wrote to ``eligible``). Returns a cudaError_t.
extern "C" int transflow_introduction_update(const void* args,
                                             void* stream) {
  const IntroArgs* a = static_cast<const IntroArgs*>(args);
  if (const int err = check_intro(a)) return err;
  introduction_update_kernel<<<blocks_for((long long)a->H * a->W), kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// K4: a static layer's new rgba over ``num_sources`` sources (a later group
// passes rgba == out). Returns a cudaError_t.
extern "C" int transflow_static_blit(const void* args, void* stream) {
  const BlitArgs* a = static_cast<const BlitArgs*>(args);
  if (a == nullptr || a->n < 1 || a->num_sources < 0 ||
      a->num_sources > kMaxSources ||
      !channels_ok(a->channels, a->num_sources))
    return (int)cudaErrorInvalidValue;
  if (!aligned(a->rgba, 4) || !aligned(a->out, 4))
    return (int)cudaErrorMisalignedAddress;
  static_blit_kernel<<<blocks_for(a->n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// K2: the image over ``num_layers`` layers, and the masked layers' new
// alpha. Returns a cudaError_t.
extern "C" int transflow_composite(const void* args, void* stream) {
  const CompositeArgs* a = static_cast<const CompositeArgs*>(args);
  if (a == nullptr || a->n < 1 || a->num_layers < 0 ||
      a->num_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  composite_kernel<<<blocks_for(a->n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
