// Forward-to-backward flow conversion for Hopper (sm_90a): kernel B5.
//
// Replaces the last-write-wins scatter of transflow_tpu/ops/scatter.py
// (scatter_last_wins, a jnp scatter-max that XLA compiles; there is no
// Pallas source) as transflow_tpu/flow/transforms.py's forward_to_backward
// uses it on every frame of `-d forward`. For a float32 (H, W, 2) forward
// flow (x, y) it computes, with N = H * W and p the flat source pixel,
//
//   fx = clip(flow[p].x, -j, W-1-j)    fy = clip(flow[p].y, -i, H-1-i)
//   flat[p] = rint(fy) * W + rint(fx)         (round half to even)
//   target[p] = clamp(p + flat[p], 0, N-1)
//   winner[t] = max{p + 1 : target[p] == t and flat[p] != 0}, else 0
//   out[t] = winner[t] ? coords(winner[t] - 1) - coords(t) : (0, 0)
//
// with coords(q) = (q % W, q / W) as float32. The winner is the last
// writer in flat order, numpy.put's rule. A maximum does not depend on the
// order the atomics land in, so the kernel is deterministic under any
// contention and equals the plain PyTorch version (an amax scatter_reduce_
// and a gather) bit for bit: every value is an exact small integer.
//
// Bound on the H100. The function reads the 8-byte flow and writes the
// 8-byte output of each pixel: 16 B/pixel, 33 MB at 1080x1920, ~0.0099 ms
// at 3.35 TB/s. Beside that the kernel moves its scratch (4 B/pixel
// written by the atomics and read back by the resolve, mostly in L2), and
// a converging flow piles its atomics onto few words, which serialise at
// their L2 slice. What the design does:
// - Two launches on the caller's stream and nothing else. The scratch is
//   never cleared between calls: each word holds p + 1 tagged with the
//   call's epoch in the bits above p + 1, so a word of an earlier call
//   always loses the atomicMax and reads as "no writer". The epoch is a
//   word of the scratch that the kernels advance themselves (no host
//   state, so a CUDA graph replays it); every kMaxEpoch calls the resolve
//   zeroes the words and the epoch starts again at 1.
// - The scatter is a fixed grid of kBlocksPerSm blocks an SM; block b
//   walks its chunk of pixels last to first, so later writers land first.
//   A lane takes two pixels 32 apart (float2 loads, 256 contiguous bytes
//   a warp and load; one 128-byte run of targets a warp and atomic on a
//   smooth flow).
// - A pixel makes no atomic where the next pixel in flat order (in its
//   warp, by a shuffle) writes the same word, or where its thread claimed
//   that word for a later pixel: a converging flow then makes about one
//   atomic a warp, and the right half of a row that clips onto its last
//   pixel one a warp and step.
// - The resolve reads two words and writes one float4 a thread and step
//   (256 and 512 contiguous bytes a warp).
// - Both divide by W with a multiply-high (Divider) and keep the target
//   in int arithmetic: on a smooth flow the scatter is partly bound by
//   its instructions.
// Measured and dropped (PERF.md §6): an L2 read of the word before each
// atomic (slower on every flow but the converging one), clearing the
// scratch in the resolve (its stores took 10-37 us more), a memset before
// the scatter (3 us and a device event), one cooperative launch with a
// grid barrier, and 16-byte flow loads of two adjacent pixels (their
// atomics and stores fell on every other word).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 2;                 // pixels a lane takes a step
constexpr int kStep = kThreads * kPix;  // pixels a block takes a step
constexpr int kBlocksPerSm = 8;
constexpr unsigned kFull = 0xffffffffu;
// calls between two clearings of the scratch; fewer where N leaves fewer
// bits above p + 1
constexpr unsigned kMaxEpoch = 255;

// q / W for 0 <= q < 2^31 by a multiply-high and two shifts, exact for
// every such q (Granlund and Montgomery's round-up method; m and shift
// from the host): the divisions by W are most of both kernels' integer
// work.
struct Divider {
  int W;
  unsigned m;
  int shift;  // ceil(log2 W) - 1, or -1 for W == 1
};

__device__ __forceinline__ int div_w(int q, Divider d) {
  if (d.shift < 0) return q;
  const unsigned t = __umulhi(d.m, (unsigned)q);
  return (int)((t + (((unsigned)q - t) >> 1)) >> d.shift);
}

// The word pixel p = (i, j) writes, or -1 where it stays (flat == 0). The
// clipped offsets keep p + flat inside [0, N-1] (inf clips to the edge,
// fmaxf drops NaN), so the plain version's clamp of the target is a no-op
// here and int arithmetic cannot overflow.
__device__ __forceinline__ int pixel_target(float2 f, int p, int H,
                                            Divider d) {
  const int W = d.W;
  const int i = div_w(p, d), j = p - i * W;
  // jnp.clip: min(max(x, lo), hi)
  const float fx = fminf(fmaxf(f.x, (float)-j), (float)(W - 1 - j));
  const float fy = fminf(fmaxf(f.y, (float)-i), (float)(H - 1 - i));
  const int flat = (int)rintf(fy) * W + (int)rintf(fx);
  return flat == 0 ? -1 : p + flat;
}

// winner[0, n): the tagged words; winner[n]: the last call's epoch;
// winner[n + 1]: this call's, set by the scatter for the resolve.
__global__ void __launch_bounds__(kThreads)
    forward_scatter_kernel(const float2* __restrict__ flow,
                           unsigned* __restrict__ winner, int H, Divider d,
                           long long chunk, int bits, unsigned max_epoch) {
  __shared__ unsigned s_epoch;
  const int n = H * d.W;
  const long long hi = n - blockIdx.x * chunk;
  const int lane = threadIdx.x & 31;
  const int warp_first = (threadIdx.x >> 5) * 32 * kPix + lane;
  const unsigned last = threadIdx.x == 0 ? __ldcg(winner + n) : 0u;
  unsigned tag = 0;
  int cached = -1;
  // every block has a first step: the barrier in it is reached by all
  for (long long top = hi; top > hi - chunk && top > 0; top -= kStep) {
    const int p0 = (int)(top - kStep) + warp_first;  // may be < 0
    int t[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = p0 + 32 * k;
      t[k] = p >= 0 ? pixel_target(flow[p], p, H, d) : -1;
    }
    if (top == hi) {  // the epoch, once the first loads are under way
      if (threadIdx.x == 0) {
        const unsigned e = last >= max_epoch ? 1u : last + 1u;
        s_epoch = e;
        if (blockIdx.x == 0) winner[n + 1] = e;
      }
      __syncthreads();
      tag = s_epoch << bits;
    }
    int next[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      // pixel p's successor p + 1: lane + 1's pixel k; past lane 31,
      // lane 0's pixel k + 1; past the warp's last pixel, none
      const int down = __shfl_down_sync(kFull, t[k], 1);
      const int wrap =
          k + 1 < kPix ? __shfl_sync(kFull, t[k + 1 < kPix ? k + 1 : k], 0)
                       : -2;
      next[k] = lane == 31 ? wrap : down;
    }
#pragma unroll
    for (int k = kPix - 1; k >= 0; --k) {
      if (t[k] < 0 || t[k] == next[k]) continue;
      if (t[k] != cached) atomicMax(winner + t[k], tag | (p0 + 32 * k + 1));
      cached = t[k];
    }
  }
}

// The mapping of target (ti, tj) from its untagged winner w (0: none).
__device__ __forceinline__ float2 mapping(unsigned w, int ti, int tj,
                                          Divider d) {
  if (w == 0) return make_float2(0.f, 0.f);
  const int src = (int)w - 1;
  const int si = div_w(src, d);
  const int sj = src - si * d.W;
  return make_float2((float)sj - (float)tj, (float)si - (float)ti);
}

__global__ void __launch_bounds__(kThreads)
    backward_resolve_kernel(unsigned* __restrict__ winner,
                            float4* __restrict__ out, int H, Divider d,
                            int bits, unsigned max_epoch) {
  __shared__ unsigned s_epoch;
  const int W = d.W;
  const int n = H * W;
  const int pairs = n >> 1;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const uint2* words = reinterpret_cast<const uint2*>(winner);
  uint2 w = first < pairs ? __ldcg(words + first) : make_uint2(0, 0);
  if (threadIdx.x == 0) {
    s_epoch = __ldcg(winner + n + 1);
    if (blockIdx.x == 0) winner[n] = s_epoch;
  }
  __syncthreads();
  const unsigned e = s_epoch;
  const unsigned mask = (1u << bits) - 1u;
  const bool clear = e == max_epoch;
  for (int r = first; r < pairs; r += stride) {
    if (r != first) w = __ldcg(words + r);
    if (clear) reinterpret_cast<uint2*>(winner)[r] = make_uint2(0, 0);
    const int t = 2 * r;
    int ti = div_w(t, d), tj = t - ti * W;
    const float2 a = mapping((w.x >> bits) == e ? w.x & mask : 0u, ti, tj, d);
    if (++tj == W) {
      tj = 0;
      ++ti;
    }
    const float2 b = mapping((w.y >> bits) == e ? w.y & mask : 0u, ti, tj, d);
    out[r] = make_float4(a.x, a.y, b.x, b.y);
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0) {  // the last target
    const int t = n - 1;
    const unsigned wt = __ldcg(winner + t);
    if (clear) winner[t] = 0;
    const int ti = div_w(t, d);
    reinterpret_cast<float2*>(out)[t] =
        mapping((wt >> bits) == e ? wt & mask : 0u, ti, t - ti * W, d);
  }
}

// The fixed grid: kBlocksPerSm blocks on each SM of the current device.
int grid_blocks() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return sms[dev] * kBlocksPerSm;
}

}  // namespace

// flow and out: (H, W, 2) float32; winner: H*W + 2 int32 words of scratch.
// All three 16-byte aligned. winner is all zero before its first call;
// after that only this entry writes it, at this H*W (a zeroed buffer
// starts it again). Returns a cudaError_t.
extern "C" int transflow_forward_to_backward(const void* flow, void* winner,
                                             void* out, int H, int W,
                                             void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)H * W;
  // a word holds p + 1 <= n
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(flow) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(winner)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int blocks = grid_blocks();
  if (blocks == 0) return (int)cudaGetLastError();
  // p + 1 takes `bits` bits of a word, the epoch those above
  const int bits = 32 - __builtin_clz((unsigned)n);
  const unsigned epochs = (1u << (32 - bits)) - 1u;
  const unsigned max_epoch = epochs < kMaxEpoch ? epochs : kMaxEpoch;
  // pixels a block, a whole number of steps
  long long chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + kStep - 1) / kStep * kStep;
  Divider d{W, 0u, -1};
  if (W > 1) {
    int l = 0;
    while ((1ll << l) < W) ++l;
    d.m = (unsigned)((((1ull << l) - (unsigned long long)W) << 32) / W + 1);
    d.shift = l - 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* words = static_cast<unsigned*>(winner);
  forward_scatter_kernel<<<(unsigned)((n + chunk - 1) / chunk), kThreads, 0,
                           s>>>(static_cast<const float2*>(flow), words, H,
                                d, chunk, bits, max_epoch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pair_blocks = (n / 2 + kThreads - 1) / kThreads;
  const int resolve_blocks =
      pair_blocks < 1 ? 1 : (pair_blocks < blocks ? (int)pair_blocks : blocks);
  backward_resolve_kernel<<<resolve_blocks, kThreads, 0, s>>>(
      words, static_cast<float4*>(out), H, d, bits, max_epoch);
  return (int)cudaGetLastError();
}
