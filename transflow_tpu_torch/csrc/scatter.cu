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
// Two launches on the caller's stream, after an async memset of the int32
// `winner` buffer (the wrapper's scratch): one thread per source pixel
// (clip, round, atomicMax), then one thread per target (resolve). No host
// sync.
//
// Bound on the H100. The function reads the 8-byte flow and writes the
// 8-byte output of each pixel: 16 B/pixel, 33 MB at 1080x1920, ~0.0099 ms
// at 3.35 TB/s. The kernel also moves 12 B/pixel of scratch (the memset,
// the atomic and the resolve's read of `winner`), 28 B/pixel in all, most
// of it in L2 at this size (8.3 MB of `winner`). What the design does:
// coalesced 8-byte flow loads and stores (float2), one atomic per moving
// pixel and none for a pixel that stays, no sorting. Fusing the resolve
// into the first pass needs a grid-wide barrier and is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    forward_scatter_kernel(const float2* __restrict__ flow,
                           int* __restrict__ winner, int H, int W) {
  const long long n = (long long)H * W;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int i = (int)(p / W);
  const int j = (int)(p - (long long)i * W);
  const float2 f = flow[p];
  // jnp.clip: min(max(x, lo), hi)
  const float fx = fminf(fmaxf(f.x, (float)-j), (float)(W - 1 - j));
  const float fy = fminf(fmaxf(f.y, (float)-i), (float)(H - 1 - i));
  const long long flat = (long long)(int)rintf(fy) * W + (int)rintf(fx);
  if (flat == 0) return;
  long long target = p + flat;
  target = target < 0 ? 0 : (target > n - 1 ? n - 1 : target);
  atomicMax(winner + target, (int)(p + 1));
}

__global__ void __launch_bounds__(kThreads)
    backward_resolve_kernel(const int* __restrict__ winner,
                            float2* __restrict__ out, int H, int W) {
  const long long n = (long long)H * W;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int w = winner[t];
  float2 v = make_float2(0.f, 0.f);
  if (w != 0) {
    const long long src = w - 1;
    const int si = (int)(src / W), ti = (int)(t / W);
    const int sj = (int)(src - (long long)si * W);
    const int tj = (int)(t - (long long)ti * W);
    v.x = (float)sj - (float)tj;
    v.y = (float)si - (float)ti;
  }
  out[t] = v;
}

}  // namespace

// flow and out: (H, W, 2) float32; winner: H*W int32 scratch, zeroed here.
// Returns a cudaError_t.
extern "C" int transflow_forward_to_backward(const void* flow, void* winner,
                                             void* out, int H, int W,
                                             void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)H * W;
  // winner holds p + 1 <= n as an int
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(winner, 0, n * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  forward_scatter_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float2*>(flow), static_cast<int*>(winner), H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  backward_resolve_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(winner), static_cast<float2*>(out), H, W);
  return (int)cudaGetLastError();
}
