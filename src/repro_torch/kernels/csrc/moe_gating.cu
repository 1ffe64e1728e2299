// MoE router gating for Hopper (sm_90a).
//
// Replaces: the TPU kernel src/repro/kernels/moe_gating.py, _gating_kernel
//   (called through moe_gating_tokens).
//
// Computes, per token row of fp32 logits (T, E): probs = softmax(x) as
//   exp(x - max) / sum; then K rounds that take the largest remaining
//   probability (ties to the lowest expert index) and mask it with -1e30;
//   weights = selected / max(sum of selected, 1e-9), summed in selection
//   order.  Outputs weights (T, K) f32, ids (T, K) i32, probs (T, E) f32.
//
// What bounds it on this card: bytes, and at serving shapes the launch.
//   A row reads E * 4 bytes and writes E * 4 + K * 8; its arithmetic (one
//   exp per logit, K compare rounds) is about one operation per byte, far
//   below the fp32 ridge.  At T = 8 (one decode step) or T <= 2048 (one
//   prompt) that is at most ~1 MB, well under a microsecond at 3.35 TB/s,
//   so the fixed cost of a launch dominates.
//
// What the design does about it: one pass, nothing staged.
//   * One warp per token row.  Lane l holds experts l and l + 32 (-inf past
//     E), so a row of E <= 64 lives in one warp's registers: coalesced
//     loads, no shared memory, no __syncthreads.
//   * Max and sum through __shfl_xor_sync butterflies.  expf (not __expf)
//     and IEEE division keep the probabilities within an ulp or two of the
//     plain version; only the order of the sum differs.
//   * The top-k is K warp-wide argmax reductions over (prob, index) pairs,
//     the lower index winning ties, so every lane agrees on each pick; the
//     lane that owns the pick masks it.  Lane r keeps round r's pick and
//     writes it, so no per-thread array is indexed at run time.
//   * 8 warps (rows) per block, grid ceil(T / 8); rows past T exit whole.
//
// Layouts: all arrays contiguous, row-major.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxE = 64;
constexpr int kMaxK = 8;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// (value, index) argmax across the warp; the lower index wins a tie.  The
// order is total, so every lane ends with the same pair.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
moe_gating_kernel(const float* __restrict__ logits, float* __restrict__ w,
                  int* __restrict__ ids, float* __restrict__ probs, int T,
                  int E, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp leaves together
  const float* x = logits + static_cast<size_t>(row) * E;
  const int c0 = lane, c1 = lane + 32;
  const bool has0 = c0 < E, has1 = c1 < E;
  const float x0 = has0 ? x[c0] : -INFINITY;
  const float x1 = has1 ? x[c1] : -INFINITY;

  const float m = warp_max(fmaxf(x0, x1));
  float p0 = has0 ? expf(x0 - m) : 0.f;
  float p1 = has1 ? expf(x1 - m) : 0.f;
  const float denom = warp_sum(p0 + p1);
  p0 = p0 / denom;
  p1 = p1 / denom;
  float* prow = probs + static_cast<size_t>(row) * E;
  if (has0) prow[c0] = p0;
  if (has1) prow[c1] = p1;

  // candidates for the top-k: lanes past E can never be picked
  float s0 = has0 ? p0 : -INFINITY;
  float s1 = has1 ? p1 : -INFINITY;
  float total = 0.f, my_w = 0.f;
  int my_id = 0;
  for (int r = 0; r < K; ++r) {
    float v;
    int i;
    if (s1 > s0) {
      v = s1;
      i = c1;
    } else {
      v = s0;
      i = c0;
    }
    warp_argmax(v, i);
    if (lane == r) {
      my_w = v;
      my_id = i;
    }
    total += v;
    if (i == c0) s0 = kNeg;
    if (i == c1) s1 = kNeg;
  }
  if (lane < K) {
    const size_t o = static_cast<size_t>(row) * K + lane;
    w[o] = my_w / fmaxf(total, 1e-9f);
    ids[o] = my_id;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// E or K outside what one warp holds).
extern "C" int repro_moe_gating(const void* logits, void* w, void* ids,
                                void* probs, int T, int E, int K,
                                void* stream) {
  if (E < 1 || E > kMaxE || K < 1 || K > kMaxK || K > E || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (T + kWarps - 1) / kWarps;
  moe_gating_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(w),
      static_cast<int*>(ids), static_cast<float*>(probs), T, E, K);
  return static_cast<int>(cudaGetLastError());
}
