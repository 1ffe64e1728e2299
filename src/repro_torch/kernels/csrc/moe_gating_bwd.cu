// MoE gating backward for Hopper (sm_90a): the VJP of the gating (softmax
// over the E experts, top-K of the probabilities, renormalised) at its
// outputs, one warp per token row.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp gating
//   (src/repro/models/moe.py:62, topk_gating) with XLA's autodiff, and the
//   TPU gating kernel (src/repro/kernels/moe_gating.py:22) has no VJP.  It
//   was added so that training runs the router kernel (csrc/moe_gating.cu)
//   forward and this kernel backward, with nothing of the gating in plain
//   PyTorch on the card.
//
// Per token row, with p the probabilities, e_j the K selected experts, w_j
//   their weights and s = max(sum_j p[e_j], 1e-9) (summed in selection
//   order, as the forward sums it):
//     c       = sum_j dw_j * w_j
//     dp[e]   = dprobs[e] + (dw_j / s - c / s)   for e = e_j (c / s is 0
//               when s is clamped: nothing flows through the clamp)
//     dlogits = p * (dp - sum_e p[e] * dp[e])
//   The products dx = dlogits @ router^T and drouter = x^T @ dlogits are
//   plain fp32 matmuls in the wrapper (kernels/moe_gating.py), as the JAX
//   package leaves the router product and its gradient to XLA.
//
// What bounds it on this card: bytes, and at training's sizes the launch.
//   It reads probs and dprobs (T * E * 4 bytes each) and the weights, ids
//   and dweights (T * K * 4 each) once and writes dlogits (T * E * 4); at
//   qwen2-moe-a2.7b's E = 60, K = 4 and T = 2048 that is 1.57 MB, 0.47 us
//   at 3.35 TB/s, less than a launch.  About 10 operations an element.
//
// What the design does about it: one pass, every input read once.  Lane l
//   of a row's warp holds experts l and l + 32 (E <= 64); the K ids,
//   weights and dweights are read by every lane (one broadcast each); both
//   row sums (the selected probabilities and p . dp) are warp shuffles.
//   No shared memory and no atomics: two launches agree to the bit.
//
// Layouts: all arrays contiguous, row-major; ids int32, the rest fp32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxE = 64;
constexpr int kMaxK = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
    gating_bwd_kernel(const float* __restrict__ probs,
                      const float* __restrict__ w, const int* __restrict__ ids,
                      const float* __restrict__ dw,
                      const float* __restrict__ dprobs,
                      float* __restrict__ dlogits, int T, int E, int K) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;  // a whole warp leaves together
  const float* p = probs + row * E;
  const float* dpr = dprobs + row * E;
  const int e0 = lane, e1 = lane + 32;
  const float p0 = e0 < E ? p[e0] : 0.f;
  const float p1 = e1 < E ? p[e1] : 0.f;
  float d0 = e0 < E ? dpr[e0] : 0.f;
  float d1 = e1 < E ? dpr[e1] : 0.f;

  int id[kMaxK];
  float dwv[kMaxK];
  float total = 0.f, c = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < K) {
      id[j] = ids[row * K + j];
      dwv[j] = dw[row * K + j];
      total += p[id[j]];
      c += dwv[j] * w[row * K + j];
    }
  }
  const float s = fmaxf(total, 1e-9f);
  const float coef = total >= 1e-9f ? c / s : 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < K) {
      const float v = dwv[j] / s - coef;
      if (id[j] == e0) d0 += v;
      if (id[j] == e1) d1 += v;
    }
  }
  const float dot = warp_sum(p0 * d0 + p1 * d1);
  float* out = dlogits + row * E;
  if (e0 < E) out[e0] = p0 * (d0 - dot);
  if (e1 < E) out[e1] = p1 * (d1 - dot);
}

__global__ void gating_bwd_empty_kernel() {}

}  // namespace

extern "C" int repro_gating_bwd(const void* probs, const void* w,
                                const void* ids, const void* dw,
                                const void* dprobs, void* dlogits, int T,
                                int E, int K, void* stream) {
  if (E < 1 || E > kMaxE || K < 1 || K > kMaxK || K > E || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (T + kWarps - 1) / kWarps;
  gating_bwd_kernel<<<blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const float*>(w),
      static_cast<const int*>(ids), static_cast<const float*>(dw),
      static_cast<const float*>(dprobs), static_cast<float*>(dlogits), T, E,
      K);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel at the launch shape repro_gating_bwd uses for T rows.
extern "C" int repro_gating_bwd_empty(int T, void* stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  gating_bwd_empty_kernel<<<(T + kWarps - 1) / kWarps, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
