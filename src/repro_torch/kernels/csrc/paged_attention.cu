// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces: the TPU kernel src/repro/kernels/paged_attention.py,
//   _paged_kernel (called through paged_attention_pallas).
//
// What bounds it on this card: bytes.  Each slot's cached K and V are read
//   once (length * Hk * hd * 2 * itemsize); the arithmetic is ~2 FLOP per
//   byte for fp32 pools, far below the card's ~20 FLOP/byte fp32 ridge.
//
// What the design does about it:
//   * One thread block per (slot, kv-head) computes all rep = H / Hk query
//     heads of that kv-head, so each K/V row is read from memory once, not
//     rep times.
//   * It loops over only the slot's first ceil(length / page) pages.  Padded
//     block-table entries (0, i.e. some other slot's page) are never read;
//     a row with length 0 attends to the current token only.
//   * Lanes split the head dim (hd / 32 contiguous elements each, one
//     vector load per row); each of the 8 warps takes 4 tokens at a time and
//     issues all 8 row loads before any arithmetic, to keep 32 KB in flight
//     per block.  int8 rows are dequantised in registers with the page's
//     per-kv-head scale.
//   * Online softmax (m, l, acc) in fp32 per warp, the current token folded
//     in as warp 0's initial state; warps merge through shared memory.
//   Later work: split long contexts across blocks (64 blocks at M=8, Hk=8
//   fill half the SMs), cp.async/TMA staging.
//
// Layouts: q (M, H, hd) f32; pools (P, page, Hk, hd) f32 or int8; scales
// (P, Hk) f32; block tables (M, NP) i32; lengths (M,) i32; k/v_new
// (M, Hk, hd) f32; out (M, H, hd) f32.  All contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kTokens = 4;  // tokens per warp per iteration

template <int N>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* o) {
    float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
  __device__ static void load(const int8_t* p, float* o) {
    char2 v = *reinterpret_cast<const char2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* o) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static void load(const int8_t* p, float* o) {
    char4 v = *reinterpret_cast<const char4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// EPL: head-dim elements per lane (hd = 32 * EPL); REP: query heads per
// kv-head.
template <typename KV, int EPL, int REP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths,
                    const float* __restrict__ k_new,
                    const float* __restrict__ v_new, float* __restrict__ out,
                    int NP, int page, int Hk, float scale) {
  constexpr int HD = EPL * 32;
  constexpr bool kQuant = sizeof(KV) == 1;
  const int m = blockIdx.x, hk = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = Hk * REP;
  // the engine keeps length < NP * page; clamp so a bad length cannot
  // walk off the block table
  const int len = min(max(lengths[m], 0), NP * page);
  const int* bt = block_tables + (size_t)m * NP;

  float qr[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    Vec<EPL>::load(q + ((size_t)m * H + hk * REP + r) * HD + lane * EPL, qr[r]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] *= scale;
  }

  float mx[REP], l[REP], acc[REP][EPL];
  if (warp == 0) {
    // the current token is always attended: it seeds warp 0's state
    float kn[EPL], vn[EPL];
    Vec<EPL>::load(k_new + ((size_t)m * Hk + hk) * HD + lane * EPL, kn);
    Vec<EPL>::load(v_new + ((size_t)m * Hk + hk) * HD + lane * EPL, vn);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qr[r][e] * kn[e];
      mx[r] = warp_sum(s);
      l[r] = 1.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = vn[e];
    }
  } else {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      mx[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }
  }

  for (int t0 = warp * kTokens; t0 < len; t0 += kWarps * kTokens) {
    float kf[kTokens][EPL], vf[kTokens][EPL];
#pragma unroll
    for (int u = 0; u < kTokens; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const int pi = t / page;
        const int p = bt[pi];
        const size_t base =
            (((size_t)p * page + (t - pi * page)) * Hk + hk) * HD + lane * EPL;
        Vec<EPL>::load(k_pool + base, kf[u]);
        Vec<EPL>::load(v_pool + base, vf[u]);
        if (kQuant) {
          const float ks = k_scales[(size_t)p * Hk + hk];
          const float vs = v_scales[(size_t)p * Hk + hk];
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kf[u][e] *= ks;
            vf[u][e] *= vs;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTokens; ++u) {
      if (t0 + u >= len) break;  // uniform across the warp
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[r][e] * kf[u][e];
        s = warp_sum(s);
        const float m_new = fmaxf(mx[r], s);
        const float alpha = expf(mx[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * alpha + p * vf[u][e];
        mx[r] = m_new;
      }
    }
  }

  // merge the warps' partial states
  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][HD];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[warp][r] = mx[r];
      sm_l[warp][r] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) L += sm_l[w][r] * expf(sm_m[w][r] - M);
    const float f = expf(mx[r] - M);  // 0 for a warp that saw no token
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[r][e] * f;
    __syncthreads();
    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sm_acc[w][d];
      out[((size_t)m * H + hk * REP + r) * HD + d] = sum / L;
    }
    __syncthreads();
  }
}

template <typename KV, int EPL, int REP>
void launch(const void* q, const void* kp, const void* vp, const void* ks,
            const void* vs, const void* bt, const void* len, const void* kn,
            const void* vn, void* out, int M, int Hk, int NP, int page,
            float scale, cudaStream_t stream) {
  paged_decode_kernel<KV, EPL, REP><<<dim3(M, Hk), kWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(len), static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<float*>(out), NP, page, Hk,
      scale);
}

template <typename KV, int EPL>
bool launch_rep(int rep, const void* q, const void* kp, const void* vp,
                const void* ks, const void* vs, const void* bt, const void* len,
                const void* kn, const void* vn, void* out, int M, int Hk,
                int NP, int page, float scale, cudaStream_t s) {
  switch (rep) {
    case 1: launch<KV, EPL, 1>(q, kp, vp, ks, vs, bt, len, kn, vn, out, M, Hk, NP, page, scale, s); return true;
    case 2: launch<KV, EPL, 2>(q, kp, vp, ks, vs, bt, len, kn, vn, out, M, Hk, NP, page, scale, s); return true;
    case 4: launch<KV, EPL, 4>(q, kp, vp, ks, vs, bt, len, kn, vn, out, M, Hk, NP, page, scale, s); return true;
    case 8: launch<KV, EPL, 8>(q, kp, vp, ks, vs, bt, len, kn, vn, out, M, Hk, NP, page, scale, s); return true;
    case 16: launch<KV, EPL, 16>(q, kp, vp, ks, vs, bt, len, kn, vn, out, M, Hk, NP, page, scale, s); return true;
    default: return false;
  }
}

template <typename KV>
bool launch_hd(int hd, int rep, const void* q, const void* kp, const void* vp,
               const void* ks, const void* vs, const void* bt, const void* len,
               const void* kn, const void* vn, void* out, int M, int Hk,
               int NP, int page, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_rep<KV, 2>(rep, q, kp, vp, ks, vs, bt, len, kn, vn, out, M, Hk, NP, page, scale, s);
    case 128: return launch_rep<KV, 4>(rep, q, kp, vp, ks, vs, bt, len, kn, vn, out, M, Hk, NP, page, scale, s);
    default: return false;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim or rep with no instantiation).
extern "C" int repro_paged_decode_attention(
    int kv_int8, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* lengths, const void* k_new, const void* v_new, void* out,
    int M, int Hk, int rep, int hd, int NP, int page, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      kv_int8 ? launch_hd<int8_t>(hd, rep, q, k_pool, v_pool, k_scales,
                                  v_scales, block_tables, lengths, k_new, v_new,
                                  out, M, Hk, NP, page, scale, s)
              : launch_hd<float>(hd, rep, q, k_pool, v_pool, k_scales, v_scales,
                                 block_tables, lengths, k_new, v_new, out, M,
                                 Hk, NP, page, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
