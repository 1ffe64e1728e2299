// Flash attention forward (streaming softmax) for Hopper (sm_90a).
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py,
//   _flash_kernel (called through flash_attention_bhsd).
//
// What bounds it on this card: operations.  4 * B * H * Sq * Sk_eff * hd
//   FLOP against (B * H * (Sq + 2 * Sk) * hd) elements moved: at prefill
//   sizes (S >= 2048) that is hundreds of FLOP per byte, above the ridge,
//   so the tensor-core rate sets the floor.
//
// What the design does about it (first version: simple and right):
//   * One block of 256 threads per (batch, head, 64-row query tile); the
//     S x S score matrix never exists.  Four threads share a query row,
//     each holding a quarter of its head dim (q and the fp32 accumulator
//     stay in registers), so a row's dot product is 2 shuffles.
//   * 32-key K/V tiles are staged in shared memory as fp32 (bf16 inputs
//     are widened on load) and read by every row of the tile.
//   * fp32 running max / sum / accumulator per row; key tiles that are
//     fully masked for the whole query tile (causal future, or older than
//     the window) are skipped, so causal work is ~half of Sq * Sk.
//   * Ragged Sq / Sk are masked in the kernel: no block-multiple rule.
//   The products run on the CUDA cores in fp32.  mma/wgmma on tensor cores,
//   TMA staging and a deeper tile pipeline are later work.
//
// Layouts: q (B, H, Sq, hd), k/v (B, H, Sk, hd), out like q, each with
// arbitrary (b, h, s) strides in elements and a dense head dim; k/v are
// head-repeated.  Causal query i sits at position Sk - Sq + i.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 256; // 4 threads per query row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&a);
  raw.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

struct Strides {
  long long b, h, s;
};

// HD: head dim.  Thread (row, sub) owns the float4 chunks sub, sub + 4, ...
// of its row, so the 4 threads of a row read 4 adjacent float4s of a
// shared-memory key row (no bank conflict; the 8 rows of a warp broadcast).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int window, float scale) {
  constexpr int C4 = HD / 4;     // float4 chunks per row
  constexpr int NC = C4 / 4;     // chunks per thread
  __shared__ float4 Ks[kBK][C4];
  __shared__ float4 Vs[kBK][C4];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int qi = q0 + row;
  const bool row_ok = qi < Sq;
  const int q_offset = causal ? Sk - Sq : 0;
  const int qpos = q_offset + qi;

  float4 qv[NC], acc[NC];
  const T* qrow = q + b * qs.b + h * qs.h + (long long)qi * qs.s;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float4 x = row_ok ? load4(qrow + (c * 4 + sub) * 4) : make_float4(0, 0, 0, 0);
    qv[c] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[c] = make_float4(0, 0, 0, 0);
  }
  float m = -INFINITY, l = 0.f;

  // key range any row of this tile can see
  int k_begin = 0, k_end = Sk;
  if (causal) {
    const int qpos_lo = q_offset + q0;
    const int qpos_hi = q_offset + min(q0 + kBQ, Sq) - 1;
    k_end = min(Sk, qpos_hi + 1);
    if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  }
  k_begin = (k_begin / kBK) * kBK;

  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * C4; i += kThreads) {
      const int kr = i / C4, c = i % C4, kj = k0 + kr;
      const bool in = kj < Sk;
      Ks[kr][c] = in ? load4(kbase + (long long)kj * ks.s + c * 4) : make_float4(0, 0, 0, 0);
      Vs[kr][c] = in ? load4(vbase + (long long)kj * vs.s + c * 4) : make_float4(0, 0, 0, 0);
    }
    __syncthreads();

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = Ks[j][c * 4 + sub];
        part += qv[c].x * kk.x + qv[c].y * kk.y + qv[c].z * kk.z + qv[c].w * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      bool ok = kj < Sk;
      if (causal) {
        ok = ok && kj <= qpos;
        if (window > 0) ok = ok && kj > qpos - window;
      }
      s[j] = ok ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    // a row that has seen no visible key yet keeps an empty state
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_use);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = Vs[j][c * 4 + sub];
        acc[c].x += p * vv.x; acc[c].y += p * vv.y;
        acc[c].z += p * vv.z; acc[c].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + b * os.b + h * os.h + (long long)qi * os.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store4(orow + (c * 4 + sub) * 4,
             make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv));
  }
}

template <typename T>
bool launch(int hd, const void* q, const void* k, const void* v, void* out,
            int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
            Strides os, int causal, int window, float scale, cudaStream_t s) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  switch (hd) {
    case 64:
      flash_fwd_kernel<T, 64><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, Sq, Sk, qs, ks, vs, os, causal, window, scale);
      return true;
    case 128:
      flash_fwd_kernel<T, 128><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, Sq, Sk, qs, ks, vs, os, causal, window, scale);
      return true;
    default:
      return false;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim with no instantiation).
extern "C" int repro_flash_attention_fwd(
    int is_bf16, const void* q, const void* k, const void* v, void* out, int B,
    int H, int Sq, int Sk, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      is_bf16 ? launch<__nv_bfloat16>(hd, q, k, v, out, B, H, Sq, Sk, qs, ks,
                                      vs, os, causal, window, scale, s)
              : launch<float>(hd, q, k, v, out, B, H, Sq, Sk, qs, ks, vs, os,
                              causal, window, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
