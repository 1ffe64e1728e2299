// Flash attention forward (streaming softmax) for Hopper (sm_90a), on the
// tensor cores in 3xTF32.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:30,
//   _flash_kernel (called through flash_attention_bhsd).
//
// What bounds it on this card: operations.  4 * B * H * hd FLOP per
//   visible (query, key) pair against (B * H * (Sq + 2 * Sk) * hd) elements
//   moved: at B=1, H=32, S=2048, hd=128, causal, that is 34.4 GFLOP, or
//   0.0694 ms at the 495 TFLOP/s TF32 peak, against 33.6 MB (0.010 ms).
//
// Why three products per multiply (3xTF32): the served path is fp32 and
//   holds this kernel to 1e-4 of the fp32 plain version.  A TF32 operand
//   keeps 10 mantissa bits, which puts score errors near 1e-3 at hd=128.
//   So every operand x is split into big = tf32(x) and small = tf32(x -
//   big), and each product is big*big + big*small + small*big, summed in
//   fp32: about 22 bits of each operand, close to fp32.  The price is 3x the tensor-core work, so even at the
//   full TF32 rate this kernel cannot go below 3 * 0.0694 ~ 0.21 ms at
//   the shape above: half of that shape's bound is out of reach at fp32
//   accuracy.
//
// What the design does:
//   * One block of 4 warps per (batch, head, 64-row query tile); each
//     warp owns 16 query rows.  The grid walks the query tiles from the
//     last, so causal's heaviest tiles start first.  The S x S score
//     matrix never exists.
//   * Q (pre-scaled by 1/sqrt(hd) * log2(e), so the softmax uses exp2) is
//     staged once in shared memory; 32-key K/V tiles go through a
//     two-stage ring filled with cp.async (bf16 is widened to fp32 on a
//     plain load instead).  Rows are padded to hd + 4 floats, which makes
//     the K^T fragment reads (row g, column t) and the permuted V reads
//     (row 2t or 2t+1, column g) free of bank conflicts.  About 101 KB of
//     shared memory at hd=128: two blocks (8 warps) per SM.
//   * Each warp splits the operands it reads, though 4 warps split the
//     same K and V.  Splitting them once per block into (big, small)
//     words needs twice their shared memory; both ways of paying for it
//     that were tried on the card (staging the tiles through registers,
//     ~220-255 of them; or 8 warps and one block per SM) ran slower than
//     this kernel, although they issue far fewer instructions.
//   * Q.K^T and P.V are mma.sync.m16n8k8 TF32 (row.col), 3 per fragment
//     pair, issued pass by pass across several fragments (all 4 score
//     tiles, or kPV output tiles at a time) so that no product waits on
//     the one before it.  The tensor cores' fp32 sums do not round to
//     nearest as an fp32 add does, so long chains of them drift: the score's small products
//     have an accumulator of their own, and each key tile's P.V starts
//     from zero and is added to the output in fp32, which brings the
//     kernel nearer the plain version.
//   * The score accumulator gives a thread columns (2t, 2t+1) of rows g
//     and g+8; the tf32 A fragment wants columns (t, t+4).  The kernel
//     relabels the keys instead of moving P: c0, c2 feed a0, a1 and c1, c3
//     feed a2, a3, and the V fragment reads key rows 2t and 2t+1 of the
//     8-key slice.  The sum over keys does not see the order.
//   * fp32 running max and sum per row; a row's max and the final sum are
//     taken over the quad of lanes that share it (2 shuffles).  A row that
//     has seen no visible key keeps an empty state (no exp(-inf - -inf)).
//   * Key tiles that the whole query tile cannot see (causal future, or
//     older than the window) are skipped; a warp also skips the products
//     of a tile none of its 16 rows can see.  The mask is applied only on
//     the tiles that cross the diagonal, the window edge or the end of Sk.
//   * Ragged Sq / Sk are masked in the kernel: no block-multiple rule.
//   * The output goes through the warp's own Q rows in shared memory, so
//     it is written as 16-byte stores.
//   * For training, the row's logsumexp lse = m + log l (natural units, the
//     JAX VJP's residual) goes to an fp32 (B, H, Sq) buffer when one is
//     given; serving passes none, and the output is the same to the bit.
//
// Layouts: q (B, H, Sq, hd), k/v (B, H, Sk, hd), out like q, each with
// arbitrary (b, h, s) strides in elements and a dense head dim; k/v are
// head-repeated; lse dense.  Causal query i sits at position Sk - Sq + i.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile
constexpr int kWarps = kBQ / 16;        // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPV = 8;                  // output tiles per pass of P.V
constexpr int kPad = 4;                 // floats of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one block: the Q tile and two stages of K and V tiles.
template <int HD>
struct Smem {
  static constexpr int LD = HD + kPad;
  static constexpr int kBytes = (kBQ + 2 * 2 * kBK) * LD * 4;
};

struct Strides {
  long long b, h, s;
};

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

// --- tensor-core pieces ---------------------------------------------------

// x = big + small (+ what neither keeps), each part a TF32 value.  The
// tensor core reads a TF32 operand's top 19 bits and ignores the low 13,
// so adding half a TF32 ulp (0x1000) to the bits rounds to the nearest
// TF32 value, ties away from zero: cvt.rna.tf32.f32 for finite x, without
// its inf/nan checks (4 instructions a split instead of 9).  Every operand
// here is finite: q, k, v, and probabilities in [0, 1].
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a * b, one m16n8k8 TF32 product with an fp32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- staging --------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Rows k0 .. k0 + kBK of K and V into one ring stage; rows at or past Sk
// are zeros.  fp32 goes through cp.async, bf16 through a widening load.
template <typename T, int HD>
__device__ __forceinline__ void load_kv(float* Ks, float* Vs, const T* kbase,
                                        const T* vbase, long long kss,
                                        long long vss, int k0, int Sk,
                                        int tid) {
  constexpr int C4 = HD / 4;
  constexpr int LD = Smem<HD>::LD;
#pragma unroll
  for (int i = tid; i < kBK * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4, kj = k0 + r;
    const bool in = kj < Sk;
    const T* ks = in ? kbase + kj * kss + c : kbase;
    const T* vs = in ? vbase + kj * vss + c : vbase;
    if constexpr (sizeof(T) == 4) {
      cp_async16(Ks + r * LD + c, reinterpret_cast<const float*>(ks), in);
      cp_async16(Vs + r * LD + c, reinterpret_cast<const float*>(vs), in);
    } else {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      store4(Ks + r * LD + c, in ? load4(ks) : z);
      store4(Vs + r * LD + c, in ? load4(vs) : z);
    }
  }
}

// --- the kernel -------------------------------------------------------------

// Lane (g, t) = (lane / 4, lane % 4) of warp w holds, for each 8-column
// tile j of a 16-row accumulator, rows w*16 + g and w*16 + g + 8 at
// columns 8j + 2t and 8j + 2t + 1.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal, int window,
                 float scale) {
  constexpr int LD = Smem<HD>::LD;
  constexpr int C4 = HD / 4;
  constexpr int NT = kBK / 8;       // 8-key tiles of a key tile
  constexpr int ND = HD / 8;        // 8-column tiles of the head dim
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  // ring stage i holds K at kv(i) and V at kv(i) + kBK * LD
  auto kv = [Qs](int i) { return Qs + (kBQ + 2 * kBK * i) * LD; };

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = causal ? Sk - Sq : 0;
  const int wrow = warp * 16;                 // the warp's first row
  const int wpos_lo = q_offset + q0 + wrow;   // the warp's first position
  const int qpos0 = wpos_lo + g;              // positions of rows g, g + 8
  const int qpos1 = qpos0 + 8;

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
  load_kv<T, HD>(kv(0), kv(0) + kBK * LD, kbase, vbase, ks.s, vs.s, k_begin,
                 Sk, tid);
  cp_async_commit();

  // Q tile, scaled so that the softmax can use exp2
  const float qscale = scale * kLog2e;
  const T* qbase = q + b * qs.b + h * qs.h;
  for (int i = tid; i < kBQ * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4, qi = q0 + r;
    float4 x = qi < Sq ? load4(qbase + qi * qs.s + c) : make_float4(0, 0, 0, 0);
    x.x *= qscale; x.y *= qscale; x.z *= qscale; x.w *= qscale;
    store4(Qs + r * LD + c, x);
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // rows g, g + 8 (log2 units)
  float l[2] = {0.f, 0.f};               // this lane's part of the row sums

  const float* qa = Qs + (wrow + g) * LD + t;
  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK, stage ^= 1) {
    if (k0 + kBK < k_end) {
      load_kv<T, HD>(kv(stage ^ 1), kv(stage ^ 1) + kBK * LD, kbase, vbase,
                     ks.s, vs.s, k0 + kBK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this stage (and the Q tile) has landed

    // warp-uniform: does any of this warp's 16 rows see a key here?
    bool live = true;
    if (causal) {
      live = k0 <= wpos_lo + 15;
      if (window > 0) live = live && k0 + kBK - 1 > wpos_lo - window;
    }
    if (live) {
      const float* kt = kv(stage);
      const float* vt = kt + kBK * LD;

      // S = Q K^T over this key tile: big * big into s, the two small
      // products into lo, each pass over all NT tiles before the next
      float s[NT][4], lo[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = lo[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
        split(qa[kk * 8], ab[0], as[0]);
        split(qa[kk * 8 + 8 * LD], ab[1], as[1]);
        split(qa[kk * 8 + 4], ab[2], as[2]);
        split(qa[kk * 8 + 4 + 8 * LD], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* kr = kt + (n * 8 + g) * LD + kk * 8 + t;
          split(kr[0], bb[n][0], bs[n][0]);
          split(kr[4], bb[n][1], bs[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(lo[n], as, bb[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(lo[n], ab, bs[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(s[n], ab, bb[n]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += lo[n][e];

      // mask only where the tile crosses the diagonal, the window edge or
      // the end of Sk
      bool edge = k0 + kBK > Sk;
      if (causal) {
        edge = edge || k0 + kBK - 1 > wpos_lo;
        if (window > 0) edge = edge || k0 <= wpos_lo + 15 - window;
      }
      if (edge) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + n * 8 + 2 * t + (e & 1);
            const int qp = e < 2 ? qpos0 : qpos1;
            bool ok = kj < Sk;
            if (causal) {
              ok = ok && kj <= qp;
              if (window > 0) ok = ok && kj > qp - window;
            }
            if (!ok) s[n][e] = -INFINITY;
          }
      }

      // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        // a row that has seen no visible key yet keeps an empty state
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use);
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          s[n][2 * r] = exp2f(s[n][2 * r] - m_use);
          s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_use);
          psum += s[n][2 * r] + s[n][2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + psum;
        m[r] = m_new;
      }
      // O = alpha O + P V, kPV output tiles at a time.  P V of this key
      // tile is summed on the tensor cores from zero, pass by pass, and
      // added to O in fp32.  The A fragment's columns t, t + 4 stand for
      // keys 2t, 2t + 1 of the 8-key slice, so V is read at those rows.
      uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split(s[n][0], pb[n][0], ps[n][0]);
        split(s[n][2], pb[n][1], ps[n][1]);
        split(s[n][1], pb[n][2], ps[n][2]);
        split(s[n][3], pb[n][3], ps[n][3]);
      }
#pragma unroll
      for (int j0 = 0; j0 < ND; j0 += kPV) {
        float acc[kPV][4];
#pragma unroll
        for (int j = 0; j < kPV; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* vr = vt + (n * 8 + 2 * t) * LD + g;
          uint32_t bb[kPV][2], bs[kPV][2];
#pragma unroll
          for (int j = 0; j < kPV; ++j) {
            split(vr[(j0 + j) * 8], bb[j][0], bs[j][0]);
            split(vr[(j0 + j) * 8 + LD], bb[j][1], bs[j][1]);
          }
#pragma unroll
          for (int j = 0; j < kPV; ++j) mma(acc[j], ps[n], bb[j]);
#pragma unroll
          for (int j = 0; j < kPV; ++j) mma(acc[j], pb[n], bs[j]);
#pragma unroll
          for (int j = 0; j < kPV; ++j) mma(acc[j], pb[n], bb[j]);
        }
#pragma unroll
        for (int j = 0; j < kPV; ++j) {
          o[j0 + j][0] = fmaf(o[j0 + j][0], alpha[0], acc[j][0]);
          o[j0 + j][1] = fmaf(o[j0 + j][1], alpha[0], acc[j][1]);
          o[j0 + j][2] = fmaf(o[j0 + j][2], alpha[1], acc[j][2]);
          o[j0 + j][3] = fmaf(o[j0 + j][3], alpha[1], acc[j][3]);
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();     // every warp is done with Q (also with no key tile)

  // normalise, then write through the warp's own Q rows as 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
    // m is in log2 units; lse = m ln 2 + log l, in natural units
    const int qi = q0 + wrow + g + 8 * r;
    if (lse != nullptr && t == 0 && qi < Sq)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qi] =
          m[r] * kLn2 + logf(fmaxf(sum, 1e-30f));
  }
  float* ow = Qs + (wrow + g) * LD + 2 * t;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<float2*>(ow + j * 8) =
        make_float2(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<float2*>(ow + j * 8 + 8 * LD) =
        make_float2(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  T* obase = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = lane; i < 16 * C4; i += 32) {
    const int r = i / C4, c = (i % C4) * 4, qi = q0 + wrow + r;
    if (qi < Sq)
      store4(obase + qi * os.s + c, load4(Qs + (wrow + r) * LD + c));
  }
}

template <typename T, int HD>
void launch_hd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int Sq, int Sk, Strides qs,
               Strides ks, Strides vs, Strides os, int causal, int window,
               float scale, cudaStream_t s) {
  constexpr int smem = Smem<HD>::kBytes;
  // above 48 KB only after this; a refusal shows in cudaGetLastError()
  cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, qs, ks, vs,
      os, causal, window, scale);
}

template <typename T>
bool launch(int hd, const void* q, const void* k, const void* v, void* out,
            float* lse, int B, int H, int Sq, int Sk, Strides qs, Strides ks,
            Strides vs, Strides os, int causal, int window, float scale,
            cudaStream_t s) {
  switch (hd) {
    case 64:
      launch_hd<T, 64>(q, k, v, out, lse, B, H, Sq, Sk, qs, ks, vs, os,
                       causal, window, scale, s);
      return true;
    case 128:
      launch_hd<T, 128>(q, k, v, out, lse, B, H, Sq, Sk, qs, ks, vs, os,
                        causal, window, scale, s);
      return true;
    default:
      return false;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim with no instantiation).  ``lse`` is a dense fp32 (B, H, Sq)
// buffer for the row logsumexps, or null.
extern "C" int repro_flash_attention_fwd(
    int is_bf16, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int H, int Sq, int Sk, int hd, long long q_sb,
    long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  const bool ok =
      is_bf16 ? launch<__nv_bfloat16>(hd, q, k, v, out, lse_f, B, H, Sq, Sk,
                                      qs, ks, vs, os, causal, window, scale, s)
              : launch<float>(hd, q, k, v, out, lse_f, B, H, Sq, Sk, qs, ks,
                              vs, os, causal, window, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block for head dim ``hd`` (0 if none).
extern "C" int repro_flash_attention_smem_bytes(int hd) {
  return hd == 64 ? Smem<64>::kBytes : hd == 128 ? Smem<128>::kBytes : 0;
}
