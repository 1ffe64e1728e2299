// Flash attention backward for Hopper (sm_90a): dq, dk and dv recomputed
// from the forward's saved logsumexp, on the tensor cores in 3xTF32.
//
// Replaces: no TPU kernel.  The JAX package's gradient of attention is the
//   jnp custom VJP src/repro/models/chunked.py:86-126 (_flash_bwd); its
//   Pallas flash kernel has no backward.
//
// What bounds it on this card: operations.  Per visible (query, key) pair
//   the backward does five products of hd terms (S = q.k^T again, dP =
//   dO.v^T, dV += P^T.dO, dK += dS^T.q, dQ += dS.k), 10 * hd FLOP.  At
//   B=1, H=36, S=2048, hd=64, causal that is 48.3 GFLOP, or 0.098 ms at the
//   495 TFLOP/s TF32 peak; its bytes (q, k, v, out, dO, lse read, dq, dk,
//   dv written: 151 MB) take 0.045 ms.
//
// The design's own floor: the two passes below recompute S and dP in
//   each, 7 products a pair, and each product is three TF32 products
//   (3xTF32, as csrc/flash_attention.cu explains), 42 * hd FLOP a pair:
//   0.410 ms at the shape above and 0.729 ms at granite-8b's (H=32,
//   hd=128).  So, as for the forward, most of the TF32 bound is out of
//   reach at fp32 accuracy.
//
// What the design does:
//   * Three kernels behind one C entry (one launch count), no atomics, so
//     two launches give the same bits:
//     - flash_bwd_delta_kernel: D_i = sum_d dO_i * O_i, one warp a row,
//       into a (B, H, Sq) fp32 scratch the wrapper allocates (a row sum,
//       bytes-bound: the only arithmetic of the backward off the tensor
//       cores);
//     - flash_bwd_dkdv_kernel: one block of 4 warps per (64-key tile,
//       head, batch); each warp owns 16 keys and solves the transposed
//       problem: S^T = K.Q^T and dP^T = V.dO^T, so P^T and dS^T = P^T *
//       (dP^T - D) are already in the accumulator layout that the next
//       products read as A fragments, and dV += P^T.dO, dK += dS^T.q;
//     - flash_bwd_dq_kernel: one block of 4 warps per (64-query tile,
//       head, batch), 16 queries a warp: S, dP and dS in registers, then
//       dQ += dS.K.
//     Each block keeps its own 64 rows (K and V, or Q and dO) in shared
//     memory and streams the other operand (Q, dO, lse and D, or K and V)
//     in tiles of BN rows through a two-stage ring filled with cp.async,
//     over the range that the causal and window bounds leave; a warp
//     skips the products of a tile none of its pairs can see, and masks
//     only the tiles that cross the diagonal, the window edge or the end
//     of Sq or Sk.
//   * The grid runs the heads fastest, so the causal pass's heaviest tiles
//     (the first key tiles, the last query tiles) of every head start
//     before any lighter one (in tile-major order the last heavy tiles
//     ran alone at the end).
//   * Every product is mma.sync.m16n8k8 TF32 (row.col), three per
//     fragment pair (big*big + big*small + small*big).  The tensor cores'
//     fp32 sums do not round to nearest (they truncate), so a long chain
//     of them drifts, one way.  So no chain is long: the small products
//     keep an accumulator of their own; the score-like products (S, dP)
//     restart their chain every 32 columns of hd (kSeg steps); the long
//     sums (dK and dV over the query tiles, dQ over the key tiles) restart
//     it every ring stage; and each chain's partial is added to its total
//     with an ordinary fp32 add.  tests/test_torch_flash_bwd.py models
//     this arithmetic on the CPU against gate T1: one chain for dK and dV
//     over 512 queries reads over T1's bound.
//   * The splits take issue slots from the mma they feed.  At hd=64 each
//     landed stage is split once per block, in place, into TF32 big and
//     small planes (the four warps read each entry up to eight times); at
//     hd=128 the planes would not leave room for two blocks an SM, so
//     each warp splits what it reads.  The own rows are split by their
//     warp as it reads them.
//   * The accumulator gives a lane columns (2t, 2t+1) of rows g and g+8;
//     the A fragment wants columns (t, t+4).  The kernels relabel the
//     reduced index instead of moving P or dS (as the forward does): c0,
//     c2 feed a0, a1 and c1, c3 feed a2, a3, and the B fragment reads rows
//     2t and 2t+1 of the 8-row slice.
//   * Shared rows are padded to hd + 4 floats, which keeps the fragment
//     reads (row g, column t; and row 2t, column g) free of bank
//     conflicts.  BN is 32 rows at hd=64 and 16 at hd=128; a block uses
//     104,960 bytes at hd=64 and 101,632 at hd=128, two blocks an SM,
//     which is also what the dK/dV pass's registers allow (its dK and dV
//     accumulators alone take hd of them).
//   * q is not pre-scaled (the ring copies raw rows): S is scaled in the
//     exponent, P = exp(fma(S, scale, -lse)), and dq and dk are scaled
//     once when they are written.
//   * Masking follows the JAX VJP: a masked pair has P = 0, and ragged Sq
//     / Sk are masked in the kernel (rows past the end are zero-filled).
//     Causal query i sits at position Sk - Sq + i.
//
// Layouts: q/out/dO/dq (B, H, Sq, hd), k/v/dk/dv (B, H, Sk, hd), each with
// arbitrary (b, h, s) strides in elements and a dense head dim; k/v are
// head-repeated.  q, k, v and dO rows are 16-byte aligned (the wrapper
// copies a tensor that is not).  lse and the scratch D are dense (B, H,
// Sq) fp32.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 64;              // own rows of a block
constexpr int kWarps = kRows / 16;     // 16 own rows a warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 4;                // floats of padding per shared row
constexpr int kSeg = 4;                // 8-column steps of hd in one chain

template <int HD>
struct Tile {
  static constexpr int LD = HD + kPad;
  static constexpr int BN = HD == 64 ? 32 : 16;   // streamed rows a stage
  static constexpr int NT = BN / 8;               // 8-row slices of a stage
  static constexpr int ND = HD / 8;               // 8-column tiles of hd
  static constexpr int kAcc = HD == 64 ? 8 : 1;   // output tiles a pass
  // a streamed tile is split once per block into TF32 big and small
  // planes where shared memory allows it, else each warp splits what it
  // reads
  static constexpr bool kPre = HD == 64;
  static constexpr int kTile = (kPre ? 2 : 1) * BN * LD;   // floats
  // a ring stage: two streamed tiles, then (dK/dV pass) BN lse and BN D
  static constexpr int kStage = 2 * kTile + 2 * BN;
  // own rows (two 64-row tiles), then two stages; the same in both passes
  static constexpr int kBytes = (2 * kRows * LD + 2 * kStage) * 4;
};

struct Strides {
  long long b, h, s;
};

struct Geometry {
  int Sq, Sk, causal, window, q_offset;
  float scale;
  __device__ __forceinline__ bool visible(int qi, int kj) const {
    if (qi >= Sq || kj >= Sk) return false;
    if (!causal) return true;
    const int qp = q_offset + qi;
    return kj <= qp && (window <= 0 || kj > qp - window);
  }
};

// --- tensor-core pieces (as csrc/flash_attention.cu) -------------------------

// x = big + small, each a TF32 value: cvt.rna.tf32.f32 for finite x
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

// the (big, small) parts of entry off of a streamed tile: read from its
// planes, or split here
template <int HD>
__device__ __forceinline__ void frag(const float* X, int off, uint32_t& big,
                                     uint32_t& small) {
  if constexpr (Tile<HD>::kPre) {
    big = __float_as_uint(X[off]);
    small = __float_as_uint(X[off + Tile<HD>::BN * Tile<HD>::LD]);
  } else {
    split(X[off], big, small);
  }
}

// --- staging ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// rows r0 .. r0 + rows of a (b, h) slice into a padded shared tile; rows
// at or past n are zeros
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ss, int r0, int rows,
                                          int n) {
  constexpr int C4 = HD / 4, LD = Tile<HD>::LD;
  for (int i = threadIdx.x; i < rows * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4, s = r0 + r;
    const bool in = s < n;
    cp_async16(dst + r * LD + c, in ? src + s * ss + c : src, in);
  }
}

// entries r0 .. r0 + count of a dense row into shared memory; past n zeros
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int r0, int count, int n) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, in ? src + r0 + i : src, in);
  }
}

// a landed streamed tile split in place: the big parts where the tile
// was, the small parts BN rows after it
template <int HD>
__device__ __forceinline__ void split_tile(float* X) {
  constexpr int C4 = HD / 4, LD = Tile<HD>::LD, BN = Tile<HD>::BN;
  for (int i = threadIdx.x; i < BN * C4; i += kThreads) {
    float* x = X + (i / C4) * LD + (i % C4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x);
    uint4 b, sm;
    split(v.x, b.x, sm.x);
    split(v.y, b.y, sm.y);
    split(v.z, b.z, sm.z);
    split(v.w, b.w, sm.w);
    *reinterpret_cast<uint4*>(x) = b;
    *reinterpret_cast<uint4*>(x + BN * LD) = sm;
  }
}

// --- the products ---------------------------------------------------------------

// Lane (g, t) = (lane / 4, lane % 4) of a warp holds, for each 8-column
// tile n of a 16-row accumulator, rows g and g + 8 at columns 8n + 2t and
// 8n + 2t + 1.

// s[n] = A . B^T over the head dim: A the warp's 16 rows (shared, row
// stride LD), B the NT 8-row slices of a stage.  In chains of kSeg
// 8-column steps: big * big into part, the two small products into lo,
// each pass over all NT slices; each chain's part + lo is added to s in
// fp32.
template <int HD, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* A,
                                       const float* B, int g, int t) {
  constexpr int LD = Tile<HD>::LD;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const float* a = A + g * LD + t;
#pragma unroll
  for (int k0 = 0; k0 < HD / 8; k0 += kSeg) {
    float part[NT][4], lo[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = lo[n][e] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + kSeg; ++kk) {
      uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
      split(a[kk * 8], ab[0], as[0]);
      split(a[kk * 8 + 8 * LD], ab[1], as[1]);
      split(a[kk * 8 + 4], ab[2], as[2]);
      split(a[kk * 8 + 4 + 8 * LD], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int off = (n * 8 + g) * LD + kk * 8 + t;
        frag<HD>(B, off, bb[n][0], bs[n][0]);
        frag<HD>(B, off + 4, bb[n][1], bs[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) mma(lo[n], as, bb[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma(lo[n], ab, bs[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma(part[n], ab, bb[n]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += part[n][e] + lo[n][e];
  }
}

// An accumulator tile as A fragments (big, small): the A fragment's
// columns t, t + 4 stand for columns 2t, 2t + 1 of the accumulator.
template <int NT>
__device__ __forceinline__ void as_a(const float (&x)[NT][4],
                                     uint32_t (&xb)[NT][4],
                                     uint32_t (&xs)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    split(x[n][0], xb[n][0], xs[n][0]);
    split(x[n][2], xb[n][1], xs[n][1]);
    split(x[n][1], xb[n][2], xs[n][2]);
    split(x[n][3], xb[n][3], xs[n][3]);
  }
}

// acc += X_A . Y over this stage: X_A the warp's (16 x BN) tile as A
// fragments, Y the stage's BN rows (shared, row stride LD), read at rows 2t
// and 2t + 1 of each 8-row slice to match the relabelling.  kAcc output
// tiles at a time; each starts from zero, big * big apart from the small
// products, and is added to acc in fp32.
template <int HD, int NT>
__device__ __forceinline__ void long_sum(float (&acc)[HD / 8][4],
                                         const uint32_t (&xb)[NT][4],
                                         const uint32_t (&xs)[NT][4],
                                         const float* Y, int g, int t) {
  constexpr int LD = Tile<HD>::LD, ND = HD / 8, kAcc = Tile<HD>::kAcc;
#pragma unroll
  for (int j0 = 0; j0 < ND; j0 += kAcc) {
    float part[kAcc][4], lo[kAcc][4];
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = lo[j][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int off = (n * 8 + 2 * t) * LD + j0 * 8 + g;
      uint32_t bb[kAcc][2], bs[kAcc][2];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        frag<HD>(Y, off + j * 8, bb[j][0], bs[j][0]);
        frag<HD>(Y, off + j * 8 + LD, bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kAcc; ++j) mma(lo[j], xs[n], bb[j]);
#pragma unroll
      for (int j = 0; j < kAcc; ++j) mma(lo[j], xb[n], bs[j]);
#pragma unroll
      for (int j = 0; j < kAcc; ++j) mma(part[j], xb[n], bb[j]);
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j0 + j][e] += part[j][e] + lo[j][e];
  }
}

// rows r and r + 8 of a warp's 16-row accumulator, times mul, as float2
// stores at row stride ss; rows at or past n are skipped
template <int HD>
__device__ __forceinline__ void store_rows(float* base, long long ss,
                                           const float (&acc)[HD / 8][4],
                                           int r, int n, float mul, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= n) continue;
    float* dst = base + row * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

// --- the kernels --------------------------------------------------------------------

__global__ void flash_bwd_delta_kernel(const float* __restrict__ out,
                                       const float* __restrict__ dout,
                                       float* __restrict__ D, int H, int Sq,
                                       int hd, Strides os, Strides ds) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  if (row >= H * Sq) return;
  const int h = row / Sq, i = row % Sq;
  const float* o = out + b * os.b + h * os.h + i * os.s;
  const float* g = dout + b * ds.b + h * ds.h + i * ds.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(g[d], o[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[(static_cast<long long>(b) * H + h) * Sq + i] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, int H, Geometry geo, Strides qs,
                      Strides ks, Strides vs, Strides gs, Strides dks,
                      Strides dvs) {
  using T = Tile<HD>;
  constexpr int LD = T::LD, BN = T::BN, NT = T::NT, ND = T::ND;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kRows * LD;
  // stage i: Q at stage(i), dO at + kTile, lse at + 2 kTile, D after it
  float* ring = Vs + kRows * LD;
  auto stage_at = [ring](int i) { return ring + i * T::kStage; };

  const int b = blockIdx.z, h = blockIdx.x, k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + warp * 16;   // the warp's first key
  const long long row0 = (static_cast<long long>(b) * H + h) * geo.Sq;
  const float* qbase = q + b * qs.b + h * qs.h;
  const float* gbase = dout + b * gs.b + h * gs.h;
  auto load_stage = [&](int i, int q0) {
    float* st = stage_at(i);
    load_rows<HD>(st, qbase, qs.s, q0, BN, geo.Sq);
    load_rows<HD>(st + T::kTile, gbase, gs.s, q0, BN, geo.Sq);
    load_vec(st + 2 * T::kTile, lse + row0, q0, BN, geo.Sq);
    load_vec(st + 2 * T::kTile + BN, D + row0, q0, BN, geo.Sq);
  };

  // the query rows that can see a key of this tile
  int q_begin = 0, q_end = geo.Sq;
  if (geo.causal) {
    const int k_last = min(k0 + kRows, geo.Sk) - 1;
    q_begin = max(0, k0 - geo.q_offset);
    if (geo.window > 0)
      q_end = min(geo.Sq, k_last + geo.window - geo.q_offset);
  }
  q_begin = (q_begin / BN) * BN;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  if (q_begin < q_end) {
    load_rows<HD>(Ks, k + b * ks.b + h * ks.h, ks.s, k0, kRows, geo.Sk);
    load_rows<HD>(Vs, v + b * vs.b + h * vs.h, vs.s, k0, kRows, geo.Sk);
    load_stage(0, q_begin);
    cp_async_commit();
  }
  int stage = 0;
  for (int q0 = q_begin; q0 < q_end; q0 += BN, stage ^= 1) {
    if (q0 + BN < q_end) {
      load_stage(stage ^ 1, q0 + BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this stage (and the K, V tiles) has landed
    if constexpr (T::kPre) {
      split_tile<HD>(stage_at(stage));
      split_tile<HD>(stage_at(stage) + T::kTile);
      __syncthreads();
    }

    // warp-uniform: can any of this warp's 16 keys be seen here?
    const int p0 = geo.q_offset + q0;   // position of the stage's first query
    bool live = kw < geo.Sk;
    if (geo.causal) {
      live = live && kw <= p0 + BN - 1;
      if (geo.window > 0) live = live && kw + 15 > p0 - geo.window;
    }
    if (live) {
      const float* Qt = stage_at(stage);
      const float* dOt = Qt + T::kTile;
      const float* lse_t = Qt + 2 * T::kTile;
      const float* D_t = lse_t + BN;
      // mask only where the tile crosses the diagonal, the window edge or
      // the end of Sq or Sk
      bool edge = kw + 16 > geo.Sk || q0 + BN > geo.Sq;
      if (geo.causal) {
        edge = edge || kw + 15 > p0;
        if (geo.window > 0) edge = edge || kw <= p0 + BN - 1 - geo.window;
      }

      // P^T: rows are keys kw + g (+ 8), columns queries q0 + 8n + 2t (+ 1)
      float p[NT][4], ds[NT][4];
      scores<HD, NT>(p, Ks + warp * 16 * LD, Qt, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(lse_t + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe =
              expf(fmaf(p[n][e], geo.scale, -((e & 1) ? l.y : l.x)));
          p[n][e] = (!edge || geo.visible(q0 + c + (e & 1),
                                          kw + g + 8 * (e >> 1)))
                        ? pe : 0.f;
        }
      }
      // dS^T = P^T (dP^T - D)
      scores<HD, NT>(ds, Vs + warp * 16 * LD, dOt, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 dd = *reinterpret_cast<const float2*>(D_t + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (ds[n][e] - ((e & 1) ? dd.y : dd.x));
      }
      uint32_t xb[NT][4], xs[NT][4];
      as_a<NT>(p, xb, xs);
      long_sum<HD, NT>(dv_acc, xb, xs, dOt, g, t);   // dV += P^T dO
      as_a<NT>(ds, xb, xs);
      long_sum<HD, NT>(dk_acc, xb, xs, Qt, g, t);    // dK += dS^T q
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

  store_rows<HD>(dk + b * dks.b + h * dks.h, dks.s, dk_acc, kw + g, geo.Sk,
                 geo.scale, t);
  store_rows<HD>(dv + b * dvs.b + h * dvs.h, dvs.s, dv_acc, kw + g, geo.Sk,
                 1.f, t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    float* __restrict__ dq, int H, Geometry geo, Strides qs,
                    Strides ks, Strides vs, Strides gs, Strides dqs) {
  using T = Tile<HD>;
  constexpr int LD = T::LD, BN = T::BN, NT = T::NT, ND = T::ND;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kRows * LD;
  // stage i: K at stage(i), V at + kTile
  float* ring = dOs + kRows * LD;
  auto stage_at = [ring](int i) { return ring + i * T::kStage; };

  const int b = blockIdx.z, h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + warp * 16;              // the warp's first query
  const int wpos = geo.q_offset + qw;         // and its position
  const long long row0 = (static_cast<long long>(b) * H + h) * geo.Sq;
  const float* kbase = k + b * ks.b + h * ks.h;
  const float* vbase = v + b * vs.b + h * vs.h;
  auto load_stage = [&](int i, int k0) {
    float* st = stage_at(i);
    load_rows<HD>(st, kbase, ks.s, k0, BN, geo.Sk);
    load_rows<HD>(st + T::kTile, vbase, vs.s, k0, BN, geo.Sk);
  };

  // lse and D of rows g and g + 8 (0 past Sq)
  float lse_r[2], D_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + 8 * r;
    lse_r[r] = qi < geo.Sq ? lse[row0 + qi] : 0.f;
    D_r[r] = qi < geo.Sq ? D[row0 + qi] : 0.f;
  }

  // the key range any row of this tile can see (as the forward's)
  int k_begin = 0, k_end = geo.Sk;
  if (geo.causal) {
    const int qpos_lo = geo.q_offset + q0;
    const int qpos_hi = geo.q_offset + min(q0 + kRows, geo.Sq) - 1;
    k_end = min(geo.Sk, qpos_hi + 1);
    if (geo.window > 0) k_begin = max(0, qpos_lo - geo.window + 1);
  }
  k_begin = (k_begin / BN) * BN;

  float dq_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  if (k_begin < k_end) {
    load_rows<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, kRows, geo.Sq);
    load_rows<HD>(dOs, dout + b * gs.b + h * gs.h, gs.s, q0, kRows, geo.Sq);
    load_stage(0, k_begin);
    cp_async_commit();
  }
  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BN, stage ^= 1) {
    if (k0 + BN < k_end) {
      load_stage(stage ^ 1, k0 + BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this stage (and the Q, dO tiles) has landed
    if constexpr (T::kPre) {
      split_tile<HD>(stage_at(stage));
      split_tile<HD>(stage_at(stage) + T::kTile);
      __syncthreads();
    }

    // warp-uniform: does any of this warp's 16 rows see a key here?
    bool live = qw < geo.Sq;
    if (geo.causal) {
      live = live && k0 <= wpos + 15;
      if (geo.window > 0) live = live && k0 + BN - 1 > wpos - geo.window;
    }
    if (live) {
      const float* Kt = stage_at(stage);
      const float* Vt = Kt + T::kTile;
      bool edge = k0 + BN > geo.Sk || qw + 16 > geo.Sq;
      if (geo.causal) {
        edge = edge || k0 + BN - 1 > wpos;
        if (geo.window > 0) edge = edge || k0 <= wpos + 15 - geo.window;
      }

      // P: rows are queries qw + g (+ 8), columns keys k0 + 8n + 2t (+ 1)
      float p[NT][4], ds[NT][4];
      scores<HD, NT>(p, Qs + warp * 16 * LD, Kt, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(fmaf(p[n][e], geo.scale, -lse_r[e >> 1]));
          p[n][e] = (!edge || geo.visible(qw + g + 8 * (e >> 1),
                                          k0 + n * 8 + 2 * t + (e & 1)))
                        ? pe : 0.f;
        }
      // dS = P (dP - D)
      scores<HD, NT>(ds, dOs + warp * 16 * LD, Vt, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (ds[n][e] - D_r[e >> 1]);
      uint32_t xb[NT][4], xs[NT][4];
      as_a<NT>(ds, xb, xs);
      long_sum<HD, NT>(dq_acc, xb, xs, Kt, g, t);    // dQ += dS k
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

  store_rows<HD>(dq + b * dqs.b + h * dqs.h, dqs.s, dq_acc, qw + g, geo.Sq,
                 geo.scale, t);
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v,
                      const float* out, const float* dout, const float* lse,
                      float* D, float* dq, float* dk, float* dv, int B, int H,
                      const Geometry& geo, Strides qs, Strides ks, Strides vs,
                      Strides os, Strides gs, Strides dqs, Strides dks,
                      Strides dvs, cudaStream_t s) {
  constexpr int kRowsPerBlock = 8;   // one warp a row
  flash_bwd_delta_kernel<<<dim3((H * geo.Sq + kRowsPerBlock - 1) /
                                    kRowsPerBlock, B),
                           32 * kRowsPerBlock, 0, s>>>(out, dout, D, H, geo.Sq,
                                                       HD, os, gs);
  constexpr int smem = Tile<HD>::kBytes;
  // above 48 KB only after this; a refusal shows in cudaGetLastError()
  cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  flash_bwd_dkdv_kernel<HD>
      <<<dim3(H, (geo.Sk + kRows - 1) / kRows, B), kThreads, smem, s>>>(
          q, k, v, dout, lse, D, dk, dv, H, geo, qs, ks, vs, gs, dks, dvs);
  flash_bwd_dq_kernel<HD>
      <<<dim3(H, (geo.Sq + kRows - 1) / kRows, B), kThreads, smem, s>>>(
          q, k, v, dout, lse, D, dq, H, geo, qs, ks, vs, gs, dqs);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// a head dim with no instantiation).  ``D`` is a (B, H, Sq) fp32 scratch.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int H, int Sq, int Sk, int hd, const long long* strides,
    int causal, int window, float scale, void* stream) {
  // strides: (b, h, s) of q, k, v, out, dout, dq, dk, dv in that order
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Geometry geo{Sq, Sk, causal, window, causal ? Sk - Sq : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(out);
  const auto* gf = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* Df = static_cast<float*>(D);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  switch (hd) {
    case 64:
      return static_cast<int>(launch_hd<64>(
          qf, kf, vf, of, gf, lf, Df, dqf, dkf, dvf, B, H, geo, st[0], st[1],
          st[2], st[3], st[4], st[5], st[6], st[7], s));
    case 128:
      return static_cast<int>(launch_hd<128>(
          qf, kf, vf, of, gf, lf, Df, dqf, dkf, dvf, B, H, geo, st[0], st[1],
          st[2], st[3], st[4], st[5], st[6], st[7], s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the dK/dV pass (pass 0) and the dQ pass (pass
// 1) for head dim ``hd`` (0 if none): one layout size serves both.
extern "C" int repro_flash_attention_bwd_smem_bytes(int hd, int pass) {
  if (pass != 0 && pass != 1) return 0;
  return hd == 64 ? Tile<64>::kBytes : hd == 128 ? Tile<128>::kBytes : 0;
}
