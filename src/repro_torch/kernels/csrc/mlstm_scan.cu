// Chunkwise mLSTM scan (xLSTM matrix memory) for Hopper (sm_90a).
//
// Replaces: the TPU kernel src/repro/kernels/mlstm_scan.py, _mlstm_kernel
//   (called through mlstm_scan_bhsd).
//
// What it computes, per (batch, head), over S rows in chunks, with
// log-space gates and the exp(-m) stabiliser (F = in-chunk cumsum of
// log f):
//   logD[t][s] = F_t - F_s + i_s (s <= t),  m_t = max(max_s logD, F_t + m)
//   h_t = (sum_s (q_t.k_s) e^{logD - m_t} v_s + w_t q_t C)
//         / max(|sum_s (q_t.k_s) e^{logD - m_t} + w_t q_t.n|, e^{-m_t})
//   with w_t = e^{F_t + m - m_t}; then C, n, m move to the chunk's end.
// m_t is the same maximum whatever the chunk width, so the kernel's
// 64-row chunks compute the TPU kernel's function up to rounding.
//
// What bounds it on this card: operations.  A chunk of W rows of one head
// needs 4 W^2 hd + 4 W hd^2 FLOP (q k^T, P v, q C, k^T v): at W = 64 and
// hd = 1024, 95% of it is the two hd x hd-sized products q C and k^T v.
//
// What the design does about it: two kernels.
//   * mlstm_prep_kernel, one block per (chunk, batch*head), all in
//     parallel: everything that does not depend on C.  The m chain over
//     chunks, m' = max(m + F_T, max_s(F_T - F_s + i_s)), is a scalar scan
//     over the gates alone: each block folds the chunks before its own (a
//     thread each, folded in order, so every block sees the same m).
//     Then the row stabilisers m_t and weights w_t, the chunk-end weights
//     wk_s and carry, the causal score tile P = (q k^T) e^{logD - m_t}
//     with its row sums, and n's increment sum_s k_s wk_s (fp64), all
//     written to a scratch buffer (B*H*S*W floats for P: 2 MiB at B=1,
//     H=4, S=2048).  The score product is thus done once per chunk, on
//     the CUDA cores (fp32 products summed per 32 head dims, the slices
//     added in fp64).
//   * The gates are scalar work, so the prep takes them in fp64 (F, the m
//     chain, m_t and the exponents of w, wk, carry and P), rounding each
//     result to fp32 once.  In fp32, the rounding of the chain's F_T (a
//     sum of 64 log f) shifts the weight of the memory against the
//     chunk's own rows; where the denominator cancels between the two,
//     that alone took h past gate G1 on a warm start with m = 20 (a
//     64-row chunk rounds at every chunk's end, the plain version's
//     256-row chunk does not).
//   * mlstm_walk_kernel, one block of 8 warps per (batch*head, 32 columns
//     of C): only what needs C.  Its 32 x hd tile of C^T (132 KB at
//     hd = 1024) and all of n stay in shared memory while the block walks
//     the chunks; per chunk it reads P, the gates and n's increment from
//     L2 and computes q C_tile and q.n, P v_tile, the output tile, and the
//     updates C_tile = carry C_tile + (k wk)^T v_tile and n = carry n +
//     increment (hd values, in every block; block column 0 writes n out).
//   * The three products run on the tensor cores as mma.sync.m16n8k8 TF32
//     in the 3xTF32 split (big * big + big * small + small * big, each
//     fp32 operand split by integer rounding), close to fp32.  The tensor
//     cores' fp32 sums do not round to nearest, so long chains of them
//     drift: q C and P v are summed from zero per 8-wide k step and added
//     to their running sums in fp32 (the four warps of a row block hold a
//     quarter of the head dims each, summed in order in shared memory),
//     and each chunk's update dC starts from zero and is added as
//     carry C + dC in fp32 on the CUDA cores.
//   * Where q.n nearly cancels (a memory-dominated state) h is num / den
//     with a tiny den, and den's rounding is what reaches h: an fp32 q.n
//     summed in another order than the plain version's took h past gate
//     G1 on a warm start with m = 20.  So q.n is taken in fp64 on the CUDA
//     cores (the products of fp32 operands are exact there), and so are
//     the denominator, P's row sums and the score tile's sums across
//     head-dim slices.  n itself (hd values) and its increments are
//     carried in fp64: at 64-row chunks n is rescaled by carry at every
//     chunk's end, and in fp32 those roundings alone took such rows close
//     to the gate.
//   * Fragment indices are relabelled so that every operand is read as
//     float2: in a k step, slot t stands for head dim 2t and slot t + 4
//     for 2t + 1 (the sum over k does not see the order); C^T rows of hd + 8
//     floats make the fragment reads and the update free of bank conflicts.
//   * Why not one kernel: a block would need the scores of a chunk it did
//     not compute, or an exchange across blocks; both cost more than the
//     2 MiB round trip of P through L2.
//   * expf and IEEE division (no fast math).  Any S >= 1
//     (a ragged last chunk is masked) and any start state, including
//     m = -1e30 (no state) and a serving cache's m = 0.
//
// Layouts (fp32, contiguous; q, k, v, h, C0, C 16-byte aligned): q, k, v, h
// (BH, S, hd); log_i, log_f (BH, S); C0, C (BH, hd, hd); n0, n (BH, hd);
// m0, m (BH).  Scratch: see repro_mlstm_scratch_layout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 64;           // rows per chunk
constexpr int kBV = 32;          // value columns of C and h per walk block
constexpr int kDK = 32;          // head-dim slice of the prep's score product
constexpr int kLdT = kW + 4;     // row stride of the prep's transposed slices
constexpr int kPs = kW + 1;      // row stride of a score tile in shared memory
constexpr int kMaxHd = 1024;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// What the prep pass hands the walk, per batch*head: nk [nC][hd]; P
// [nC][W][W]; the per-row arrays [nC * W] (rows past S hold zeros); per
// chunk [nC].  Each array covers all heads, in this order in the scratch
// buffer, nk first so that its doubles are aligned.
struct Scratch {
  double* nk;     // sum_s k_s wk_s, n's increment over the chunk
  float* P;       // (q k^T) e^{logD - m_t}, causal, zero past S
  float* w;       // w_t = e^{F_t + m - m_t}
  float* mt;      // m_t
  float* rs;      // sum_s P[t][s]
  float* wk;      // e^{F_T - F_s + i_s - m'}
  float* carry;   // e^{m + F_T - m'}
  float* m;       // m entering the chunk
};

constexpr int kArrays = 8;

// Offsets of the arrays of Scratch, in floats from the buffer's start, in
// the struct's order; off[kArrays] is the buffer's length.
void scratch_offsets(int BH, int S, int hd, long long (&off)[kArrays + 1]) {
  const long long chunks = static_cast<long long>(BH) * ((S + kW - 1) / kW);
  const long long rows = chunks * kW;
  const long long len[kArrays] = {2 * chunks * hd, rows * kW, rows, rows,
                                  rows, rows, chunks, chunks};
  off[0] = 0;
  for (int i = 0; i < kArrays; ++i) off[i + 1] = off[i] + len[i];
}

Scratch scratch_views(float* base, int BH, int S, int hd) {
  long long off[kArrays + 1];
  scratch_offsets(BH, S, hd, off);
  return Scratch{reinterpret_cast<double*>(base), base + off[1],
                 base + off[2], base + off[3], base + off[4], base + off[5],
                 base + off[6], base + off[7]};
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// F_T and max_s(F_T - F_s + i_s) of one chunk of Wv rows from t0, by one
// thread, in fp64 (see the prep kernel): F is the in-chunk cumsum of log f.
struct ChunkStats {
  double Ft, A;
};

__device__ ChunkStats chunk_stats(const float* li, const float* lf, int t0,
                                  int Wv) {
  double F = 0.0;
#pragma unroll 16
  for (int t = 0; t < Wv; ++t) F += lf[t0 + t];
  ChunkStats st{F, kNeg};
  F = 0.0;
#pragma unroll 16
  for (int t = 0; t < Wv; ++t) {
    F += lf[t0 + t];
    st.A = fmax(st.A, (st.Ft - F) + li[t0 + t]);
  }
  return st;
}

// ---------------------------------------------------------------- prep

__global__ void __launch_bounds__(kThreads)
mlstm_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ log_i,
                  const float* __restrict__ log_f,
                  const float* __restrict__ m0, Scratch sc,
                  float* __restrict__ m_out, int S, int hd, int nC) {
  __shared__ __align__(16) float qT[kDK * kLdT];   // [d][t]
  __shared__ __align__(16) float kT[kDK * kLdT];
  __shared__ float Ps[kW * kPs];
  __shared__ float wks[kW];
  __shared__ double Fs[kW], lis[kW], mts[kW];
  __shared__ double stat[2][kThreads];
  __shared__ double m_in, m_nx;

  const int c = blockIdx.x;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int t0 = c * kW, Wv = min(kW, S - t0);
  const float* lib = log_i + bh * S;
  const float* lfb = log_f + bh * S;
  const long long row0 = bh * nC * kW + t0;   // this chunk in the row arrays

  // ---- m entering this chunk: the chunks before it, a thread each, folded
  // in order by every thread
  double m = m0[bh];
  for (int j0 = 0; j0 < c; j0 += kThreads) {
    if (j0 + tid < c) {
      const ChunkStats st = chunk_stats(lib, lfb, (j0 + tid) * kW, kW);
      stat[0][tid] = st.Ft;
      stat[1][tid] = st.A;
    }
    __syncthreads();
    for (int i = 0; i < min(kThreads, c - j0); ++i)
      m = fmax(m + stat[0][i], stat[1][i]);
    __syncthreads();
  }

  // ---- this chunk's gates (F by one thread, as chunk_stats sums it), its
  // chunk-end weights and carry
  if (tid < kW) {
    Fs[tid] = tid < Wv ? lfb[t0 + tid] : 0.f;
    lis[tid] = tid < Wv ? lib[t0 + tid] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    double F = 0.0;
    for (int t = 0; t < kW; ++t) {
      F += Fs[t];
      Fs[t] = F;
    }
    const double Ft = Fs[Wv - 1];
    double A = kNeg;
    for (int t = 0; t < Wv; ++t) A = fmax(A, (Ft - Fs[t]) + lis[t]);
    const double m_next = fmax(m + Ft, A);
    m_in = m;
    m_nx = m_next;
    sc.carry[bh * nC + c] = static_cast<float>(exp((m + Ft) - m_next));
    sc.m[bh * nC + c] = static_cast<float>(m);
    if (c == nC - 1) m_out[bh] = static_cast<float>(m_next);
  }
  __syncthreads();
  if (tid < kW) {
    wks[tid] = tid < Wv ? static_cast<float>(exp(
        ((Fs[Wv - 1] - Fs[tid]) + lis[tid]) - m_nx)) : 0.f;
    sc.wk[row0 + tid] = wks[tid];
  }
  // ---- row stabilisers and weights
  if (tid < kW) {
    double mt = 0.0, w = 0.0;
    if (tid < Wv) {
      const double Fi = Fs[tid];
      double mi = kNeg;
      for (int s = 0; s <= tid; ++s) mi = fmax(mi, (Fi - Fs[s]) + lis[s]);
      const double binter = Fi + m_in;
      mt = fmax(mi, binter);
      w = exp(binter - mt);
    }
    mts[tid] = mt;
    sc.mt[row0 + tid] = static_cast<float>(mt);
    sc.w[row0 + tid] = static_cast<float>(w);
  }

  // ---- scores q k^T over the head dim in 32-wide slices; each thread a
  // 4 x 4 tile (rows 4 tr.., columns 4 tc..), each slice summed apart.
  // With each slice of k also n's increment sum_s k_s wk_s: eight lanes a
  // head dim, eight rows each (fp32 products, as the walk's update
  // multiplies, summed in fp64)
  const int tr = tid >> 4, tc = tid & 15;
  const int nd = tid >> 3, np = tid & 7;
  double* nkg = sc.nk + (bh * nC + c) * hd;
  const float* qb = q + (bh * S + t0) * hd;
  const float* kb = k + (bh * S + t0) * hd;
  double sacc[4][4];                   // the slices' sums, added in fp64
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0;
  // the next slice's rows, two float4 of q and of k a thread, loaded while
  // the current slice is multiplied
  float4 pq[2], pk[2];
  auto load_slice = [&](int d0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kThreads, r = i % kW, c4 = (i / kW) * 4;
      pq[e] = pk[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < Wv) {
        pq[e] = ldg4(qb + static_cast<long long>(r) * hd + d0 + c4);
        pk[e] = ldg4(kb + static_cast<long long>(r) * hd + d0 + c4);
      }
    }
  };
  load_slice(0);
  for (int d0 = 0; d0 < hd; d0 += kDK) {
    __syncthreads();                   // the previous slice is consumed
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kThreads, r = i % kW, c4 = (i / kW) * 4;
      qT[(c4 + 0) * kLdT + r] = pq[e].x;
      qT[(c4 + 1) * kLdT + r] = pq[e].y;
      qT[(c4 + 2) * kLdT + r] = pq[e].z;
      qT[(c4 + 3) * kLdT + r] = pq[e].w;
      kT[(c4 + 0) * kLdT + r] = pk[e].x;
      kT[(c4 + 1) * kLdT + r] = pk[e].y;
      kT[(c4 + 2) * kLdT + r] = pk[e].z;
      kT[(c4 + 3) * kLdT + r] = pk[e].w;
    }
    __syncthreads();
    if (d0 + kDK < hd) load_slice(d0 + kDK);
    {
      double x = 0.0;
#pragma unroll
      for (int j = 0; j < kW / 8; ++j) {
        const int s = 8 * j + np;
        x += static_cast<double>(kT[nd * kLdT + s] * wks[s]);
      }
      x += __shfl_xor_sync(kFull, x, 1);
      x += __shfl_xor_sync(kFull, x, 2);
      x += __shfl_xor_sync(kFull, x, 4);
      if (np == 0) nkg[d0 + nd] = x;
    }
    float sp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * kLdT + 4 * tr]);
      const float4 b = *reinterpret_cast<const float4*>(&kT[d * kLdT + 4 * tc]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sp[i][j] = fmaf(av[i], bv[j], sp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] += sp[i][j];
  }

  // ---- P = scores e^{logD - m_t}, causal, and its row sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * tr + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * tc + j;
      float p = 0.f;
      if (t < Wv && s <= t)
        p = static_cast<float>(
            sacc[i][j] * exp(((Fs[t] - Fs[s]) + lis[s]) - mts[t]));
      Ps[t * kPs + s] = p;
    }
  }
  __syncthreads();
  float* Pg = sc.P + (bh * nC + c) * kW * kW;
  for (int i = tid; i < kW * kW; i += kThreads)
    Pg[i] = Ps[(i / kW) * kPs + i % kW];
  if (tid < kW) {
    double rs = 0.0;
    for (int s = 0; s <= tid; ++s) rs += Ps[tid * kPs + s];
    sc.rs[row0 + tid] = static_cast<float>(rs);
  }
}

// ---------------------------------------------------------------- walk

// --- tensor-core pieces (as in flash_attention.cu) ---------------------

// x = big + small (+ what neither keeps), each part a TF32 value: the
// tensor core reads a TF32 operand's top 19 bits, so adding half a TF32
// ulp (0x1000) to the bits rounds to the nearest TF32 value (ties away
// from zero).  Every operand here is finite.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a * b, one m16n8k8 TF32 product with an fp32 accumulator.  Lane
// (g, t) = (lane / 4, lane % 4) holds a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; c = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

constexpr int kLdV = kW + 4;     // row stride of the split v^T tile
constexpr int kLdX = kBV + 8;    // row stride of the q C partials

// Shared memory of one walk block: C^T tile (hd + 8 floats a row: the
// fragment reads and the update's float2 accesses are free of bank
// conflicts), n, v^T split into big and small words, the four quarters'
// q C partials and q.n partials, and the chunk's per-row gates.
__host__ __device__ constexpr int walk_smem_floats(int hd) {
  return kBV * (hd + 8)      // C^T
         + 2 * kBV * kLdV    // v^T, big and small
         + 4 * kW * kLdX     // q C partials
         + 2 * hd            // n (fp64)
         + 2 * 4 * kW        // q.n partials (fp64)
         + 4 * kW            // w, e^{-m_t}, row sums, wk
         + 4;                // carry
}

// NK 8-wide steps of q C (and q.n) over the head dims from d, for the
// warp's rows (2 m-tiles of 16) and all 32 columns.  The k index of a step
// is relabelled: fragment slot t stands for head dim d + 2t and slot t + 4
// for d + 2t + 1, so that q and C are read as float2.  Each step's three
// products are summed from zero on the tensor cores, pass by pass, and
// added to ``run`` in fp32: the tensor cores' fp32 sums do not round to
// nearest, so a chain of them over more than one step drifts.
template <int NK>
__device__ __forceinline__ void qc_steps(float (&run)[2][4][4],
                                         double (&qn)[2][2],
                                         const float2 (&qa)[NK][2][2],
                                         const float* Cs, const double* ns,
                                         int ldc, int d, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const int dk = d + 8 * ks + 2 * t;
    uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      split(qa[ks][m][0].x, ab[m][0], as[m][0]);
      split(qa[ks][m][1].x, ab[m][1], as[m][1]);
      split(qa[ks][m][0].y, ab[m][2], as[m][2]);
      split(qa[ks][m][1].y, ab[m][3], as[m][3]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 cb = *reinterpret_cast<const float2*>(Cs + (8 * n + g) * ldc + dk);
      split(cb.x, bb[n][0], bs[n][0]);
      split(cb.y, bb[n][1], bs[n][1]);
    }
    const double2 nn = *reinterpret_cast<const double2*>(ns + dk);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        qn[m][hh] = fma(static_cast<double>(qa[ks][m][hh].y), nn.y,
                        fma(static_cast<double>(qa[ks][m][hh].x), nn.x,
                            qn[m][hh]));
    float fr[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) fr[m][n][e] = 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(fr[m][n], as[m], bb[n]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(fr[m][n], ab[m], bs[n]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(fr[m][n], ab[m], bb[n]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[m][n][e] += fr[m][n][e];
  }
}

// q rows of the next NK steps (zeros past the chunk)
template <int NK>
__device__ __forceinline__ void qc_load(float2 (&qa)[NK][2][2],
                                        const float* const (&qrow)[2][2],
                                        const bool (&live)[2][2], int d) {
#pragma unroll
  for (int ks = 0; ks < NK; ++ks)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        qa[ks][m][hh] = live[m][hh] ? ldg2(qrow[m][hh] + d + 8 * ks)
                                    : make_float2(0.f, 0.f);
}

// The warp's share of X = q C and q.n: its 32 rows over one quarter of the
// head dims, NK steps at a time, the next steps' q loaded while these are
// multiplied.
template <int NK>
__device__ __forceinline__ void qc_quarter(float (&run)[2][4][4],
                                           double (&qn)[2][2],
                                           const float* const (&qrow)[2][2],
                                           const bool (&live)[2][2],
                                           const float* Cs, const double* ns,
                                           int ldc, int dbeg, int dend, int g,
                                           int t) {
  float2 qa[NK][2][2];
  qc_load<NK>(qa, qrow, live, dbeg);
  for (int d = dbeg; d < dend; d += 8 * NK) {
    float2 nx[NK][2][2];
    if (d + 8 * NK < dend) qc_load<NK>(nx, qrow, live, d + 8 * NK);
    qc_steps<NK>(run, qn, qa, Cs, ns, ldc, d, g, t);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) qa[ks][m][hh] = nx[ks][m][hh];
  }
}

// One walk block: batch*head bh, columns col0 .. col0 + 31 of C.  Per
// chunk, three phases between barriers:
//   1. stage v^T (split) and the chunk's gates (loaded during the last
//      chunk's phase 3);
//   2. X = q C and q.n (fp64): warp w takes rows 32 (w & 1) .. + 31 and
//      head dims quarter w >> 1, and leaves its partial sums in shared
//      memory;
//   3. dC^T = v^T (k wk) for the warp's 32-dim blocks of C (w, w + 8, ..),
//      then C^T = carry C^T + dC^T in fp32; n = carry n + the prep's
//      increment in fp64;
//      Y = P v (rows 16 (w & 3).., columns 16 (w >> 2)..) and the output
//      h = (Y + w X) / max(|rs + w q.n|, e^{-m_t}), the four quarters
//      summed in order.
__global__ void __launch_bounds__(kThreads, 1)
mlstm_walk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ C0,
                  const float* __restrict__ n0, Scratch sc,
                  float* __restrict__ h, float* __restrict__ C_out,
                  float* __restrict__ n_out, int S, int hd, int nC) {
  extern __shared__ float4 smem4[];
  const int ldc = hd + 8;
  float* Cs = reinterpret_cast<float*>(smem4);          // [kBV][ldc]: C^T
  uint32_t* Vb = reinterpret_cast<uint32_t*>(Cs + kBV * ldc);  // [kBV][kLdV]
  uint32_t* Vl = Vb + kBV * kLdV;
  float* Xp = reinterpret_cast<float*>(Vl + kBV * kLdV);  // [4][kW][kLdX]
  double* ns = reinterpret_cast<double*>(Xp + 4 * kW * kLdX);  // [hd] n
  double* qnp = ns + hd;                                 // [4][kW]
  float* gw = reinterpret_cast<float*>(qnp + 4 * kW);    // [kW] w_t
  float* gm = gw + kW;                                   // [kW] e^{-m_t}
  float* grs = gm + kW;                                  // [kW] row sums
  float* gwk = grs + kW;                                 // [kW] wk_s
  float* car = gwk + kW;                                 // [1]

  const long long bh = blockIdx.x;
  const int col0 = blockIdx.y * kBV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // C0's tile, transposed: lanes over rows d (conflict-free stores), four
  // columns a load
  const float* Cb = C0 + bh * hd * hd + col0;
  for (int i = tid; i < hd * (kBV / 4); i += kThreads) {
    const int d = i % hd, j = (i / hd) * 4;
    const float4 x = ldg4(Cb + static_cast<long long>(d) * hd + j);
    Cs[(j + 0) * ldc + d] = x.x;
    Cs[(j + 1) * ldc + d] = x.y;
    Cs[(j + 2) * ldc + d] = x.z;
    Cs[(j + 3) * ldc + d] = x.w;
  }
  for (int d = tid; d < hd; d += kThreads) ns[d] = n0[bh * hd + d];

  // the next chunk's v tile (rows tid / 32 + 8 e, column tid % 32) and
  // gates, held in registers across a phase
  float vpre[kW * kBV / kThreads];
  float gpre = 0.f;
  auto prefetch = [&](int c) {
    const int t0 = c * kW, Wv = min(kW, S - t0);
    const float* vb = v + (bh * S + t0) * hd + col0;
#pragma unroll
    for (int e = 0; e < kW * kBV / kThreads; ++e) {
      const int s = tid / kBV + e * (kThreads / kBV);
      vpre[e] = s < Wv ? vb[static_cast<long long>(s) * hd + tid % kBV] : 0.f;
    }
    const long long row0 = bh * nC * kW + t0;
    const int a = tid / kW, r = tid % kW;    // gate array a, row r
    gpre = a == 0 ? sc.w[row0 + r] : a == 1 ? sc.mt[row0 + r]
         : a == 2 ? sc.rs[row0 + r] : sc.wk[row0 + r];
  };
  prefetch(0);
  float carry_pre = sc.carry[bh * nC];

  for (int c = 0; c < nC; ++c) {
    const int t0 = c * kW, Wv = min(kW, S - t0);
    const float* qb = q + (bh * S + t0) * hd;
    const float* kb = k + (bh * S + t0) * hd;

    // ---- 1. stage
#pragma unroll
    for (int e = 0; e < kW * kBV / kThreads; ++e) {
      const int s = tid / kBV + e * (kThreads / kBV), j = tid % kBV;
      split(vpre[e], Vb[j * kLdV + s], Vl[j * kLdV + s]);
    }
    {
      const int a = tid / kW, r = tid % kW;
      (a == 0 ? gw : a == 1 ? gm : a == 2 ? grs : gwk)[r] =
          a == 1 ? expf(-gpre) : gpre;
    }
    if (tid == 0) car[0] = carry_pre;
    __syncthreads();
    const float carry = car[0];

    // ---- 2. X = q C and q.n
    {
      const int rbase = (warp & 1) * 32, quarter = warp >> 1;
      const int dlen = hd / 4, dbeg = quarter * dlen;
      const float* qrow[2][2];
      bool live[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = rbase + 16 * m + g + 8 * hh;
          live[m][hh] = r < Wv;
          qrow[m][hh] = qb + static_cast<long long>(live[m][hh] ? r : 0) * hd + 2 * t;
        }
      float run[2][4][4];
      double qn[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        qn[m][0] = qn[m][1] = 0.0;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[m][n][e] = 0.f;
      }
      if (dlen % 16 == 0)
        qc_quarter<2>(run, qn, qrow, live, Cs, ns, ldc, dbeg, dbeg + dlen, g, t);
      else
        qc_quarter<1>(run, qn, qrow, live, Cs, ns, ldc, dbeg, dbeg + dlen, g, t);
      float* xq = Xp + quarter * kW * kLdX;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = rbase + 16 * m + g;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          *reinterpret_cast<float2*>(xq + r * kLdX + 8 * n + 2 * t) =
              make_float2(run[m][n][0], run[m][n][1]);
          *reinterpret_cast<float2*>(xq + (r + 8) * kLdX + 8 * n + 2 * t) =
              make_float2(run[m][n][2], run[m][n][3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          double x = qn[m][hh];
          x += __shfl_xor_sync(kFull, x, 1);
          x += __shfl_xor_sync(kFull, x, 2);
          if (t == 0) qnp[quarter * kW + r + 8 * hh] = x;
        }
      }
    }
    __syncthreads();
    if (c + 1 < nC) {
      prefetch(c + 1);
      carry_pre = sc.carry[bh * nC + c + 1];
    }

    // ---- 3a. C^T = carry C^T + v^T (k wk), n = carry n + sum_s k wk
    // (n's increment from the prep, loaded before the products and added
    // after them)
    double nkr[kMaxHd / kThreads];
    {
      const double* nk = sc.nk + (bh * nC + c) * hd;
#pragma unroll
      for (int e = 0; e < kMaxHd / kThreads; ++e) {
        const int d = tid + e * kThreads;
        nkr[e] = d < hd ? __ldg(nk + d) : 0.0;
      }
    }
    for (int nb = warp; nb < hd / 32; nb += kWarps) {
      const int d0 = nb * 32;
      float acc[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kW / 8; ++ks) {
        const int s0 = 8 * ks + t, s1 = s0 + 4;
        const float w0 = gwk[s0], w1 = gwk[s1];
        uint32_t bb[4][2], bs[4][2], ab[2][4], as[2][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int d = d0 + 8 * n + g;
          const float x0 = s0 < Wv ? kb[static_cast<long long>(s0) * hd + d] * w0 : 0.f;
          const float x1 = s1 < Wv ? kb[static_cast<long long>(s1) * hd + d] * w1 : 0.f;
          split(x0, bb[n][0], bs[n][0]);
          split(x1, bb[n][1], bs[n][1]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int j = 16 * m + g;
          ab[m][0] = Vb[j * kLdV + s0];
          ab[m][1] = Vb[(j + 8) * kLdV + s0];
          ab[m][2] = Vb[j * kLdV + s1];
          ab[m][3] = Vb[(j + 8) * kLdV + s1];
          as[m][0] = Vl[j * kLdV + s0];
          as[m][1] = Vl[(j + 8) * kLdV + s0];
          as[m][2] = Vl[j * kLdV + s1];
          as[m][3] = Vl[(j + 8) * kLdV + s1];
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) mma(acc[m][n], as[m], bb[n]);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) mma(acc[m][n], ab[m], bs[n]);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) mma(acc[m][n], ab[m], bb[n]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = 16 * m + g, d = d0 + 8 * n + 2 * t;
          float2* p0 = reinterpret_cast<float2*>(Cs + j * ldc + d);
          float2* p1 = reinterpret_cast<float2*>(Cs + (j + 8) * ldc + d);
          float2 c0 = *p0, c1 = *p1;
          c0.x = fmaf(carry, c0.x, acc[m][n][0]);
          c0.y = fmaf(carry, c0.y, acc[m][n][1]);
          c1.x = fmaf(carry, c1.x, acc[m][n][2]);
          c1.y = fmaf(carry, c1.y, acc[m][n][3]);
          *p0 = c0;
          *p1 = c1;
        }
    }
#pragma unroll
    for (int e = 0; e < kMaxHd / kThreads; ++e) {
      const int d = tid + e * kThreads;
      if (d < hd) ns[d] = fma(static_cast<double>(carry), ns[d], nkr[e]);
    }

    // ---- 3b. Y = P v and the output rows
    {
      const int mt = warp & 3, nh = warp >> 2;
      const int r = 16 * mt + g;
      const float* Pc = sc.P + (bh * nC + c) * kW * kW;
      float y[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
      for (int ks = 0; ks < 2 * mt + 2; ++ks) {      // P[t][s] = 0 for s > t
        const int s0 = 8 * ks + t, s1 = s0 + 4;
        uint32_t pb[4], ps[4], bb[2][2], bs[2][2];
        split(Pc[r * kW + s0], pb[0], ps[0]);
        split(Pc[(r + 8) * kW + s0], pb[1], ps[1]);
        split(Pc[r * kW + s1], pb[2], ps[2]);
        split(Pc[(r + 8) * kW + s1], pb[3], ps[3]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int j = 16 * nh + 8 * n + g;
          bb[n][0] = Vb[j * kLdV + s0];
          bb[n][1] = Vb[j * kLdV + s1];
          bs[n][0] = Vl[j * kLdV + s0];
          bs[n][1] = Vl[j * kLdV + s1];
        }
        float fr[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) fr[n][0] = fr[n][1] = fr[n][2] = fr[n][3] = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) mma(fr[n], ps, bb[n]);
#pragma unroll
        for (int n = 0; n < 2; ++n) mma(fr[n], pb, bs[n]);
#pragma unroll
        for (int n = 0; n < 2; ++n) mma(fr[n], pb, bb[n]);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[n][e] += fr[n][e];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = r + 8 * hh;
        if (rr >= Wv) continue;
        const double qn =
            ((qnp[rr] + qnp[kW + rr]) + qnp[2 * kW + rr]) + qnp[3 * kW + rr];
        const float wt = gw[rr];
        const float den = static_cast<float>(grs[rr] + wt * qn);
        const float norm = fmaxf(fabsf(den), gm[rr]);
        float* hr = h + (bh * S + t0 + rr) * hd + col0;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * nh + 8 * n + 2 * t;
          float2 x = *reinterpret_cast<const float2*>(Xp + rr * kLdX + col);
#pragma unroll
          for (int qq = 1; qq < 4; ++qq) {
            const float2 xx =
                *reinterpret_cast<const float2*>(Xp + (qq * kW + rr) * kLdX + col);
            x.x += xx.x;
            x.y += xx.y;
          }
          *reinterpret_cast<float2*>(hr + col) =
              make_float2((y[n][2 * hh] + wt * x.x) / norm,
                          (y[n][2 * hh + 1] + wt * x.y) / norm);
        }
      }
    }
    __syncthreads();       // phase 1 of the next chunk rewrites v and gates
  }

  float* Co = C_out + bh * hd * hd + col0;
  for (int i = tid; i < hd * (kBV / 4); i += kThreads) {
    const int d = i % hd, j = (i / hd) * 4;
    *reinterpret_cast<float4*>(Co + static_cast<long long>(d) * hd + j) =
        make_float4(Cs[(j + 0) * ldc + d], Cs[(j + 1) * ldc + d],
                    Cs[(j + 2) * ldc + d], Cs[(j + 3) * ldc + d]);
  }
  if (blockIdx.y == 0)
    for (int d = tid; d < hd; d += kThreads)
      n_out[bh * hd + d] = static_cast<float>(ns[d]);
}

bool shape_ok(int BH, int S, int hd) {
  return hd % kBV == 0 && hd >= kBV && hd <= kMaxHd && S >= 1 && BH >= 1;
}

void launch_prep(const void* q, const void* k, const void* log_i,
                 const void* log_f, const void* m0, const Scratch& sc,
                 void* m, int BH, int S, int hd, cudaStream_t stream) {
  const int nC = (S + kW - 1) / kW;
  mlstm_prep_kernel<<<dim3(nC, BH), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(log_i), static_cast<const float*>(log_f),
      static_cast<const float*>(m0), sc, static_cast<float*>(m), S, hd, nC);
}

}  // namespace

// The scratch buffer that repro_mlstm_prep and repro_mlstm_scan need for
// BH heads of S rows of width hd, in floats: out[0] = the chunk width W;
// out[1 + i] = the offset of array i of nk (doubles: hd per chunk and
// head), P (W x W per chunk and head), w, m_t, the row sums, wk (W per
// chunk and head), carry and m entering the chunk (one per chunk and
// head); out[9] = the buffer's length.  Each array covers all heads,
// (head, chunk, ...) in row-major order.
extern "C" void repro_mlstm_scratch_layout(int BH, int S, int hd,
                                           long long* out) {
  long long off[kArrays + 1];
  scratch_offsets(BH, S, hd, off);
  out[0] = kW;
  for (int i = 0; i <= kArrays; ++i) out[1 + i] = off[i];
}

// Dynamic shared memory of one walk block for head dim ``hd``.
extern "C" int repro_mlstm_walk_smem_bytes(int hd) {
  return static_cast<int>(sizeof(float)) * walk_smem_floats(hd);
}

// The first pass alone: fills ``scratch`` and writes the final m.  Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a shape
// the kernels do not take (hd a multiple of 32 up to 1024, S >= 1).
extern "C" int repro_mlstm_prep(const void* q, const void* k,
                                const void* log_i, const void* log_f,
                                const void* m0, void* scratch, void* m, int BH,
                                int S, int hd, void* stream) {
  if (!shape_ok(BH, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  launch_prep(q, k, log_i, log_f, m0,
              scratch_views(static_cast<float*>(scratch), BH, S, hd), m, BH,
              S, hd, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The scan: the prep pass, then the walk.  Returns cudaGetLastError()
// after the launches, or the error of the first launch or of raising the
// walk's shared-memory limit; cudaErrorInvalidValue as repro_mlstm_prep.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* log_i, const void* log_f,
                                const void* C0, const void* n0, const void* m0,
                                void* scratch, void* h, void* C, void* n,
                                void* m, int BH, int S, int hd, void* stream) {
  if (!shape_ok(BH, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nC = (S + kW - 1) / kW;
  const Scratch sc = scratch_views(static_cast<float*>(scratch), BH, S, hd);
  launch_prep(q, k, log_i, log_f, m0, sc, m, BH, S, hd, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = sizeof(float) * static_cast<size_t>(walk_smem_floats(hd));
  err = cudaFuncSetAttribute(mlstm_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_walk_kernel<<<dim3(BH, hd / kBV), kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(C0),
      static_cast<const float*>(n0), sc, static_cast<float*>(h),
      static_cast<float*>(C), static_cast<float*>(n), S, hd, nC);
  return static_cast<int>(cudaGetLastError());
}
