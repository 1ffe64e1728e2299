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
// needs 4 W^2 hd + 4 W hd^2 FLOP (q k^T, P v, q C, k^T v): at W = 256 and
// hd = 1024 that is 1.3 GFLOP against about 5 MB moved.
//
// What the design does about it (a first version: simple and right):
//   * C is hd x hd, 4 MiB per (batch, head) at hd = 1024: no shared memory
//     holds it.  Given a chunk's scores and denominators the value
//     columns of h and of C are independent, so the grid is
//     (B*H, hd/32): each block owns an hd x 32 column tile of C (128 KB of
//     dynamic shared memory at hd = 1024) and walks the whole sequence.
//   * Every block of a head recomputes the chunk's gates, its 64 x 64
//     scores q k^T and q.n, bit for bit the same.  The score product is
//     thus done hd/32 times: at hd = 1024 about half the kernel's FLOP is
//     that repetition.  Sharing it is a later redesign.
//   * Per chunk, q and k stream through shared memory in 32-wide head
//     slices; each slice feeds the scores, q C[:, tile] (before that slice
//     of C is updated), q.n, then the update of the same slice of C and n.
//     fp32 on the CUDA cores, expf and IEEE division (no fast math).
//   * Sums over the head dim are taken per 32-wide slice and then across
//     slices, which keeps them as close to the exact sum as a blocked
//     product: one running fp32 sum over 1024 terms loses more.
//   * Any S >= 1 (a ragged last chunk is masked) and any start state,
//     including m = -1e30 (no state) and a serving cache's m = 0.
//
// Layouts (fp32, contiguous): q, k, v, h (BH, S, hd); log_i, log_f
// (BH, S); C0, C (BH, hd, hd); n0, n (BH, hd); m0, m (BH).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWc = 64;          // rows per chunk
constexpr int kBV = 32;          // value columns of C and h per block
constexpr int kDK = 32;          // head-dim slice streamed per step
constexpr int kPad = kDK + 1;    // row stride of the q/k slices
constexpr int kPs = kWc + 1;     // row stride of the score tile
constexpr int kMaxHd = 1024;
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr int smem_floats(int hd) {
  return hd * kBV            // C tile
         + hd                // n
         + 3 * kWc * kPad    // q, k and k * wk slices
         + kWc * kBV         // v tile
         + kWc * kPs         // scores, then P
         + 6 * kWc           // F, log i, m_t, w_int, wk, norm
         + 2;                // m_prev, m_next and carry
}

__global__ void __launch_bounds__(kThreads, 1)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ log_i,
                  const float* __restrict__ log_f,
                  const float* __restrict__ C0, const float* __restrict__ n0,
                  const float* __restrict__ m0, float* __restrict__ h,
                  float* __restrict__ C_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, int S, int hd) {
  extern __shared__ float smem[];
  float* Cs = smem;                    // [hd][kBV]
  float* ns = Cs + hd * kBV;           // [hd]
  float* qs = ns + hd;                 // [kWc][kPad]
  float* ks = qs + kWc * kPad;         // [kWc][kPad]
  float* kws = ks + kWc * kPad;        // [kWc][kPad]: k * wk
  float* vs = kws + kWc * kPad;        // [kWc][kBV]
  float* Ps = vs + kWc * kBV;          // [kWc][kPs]
  float* Fs = Ps + kWc * kPs;          // [kWc]
  float* lis = Fs + kWc;               // [kWc]
  float* mts = lis + kWc;              // [kWc]
  float* wis = mts + kWc;              // [kWc]
  float* wks = wis + kWc;              // [kWc]
  float* nrm = wks + kWc;              // [kWc]
  float* scal = nrm + kWc;             // [2]: m_prev / m_next, carry

  const long long bh = blockIdx.x;
  const int col0 = blockIdx.y * kBV;
  const int tid = threadIdx.x;
  // register tiles: rows r0..r0+3; score columns tj + 16 j (j < 4), value
  // columns tj and tj + 16
  const int r0 = (tid >> 4) * 4;
  const int tj = tid & 15;

  const float* qb = q + bh * S * hd;
  const float* kb = k + bh * S * hd;
  const float* vb = v + bh * S * hd;
  float* hb = h + bh * S * hd;
  const float* lib = log_i + bh * S;
  const float* lfb = log_f + bh * S;

  for (int i = tid; i < hd * kBV; i += kThreads) {
    const int d = i / kBV, j = i % kBV;
    Cs[i] = C0[bh * hd * hd + (long long)d * hd + col0 + j];
  }
  for (int d = tid; d < hd; d += kThreads) ns[d] = n0[bh * hd + d];
  float mp = m0[bh];

  for (int t0 = 0; t0 < S; t0 += kWc) {
    const int Wv = min(kWc, S - t0);

    // ---- gates of the chunk (every block computes the same values)
    if (tid < kWc) {
      lis[tid] = tid < Wv ? lib[t0 + tid] : 0.f;
      Fs[tid] = tid < Wv ? lfb[t0 + tid] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < Wv; ++t) {
        acc += Fs[t];
        Fs[t] = acc;
      }
    }
    __syncthreads();
    const float Ft = Fs[Wv - 1];
    if (tid < Wv) {
      const float Fi = Fs[tid];
      float mi = kNeg;
      for (int s = 0; s <= tid; ++s) mi = fmaxf(mi, (Fi - Fs[s]) + lis[s]);
      const float binter = Fi + mp;
      const float mt = fmaxf(mi, binter);
      mts[tid] = mt;
      wis[tid] = expf(binter - mt);
      wks[tid] = (Ft - Fi) + lis[tid];     // F_T - F_s + i_s, weighted below
    }
    __syncthreads();
    if (tid == 0) {
      float mx = mp + Ft;
      for (int s = 0; s < Wv; ++s) mx = fmaxf(mx, wks[s]);
      scal[0] = mx;
      scal[1] = expf(mp + Ft - mx);
    }
    __syncthreads();
    const float m_next = scal[0];
    const float carry = scal[1];
    if (tid < kWc) wks[tid] = tid < Wv ? expf(wks[tid] - m_next) : 0.f;
    for (int i = tid; i < kWc * kBV; i += kThreads) {
      const int s = i / kBV, j = i % kBV;
      vs[i] = s < Wv ? vb[(long long)(t0 + s) * hd + col0 + j] : 0.f;
    }
    __syncthreads();

    // ---- stream the head dim: scores, q C (old C), q.n, then C/n update
    float sacc[4][4], iacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
      iacc[i][0] = iacc[i][1] = 0.f;
    }
    float qn = 0.f;
    for (int d0 = 0; d0 < hd; d0 += kDK) {
      for (int i = tid; i < kWc * kDK; i += kThreads) {
        const int s = i / kDK, d = i % kDK;
        float qv = 0.f, kv = 0.f;
        if (s < Wv) {
          const long long off = (long long)(t0 + s) * hd + d0 + d;
          qv = qb[off];
          kv = kb[off];
        }
        qs[s * kPad + d] = qv;
        ks[s * kPad + d] = kv;
        kws[s * kPad + d] = kv * wks[s];
      }
      __syncthreads();
      float sp[4][4], ip[4][2];          // this slice's share of the sums
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sp[i][j] = 0.f;
        ip[i][0] = ip[i][1] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < kDK; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(r0 + i) * kPad + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[(tj + 16 * j) * kPad + d];
        const float c0 = Cs[(d0 + d) * kBV + tj];
        const float c1 = Cs[(d0 + d) * kBV + tj + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sp[i][j] = fmaf(a[i], b[j], sp[i][j]);
          ip[i][0] = fmaf(a[i], c0, ip[i][0]);
          ip[i][1] = fmaf(a[i], c1, ip[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] += sp[i][j];
        iacc[i][0] += ip[i][0];
        iacc[i][1] += ip[i][1];
      }
      if (tid < kWc) {
        float qp = 0.f;
        for (int d = 0; d < kDK; ++d) qp = fmaf(qs[tid * kPad + d], ns[d0 + d], qp);
        qn += qp;
      }
      __syncthreads();
      // C[d0 + d][j] = carry * C + sum_s (k_s wk_s)[d] v_s[j]; 4 per thread
      {
        const int j = tid & 31;
        const int d = tid >> 5;            // rows d, d + 8, d + 16, d + 24
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int s = 0; s < kWc; ++s) {
          const float vv = vs[s * kBV + j];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r] = fmaf(kws[s * kPad + d + 8 * r], vv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float* cp = &Cs[(d0 + d + 8 * r) * kBV + j];
          *cp = carry * *cp + acc[r];
        }
      }
      if (tid < kDK) {
        float acc = 0.f;
        for (int s = 0; s < kWc; ++s) acc += kws[s * kPad + tid];
        ns[d0 + tid] = carry * ns[d0 + tid] + acc;
      }
      __syncthreads();
    }

    // ---- P = scores * e^{logD - m_t}, causal; denominators; outputs
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tj + 16 * j;
        float p = 0.f;
        if (t < Wv && s <= t)
          p = sacc[i][j] * expf((Fs[t] - Fs[s]) + lis[s] - mts[t]);
        Ps[t * kPs + s] = p;
      }
    }
    __syncthreads();
    if (tid < Wv) {
      float den = 0.f;
      for (int s = 0; s <= tid; ++s) den += Ps[tid * kPs + s];
      den = den + wis[tid] * qn;
      nrm[tid] = fmaxf(fabsf(den), expf(-mts[tid]));
    }
    __syncthreads();
    {
      float o[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = 0.f;
#pragma unroll 8
      for (int s = 0; s < kWc; ++s) {
        const float v0 = vs[s * kBV + tj];
        const float v1 = vs[s * kBV + tj + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(r0 + i) * kPs + s];
          o[i][0] = fmaf(p, v0, o[i][0]);
          o[i][1] = fmaf(p, v1, o[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + i;
        if (t < Wv) {
          float* hr = hb + (long long)(t0 + t) * hd + col0;
          hr[tj] = (o[i][0] + wis[t] * iacc[i][0]) / nrm[t];
          hr[tj + 16] = (o[i][1] + wis[t] * iacc[i][1]) / nrm[t];
        }
      }
    }
    mp = m_next;
    __syncthreads();       // the next chunk rewrites the gate arrays
  }

  for (int i = tid; i < hd * kBV; i += kThreads) {
    const int d = i / kBV, j = i % kBV;
    C_out[bh * hd * hd + (long long)d * hd + col0 + j] = Cs[i];
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < hd; d += kThreads) n_out[bh * hd + d] = ns[d];
    if (tid == 0) m_out[bh] = mp;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch, or the error of raising the
// kernel's shared-memory limit; cudaErrorInvalidValue for a head dim the
// kernel does not take (a multiple of 32 up to 1024) or an empty input.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* log_i, const void* log_f,
                                const void* C0, const void* n0, const void* m0,
                                void* h, void* C, void* n, void* m, int BH,
                                int S, int hd, void* stream) {
  if (hd % kBV != 0 || hd < kBV || hd > kMaxHd || S < 1 || BH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * static_cast<size_t>(smem_floats(hd));
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, hd / kBV);
  mlstm_scan_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(log_i),
      static_cast<const float*>(log_f), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<float*>(h), static_cast<float*>(C), static_cast<float*>(n),
      static_cast<float*>(m), S, hd);
  return static_cast<int>(cudaGetLastError());
}
