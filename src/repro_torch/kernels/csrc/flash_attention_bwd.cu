// Flash attention backward for Hopper (sm_90a): dq, dk and dv recomputed
// from the forward's saved logsumexp, fp32 FMA on the CUDA cores.
//
// Replaces: no TPU kernel.  The JAX package's gradient of attention is the
//   jnp custom VJP src/repro/models/chunked.py:86-126 (_flash_bwd); its
//   Pallas flash kernel has no backward.
//
// What bounds it on this card: operations.  Per visible (query, key) pair
//   the backward does five products of hd terms (S = q.k^T again, dP =
//   dO.v^T, dV += P^T.dO, dK += dS^T.q, dQ += dS.k), 10 * hd FLOP, which
//   is 2.5 times the forward's.  At B=1, H=36, S=2048, hd=64, causal that
//   is 48.3 GFLOP, or 0.098 ms at the 495 TFLOP/s TF32 peak; its bytes
//   (q, k, v, out, dO, lse read, dq, dk, dv written: 151 MB) take 0.045
//   ms.
//   This kernel runs its products as fp32 FMA on the CUDA cores (67
//   TFLOP/s at best), and recomputes S and dP in both passes (7 products a
//   pair, not 5): the tensor cores are a later change.
//
// What the design does:
//   * Three kernels behind one C entry (one launch count):
//     - flash_bwd_delta_kernel: D_i = sum_d dO_i * O_i, one warp a row,
//       into a (B, H, Sq) fp32 scratch the wrapper allocates;
//     - flash_bwd_dkdv_kernel: one block per (64-key tile, head, batch).
//       The K and V tiles stay in shared memory; the block walks the query
//       tiles that can see its keys (the causal and window bounds skip the
//       rest), and for each recomputes S = (q * scale) . k^T, P = exp(S -
//       lse), dP = dO . v^T and dS = P * (dP - D), puts P and dS in shared
//       memory, and adds P^T . dO into dV and dS^T . (q * scale) into dK.
//       dK and dV live in registers and are written once;
//     - flash_bwd_dq_kernel: one block per (query tile, head, batch), the
//       same recomputation over the key tiles its rows can see, adding dS .
//       k into dQ, which is scaled and written once.
//     No atomics, so two launches give the same bits.
//   * 256 threads as 16 x 16; a thread owns the (ty + 16 a, tx + 16 c)
//     entries of each tile product, so in every inner step the threads of
//     a warp read 2 broadcast rows of one operand and 16 consecutive
//     entries of the other.  Rows are padded to an odd number of floats,
//     which keeps those reads free of bank conflicts.
//   * Query tiles are 64 rows at hd=64 and 32 at hd=128.  The dK/dV
//     pass's shared memory (K, V, Q, dO tiles, P and dS) is 98 KB at hd=64,
//     two blocks per SM, and 113 KB at hd=128, one block per SM.
//   * Masking follows the JAX VJP: a masked pair has P = 0 (its additive
//     -1e30 mask makes exp(S - lse) zero there), and ragged Sq / Sk are
//     masked in the kernel.  Causal query i sits at position Sk - Sq + i.
//
// Layouts: q/out/dO/dq (B, H, Sq, hd), k/v/dk/dv (B, H, Sk, hd), each with
// arbitrary (b, h, s) strides in elements and a dense head dim; k/v are
// head-repeated.  lse and the scratch D are dense (B, H, Sq) fp32.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBK = 64;         // keys per tile

template <int HD>
struct Tile {
  static constexpr int BQ = HD == 128 ? 32 : 64;   // queries per tile
  static constexpr int LD = HD + 1;                // padded row of a q/k tile
  static constexpr int LDP = kBK + 1;              // padded row of P / dS
  static constexpr int RQ = BQ / 16;               // query rows a thread owns
  static constexpr int RK = kBK / 16;              // key rows a thread owns
  static constexpr int CD = HD / 16;               // head columns a thread owns
  // floats of shared memory: K, V, Q, dO, P, dS, lse, D
  static constexpr int kDkdvFloats =
      2 * kBK * LD + 2 * BQ * LD + 2 * BQ * LDP + 2 * BQ;
  // Q, dO, K, V, dS, lse, D
  static constexpr int kDqFloats =
      2 * BQ * LD + 2 * kBK * LD + BQ * LDP + 2 * BQ;
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

// rows r0 .. r0 + rows of a (b, h) slice into a padded shared tile, times
// ``mul``; rows at or past ``n`` are zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int rows,
                                          int n, float mul) {
  constexpr int LD = Tile<HD>::LD;
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = r0 + r;
    dst[r * LD + d] = s < n ? src[s * ss + d] * mul : 0.f;
  }
}

// c[a][j] = sum_d A[ty + 16 a][d] * B[tx + 16 j][d] over padded tiles
template <int HD, int RA, int RB>
__device__ __forceinline__ void product_abt(float (&c)[RA][RB], const float* A,
                                            const float* B, int ty, int tx) {
  constexpr int LD = Tile<HD>::LD;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int j = 0; j < RB; ++j) c[a][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[RA], bv[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int j = 0; j < RB; ++j) bv[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int j = 0; j < RB; ++j) c[a][j] = fmaf(av[a], bv[j], c[a][j]);
  }
}

// S, P and dS of one (query tile, key tile) pair: P and dS go to shared
// memory at [query row][key] with row length LDP
template <int HD>
__device__ __forceinline__ void probs_and_dscores(
    float* Ps, float* dSs, const float* Qs, const float* dOs, const float* Ks,
    const float* Vs, const float* lse_s, const float* D_s, int q0, int k0,
    const Geometry& geo, int ty, int tx) {
  constexpr int RQ = Tile<HD>::RQ, RK = Tile<HD>::RK, LDP = Tile<HD>::LDP;
  float s[RQ][RK], dp[RQ][RK];
  product_abt<HD, RQ, RK>(s, Qs, Ks, ty, tx);
  product_abt<HD, RQ, RK>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      const int j = tx + 16 * c;
      const float p =
          geo.visible(q0 + i, k0 + j) ? expf(s[a][c] - lse_s[i]) : 0.f;
      if (Ps != nullptr) Ps[i * LDP + j] = p;
      dSs[i * LDP + j] = p * (dp[a][c] - D_s[i]);
    }
  }
}

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
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, int H, Geometry geo, Strides qs,
                      Strides ks, Strides vs, Strides gs, Strides dks,
                      Strides dvs) {
  using T = Tile<HD>;
  constexpr int BQ = T::BQ, LD = T::LD, LDP = T::LDP, RK = T::RK, CD = T::CD;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* D_s = lse_s + BQ;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = (static_cast<long long>(b) * H + h) * geo.Sq;

  load_tile<HD>(Ks, k + b * ks.b + h * ks.h, ks.s, k0, kBK, geo.Sk, 1.f);
  load_tile<HD>(Vs, v + b * vs.b + h * vs.h, vs.s, k0, kBK, geo.Sk, 1.f);

  // the query rows that can see a key of this tile
  int q_begin = 0, q_end = geo.Sq;
  if (geo.causal) {
    const int k_last = min(k0 + kBK, geo.Sk) - 1;
    q_begin = max(0, k0 - geo.q_offset);
    if (geo.window > 0)
      q_end = min(geo.Sq, k_last + geo.window - geo.q_offset);
  }
  q_begin = (q_begin / BQ) * BQ;

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const float* qbase = q + b * qs.b + h * qs.h;
  const float* gbase = dout + b * gs.b + h * gs.h;
  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();   // the previous tile's P and dS are consumed
    load_tile<HD>(Qs, qbase, qs.s, q0, BQ, geo.Sq, geo.scale);
    load_tile<HD>(dOs, gbase, gs.s, q0, BQ, geo.Sq, 1.f);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < geo.Sq;
      lse_s[i] = in ? lse[row0 + q0 + i] : 0.f;
      D_s[i] = in ? D[row0 + q0 + i] : 0.f;
    }
    __syncthreads();
    probs_and_dscores<HD>(Ps, dSs, Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, geo,
                          ty, tx);
    __syncthreads();
    // dV += P^T dO and dK += dS^T (q * scale), over the tile's queries
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float p[RK], ds[RK], g[CD], qv[CD];
#pragma unroll
      for (int a = 0; a < RK; ++a) {
        p[a] = Ps[i * LDP + ty + 16 * a];
        ds[a] = dSs[i * LDP + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        g[c] = dOs[i * LD + tx + 16 * c];
        qv[c] = Qs[i * LD + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < RK; ++a)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[a][c] = fmaf(p[a], g[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(ds[a], qv[c], dk_acc[a][c]);
        }
    }
  }

  float* dkbase = dk + b * dks.b + h * dks.h;
  float* dvbase = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int a = 0; a < RK; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= geo.Sk) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dkbase[kj * dks.s + tx + 16 * c] = dk_acc[a][c];
      dvbase[kj * dvs.s + tx + 16 * c] = dv_acc[a][c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    float* __restrict__ dq, int H, Geometry geo, Strides qs,
                    Strides ks, Strides vs, Strides gs, Strides dqs) {
  using T = Tile<HD>;
  constexpr int BQ = T::BQ, LD = T::LD, LDP = T::LDP, RQ = T::RQ, CD = T::CD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + kBK * LD;
  float* dSs = Vs + kBK * LD;
  float* lse_s = dSs + BQ * LDP;
  float* D_s = lse_s + BQ;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = (static_cast<long long>(b) * H + h) * geo.Sq;

  load_tile<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, geo.Sq, geo.scale);
  load_tile<HD>(dOs, dout + b * gs.b + h * gs.h, gs.s, q0, BQ, geo.Sq, 1.f);
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const bool in = q0 + i < geo.Sq;
    lse_s[i] = in ? lse[row0 + q0 + i] : 0.f;
    D_s[i] = in ? D[row0 + q0 + i] : 0.f;
  }

  // the key range any row of this tile can see (as the forward's)
  int k_begin = 0, k_end = geo.Sk;
  if (geo.causal) {
    const int qpos_lo = geo.q_offset + q0;
    const int qpos_hi = geo.q_offset + min(q0 + BQ, geo.Sq) - 1;
    k_end = min(geo.Sk, qpos_hi + 1);
    if (geo.window > 0) k_begin = max(0, qpos_lo - geo.window + 1);
  }
  k_begin = (k_begin / kBK) * kBK;

  float dq_acc[RQ][CD];
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq_acc[a][c] = 0.f;

  const float* kbase = k + b * ks.b + h * ks.h;
  const float* vbase = v + b * vs.b + h * vs.h;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K and dS are consumed
    load_tile<HD>(Ks, kbase, ks.s, k0, kBK, geo.Sk, 1.f);
    load_tile<HD>(Vs, vbase, vs.s, k0, kBK, geo.Sk, 1.f);
    __syncthreads();
    probs_and_dscores<HD>(nullptr, dSs, Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0,
                          geo, ty, tx);
    __syncthreads();
    // dQ += dS k over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float ds[RQ], kv[CD];
#pragma unroll
      for (int a = 0; a < RQ; ++a) ds[a] = dSs[(ty + 16 * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int c = 0; c < CD; ++c)
          dq_acc[a][c] = fmaf(ds[a], kv[c], dq_acc[a][c]);
    }
  }

  float* dqbase = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= geo.Sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      dqbase[qi * dqs.s + tx + 16 * c] = dq_acc[a][c] * geo.scale;
  }
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v,
                      const float* out, const float* dout, const float* lse,
                      float* D, float* dq, float* dk, float* dv, int B, int H,
                      const Geometry& geo, Strides qs, Strides ks, Strides vs,
                      Strides os, Strides gs, Strides dqs, Strides dks,
                      Strides dvs, cudaStream_t s) {
  using T = Tile<HD>;
  constexpr int kRowsPerBlock = 8;   // one warp a row
  flash_bwd_delta_kernel<<<dim3((H * geo.Sq + kRowsPerBlock - 1) /
                                    kRowsPerBlock, B),
                           32 * kRowsPerBlock, 0, s>>>(out, dout, D, H, geo.Sq,
                                                       HD, os, gs);
  constexpr int dkdv_smem = T::kDkdvFloats * 4;
  constexpr int dq_smem = T::kDqFloats * 4;
  // above 48 KB only after this; a refusal shows in cudaGetLastError()
  cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  flash_bwd_dkdv_kernel<HD>
      <<<dim3((geo.Sk + kBK - 1) / kBK, H, B), kThreads, dkdv_smem, s>>>(
          q, k, v, dout, lse, D, dk, dv, H, geo, qs, ks, vs, gs, dks, dvs);
  flash_bwd_dq_kernel<HD>
      <<<dim3((geo.Sq + T::BQ - 1) / T::BQ, H, B), kThreads, dq_smem, s>>>(
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

// Dynamic shared memory of the dK/dV pass and the dQ pass for head dim
// ``hd`` (0 if none).
extern "C" int repro_flash_attention_bwd_smem_bytes(int hd, int pass) {
  if (hd == 64) return 4 * (pass == 0 ? Tile<64>::kDkdvFloats : Tile<64>::kDqFloats);
  if (hd == 128)
    return 4 * (pass == 0 ? Tile<128>::kDkdvFloats : Tile<128>::kDqFloats);
  return 0;
}
