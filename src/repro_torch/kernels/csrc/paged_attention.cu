// Paged single-query decode attention for Hopper (sm_90a), in two passes.
//
// Replaces: the TPU kernel src/repro/kernels/paged_attention.py,
//   _paged_kernel (called through paged_attention_pallas).
//
// What bounds it on this card: bytes.  Each slot's live K and V rows are
//   read once (length * Hk * hd * 2 * itemsize), with one dequant scale per
//   (page, kv-head) for int8 pools.  At granite-8b's decode shape one call
//   is ~0.1 GFLOP against 52 MB (fp32), ~2 FLOP a byte, far below the
//   card's fp32 ridge: the work is to keep every SM pulling bytes, so no
//   tensor cores.
//
// What the design does about it:
//   * Split pass, grid (kv-head, slot, split), the split slowest so that
//     the long slots' later splits are not queued behind the short slots'
//     empty ones.  The host plans a number of pages per split from the
//     shapes alone (kernels/paged_attention.py, split_pages), so that long
//     contexts spread over many blocks and all 132 SMs pull bytes.  A block
//     covers its split's pages of one slot for one kv-head and all
//     rep = H / Hk query heads of it, so each K/V row is read from memory
//     once.  A block whose split starts at or past the slot's
//     ceil(length / page) pages writes an empty partial (m = -inf, l = 0)
//     and exits; padded block-table entries are never read.
//   * 32-row tiles of K and V are staged into shared memory with cp.async,
//     16 bytes a thread (16 int8 values), in a ring of kStages tiles, rows
//     padded by 16 bytes against bank conflicts.  Rows past the length are
//     zero-filled, not read.  An int8 tile's scales come once per page.
//   * Scores: each warp takes a quarter of the head dim, each lane one row
//     of the tile, for every query head at once; the four partial dots are
//     summed in warp order through shared memory, so no warp reduction per
//     token.  Then one max and one exponent per row and query head, in fp32
//     (online softmax); P.V with the lanes over the head dim and the warps
//     over the tile's rows.  The split's (m, l, acc) go to a scratch buffer
//     the wrapper allocates.
//   * Merge pass, grid (kv-head, slot), a warp per query head, launched as
//     a programmatic dependent of the split pass: it starts while the split
//     grid drains, scores the current token, then waits for the partials.
//     The lanes read 32 splits' (m, l) at once; it folds the current token
//     (k_new, v_new) first, then the slot's live splits in split order
//     (their accumulators loaded 8 at a time), and writes out.  No atomics
//     anywhere: the output is the same to the bit from run to run.
//
// Layouts: q (M, H, hd) f32; pools (P, page, Hk, hd) f32 or int8; scales
// (P, Hk) f32; block tables (M, NP) i32; lengths (M,) i32; k/v_new
// (M, Hk, hd) f32; out (M, H, hd) f32.  All contiguous.  Scratch, with
// n = M * Hk * S * rep for S splits: m[n], l[n], acc[n * hd], each indexed
// ((slot * Hk + kv-head) * S + split) * rep + query head (then head dim).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;    // cache rows per stage: one a lane in the score
constexpr int kStages = 3;   // depth of the cp.async ring

// Shared memory of the split pass for one instantiation, in bytes.
template <typename KV, int HD, int REP>
struct SplitSmem {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(KV));
  static constexpr int kStride = kRowBytes + 16;        // padded row
  static constexpr int kChunks = kRowBytes / 16;        // 16-byte copies a row
  static constexpr int kStage = 2 * kTile * kStride;    // K rows, then V rows
  static constexpr int kRing = kStages * kStage;
  static constexpr int kSum = kWarps * REP * HD * 4;    // per-warp acc at the end
  static constexpr int kRegion = kRing > kSum ? kRing : kSum;
  static constexpr int kScales = kStages * 2 * kTile * 4;
  static constexpr int kQ = REP * HD * 4;
  static constexpr int kPart = kWarps * REP * kTile * 4;
  static constexpr int kP = kTile * REP * 4;
  static constexpr int kAlpha = 16 * ((REP * 4 + 15) / 16);
  static constexpr int kBytes = kRegion + kScales + kQ + kPart + kP + kAlpha;
  static_assert(kThreads % kChunks == 0, "a thread copies whole chunks");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float byte_at(int w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xff));
}

// n values of a row in shared memory (fp32 or int8) as floats.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_row(const int8_t* p, float* o) {
  if constexpr (N == 4) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    const char2 v = *reinterpret_cast<const char2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}

// One block: one split of one slot's pages, one kv-head, its REP query heads.
template <typename KV, int HD, int REP>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
                   const KV* __restrict__ v_pool,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int NP, int page, int Hk,
                   int pps, float scale) {
  using L = SplitSmem<KV, HD, REP>;
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int kSlice = HD / kWarps;   // head dims of a warp in the score
  constexpr int kEpl = HD / 32;         // head dims of a lane in P.V
  constexpr int kRunning = (REP + kWarps - 1) / kWarps;
  const int hk = blockIdx.x, m = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t part = ((size_t)(m * Hk + hk) * S + split) * REP;
  // the merge pass may launch now: it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // the engine keeps length < NP * page; clamp so a bad length cannot walk
  // off the block table
  const int len = min(max(lengths[m], 0), NP * page);
  const int live_pages = (len + page - 1) / page;
  const int p0 = split * pps;
  if (p0 >= live_pages) {
    for (int r = tid; r < REP; r += kThreads) {
      part_m[part + r] = -INFINITY;
      part_l[part + r] = 0.f;
    }
    return;
  }
  const int t_begin = p0 * page;
  const int t_end = min(len, (p0 + pps) * page);
  const int ntiles = (t_end - t_begin + kTile - 1) / kTile;
  const int* bt = block_tables + (size_t)m * NP;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* sc_s = reinterpret_cast<float*>(smem + L::kRegion);  // [stage][k|v][kTile]
  float* q_s = reinterpret_cast<float*>(smem + L::kRegion + L::kScales);
  float* part_s = q_s + REP * HD;                             // [warp][r][row]
  float* p_s = part_s + kWarps * REP * kTile;                 // [row][r]
  float* alpha_s = p_s + kTile * REP;

  const unsigned char* kbytes = reinterpret_cast<const unsigned char*>(k_pool);
  const unsigned char* vbytes = reinterpret_cast<const unsigned char*>(v_pool);
  // copy tile `tile` of this split into its ring stage; always one group
  auto issue = [=](int tile) {
    if (tile < ntiles) {
      unsigned char* kbuf = ring + (tile % kStages) * L::kStage;
      unsigned char* vbuf = kbuf + kTile * L::kStride;
      const int t0 = t_begin + tile * kTile;
      const int ch = tid % L::kChunks;
#pragma unroll
      for (int j = 0; j < kTile * L::kChunks / kThreads; ++j) {
        const int row = tid / L::kChunks + j * (kThreads / L::kChunks);
        const int t = t0 + row;
        const bool live = t < t_end;
        size_t off = 0;
        if (live) {
          const int pg = t / page;
          off = (((size_t)bt[pg] * page + (t - pg * page)) * Hk + hk) *
                    L::kRowBytes + ch * 16;
        }
        const int n = live ? 16 : 0;   // rows past the length: zero-filled
        cp_async16(kbuf + row * L::kStride + ch * 16, kbytes + off, n);
        cp_async16(vbuf + row * L::kStride + ch * 16, vbytes + off, n);
      }
      if (kQuant) {
        // one scale pair per page the tile touches
        const int pg0 = t0 / page;
        const int npg = (min(t0 + kTile, t_end) - 1) / page - pg0 + 1;
        float* sc = sc_s + (tile % kStages) * 2 * kTile;
        if (tid < npg) {
          const size_t at = (size_t)bt[pg0 + tid] * Hk + hk;
          cp_async4(sc + tid, k_scales + at);
          cp_async4(sc + kTile + tid, v_scales + at);
        }
      }
    }
    cp_async_commit();
  };

  float mrun[kRunning], lrun[kRunning];   // the query heads of this warp
#pragma unroll
  for (int i = 0; i < kRunning; ++i) {
    mrun[i] = -INFINITY;
    lrun[i] = 0.f;                        // per lane; summed at the end
  }
  float acc[REP][kEpl];                   // this warp's rows of each tile
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[r][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  // q's load overlaps the first tiles'; the first barrier publishes it
  for (int i = tid; i < REP * HD; i += kThreads)
    q_s[i] = q[((size_t)m * Hk * REP + hk * REP) * HD + i] * scale;

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();
    // this tile has landed for every thread, and every thread is done with
    // the stage the next copy overwrites
    __syncthreads();
    issue(tile + kStages - 1);

    const unsigned char* kbuf = ring + (tile % kStages) * L::kStage;
    const unsigned char* vbuf = kbuf + kTile * L::kStride;
    const float* sck = sc_s + (tile % kStages) * 2 * kTile;
    const int t0 = t_begin + tile * kTile;
    const int rows = min(kTile, t_end - t0);

    // partial scores: lane = row, warp = a quarter of the head dim
    {
      float s[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) s[r] = 0.f;
      const unsigned char* krow = kbuf + lane * L::kStride;
      if constexpr (!kQuant) {
#pragma unroll
        for (int e = 0; e < kSlice; e += 4) {
          const int d = warp * kSlice + e;
          const float4 k4 = *reinterpret_cast<const float4*>(krow + d * 4);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const float4 q4 = *reinterpret_cast<const float4*>(q_s + r * HD + d);
            s[r] = fmaf(q4.x, k4.x, s[r]);
            s[r] = fmaf(q4.y, k4.y, s[r]);
            s[r] = fmaf(q4.z, k4.z, s[r]);
            s[r] = fmaf(q4.w, k4.w, s[r]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kSlice; e += 16) {
          const int d = warp * kSlice + e;
          const int4 raw = *reinterpret_cast<const int4*>(krow + d);
          const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float k0 = byte_at(w[j], 0), k1 = byte_at(w[j], 1);
            const float k2 = byte_at(w[j], 2), k3 = byte_at(w[j], 3);
#pragma unroll
            for (int r = 0; r < REP; ++r) {
              const float4 q4 =
                  *reinterpret_cast<const float4*>(q_s + r * HD + d + 4 * j);
              s[r] = fmaf(q4.x, k0, s[r]);
              s[r] = fmaf(q4.y, k1, s[r]);
              s[r] = fmaf(q4.z, k2, s[r]);
              s[r] = fmaf(q4.w, k3, s[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r)
        part_s[(warp * REP + r) * kTile + lane] = s[r];
    }
    __syncthreads();

    // online softmax: a warp per query head, a lane per row
    {
      const int slot = (t0 + lane) / page - t0 / page;   // the row's page
#pragma unroll
      for (int i = 0; i < kRunning; ++i) {
        const int r = warp + i * kWarps;
        if (r < REP) {
          float x = -INFINITY;
          if (lane < rows) {
            x = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              x += part_s[(w * REP + r) * kTile + lane];
            if (kQuant) x *= sck[slot];
          }
          const float m_new = fmaxf(mrun[i], warp_max(x));
          const float p = expf(x - m_new);            // 0 past the length
          const float alpha = expf(mrun[i] - m_new);  // 0 at the first tile
          lrun[i] = lrun[i] * alpha + p;
          mrun[i] = m_new;
          p_s[lane * REP + r] = (kQuant && lane < rows) ? p * sck[kTile + slot] : p;
          if (lane == 0) alpha_s[r] = alpha;
        }
      }
    }
    __syncthreads();

    // P.V: lanes over the head dim, warps over the tile's rows
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float a = alpha_s[r];
#pragma unroll
      for (int e = 0; e < kEpl; ++e) acc[r][e] *= a;
    }
#pragma unroll
    for (int j = 0; j < kTile / kWarps; ++j) {
      const int row = warp + j * kWarps;
      if (row >= rows) break;               // uniform across the warp
      float v[kEpl];
      load_row<kEpl>(reinterpret_cast<const KV*>(vbuf + row * L::kStride) +
                         lane * kEpl, v);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = p_s[row * REP + r];
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[r][e] = fmaf(p, v[e], acc[r][e]);
      }
    }
  }

  // the split's m and l
#pragma unroll
  for (int i = 0; i < kRunning; ++i) {
    const int r = warp + i * kWarps;
    if (r < REP) {
      const float l = warp_sum(lrun[i]);
      if (lane == 0) {
        part_m[part + r] = mrun[i];
        part_l[part + r] = l;
      }
    }
  }
  // the warps' accumulators, summed in warp order through the free ring
  cp_async_wait<0>();
  __syncthreads();
  float* sum = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < kEpl; ++e)
      sum[(warp * REP + r) * HD + lane * kEpl + e] = acc[r][e];
  __syncthreads();
  float* out = part_acc + part * HD;
  for (int i = tid; i < REP * HD; i += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += sum[w * REP * HD + i];
    out[i] = x;
  }
}

// One block: one slot, one kv-head; warp r merges query head hk * REP + r.
template <int HD, int REP>
__global__ void __launch_bounds__(REP * 32)
paged_merge_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                   const float* __restrict__ v_new,
                   const int* __restrict__ lengths,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, float* __restrict__ out,
                   int NP, int page, int Hk, int pps, int S, float scale) {
  constexpr int kEpl = HD / 32;
  constexpr int kBatch = 8;   // partial accumulators loaded at once
  const int hk = blockIdx.x, m = blockIdx.y;
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lengths[m], 0), NP * page);
  // the live splits are a prefix: those that start below ceil(len / page)
  const int live = ((len + page - 1) / page + pps - 1) / pps;
  const size_t head = (size_t)m * Hk * REP + hk * REP + r;
  const size_t base = (size_t)(m * Hk + hk) * S * REP + r;

  float qv[kEpl], kn[kEpl], vn[kEpl];
  load_row<kEpl>(q + head * HD + lane * kEpl, qv);
  load_row<kEpl>(k_new + ((size_t)m * Hk + hk) * HD + lane * kEpl, kn);
  load_row<kEpl>(v_new + ((size_t)m * Hk + hk) * HD + lane * kEpl, vn);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kEpl; ++e) s = fmaf(qv[e] * scale, kn[e], s);
  s = warp_sum(s);
  // the split pass's partials are complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // the largest exponent: each lane reads one split's m
  float mx = s;
  for (int c = 0; c < live; c += 32) {
    const int i = c + lane;
    mx = fmaxf(mx, warp_max(i < live ? part_m[base + (size_t)i * REP]
                                     : -INFINITY));
  }
  // the current token first, then the splits in order; a lane holds one
  // split's weight and l, handed round by shuffles
  const float w0 = expf(s - mx);
  float l = w0, acc[kEpl];
#pragma unroll
  for (int e = 0; e < kEpl; ++e) acc[e] = w0 * vn[e];
  for (int c = 0; c < live; c += 32) {
    const int n = min(32, live - c);
    const size_t at = base + (size_t)(c + lane) * REP;
    const float wi = lane < n ? expf(part_m[at] - mx) : 0.f;
    const float li = lane < n ? part_l[at] : 0.f;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float a[kBatch][kEpl];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j0 + u < n)
          load_row<kEpl>(part_acc + (base + (size_t)(c + j0 + u) * REP) * HD +
                             lane * kEpl, a[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float w = __shfl_sync(0xffffffffu, wi, (j0 + u) & 31);
        const float lw = __shfl_sync(0xffffffffu, li, (j0 + u) & 31);
        if (j0 + u < n) {
          l = fmaf(lw, w, l);
#pragma unroll
          for (int e = 0; e < kEpl; ++e) acc[e] = fmaf(w, a[u][e], acc[e]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kEpl; ++e) out[head * HD + lane * kEpl + e] = acc[e] / l;
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *bt, *len, *kn, *vn;
  void* out;
  float* scratch;
  int M, Hk, NP, page, pps;
  float scale;
  cudaStream_t stream;
};

template <typename KV, int HD, int REP>
cudaError_t split_config(int* smem, int* blocks_per_sm) {
  constexpr int bytes = SplitSmem<KV, HD, REP>::kBytes;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<KV, HD, REP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  if (smem) *smem = bytes;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, paged_split_kernel<KV, HD, REP>, kThreads, bytes);
  return cudaSuccess;
}

template <typename KV, int HD, int REP>
cudaError_t launch(const Args& a) {
  const cudaError_t e = split_config<KV, HD, REP>(nullptr, nullptr);
  if (e != cudaSuccess) return e;
  const int S = (a.NP + a.pps - 1) / a.pps;
  const size_t n = (size_t)a.M * a.Hk * S * REP;
  float* pm = a.scratch;
  float* pl = pm + n;
  float* pacc = pl + n;
  paged_split_kernel<KV, HD, REP>
      <<<dim3(a.Hk, a.M, S), kThreads, SplitSmem<KV, HD, REP>::kBytes,
         a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const KV*>(a.kp),
          static_cast<const KV*>(a.vp), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.bt),
          static_cast<const int*>(a.len), pm, pl, pacc, a.NP, a.page, a.Hk,
          a.pps, a.scale);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  // programmatic dependent launch: the merge grid starts while the split
  // grid drains and computes the current token's score before it waits
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hk, a.M);
  cfg.blockDim = dim3(REP * 32);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(
      &cfg, paged_merge_kernel<HD, REP>, static_cast<const float*>(a.q),
      static_cast<const float*>(a.kn), static_cast<const float*>(a.vn),
      static_cast<const int*>(a.len), static_cast<const float*>(pm),
      static_cast<const float*>(pl), static_cast<const float*>(pacc),
      static_cast<float*>(a.out), a.NP, a.page, a.Hk, a.pps, S, a.scale);
  return cudaGetLastError();
}

// Calls F<KV, HD, REP>::run(args...) for the runtime (int8, hd, rep);
// cudaErrorInvalidValue where there is no instantiation.
template <template <typename, int, int> class F, typename... A>
cudaError_t dispatch(int kv_int8, int hd, int rep, A... args) {
  auto by_rep = [&](auto kv, auto hdc) -> cudaError_t {
    using KV = decltype(kv);
    constexpr int HD = decltype(hdc)::value;
    switch (rep) {
      case 1: return F<KV, HD, 1>::run(args...);
      case 2: return F<KV, HD, 2>::run(args...);
      case 4: return F<KV, HD, 4>::run(args...);
      case 8: return F<KV, HD, 8>::run(args...);
      case 16: return F<KV, HD, 16>::run(args...);
      default: return cudaErrorInvalidValue;
    }
  };
  auto by_hd = [&](auto kv) -> cudaError_t {
    switch (hd) {
      case 64: return by_rep(kv, std::integral_constant<int, 64>());
      case 128: return by_rep(kv, std::integral_constant<int, 128>());
      default: return cudaErrorInvalidValue;
    }
  };
  return kv_int8 ? by_hd(int8_t()) : by_hd(float());
}

template <typename KV, int HD, int REP>
struct Launch {
  static cudaError_t run(const Args& a) { return launch<KV, HD, REP>(a); }
};

template <typename KV, int HD, int REP>
struct Config {
  static cudaError_t run(int* smem, int* blocks) {
    return split_config<KV, HD, REP>(smem, blocks);
  }
};

}  // namespace

// Both passes on `stream`.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a head dim or rep with no instantiation).
// `scratch` holds M * Hk * S * rep * (hd + 2) floats, S = ceil(NP / pps).
extern "C" int repro_paged_decode_attention(
    int kv_int8, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* lengths, const void* k_new, const void* v_new, void* out,
    void* scratch, int M, int Hk, int rep, int hd, int NP, int page, int pps,
    float scale, void* stream) {
  const Args a{q, k_pool, v_pool, k_scales, v_scales, block_tables, lengths,
               k_new, v_new, out, static_cast<float*>(scratch), M, Hk, NP,
               page, pps, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<Launch>(kv_int8, hd, rep, a));
}

// The split pass's dynamic shared memory and resident blocks per SM.
extern "C" int repro_paged_split_config(int kv_int8, int hd, int rep,
                                        int* smem_bytes, int* blocks_per_sm) {
  return static_cast<int>(
      dispatch<Config>(kv_int8, hd, rep, smem_bytes, blocks_per_sm));
}
