// MoE router gating for Hopper (sm_90a): the router product and the gating
// in one launch, and the gating alone on given logits.
//
// Replaces: the TPU kernel src/repro/kernels/moe_gating.py:22, _gating_kernel
//   (called through moe_gating_tokens), together with the product that
//   src/repro/models/moe.py:90 leaves to XLA, logits = x @ router.
//
// Two entries share the gating's device code (gate_row):
//   * repro_router_gating: x (T, D) f32 and router (D, E) f32 in, the
//     logits never leave the chip.  The main path (models/moe.py run_moe).
//   * repro_moe_gating: logits (T, E) f32 in, one warp per row.
//
// The gating, per token row of logits: probs = softmax as exp(x - max) /
//   sum; then K rounds that take the largest remaining probability (ties to
//   the lowest expert index) and mask it with -1e30; weights = selected /
//   max(sum of selected, 1e-9), summed in selection order.  Outputs weights
//   (T, K) f32, ids (T, K) i32, probs (T, E) f32.
//
// What bounds it on this card: bytes, and at decode the launch.  The fused
//   function reads x (T * D * 4 bytes) and the router (D * E * 4: 491,520 at
//   qwen2-moe-a2.7b's D = 2048, E = 60) once and writes T * (E * 4 + K * 8);
//   its product is 2 * T * D * E FLOP, under one FLOP a byte at T = 8 and
//   about 50 at T = 2048, below the fp32 ridge either way.  At T = 8 (one
//   decode step) the bytes take ~0.17 us at 3.35 TB/s, so the fixed cost
//   of a launch, and of pulling 0.5 MB into few SMs, is what remains.
//
// What the design does about it: one launch where there were two (a cuBLAS
//   product, then the gating), no logits in device memory, and a thread-
//   block cluster so that more SMs pull the router's bytes.
//   * Layout.  One cluster of C blocks per tile of ROWS token rows.  At
//     decode (8 rows) C = 16, past the portable limit, so that 16 SMs pull
//     the router's bytes; for long prompts (32 rows a tile) C = 2: 128
//     blocks at 2048 tokens, and every tile re-reads the router from L2, so
//     fewer, taller tiles.  Block r of a cluster takes D rows [r * chunk,
//     (r + 1) * chunk) of the router (chunk a multiple of 4, planned by the
//     host) in pieces of 128 rows through two shared-memory stages: a
//     piece's router rows are contiguous, all put in flight at once by
//     16-byte cp.async, and its x columns are loaded to registers while the
//     previous piece is multiplied, then widened to double.
//   * Product, in fp64 on the tensor cores (Hopper's mma.m16n8k16.f64),
//     transposed: 16 experts by 8 token rows by 16 router rows an
//     instruction.  Two fp32 products of D = 2048 terms summed in different
//     orders differ by an ulp or two of a logit, and that moves a gating
//     weight by up to twice as much: past the 1e-6 the gating is held to.
//     A product of two floats is exact in a double and the sum keeps 53
//     bits, so the logits are correctly rounded to fp32 (but for a
//     vanishing share on a rounding edge) whatever the order of the sum,
//     and the plain version, which sums in fp64 too, gives the same
//     logits.  Warp w takes 16 experts (w % 4) and half (w / 4) of the
//     token tiles, or at 8 token rows every other k-step; alternate
//     k-steps go to two accumulators (two dependency chains), all added in
//     a fixed order into the block's partial logits.
//   * Reduce.  cluster.sync(); rank r then gates rows r, r + C, ... of the
//     tile, a warp a row: lane l reads experts l and l + 32 of every rank's
//     partials through distributed shared memory and sums them in rank
//     order, then rounds to fp32.  No atomics: two launches agree to the
//     bit.  A second cluster.sync() keeps every block's partials alive
//     until all are read.
//   * Gate: today's warp-per-row softmax and K argmax rounds, unchanged.
//
// Layouts: all arrays contiguous, row-major; x and router 16-byte aligned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kMaxE = 64;
constexpr int kMaxK = 8;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kRouterThreads = 256;
constexpr int kRouterWarps = kRouterThreads / 32;  // sub-sums of a column
constexpr int kMaxCluster = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

// One token row's gating, by a whole warp.  Lane l holds the logits of
// experts l (x0) and l + 32 (x1), -inf past E.
//   * Max and sum through __shfl_xor_sync butterflies.  expf (not __expf)
//     and IEEE division keep the probabilities within an ulp or two of the
//     plain version; only the order of the sum differs.
//   * The top-k is K warp-wide argmax reductions over (prob, index) pairs,
//     the lower index winning ties, so every lane agrees on each pick; the
//     lane that owns the pick masks it.  Lane r keeps round r's pick and
//     writes it, so no per-thread array is indexed at run time.
__device__ __forceinline__ void gate_row(float x0, float x1, int lane, int E,
                                         int K, float* __restrict__ prow,
                                         float* __restrict__ wrow,
                                         int* __restrict__ idrow) {
  const int c0 = lane, c1 = lane + 32;
  const bool has0 = c0 < E, has1 = c1 < E;
  const float m = warp_max(fmaxf(x0, x1));
  float p0 = has0 ? expf(x0 - m) : 0.f;
  float p1 = has1 ? expf(x1 - m) : 0.f;
  const float denom = warp_sum(p0 + p1);
  p0 = p0 / denom;
  p1 = p1 / denom;
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
    wrow[lane] = my_w / fmaxf(total, 1e-9f);
    idrow[lane] = my_id;
  }
}

// Logits in: one warp per token row, 8 rows a block; rows past T exit whole.
__global__ void __launch_bounds__(kWarps * 32)
moe_gating_kernel(const float* __restrict__ logits, float* __restrict__ w,
                  int* __restrict__ ids, float* __restrict__ probs, int T,
                  int E, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp leaves together
  const float* x = logits + static_cast<size_t>(row) * E;
  const float x0 = lane < E ? x[lane] : -INFINITY;
  const float x1 = lane + 32 < E ? x[lane + 32] : -INFINITY;
  gate_row(x0, x1, lane, E, K, probs + static_cast<size_t>(row) * E,
           w + static_cast<size_t>(row) * K, ids + static_cast<size_t>(row) * K);
}

// Shared memory of the router kernel, in doubles: the block's partial
// logits [ROWS][kMaxE], then two stages, each a piece of kSub of the
// block's router rows: x [ROWS][kXStride] (doubles; 4 past the piece, so
// that a warp's fragments fall on distinct banks) and the router
// [kSub][E] (floats, room for E = 64).  After the product the stages hold
// the two k-halves' sums where the warps split k.
constexpr int kSub = 128;
constexpr int kXStride = kSub + 4;

__host__ __device__ constexpr size_t router_stage_doubles(int rows) {
  return static_cast<size_t>(rows) * kXStride + static_cast<size_t>(kSub) * kMaxE / 2;
}

__host__ __device__ constexpr size_t router_smem_doubles(int rows) {
  return static_cast<size_t>(rows) * kMaxE + 2 * router_stage_doubles(rows);
}

// c (16x8) += a (16x16) * b (16x8) in fp64 on the tensor cores (Hopper's
// mma.m16n8k16.f64).  With g = lane / 4 and t = lane % 4: a[i + 2 j] =
// a[g + 8 i][t + 4 j], b[j] = b[t + 4 j][g], c[i + 2 j] = c[g + 8 j][2 t +
// i].
__device__ __forceinline__ void dmma_16x8x16(double (&c)[4], const double (&a)[8],
                                             const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Router product + gating.  Grid (C, tiles), cluster (C, 1, 1): blockIdx.x
// is the block's rank in its cluster, blockIdx.y its tile of ROWS tokens.
template <int ROWS>
__global__ void __launch_bounds__(kRouterThreads)
router_gating_kernel(const float* __restrict__ x,
                     const float* __restrict__ router, float* __restrict__ w,
                     int* __restrict__ ids, float* __restrict__ probs, int T,
                     int D, int E, int K, int chunk) {
  static_assert(ROWS % 8 == 0, "whole 8-row tiles of the product");
  constexpr int kTiles = ROWS / 8;                       // 8-token tiles
  constexpr int kQuads = kSub / 4;                       // float4s a piece's row
  constexpr int kXPer = (ROWS * kQuads + kRouterThreads - 1) / kRouterThreads;
  constexpr int kStage = static_cast<int>(router_stage_doubles(ROWS));
  static_assert(kXPer * kRouterThreads == ROWS * kQuads, "whole x copies");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * ROWS;
  const int d_begin = min(D, rank * chunk);
  const int d_end = min(D, d_begin + chunk);      // (d_end - d_begin) % 4 == 0
  const int pieces = (d_end - d_begin + kSub - 1) / kSub;

  extern __shared__ __align__(16) double smem[];
  double* part = smem;                            // [ROWS][kMaxE]
  double* stages = smem + ROWS * kMaxE;
  auto xbuf = [&](int s) { return stages + s * kStage; };
  auto rbuf = [&](int s) {
    return reinterpret_cast<float*>(stages + s * kStage + ROWS * kXStride);
  };

  // a piece's router rows are m * E contiguous floats: all of them in
  // flight at once, 16 bytes a copy
  auto issue_router = [&](int piece, int s) {
    const int a = d_begin + piece * kSub, m = min(kSub, d_end - a);
    const float* src = router + static_cast<size_t>(a) * E;
    float* dst = rbuf(s);
    for (int i = tid; i < m * E / 4; i += kRouterThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    cp_async_commit();
  };
  // a piece of the tile's x into registers (a warp reads one token row's
  // 512 contiguous bytes; rows past T and columns past the piece are
  // zeros), then widened to double into its stage
  float4 xr[kXPer];
  auto load_x = [&](int piece) {
    const int a = d_begin + piece * kSub;
    const int quads = min(kSub, d_end - a) >> 2;
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kRouterThreads, q = i % kQuads, t = i / kQuads;
      xr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < quads && row0 + t < T)
        xr[j] = *reinterpret_cast<const float4*>(
            x + static_cast<size_t>(row0 + t) * D + a + 4 * q);
    }
  };
  auto store_x = [&](int s) {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kRouterThreads, q = i % kQuads, t = i / kQuads;
      double* dst = xbuf(s) + t * kXStride + 4 * q;
      dst[0] = xr[j].x;
      dst[1] = xr[j].y;
      dst[2] = xr[j].z;
      dst[3] = xr[j].w;
    }
  };

  // The product, transposed (logits^T = router^T x^T), as 16x8x16 fp64
  // tensor-core products: 16 experts by 8 token rows by 16 router rows.  A
  // product of two floats is exact in a double and the sums carry 53 bits,
  // so the logits come out correctly rounded to fp32 (but for a vanishing
  // share on a rounding edge) whatever the order of the sum.  Warp w takes
  // the 16 experts from 16 (w % 4), and of the token tiles and k-steps its
  // half w / 4: the upper or lower token tiles, or at 8 token rows (one
  // tile) every other k-step, whose two sums are added in order at the
  // end.  Alternate k-steps of a warp go to two accumulators (two
  // dependency chains), added in order.  Two stages: the next piece's
  // copies fly while this one is multiplied
  constexpr int kETiles = kMaxE / 16;
  constexpr int kHalves = kRouterWarps / kETiles;
  constexpr int kKSplit = kTiles == 1 ? kHalves : 1;
  constexpr int kMine = kTiles * kKSplit / kHalves;      // token tiles a warp takes
  static_assert(kHalves == 2 && kMine >= 1, "8 warps over 4 expert tiles");
  const int gid = lane >> 2, tig = lane & 3;
  const int et = warp % kETiles, half = warp / kETiles;
  const int nt0 = kKSplit == 1 ? half * kMine : 0;
  const bool live = 16 * et < E;                   // warp-uniform
  double acc[2][kMine][4];   // two chains: alternate k-steps
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < kMine; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][j][i] = 0.0;
  // one k-step (16 router rows from k) into the chain c; router rows past
  // the piece (m rows) are stale in the stage, so they are masked, and x
  // columns past it are zeros
  auto step = [&](const float* rb, const double* xb, int m, int k,
                  double (&c)[kMine][4]) {
    double a[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 16 * et + gid + 8 * i, kk = k + tig + 4 * j;
        a[i + 2 * j] = e < E && kk < m ? static_cast<double>(rb[kk * E + e]) : 0.0;
      }
#pragma unroll
    for (int n = 0; n < kMine; ++n) {
      double b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = xb[((nt0 + n) * 8 + gid) * kXStride + k + tig + 4 * j];
      dmma_16x8x16(c[n], a, b);
    }
  };
  if (pieces > 0) {
    issue_router(0, 0);
    load_x(0);
    store_x(0);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int piece = 0; piece < pieces; ++piece) {
    const int s = piece & 1;
    const bool next = piece + 1 < pieces;
    if (next) {
      issue_router(piece + 1, s ^ 1);
      load_x(piece + 1);
    }
    const int m = min(kSub, d_end - (d_begin + piece * kSub));
    if (live) {
      constexpr int kStep = 16 * kKSplit;
      for (int k = kKSplit == 1 ? 0 : 16 * half; k < m; k += 2 * kStep) {
        step(rbuf(s), xbuf(s), m, k, acc[0]);
        if (k + kStep < m) step(rbuf(s), xbuf(s), m, k + kStep, acc[1]);
      }
    }
    if (next) {
      store_x(s ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  // c[i]: expert 16 et + g + 8 (i / 2), token 8 (nt0 + n) + 2 t + i % 2
  double* out = kKSplit == 1 ? part : stages + half * ROWS * kMaxE;
#pragma unroll
  for (int n = 0; n < kMine; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[((nt0 + n) * 8 + 2 * tig + (i & 1)) * kMaxE + 16 * et + gid + 8 * (i >> 1)] =
          acc[0][n][i] + acc[1][n][i];
  if (kKSplit > 1) {
    __syncthreads();
    for (int i = tid; i < ROWS * kMaxE; i += kRouterThreads) {
      double v = stages[i];
#pragma unroll
      for (int h = 1; h < kKSplit; ++h) v += stages[h * ROWS * kMaxE + i];
      part[i] = v;
    }
  }
  cluster.sync();  // every rank's partials are written and visible

  for (int t = rank + C * warp; t < ROWS; t += C * kRouterWarps) {
    const int row = row0 + t;
    if (row >= T) break;  // warp-uniform; later rows are past T too
    // every rank's partials in flight at once, then summed in rank order
    double v0[kMaxCluster], v1[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const double* pr = cluster.map_shared_rank(part, r) + t * kMaxE;
        v0[r] = pr[lane];
        v1[r] = pr[lane + 32];
      }
    }
    double x0 = 0.0, x1 = 0.0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        x0 += v0[r];
        x1 += v1[r];
      }
    }
    gate_row(lane < E ? static_cast<float>(x0) : -INFINITY,
             lane + 32 < E ? static_cast<float>(x1) : -INFINITY, lane, E, K,
             probs + static_cast<size_t>(row) * E,
             w + static_cast<size_t>(row) * K, ids + static_cast<size_t>(row) * K);
  }
  cluster.sync();  // no block leaves while another may read its partials
}

// The launch floor: the router kernel's launch shape (grid, cluster, block,
// shared memory) and nothing else.
__global__ void __launch_bounds__(kRouterThreads) router_empty_kernel() {}

// Raise a kernel's dynamic shared memory limit, and allow clusters past 8,
// once per kernel rather than on every launch (the host's cost counts at
// decode).  The port launches from one thread.
cudaError_t prepare(const void* fn, size_t smem, int C) {
  constexpr int kSlots = 4;
  static const void* fns[kSlots] = {};
  static size_t smems[kSlots] = {};
  static bool wide[kSlots] = {};
  int i = 0;
  while (i < kSlots && fns[i] != nullptr && fns[i] != fn) ++i;
  if (i == kSlots) return cudaErrorInvalidValue;
  fns[i] = fn;
  if (smem > smems[i]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smems[i] = smem;
  }
  if (C > 8 && !wide[i]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide[i] = true;
  }
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int T, int C, int rows, cudaStream_t stream,
                   Args... args) {
  const size_t smem = router_smem_doubles(rows) * sizeof(double);
  cudaError_t err = prepare(reinterpret_cast<const void*>(kernel), smem, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (T + rows - 1) / rows, 1);
  cfg.blockDim = dim3(kRouterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool plan_ok(int T, int D, int C, int chunk, int rows) {
  return T >= 0 && D >= 4 && D % 4 == 0 && (C == 1 || C == 2 || C == 4 ||
                                            C == 8 || C == kMaxCluster) &&
         chunk > 0 && chunk % 4 == 0 && static_cast<long long>(chunk) * C >= D &&
         (rows == 8 || rows == 32) && (T + rows - 1) / rows <= 65535;
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

// Router product + gating.  The plan (cluster size C, router rows a block
// ``chunk``, token rows a tile ``rows``) comes from the host
// (kernels/moe_gating.py router_plan), which the plain version follows too.
extern "C" int repro_router_gating(const void* x, const void* router, void* w,
                                   void* ids, void* probs, int T, int D, int E,
                                   int K, int C, int chunk, int rows,
                                   void* stream) {
  if (E < 1 || E > kMaxE || K < 1 || K > kMaxK || K > E ||
      !plan_ok(T, D, C, chunk, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* rp = static_cast<const float*>(router);
  auto* wp = static_cast<float*>(w);
  auto* ip = static_cast<int*>(ids);
  auto* pp = static_cast<float*>(probs);
  if (rows == 8)
    return launch_cluster(router_gating_kernel<8>, T, C, rows, s, xp, rp, wp,
                          ip, pp, T, D, E, K, chunk);
  return launch_cluster(router_gating_kernel<32>, T, C, rows, s, xp, rp, wp, ip,
                        pp, T, D, E, K, chunk);
}

// The empty kernel at the launch shape repro_router_gating would use.
extern "C" int repro_router_gating_empty(int T, int D, int C, int chunk,
                                         int rows, void* stream) {
  if (!plan_ok(T, D, C, chunk, rows) || T == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(router_empty_kernel, T, C, rows,
                        static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one router-kernel block, in bytes.
extern "C" int repro_router_gating_smem_bytes(int rows) {
  return static_cast<int>(router_smem_doubles(rows) * sizeof(double));
}
