// Fused LayerNorm + matmul (+bias) forward for Hopper (sm_90a), plain C
// interface (ctypes).
//
// Replaces distributed_tensorflow_tpu/ops/fused_ln_matmul.py::_fwd_kernel:
// y = (LN(x; gamma, beta, eps) cast to x's dtype) @ w + bias, with the row
// statistics in f32 (mean, then the mean of squared deviations, as in that
// file's _ln) and the product accumulated in f32, cast to the output dtype.
// w is [d, n] with element (k, c) at w[k*sk + c*sn]: the contiguous [d, n]
// array (sn == 1) and the transposed view of an nn.Linear weight [n, d]
// (sk == 1) both load coalesced. Two designs, chosen by M alone (the
// wrapper's fwd_plan): serving's few rows and training's many.
//
// ln_matmul_kernel, serving (M below the wrapper's LN_TILED_MIN_M: decode
// slots, one prefill chunk). Bound: the bytes of w, d*n*sizeof, read once
// per row tile. At decode all of w is 1.2 MB (n = 768) or 4.7 MB (n =
// 3072): one wave of CTAs that each issue their whole share of w at once
// moves it in about one DRAM round trip, where CTAs that walk d in
// dependent tiles pay one round trip a tile. So the work is spread over
// the card three ways: row tiles (16 rows of M), column tiles (64 columns
// of n) and a split of d over the `split` CTAs (ranks) of a thread-block
// cluster (split <= 8, the portable size); the wrapper's rows_plan picks
// the split from the shapes and the SM count.
// Rank r of a cluster owns the d-slice [r*dS, (r+1)*dS), dS a multiple of
// 16, none empty. Each CTA (128 threads, 4 warps):
//  1. issues, before any dependent work, the loads of the rows whose
//     statistics it computes (the first 768 elements of each, 8 a lane,
//     into registers), then its x rows' slice, gamma's and beta's slice
//     and its column tile's bias (one cp.async group) and its whole w
//     slice, dS x 64 (a second group); ragged edges of M, d and n are
//     zero-filled. So every DRAM round trip of the CTA overlaps the others;
//  2. computes the statistics of its share of the rows (row r on rank r %
//     split) over the whole row from those registers while the copies fly,
//     and writes them into every rank's shared memory; after one cluster
//     barrier each rank normalises its slice of every row in place, rounded
//     to x's dtype. So each row is read once per column tile, not once per
//     rank, and only the rows' slice sits in shared memory (d is bounded by
//     the slice alone);
//  3. multiplies with w as the A operand ("swap AB"): mma.sync m16n8k16
//     (tile_mma.cuh) puts 16 columns of n on the fragment's rows and the
//     16 token rows on two 8-wide sides, so each warp loads one fragment
//     of w and two of h a step; each warp owns 16 columns. f32 inputs take
//     the same tiles with f32 FMAs on CUDA cores;
//  4. writes each f32 partial into the shared memory of the rank that owns
//     its chunk (8 columns of one row; rank r owns the chunks r, r +
//     split, ...) through distributed shared memory; after one cluster
//     barrier rank r sums its chunks over every rank's partials in rank
//     order from its own shared memory,
//     adds the bias in f32, casts and stores them in 16-byte stores where
//     the row allows. No rank reads another's memory after the barrier, so
//     none waits to leave. No float atomics, no second launch: for one plan
//     the sums run in one order, so a call repeats bit for bit.
// With split = 1 the same kernel runs on a cluster of one.
//
// Training M (M >= LN_TILED_MIN_M; gpt_small: M = 8192, d = 768, n = 768
// or 3072): bound by the 2*M*d*n operations of the product. 16-row CTAs
// would stream all of w per 16 rows (2.4 GB from L2 at n = 3072) and
// normalise each row once per 64-column tile, so the work is split in two:
//  1. ln_stats_kernel: each row's mean and rstd ([M] f32 each, into a
//     workspace), two rows a warp side by side, 16-byte loads, the first
//     768 columns of each row held in registers between the two passes.
//  2. ln_matmul_tiled_kernel: a 2-D tiled product on tile_mma.cuh, as the
//     backward's dh and dw: a CTA owns a 128 x 256 output tile (rows of x
//     x columns of n), 8 warps of mma.sync m16n8k16 over 64 x 64 register
//     tiles; x's rows (k contiguous), w's tile (either layout) and the
//     stage's gamma, beta stream through a 3-stage cp.async.cg ring, 128
//     bytes of d a stage, ragged edges zero-filled. Once a stage lands the
//     CTA rewrites its x tile in place as h = (x - mean) * rstd * gamma +
//     beta, rounded to x's dtype, behind one barrier (each thread keeps its
//     rows' mean and rstd in registers); ldmatrix reads h as it lies and w
//     with .trans when n is contiguous. Epilogue: + bias in f32, cast,
//     masked stores. So w is read once per 128 rows and each row is
//     normalised once per 128-column tile, from L2. f32 inputs take the
//     same tiling with f32 FMAs on CUDA cores. No limit on d; d and n
//     multiples of 8, x 16-byte aligned, w as the backward kernels take it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

namespace cg = cooperative_groups;

using tile::from_f32;
using tile::to_f32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// serving M: the row-tile kernel, d split over a cluster
// ---------------------------------------------------------------------------

constexpr int RW_THREADS = 128;  // 4 warps
constexpr int RW_WARPS = RW_THREADS / 32;
constexpr int RW_ROWS = 16;      // rows of M a CTA: the n8 side of two mma tiles
constexpr int RW_COLS = 64;      // columns of n a CTA: 16 a warp
constexpr int RW_KSTEP = 16;     // the mma's depth: a d-slice is whole steps of it
constexpr int RW_MAX_SPLIT = 8;  // the portable cluster size
constexpr int RW_CHUNK = 8;      // columns of y a thread sums and stores at once
constexpr int RW_CACHE = 3;      // 8-element chunks of a row a lane keeps in registers
// What the kernel does by default; tools/ln_fwd_turns.py times it with one
// of these switched off (an ablated kernel computes garbage).
constexpr bool RW_LN_PASS = true;      // the statistics and the in-place normalisation
constexpr bool RW_CLUSTER_SUM = true;  // the sum over the ranks' partials

// The shared-memory carve-up of one CTA (bytes; every part 16-byte
// aligned), the same on the host (the launch's size) and the device. The
// wrapper's rows_smem states the same sum.
struct RowsLayout {
  int dS;   // depth of a rank's d-slice
  int ldx;  // pitch of Xs [RW_ROWS][ldx]: the x rows' slice, then h
  int ldw;  // pitch of Ws: [dS][ldw] when n is contiguous, else [RW_COLS][ldw]
  int nch;  // chunks of y a rank owns: Ps [split][nch][RW_CHUNK], f32 partials
  int w_off, gb_off, p_off, st_off, bytes;
};

template <typename T>
__host__ __device__ inline RowsLayout rows_layout(int split, int d, bool n_contig) {
  constexpr int P = 16 / sizeof(T);  // elements of a 16-byte chunk
  RowsLayout L;
  L.dS = round_up((d + split - 1) / split, RW_KSTEP);
  L.ldx = L.dS + P;
  L.ldw = n_contig ? RW_COLS + P : L.dS + P;
  L.nch = (RW_ROWS * RW_COLS / RW_CHUNK + split - 1) / split;
  L.w_off = RW_ROWS * L.ldx * (int)sizeof(T);
  L.gb_off = L.w_off + (n_contig ? L.dS : RW_COLS) * L.ldw * (int)sizeof(T);
  L.p_off = L.gb_off + (2 * L.dS + RW_COLS) * 4;  // gamma's, beta's slice; the tile's bias
  L.st_off = L.p_off + split * L.nch * RW_CHUNK * 4;
  L.bytes = L.st_off + 2 * RW_ROWS * 4;  // [2][RW_ROWS]: mean, rstd
  return L;
}

// w's rows [k0, k0 + depth) of the column tile at n0 into Ws, in 16-byte
// cp.async copies along w's unit-stride dim when ``vec`` (every vector
// that starts in range lies wholly in range and is 16-byte aligned,
// checked by the host), else element by element; zeros past d and n.
template <typename T>
__device__ __forceinline__ void rows_load_w(T* Ws, int ldw, const T* __restrict__ w,
                                            long long sk, long long sn, int d, int n, int k0,
                                            int n0, int depth, bool vec) {
  constexpr int P = 16 / sizeof(T);
  if (sn == 1) {  // Ws[k][c]: chunks along n
    constexpr int per = RW_COLS / P;
    for (int i = threadIdx.x; i < depth * per; i += RW_THREADS) {
      const int k = i / per, c = i % per * P, gk = k0 + k, gc = n0 + c;
      if (vec) {
        const bool ok = gk < d && gc < n;
        tile::cp_async16(Ws + k * ldw + c, ok ? w + gk * sk + gc : w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j)
          Ws[k * ldw + c + j] = gk < d && gc + j < n ? w[gk * sk + gc + j] : from_f32<T>(0.f);
      }
    }
  } else {  // Ws[c][k]: chunks along d
    const int per = depth / P;
    for (int i = threadIdx.x; i < RW_COLS * per; i += RW_THREADS) {
      const int c = i / per, k = i % per * P, gk = k0 + k, gc = n0 + c;
      if (vec) {
        const bool ok = gk < d && gc < n;
        tile::cp_async16(Ws + c * ldw + k, ok ? w + gk + gc * sn : w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j)
          Ws[c * ldw + k + j] =
              gk + j < d && gc < n ? w[(gk + j) * sk + gc * sn] : from_f32<T>(0.f);
      }
    }
  }
}

// grid (column tiles x split, row tiles), cluster (split, 1, 1): CTA
// (b, mt) is rank b % split of column tile b / split.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(RW_THREADS)
ln_matmul_kernel(const TIn* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const TIn* __restrict__ w,
                 const float* __restrict__ bias, TOut* __restrict__ y, int M, int d, int n,
                 long long sk, long long sn, int split, float eps, bool vec_x, bool vec_w,
                 bool vec_y) {
  constexpr int P = 16 / sizeof(TIn), ROWS = RW_ROWS, WARPS = RW_WARPS, COLS = RW_COLS;
  constexpr int NJ = ROWS / 8, RPW = ROWS / WARPS;
  static_assert(COLS == 16 * WARPS, "a warp owns 16 columns");
  extern __shared__ __align__(16) unsigned char smem[];
  // arrive now, wait before the first write into another rank's shared
  // memory: every rank of the cluster has started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const bool n_contig = sn == 1;
  const RowsLayout L = rows_layout<TIn>(split, d, n_contig);
  TIn* Xs = reinterpret_cast<TIn*>(smem);
  TIn* Ws = reinterpret_cast<TIn*>(smem + L.w_off);
  float* gs = reinterpret_cast<float*>(smem + L.gb_off);
  float* Ps = reinterpret_cast<float*>(smem + L.p_off);
  float* st = reinterpret_cast<float*>(smem + L.st_off);
  const int rank = blockIdx.x % split;
  const int n0 = blockIdx.x / split * COLS, m0 = blockIdx.y * ROWS, k0 = rank * L.dS;
  const int kn = min(L.dS, d - k0);  // columns of d this rank holds (> 0)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. Loads, before any dependent work. First the rows whose statistics
  //    this rank computes (row r on rank r % split; warp w takes the rank's
  //    rows j = w, w + 4, ..., lane l the 8-element chunks 8l, 8l + 256,
  //    ...): the first RW_CACHE chunks of each into registers, ahead of the
  //    copies in the memory queues. Then x's rows' slice, gamma's and
  //    beta's slice and the column tile's bias (one cp.async group) and the
  //    whole w slice (a second).
  auto row = [&](int u) { return rank + split * (warp + WARPS * u); };
  auto live = [&](int u) { return row(u) < ROWS && m0 + row(u) < M; };
  auto xrow = [&](int u) { return x + (size_t)(m0 + row(u)) * d; };
  const bool vec8 = d % 8 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  tile::Raw8<TIn> xc[RPW][RW_CACHE];
  if (RW_LN_PASS && vec8) {
#pragma unroll
    for (int u = 0; u < RPW; ++u)
#pragma unroll
      for (int i = 0; i < RW_CACHE; ++i)
        if (live(u) && 8 * lane + 256 * i < d) tile::load_raw(xrow(u) + 8 * lane + 256 * i, xc[u][i]);
  }
  if (vec_x) {
    const int per = L.dS / P;
    for (int i = tid; i < ROWS * per; i += RW_THREADS) {
      const int r = i / per, c = i % per * P;
      const bool ok = m0 + r < M && c < kn;
      tile::cp_async16(Xs + r * L.ldx + c, ok ? x + (size_t)(m0 + r) * d + k0 + c : x, ok);
    }
  } else {
    for (int i = tid; i < ROWS * L.dS; i += RW_THREADS) {
      const int r = i / L.dS, c = i % L.dS;
      Xs[r * L.ldx + c] =
          m0 + r < M && c < kn ? x[(size_t)(m0 + r) * d + k0 + c] : from_f32<TIn>(0.f);
    }
  }
  for (int i = tid; i < 2 * L.dS; i += RW_THREADS) {
    const int c = i % L.dS;
    tile::cp_async4(gs + i, (i < L.dS ? gamma : beta) + (c < kn ? k0 + c : 0), c < kn);
  }
  for (int i = tid; i < COLS; i += RW_THREADS)  // the bias, needed only at the end
    tile::cp_async4(gs + 2 * L.dS + i, bias + (n0 + i < n ? n0 + i : 0), n0 + i < n);
  tile::cp_async_commit();
  rows_load_w<TIn>(Ws, L.ldw, w, sk, sn, d, n, k0, n0, L.dS, vec_w);
  tile::cp_async_commit();

  // 2. The statistics while the copies fly: the mean, then the mean of
  //    squared deviations, both passes over the registers (a row longer
  //    than the cache reads the rest again); each rank writes its rows'
  //    mean and rstd into every rank's shared memory, one cluster barrier
  //    makes them whole, and each rank normalises its slice of every row in
  //    place, rounded to x's dtype.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
  if constexpr (RW_LN_PASS) {
    float s[RPW], mu[RPW];
#pragma unroll
    for (int u = 0; u < RPW; ++u) s[u] = 0.f;
    if (vec8) {
      auto pass = [&](auto&& f) {
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
          if (!live(u)) continue;
          float v[8];
#pragma unroll
          for (int i = 0; i < RW_CACHE; ++i)
            if (8 * lane + 256 * i < d) {
              tile::unpack(xc[u][i], v);
              f(u, v);
            }
          for (int k = 8 * lane + 256 * RW_CACHE; k < d; k += 256) {
            tile::load8(xrow(u) + k, v);
            f(u, v);
          }
        }
      };
      using F8 = float[8];
      pass([&](int u, const F8& v) {
#pragma unroll
        for (int q = 0; q < 8; ++q) s[u] += v[q];
      });
#pragma unroll
      for (int u = 0; u < RPW; ++u) mu[u] = warp_sum(s[u]) / d, s[u] = 0.f;
      pass([&](int u, const F8& v) {
#pragma unroll
        for (int q = 0; q < 8; ++q) s[u] += (v[q] - mu[u]) * (v[q] - mu[u]);
      });
    } else {
#pragma unroll
      for (int u = 0; u < RPW; ++u)
        if (live(u))
          for (int k = lane; k < d; k += 32) s[u] += to_f32(xrow(u)[k]);
#pragma unroll
      for (int u = 0; u < RPW; ++u) mu[u] = warp_sum(s[u]) / d, s[u] = 0.f;
#pragma unroll
      for (int u = 0; u < RPW; ++u)
        if (live(u))
          for (int k = lane; k < d; k += 32) {
            const float v = to_f32(xrow(u)[k]) - mu[u];
            s[u] += v * v;
          }
    }
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const float rs = rsqrtf(warp_sum(s[u]) / d + eps);
      if (live(u) && lane < split) {  // lane q writes rank q's copy
        float* dst = cluster.map_shared_rank(st, lane);
        dst[row(u)] = mu[u];
        dst[ROWS + row(u)] = rs;
      }
    }
    tile::cp_async_wait<1>();  // this thread's x, gamma, beta copies have landed
    cluster.sync();            // ... everyone's, and every row's statistics
    // h = (x - mean) * rstd * gamma + beta over this rank's slice, in place
    if (d % P == 0) {
      const int per = L.dS / P;
      for (int i = tid; i < ROWS * per; i += RW_THREADS) {
        const int r = i / per, c = i % per * P;
        if (m0 + r < M && c < kn)
          tile::ln_chunk(Xs + r * L.ldx + c, st[r], st[ROWS + r], gs + c, gs + L.dS + c);
      }
    } else {
      for (int i = tid; i < ROWS * L.dS; i += RW_THREADS) {
        const int r = i / L.dS, c = i % L.dS;
        if (m0 + r < M && c < kn) {
          TIn* p = Xs + r * L.ldx + c;
          *p = from_f32<TIn>((to_f32(*p) - st[r]) * st[ROWS + r] * gs[c] + gs[L.dS + c]);
        }
      }
    }
  }

  // 3. The product, w as the A operand: acc[0][j] holds columns wm.. of n
  //    by token rows 8j.. .
  float acc[1][NJ][4];
  tile::zero(acc);
  const int wm = warp * 16;
  auto product = [&](int ka, int kb) {
    for (int kk = ka; kk < kb; kk += RW_KSTEP) {
      if (n_contig)
        tile::warp_tile_rows<1, NJ, true, RW_KSTEP>(acc, Ws + kk * L.ldw, L.ldw, Xs + kk,
                                                    L.ldx, false, wm, 0, lane);
      else
        tile::warp_tile_rows<1, NJ, false, RW_KSTEP>(acc, Ws + kk, L.ldw, Xs + kk, L.ldx,
                                                     false, wm, 0, lane);
    }
  };
  tile::cp_async_wait<0>();
  __syncthreads();  // the w slice and h are whole
  product(0, L.dS);

  // 4. Each partial into the shared memory of the rank that owns its chunk
  //    (chunk i: 8 columns of one row, the (i / split)-th of rank i %
  //    split), at [this rank]; one barrier; then each
  //    rank sums its chunks over the ranks in order, from its own shared
  //    memory alone, so no rank reads another's after the barrier and none
  //    waits to leave.
  constexpr int CPR = COLS / RW_CHUNK;
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1), c = wm + g + 8 * (e >> 1);
        if (m0 + r < M && n0 + c < n) {
          const int i = r * CPR + c / RW_CHUNK;
          const int owner = RW_CLUSTER_SUM ? i % split : rank;
          cluster.map_shared_rank(Ps, owner)[(rank * L.nch + i / split) * RW_CHUNK +
                                             c % RW_CHUNK] = acc[0][j][e];
        }
      }
  }
  cluster.sync();  // every partial has reached its owner
  for (int i = rank + split * tid; i < ROWS * CPR; i += split * RW_THREADS) {
    const int r = i / CPR, c = i % CPR * RW_CHUNK;
    const int m = m0 + r, col = n0 + c;
    if (m >= M || col >= n) continue;
    float v[RW_CHUNK] = {};
    for (int q = 0; q < (RW_CLUSTER_SUM ? split : 1); ++q) {
      const int from = RW_CLUSTER_SUM ? q : rank;
      const float4* p =
          reinterpret_cast<const float4*>(Ps + (from * L.nch + i / split) * RW_CHUNK);
      const float4 a = p[0], b = p[1];
      v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w;
      v[4] += b.x, v[5] += b.y, v[6] += b.z, v[7] += b.w;
    }
#pragma unroll
    for (int e = 0; e < RW_CHUNK; ++e) v[e] += gs[2 * L.dS + c + e];
    TOut* out = y + (size_t)m * n + col;
    if (vec_y && col + RW_CHUNK <= n) {
      tile::store8(out, v);
    } else {
      for (int e = 0; e < RW_CHUNK && col + e < n; ++e) out[e] = from_f32<TOut>(v[e]);
    }
  }
}

// split (1..8, no empty d-slice): the wrapper's rows_plan
template <typename TIn, typename TOut>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           const void* bias, void* y, int M, int d, int n, int sk, int sn, int split, float eps,
           void* stream) {
  if (d < 1 || n < 1 || M < 0 || (sk != 1 && sn != 1) || split < 1 || split > RW_MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const RowsLayout L = rows_layout<TIn>(split, d, sn == 1);
  if ((split - 1) * L.dS >= d || L.bytes > 232448 || (M + RW_ROWS - 1) / RW_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  constexpr int P = 16 / sizeof(TIn);
  const bool vec_x = d % P == 0 && tile::aligned16(x);
  // vectors run along the unit-stride dim: its extent and the other
  // stride must keep every vector whole and 16-byte aligned
  const bool vec_w = tile::aligned16(w) && (sn == 1 ? n % P == 0 && sk % P == 0
                                                    : d % P == 0 && sn % P == 0);
  const bool vec_y = n % RW_CHUNK == 0 && tile::aligned16(y);
  auto kern = ln_matmul_kernel<TIn, TOut>;
  int e = tile::set_smem(kern, L.bytes);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + RW_COLS - 1) / RW_COLS * split, (M + RW_ROWS - 1) / RW_ROWS);
  cfg.blockDim = dim3(RW_THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kern, (const TIn*)x, (const float*)gamma,
                              (const float*)beta, (const TIn*)w, (const float*)bias, (TOut*)y,
                              M, d, n, (long long)sk, (long long)sn, split, eps, vec_x, vec_w,
                              vec_y);
  if (e) return e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// training-size M: a row-statistics pass and a tiled product
// ---------------------------------------------------------------------------

constexpr int ST_WARPS = 8;
constexpr int ST_ROWS = 2 * ST_WARPS;  // rows of a statistics CTA: two a warp
constexpr int ST_CACHE = 3;  // 256-column chunks of a row held in registers

__device__ __forceinline__ void warp_sum2(float (&v)[2]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    v[1] += __shfl_xor_sync(0xffffffffu, v[1], o);
  }
}

// Warp w of CTA b takes the rows r = b*ST_ROWS + w and r + ST_WARPS; lane l
// the 8-column chunks 8l, 8l + 256, ... of both (the first ST_CACHE loaded
// once, the rest read again in the second pass): mean, then rstd = rsqrt of
// the mean of squared deviations plus eps.
template <typename T>
__global__ void __launch_bounds__(32 * ST_WARPS)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean, float* __restrict__ rstd,
                int M, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rr[2] = {(int)blockIdx.x * ST_ROWS + warp, (int)blockIdx.x * ST_ROWS + warp + ST_WARPS};
  const bool ok[2] = {rr[0] < M, rr[1] < M};
  tile::Raw8<T> xc[2][ST_CACHE];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < ST_CACHE; ++i) {
      const int k = 8 * lane + 256 * i;
      if (ok[p] && k < d) tile::load_raw(x + (size_t)rr[p] * d + k, xc[p][i]);
    }
  // f(p, v[8]) over every chunk of both rows
  auto pass = [&](auto&& f) {
#pragma unroll
    for (int i = 0; i < ST_CACHE; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (ok[p] && 8 * lane + 256 * i < d) {
          float v[8];
          tile::unpack(xc[p][i], v);
          f(p, v);
        }
    for (int k = 8 * lane + 256 * ST_CACHE; k < d; k += 256)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (ok[p]) {
          float v[8];
          tile::load8(x + (size_t)rr[p] * d + k, v);
          f(p, v);
        }
  };
  using F8 = float[8];
  float s[2] = {0.f, 0.f}, mu[2];
  pass([&](int p, const F8& v) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s[p] += v[q];
  });
  warp_sum2(s);
#pragma unroll
  for (int p = 0; p < 2; ++p) mu[p] = s[p] / d, s[p] = 0.f;
  pass([&](int p, const F8& v) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s[p] += (v[q] - mu[p]) * (v[q] - mu[p]);
  });
  warp_sum2(s);
#pragma unroll
  for (int p = 0; p < 2; ++p)
    if (lane == 0 && ok[p]) mean[rr[p]] = mu[p], rstd[rr[p]] = rsqrtf(s[p] / d + eps);
}

// The ring of the tiled product, for output tiles of 128 rows x BN = 4 WN
// columns (WN = 64: 128 x 256 timed faster than 128 x 128 at gpt_small's
// shapes on an H100, PERF.md). One CTA an SM: the ring takes ~167 KB of
// shared memory (the wrapper's TILE_CTAS_PER_SM). A stage holds BK columns
// of d (128 bytes of a row): x's rows [BM][LDA] (rewritten as h in place),
// w's tile, either Bs[BN][LDK] (d contiguous, sk == 1) or Bs[BK][LDN] (n
// contiguous), then gamma [BK] and beta [BK] f32.
template <typename T>
struct Fw {
  static constexpr int WN = 64;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BN = 4 * WN;
  static constexpr int BK = tile::STAGE_BYTES / sizeof(T);
  static constexpr int NJ = WN / 8;
  static constexpr int LDA = tile::pad_ld<T>(BK), LDK = tile::pad_ld<T>(BK),
                       LDN = tile::pad_ld<T>(BN);
  static constexpr int A_ELEMS = tile::BM * LDA;
  static constexpr int B_ELEMS = BN * LDK > BK * LDN ? BN * LDK : BK * LDN;
  static constexpr size_t STAGE = sizeof(T) * (A_ELEMS + B_ELEMS) + sizeof(float) * 2 * BK;
  static constexpr size_t SMEM = STAGE * tile::STAGES;
  static_assert(STAGE % 16 == 0, "stages stay 16-byte aligned");
};

template <typename T>
__device__ __forceinline__ void fw_load(unsigned char* st, const T* __restrict__ x,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, const T* __restrict__ w,
                                        long long sk, long long sn, int M, int d, int n, int m0,
                                        int n0, int k0) {
  using S = Fw<T>;
  constexpr int V = S::V, BK = S::BK, BM = tile::BM;
  T* Xs = reinterpret_cast<T*>(st);
  T* Bs = Xs + S::A_ELEMS;
  float* gb = reinterpret_cast<float*>(Bs + S::B_ELEMS);
  tile::copy_tile<T, BM * BK / V, BK / V>(Xs, S::LDA, x, d, m0, M, k0, d);
  if (sk == 1)  // w[k, c], k contiguous: Bs[c][k]
    tile::copy_tile<T, S::BN * BK / V, BK / V>(Bs, S::LDK, w, sn, n0, n, k0, d);
  else  // w[k, c], c contiguous: Bs[k][c]
    tile::copy_tile<T, BK * S::BN / V, S::BN / V>(Bs, S::LDN, w, sk, k0, d, n0, n);
  if (threadIdx.x < 2 * BK) {  // gamma, then beta, one column a thread
    const int k = threadIdx.x % BK;
    const bool ok = k0 + k < d;
    tile::cp_async4(gb + threadIdx.x, (threadIdx.x < BK ? gamma : beta) + (ok ? k0 + k : 0), ok);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid (M tiles x n tiles), n fastest: CTA (mt, nt) writes y[mt*BM.., nt*BN..]
// = h @ w + bias over the whole of d, in one fixed order. Thread i rewrites
// the x chunks i, i + THREADS, ... of each stage: rows row0 + 32u, the same
// columns, so it keeps those rows' mean and rstd in registers.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(tile::THREADS, 1)
ln_matmul_tiled_kernel(const TIn* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const TIn* __restrict__ w, long long sk,
                       long long sn, const float* __restrict__ bias,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       TOut* __restrict__ y, int M, int d, int n) {
  using S = Fw<TIn>;
  constexpr int V = S::V, BK = S::BK, P = BK / V, BM = tile::BM, STAGES = tile::STAGES;
  constexpr int THREADS = tile::THREADS, ROWS = BM * P / THREADS;
  static_assert(THREADS % P == 0, "a thread's chunks share their columns");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntiles = (n + S::BN - 1) / S::BN;
  const int m0 = blockIdx.x / ntiles * BM, n0 = blockIdx.x % ntiles * S::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * S::WN;
  const int nk = (d + BK - 1) / BK;
  const bool b_t = sk != 1;
  const int col = threadIdx.x % P * V, row0 = threadIdx.x / P;
  float mu[ROWS], rs[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int r = m0 + row0 + u * (THREADS / P);
    mu[u] = r < M ? mean[r] : 0.f;
    rs[u] = r < M ? rstd[r] : 0.f;
  }
  float acc[4][S::NJ][4];
  tile::zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      fw_load<TIn>(smem + s * S::STAGE, x, gamma, beta, w, sk, sn, M, d, n, m0, n0, s * BK);
    tile::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tile::cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; stage kt - 1 is consumed
    const int nx = kt + STAGES - 1;
    if (nx < nk)
      fw_load<TIn>(smem + nx % STAGES * S::STAGE, x, gamma, beta, w, sk, sn, M, d, n, m0,
                       n0, nx * BK);
    tile::cp_async_commit();
    TIn* Xs = reinterpret_cast<TIn*>(smem + kt % STAGES * S::STAGE);
    const TIn* Bs = Xs + S::A_ELEMS;
    const float* gb = reinterpret_cast<const float*>(Bs + S::B_ELEMS);
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      tile::ln_chunk(Xs + (row0 + u * (THREADS / P)) * S::LDA + col, mu[u], rs[u], gb + col,
                     gb + BK + col);
    __syncthreads();  // h is whole
    if (b_t)  // one copy of the loop per w layout: constant pitches
      tile::warp_tile<S::NJ, false, BK>(acc, Xs, S::LDA, Bs, S::LDN, true, wm, wn, lane);
    else
      tile::warp_tile<S::NJ, false, BK>(acc, Xs, S::LDA, Bs, S::LDK, false, wm, wn, lane);
  }
  tile::cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < S::NJ; ++j) {
    const int c = n0 + wn + 8 * j + 2 * t;
    if (c >= n) continue;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + 16 * i + g + 8 * h;
        if (r < M)
          store2(y + (size_t)r * n + c, acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
      }
  }
}

template <typename TIn, typename TOut>
int launch_tiles(const void* x, const void* gamma, const void* beta, const void* w,
                 long long sk, long long sn, const void* bias, const float* mean,
                 const float* rstd, void* y, int M, int d, int n, cudaStream_t st) {
  using S = Fw<TIn>;
  const long long tiles = (long long)((M + tile::BM - 1) / tile::BM) * ((n + S::BN - 1) / S::BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = ln_matmul_tiled_kernel<TIn, TOut>;
  int e = tile::set_smem(kern, S::SMEM);
  if (e) return e;
  kern<<<(unsigned)tiles, tile::THREADS, S::SMEM, st>>>(
      (const TIn*)x, (const float*)gamma, (const float*)beta, (const TIn*)w, sk, sn,
      (const float*)bias, mean, rstd, (TOut*)y, M, d, n);
  return (int)cudaGetLastError();
}

// stats: [2][M] f32 workspace (mean, then rstd)
template <typename TIn, typename TOut>
int launch_tiled(const void* x, const void* gamma, const void* beta, const void* w,
                 const void* bias, void* y, void* stats, int M, int d, int n, long long sk,
                 long long sn, float eps, void* stream) {
  if (M < 1 || d < 8 || n < 8 || d % 8 || n % 8 || !tile::w_ok<TIn>(w, sk, sn, d, n) ||
      !tile::aligned16(x))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* mean = (float*)stats;
  float* rstd = mean + M;
  ln_stats_kernel<TIn><<<(M + ST_ROWS - 1) / ST_ROWS, 32 * ST_WARPS, 0, st>>>(
      (const TIn*)x, mean, rstd, M, d, eps);
  int e = (int)cudaGetLastError();
  if (e) return e;
  return launch_tiles<TIn, TOut>(x, gamma, beta, w, sk, sn, bias, mean, rstd, y, M, d, n, st);
}

}  // namespace

extern "C" {

#define DTF_ROWS_ARGS                                                                  \
  const void *x, const void *gamma, const void *beta, const void *w, const void *bias, \
      void *y, int M, int d, int n, int sk, int sn, int split, float eps, void *stream
#define DTF_ROWS_PASS x, gamma, beta, w, bias, y, M, d, n, sk, sn, split, eps, stream

int ln_matmul_f32(DTF_ROWS_ARGS) { return launch<float, float>(DTF_ROWS_PASS); }
int ln_matmul_bf16(DTF_ROWS_ARGS) {
  return launch<__nv_bfloat16, __nv_bfloat16>(DTF_ROWS_PASS);
}
int ln_matmul_bf16_f32(DTF_ROWS_ARGS) { return launch<__nv_bfloat16, float>(DTF_ROWS_PASS); }


#define DTF_TILED_ARGS                                                                   \
  const void *x, const void *gamma, const void *beta, const void *w, const void *bias,   \
      void *y, void *stats, int M, int d, int n, long long sk, long long sn, float eps, \
      void *stream
#define DTF_TILED_PASS x, gamma, beta, w, bias, y, stats, M, d, n, sk, sn, eps, stream

int ln_matmul_tiled_f32(DTF_TILED_ARGS) { return launch_tiled<float, float>(DTF_TILED_PASS); }
int ln_matmul_tiled_bf16(DTF_TILED_ARGS) {
  return launch_tiled<__nv_bfloat16, __nv_bfloat16>(DTF_TILED_PASS);
}
int ln_matmul_tiled_bf16_f32(DTF_TILED_ARGS) {
  return launch_tiled<__nv_bfloat16, float>(DTF_TILED_PASS);
}

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
