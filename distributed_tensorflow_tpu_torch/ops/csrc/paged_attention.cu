// Paged attention forward for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces distributed_tensorflow_tpu/ops/flash_attention.py::_paged_fwd_kernel
// (entry paged_flash_attention): attention of q [B,H,S,D] read IN PLACE from
// the KV block pool k/v [NB,H,bs,D] through a block table [B,MB] (int32),
// key position p attending iff p <= q_pos[b,s] (and p < MB*bs). Sentinel
// table ids (>= NB) clamp to NB-1; their positions lie above every live
// q_pos, so the mask drops them (an idle slot's past-the-table q_pos
// attends them: garbage, but finite and equal to the plain version's).
// Softmax in f32 with an explicit zero under the mask; out = (p @ V) /
// max(sum p, 1e-30), so a row that attends nothing (q_pos = -1) is 0.
//
// Bound: the bytes of K/V it reads, B*H*ctx*D*2*sizeof(T) per call (ctx =
// the positions the rows attend). Decode moves a few MB in a few
// microseconds, so the design is about latency and bytes, not operations:
//
// 1. One launch. The logical keys of a row are cut into chunks of `kc`
//    keys (whole multiples of the mma's 16, any block size: a key's block
//    is looked up per key), and the chunks into the contiguous shares of
//    the `ranks` CTAs of a thread-block cluster (<= 8, the portable size),
//    `cpr` chunks a rank; the wrapper's paged_plan picks kc, cpr and ranks
//    from the shapes and the SM count alone. A cluster covers one (b, h)
//    and up to 64 query rows, so for S <= 64 every K/V block is read once
//    per call. Each rank walks its chunks with an online softmax, then
//    pushes its f32 (m, l, acc) partials into the shared memory of the
//    rank that owns each 8-column chunk of the output (distributed shared
//    memory); after one cluster barrier each rank merges its chunks over
//    every rank's partials, from its own shared memory, lanes over the
//    partials and a fixed butterfly of shuffles between them, and stores
//    them. No float atomics, no second launch, no scratch in global
//    memory: for one plan the sums run in one order, so a call repeats bit
//    for bit, and no rank reads another's memory after the barrier.
// 2. A short dependent chain. Every thread first issues its loads at once:
//    the tile's q_pos, the rank's slice of the table (clamped ids into
//    shared memory) and q's rows (cp.async). One barrier later every
//    thread knows the highest position any row of the tile attends (a
//    warp reduction, no serial loop), so chunks past it are never read,
//    and K/V of the first stages are in flight.
// 3. K/V stay in their own dtype: 16-byte cp.async.cg copies straight into
//    a ring of min(cpr, PA_STAGES) shared-memory stages (rows padded by 16
//    bytes, so ldmatrix's rows fall on distinct banks); the next chunks
//    fly while this one's products run. Keys past the highest position are
//    zero-filled, never read.
// 4. Tensor cores. The warps of a CTA split 16-row query groups and the
//    keys of each chunk (S <= 16: 4 warps, 1 row group, each warp a quarter
//    of the keys; S <= 32: 4 warps, 2 x 2; longer: 8 warps, 4 row groups x
//    2, so that two warps of each SM sub-partition hide each other's
//    dependent mma, shuffle and exp latencies). A warp step is 16 keys:
//    S = Q K^T by mma.sync m16n8k16 (tile_mma.cuh's warp tile,
//    Q and K by ldmatrix), the online softmax on the accumulator
//    fragments, then P V with P taken from those fragments as the A
//    operand and V by ldmatrix.trans. P keeps f32 precision: it is split
//    into a bf16 high part and a bf16 residual, and both are multiplied
//    by V (exact in bf16) into the same f32 accumulator. At S = 1 the one
//    live row of a 16-row mma tile wastes 15/16 of it, and CUDA-core dot
//    products from the bf16 ring measured faster on an H100 (PERF.md,
//    tools/paged_turns.py): lane pairs dot q with a key each, then each
//    lane sums p V for its columns over the step's 16 keys.
// f32 inputs run the same design with the same fragment layout on CUDA
// cores (tile_mma.cuh's f32 warp tile; P through a per-warp shared tile).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int PA_THREADS = 128;       // a CTA at S <= 32: 4 warps
constexpr int PA_WIDE_THREADS = 256;  // at S > 32: 8 warps, 4 row groups x 2 key groups
constexpr int PA_KS = 16;         // keys of one warp step: the mma's depth in P V
constexpr int PA_STAGES = 3;      // depth of the K/V ring, in chunks, at most
constexpr int PA_MAX_RANKS = 8;   // the portable cluster size
constexpr int PA_IDS = 160;       // table ids a CTA holds at once (a pass of its chunks)
constexpr int PA_MAX_CHUNK = 128; // keys of a chunk at most
constexpr float kNegInf = -1e30f;
// What the kernel does by default; tools/paged_turns.py times it with one
// of these switched (an ablated kernel computes garbage).
constexpr bool PA_SUMS = true;         // the merge's sums over the pushed partials
constexpr bool PA_KV_COPY = true;      // the K/V copies
constexpr bool PA_PRODUCTS = true;     // the warps' steps: products and online softmax
constexpr bool PA_P_SPLIT = true;      // P V with P's bf16 residual (f32 precision)
constexpr bool PA_DECODE_MMA = false;  // S = 1 on tensor cores (else CUDA-core dots)

// Phase marks: tools/paged_turns.py's timeline variant defines them to
// record each CTA's %globaltimer at the start, after the first dependent
// loads, after its chunks, before and after the cluster barrier, inside the
// merge and at the end; nothing by default.
#define PA_MARK(i)

__host__ __device__ constexpr int round16(int a) { return (a + 15) / 16 * 16; }

// The shared-memory carve-up of one CTA (bytes; every part 16-byte
// aligned), the same on the host (the launch's size) and the device. The
// wrapper's paged_smem states the same sum (tests/test_torch_build.py
// holds the two equal over the plans paged_plan makes).
struct Layout {
  int stages;  // ring stages: one a chunk of the rank's share, at most PA_STAGES
  int wk;    // warps that share a row group's keys
  int rows;  // query rows of a CTA tile: 16 per row group
  int rl;    // rows of a tile the merge takes at most: min(rows, S)
  int ld;    // pitch of the Q, K and V rows (elements)
  int nown;  // 8-column output chunks a rank owns at most
  int kv_off, p_off, acc_off, ml_off, pos_off, ids_off, bytes;
};

template <typename T, int DK, int WARPS>
__host__ __device__ constexpr Layout layout(int S, int D, int kc, int ranks, int cpr) {
  Layout L{};
  L.stages = cpr < PA_STAGES ? cpr : PA_STAGES;
  L.wk = S <= 16 ? 4 : S <= 32 ? 2 : WARPS / 4;
  L.rows = 16 * (WARPS / L.wk);
  L.rl = S < L.rows ? S : L.rows;
  L.ld = DK + 16 / (int)sizeof(T);
  L.nown = (L.rl * (D / 8) + ranks - 1) / ranks;
  L.kv_off = L.rows * L.ld * (int)sizeof(T);
  L.p_off = L.kv_off + L.stages * 2 * kc * L.ld * (int)sizeof(T);
  // f32: each warp's P tile for its CUDA-core P V ([16][PA_KS + 4])
  L.acc_off = L.p_off + (sizeof(T) == 4 ? WARPS * 16 * (PA_KS + 4) * 4 : 0);
  L.ml_off = L.acc_off + ranks * L.wk * L.nown * 8 * 4;  // [slot][nown][8] f32 partials
  L.pos_off = L.ml_off + round16(ranks * L.wk * L.rl * 8);  // [slot][rl] (m, l)
  L.ids_off = L.pos_off + round16((L.rows + WARPS) * 4);  // positions, warp maxima
  L.bytes = L.ids_off + PA_IDS * 4;
  return L;
}

// Chunks of one pass: as many as keep the table ids they span within
// PA_IDS (a span of n*kc keys touches at most n*kc/bs + 2 blocks).
__device__ __forceinline__ int pass_chunks(int kc, int bs) {
  return max(1, (PA_IDS - 2) * bs / kc);
}

// one 16-byte chunk as f32
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[8]) {
  tile::load8(p, v);
}
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A = P's bf16 high part, R = its residual, from two m16n8 fragments
// (keys 0-7, 8-15 of a step) in the m16n8k16 A layout
__device__ __forceinline__ void split_p(const float (&s)[1][2][4], uint32_t (&a)[4],
                                        uint32_t (&r)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* f = &s[0][q >> 1][2 * (q & 1)];
    a[q] = bf16x2(f[0], f[1]);
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&a[q]);
    r[q] = bf16x2(f[0] - __bfloat162float(h.x), f[1] - __bfloat162float(h.y));
  }
}

// grid (ranks x row tiles, H, B), cluster (ranks, 1, 1): CTA (x, h, b) is
// rank x % ranks of row tile x / ranks of (b, h). CORES: the S = 1 launch
// on CUDA cores (an instantiation of its own, so its code does not weigh
// on the mma path's registers); WARPS: 4, or 8 at S > 32.
template <typename T, int DK, bool CORES, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ q_pos, T* __restrict__ out, int H, int S, int D,
                       int NB, int bs, int MB, int ranks, int kc, int cpr, float scale) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte copy
  constexpr int NJ = DK / 8;         // n8 tiles of the output's columns
  constexpr int CH = DK / V;         // 16-byte chunks of a row
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  // arrive now, wait before the first write into another rank's shared
  // memory: every rank of the cluster has started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  PA_MARK(0);
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout<T, DK, WARPS>(S, D, kc, ranks, cpr);
  T* Qs = reinterpret_cast<T*>(smem);
  T* KV = reinterpret_cast<T*>(smem + L.kv_off);
  float* Racc = reinterpret_cast<float*>(smem + L.acc_off);
  float2* ML = reinterpret_cast<float2*>(smem + L.ml_off);
  int* pos_s = reinterpret_cast<int*>(smem + L.pos_off);
  int* hi_s = pos_s + L.rows;
  int* ids = reinterpret_cast<int*>(smem + L.ids_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % ranks, s0 = blockIdx.x / ranks * L.rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int wr = warp / L.wk, wk = warp % L.wk;
  const int total = MB * bs;  // logical keys of a row
  const int nchunks = (total + kc - 1) / kc;
  const int c_lo = rank * cpr, c_top = min(nchunks, c_lo + cpr);
  const int pc = pass_chunks(kc, bs);
  const size_t bh = (size_t)b * H + h;

  // 1. The loads that start the chain, all at once: the tile's positions
  //    (a position past the table attends the whole table), the first
  //    pass's slice of the table (clamped ids), q's rows (one cp.async
  //    group; rows past S and columns past D zero-filled).
  int lim = -1;
  if (tid < L.rows && s0 + tid < S) lim = min(q_pos[(size_t)b * S + s0 + tid], total - 1);
  auto load_ids = [&](int c0, int n) {
    const int blk0 = c0 * kc / bs, blk1 = min(MB, ((c0 + n) * kc - 1) / bs + 1);
    for (int i = tid; i < blk1 - blk0; i += THREADS)
      ids[i] = min(max(table[(size_t)b * MB + blk0 + i], 0), NB - 1);
  };
  if (c_lo < c_top) load_ids(c_lo, min(pc, c_top - c_lo));
  for (int i = tid; i < L.rows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH * V;
    const bool ok = s0 + r < S && c < D;
    tile::cp_async16(Qs + r * L.ld + c, ok ? q + (bh * S + s0 + r) * D + c : q, ok);
  }
  tile::cp_async_commit();
  if (tid < L.rows) pos_s[tid] = lim;
  const int wmax = __reduce_max_sync(0xffffffffu, lim);
  if (lane == 0) hi_s[warp] = wmax;
  __syncthreads();
  PA_MARK(1);
  int hi = hi_s[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) hi = max(hi, hi_s[w]);
  // chunks past every row's position are never read
  const int c_end = hi < 0 ? c_lo : min(c_top, hi / kc + 1);

  // this thread's rows (g, g + 8 of its warp's group) and their limits
  const int r0 = 16 * wr + g;
  const bool warp_live = s0 + 16 * wr < S;
  const int lim0 = pos_s[r0], lim1 = pos_s[r0 + 8];
  const int whi = __reduce_max_sync(0xffffffffu, max(lim0, lim1));

  // K/V of chunk c into ring stage st: keys past hi (and past the table)
  // zero-filled, never read; ids hold the pass's blocks from blk0
  auto issue = [&](int c, int st, int blk0) {
    if (!PA_KV_COPY) return;
    T* Ks = KV + (size_t)st * 2 * kc * L.ld;
    T* Vs = Ks + (size_t)kc * L.ld;
    for (int i = tid; i < kc * CH; i += THREADS) {
      const int key = i / CH, ch = i % CH, col = ch * V, p = c * kc + key;
      const bool ok = p <= hi && col < D;
      size_t src = 0;
      if (ok) src = (((size_t)ids[p / bs - blk0] * H + h) * bs + p % bs) * D + col;
      tile::cp_async16(Ks + key * L.ld + col, k_pool + src, ok);
      tile::cp_async16(Vs + key * L.ld + col, v_pool + src, ok);
    }
  };

  // the warp's running state: rows g, g + 8 in the mma fragment layout
  float o[1][NJ][4];
  tile::zero(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the CUDA-core S = 1 path: row 0 alone, lane owns columns 2 lane + 64 u
  constexpr int CU = (DK + 63) / 64;
  float oc[CU][2] = {};
  float mc = kNegInf, lc = 0.f;

  auto step_mma = [&](const T* Ks, const T* Vs, int key0, int p0) {
    float s[1][2][4];
    tile::zero(s);
    tile::warp_tile_rows<1, 2, false, DK>(s, Qs + 16 * wr * L.ld, L.ld, Ks + key0 * L.ld, L.ld,
                                          false, 0, 0, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 8 * j + 2 * t + (e & 1);
        const float v = p <= ((e >> 1) ? lim1 : lim0) ? s[0][j][e] * scale : kNegInf;
        s[0][j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
    // an explicit zero under the mask (never exp(NEG_INF - NEG_INF))
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, p = p0 + 8 * j + 2 * t + (e & 1);
        const float pe = p <= (r ? lim1 : lim0) ? expf(s[0][j][e] - m[r]) : 0.f;
        s[0][j][e] = pe;
        l[r] += pe;
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      o[0][j][0] *= corr[0], o[0][j][1] *= corr[0];
      o[0][j][2] *= corr[1], o[0][j][3] *= corr[1];
    }
    if constexpr (sizeof(T) == 2) {
      uint32_t a[4], res[4];
      split_p(s, a, res);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t bv[4];
        tile::ldsm_x4_trans(bv, Vs + (key0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L.ld + 8 * j +
                                    8 * (lane >> 4));
        tile::mma_bf16(o[0][j], a, bv[0], bv[1]);
        tile::mma_bf16(o[0][j + 1], a, bv[2], bv[3]);
        if (PA_P_SPLIT) {
          tile::mma_bf16(o[0][j], res, bv[0], bv[1]);
          tile::mma_bf16(o[0][j + 1], res, bv[2], bv[3]);
        }
      }
    } else {
      float* Pw = reinterpret_cast<float*>(smem + L.p_off) + warp * 16 * (PA_KS + 4);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Pw[(g + 8 * (e >> 1)) * (PA_KS + 4) + 8 * j + 2 * t + (e & 1)] = s[0][j][e];
      __syncwarp();
      tile::warp_tile_rows<1, NJ, false, PA_KS>(o, Pw, PA_KS + 4, Vs + key0 * L.ld, L.ld, true, 0,
                                                0, lane);
      __syncwarp();
    }
  };

  // S = 1 on CUDA cores: lane (key lane / 2, half lane % 2) dots half of q
  // with its key; lane c then sums p V over the step's keys for its columns
  auto step_cores = [&](const T* Ks, const T* Vs, int key0, int p0) {
    const int key = lane >> 1, half = lane & 1, p = p0 + key;
    const T* kr = Ks + (key0 + key) * L.ld;
    float s = 0.f;
#pragma unroll
    for (int ch = half * CH / 2; ch < (half + 1) * CH / 2; ++ch) {
      float kv[V], qv[V];
      load_chunk(kr + ch * V, kv);
      load_chunk(Qs + ch * V, qv);
#pragma unroll
      for (int e = 0; e < V; ++e) s = fmaf(qv[e], kv[e], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s = p <= pos_s[0] ? s * scale : kNegInf;
    float mx = s;
#pragma unroll
    for (int w = 2; w < 32; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float mn = fmaxf(mc, mx), corr = expf(mc - mn);
    mc = mn;
    const float pe = p <= pos_s[0] ? expf(s - mn) : 0.f;
    lc = lc * corr + (half ? 0.f : pe);
#pragma unroll
    for (int u = 0; u < CU; ++u) oc[u][0] *= corr, oc[u][1] *= corr;
#pragma unroll
    for (int k = 0; k < PA_KS; ++k) {
      const float pk = __shfl_sync(0xffffffffu, pe, 2 * k);
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int c = 2 * lane + 64 * u;
        if (c < DK) {
          const float2 v = load2(Vs + (key0 + k) * L.ld + c);
          oc[u][0] = fmaf(pk, v.x, oc[u][0]);
          oc[u][1] = fmaf(pk, v.y, oc[u][1]);
        }
      }
    }
  };

  // 2. The rank's chunks, in passes of at most pc (the ids they span fit
  //    PA_IDS), each through the ring: L.stages chunks in flight, a
  //    warp's steps of 16 keys dealt round the warps sharing a row group.
  for (int cp = c_lo; cp < c_end; cp += pc) {
    const int np = min(pc, c_end - cp);
    if (cp != c_lo) {
      __syncthreads();  // no thread still reads the last pass's ids
      load_ids(cp, np);
      __syncthreads();
    }
    const int blk0 = cp * kc / bs;
    for (int i = 0; i < L.stages; ++i) {
      if (i < np) issue(cp + i, i, blk0);
      tile::cp_async_commit();
    }
    for (int i = 0; i < np; ++i) {
      if (L.stages >= 3)
        tile::cp_async_wait<2>();
      else if (L.stages == 2)
        tile::cp_async_wait<1>();
      else
        tile::cp_async_wait<0>();
      __syncthreads();  // chunk i (and q) have landed for every thread
      const int c = cp + i, st = i % L.stages;
      const T* Ks = KV + (size_t)st * 2 * kc * L.ld;
      const T* Vs = Ks + (size_t)kc * L.ld;
      if (PA_PRODUCTS && warp_live) {
        for (int key0 = wk * PA_KS; key0 < kc; key0 += L.wk * PA_KS) {
          const int p0 = c * kc + key0;
          if (p0 > whi) break;  // keys ascend: no row of the warp attends the rest
          if constexpr (CORES)
            step_cores(Ks, Vs, key0, p0);
          else
            step_mma(Ks, Vs, key0, p0);
        }
      }
      __syncthreads();  // every warp is done with the stage before it refills
      if (i + L.stages < np) issue(c + L.stages, st, blk0);
      tile::cp_async_commit();
    }
  }
  tile::cp_async_wait<0>();
  PA_MARK(2);

  // 3. Push each live row's partials to the ranks that own its output
  //    chunks (chunk i = row * D/8 + column / 8 is the (i / ranks)-th of
  //    rank i % ranks), at slot (this rank, wk); (m, l) to every rank.
  const int slot = rank * L.wk + wk, cpr8 = D / 8;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
  if (warp_live && CORES) {
#pragma unroll
    for (int w = 1; w < 32; w <<= 1) lc += __shfl_xor_sync(0xffffffffu, lc, w);
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int c = 2 * lane + 64 * u;
      if (c < D) {
        const int i = c / 8;
        cluster.map_shared_rank(
            reinterpret_cast<float2*>(Racc + ((slot * L.nown + i / ranks) * 8 + c % 8)),
            i % ranks)[0] = make_float2(oc[u][0], oc[u][1]);
      }
    }
    if (lane < ranks) cluster.map_shared_rank(ML, lane)[slot * L.rl] = make_float2(mc, lc);
  } else if (warp_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r0 + 8 * r;
      if (s0 + row >= S) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= cpr8) break;
        const int i = row * cpr8 + j;
        cluster.map_shared_rank(
            reinterpret_cast<float2*>(Racc + ((slot * L.nown + i / ranks) * 8 + 2 * t)),
            i % ranks)[0] = make_float2(o[0][j][2 * r], o[0][j][2 * r + 1]);
      }
      for (int dst = t; dst < ranks; dst += 4)
        cluster.map_shared_rank(ML, dst)[slot * L.rl + row] = make_float2(m[r], l[r]);
    }
  }
  PA_MARK(3);
  cluster.sync();  // every partial has reached its owner
  PA_MARK(4);

  // 4. Merge this rank's chunks: a group of lpc lanes a chunk (a power of
  //    two, as many as the threads allow, at most one a slot), lane u of a
  //    group taking the slots u, u + lpc, ...; the common max, the weights
  //    e^(m - M), sum l and the weighted partials are reduced over the
  //    group by a fixed butterfly of shuffles, so the order of the sums is
  //    fixed by the plan. Normalise by max(sum l, 1e-30), store 8 columns.
  const int nslots = ranks * L.wk, here = min(L.rows, S - s0) * cpr8;
  const int own = (here - rank + ranks - 1) / ranks;  // chunks this rank owns
  int lpc = 1;
  while (lpc < 32 && lpc < nslots && 2 * lpc * own <= THREADS) lpc *= 2;
  const int sub = tid % lpc;
  for (int base = 0; base < own; base += THREADS / lpc) {
    const int j = base + tid / lpc;
    const bool act = j < own;
    const int row = act ? (rank + j * ranks) / cpr8 : 0;
    float M = kNegInf;
    for (int sl = sub; PA_SUMS && act && sl < nslots; sl += lpc)
      M = fmaxf(M, ML[sl * L.rl + row].x);
    for (int w = 1; w < lpc; w <<= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, w));
    PA_MARK(6);
    float acc[8] = {}, ls = 0.f;
    for (int sl = sub; PA_SUMS && act && sl < nslots; sl += lpc) {
      const float2 ml = ML[sl * L.rl + row];
      const float w = expf(ml.x - M);
      const float4* pa = reinterpret_cast<const float4*>(Racc + (sl * L.nown + j) * 8);
      const float4 a0 = pa[0], a1 = pa[1];
      acc[0] += a0.x * w, acc[1] += a0.y * w, acc[2] += a0.z * w, acc[3] += a0.w * w;
      acc[4] += a1.x * w, acc[5] += a1.y * w, acc[6] += a1.z * w, acc[7] += a1.w * w;
      ls += ml.y * w;
    }
    for (int w = 1; w < lpc; w <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], w);
      ls += __shfl_xor_sync(0xffffffffu, ls, w);
    }
    PA_MARK(7);
    if (act && sub == 0) {
      const float inv = 1.f / fmaxf(ls, 1e-30f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= inv;
      tile::store8(out + (bh * S + s0 + row) * D + (rank + j * ranks) % cpr8 * 8, acc);
    }
  }
  PA_MARK(5);
}

template <typename T, int DK, bool CORES, int WARPS>
int launch_kernel(const void* q, const void* k_pool, const void* v_pool, const void* table,
                  const void* q_pos, void* out, int B, int H, int S, int D, int NB, int bs,
                  int MB, int ranks, int kc, int cpr, float scale, void* stream) {
  const Layout L = layout<T, DK, WARPS>(S, D, kc, ranks, cpr);
  const long long rt = (S + L.rows - 1) / L.rows;
  if (L.bytes > 232448 || rt * ranks > 0x7fffffffLL || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<T, DK, CORES, WARPS>;
  int e = tile::set_smem(kern, L.bytes);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rt * ranks), H, B);
  cfg.blockDim = dim3(32 * WARPS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k_pool, (const T*)v_pool,
                              (const int*)table, (const int*)q_pos, (T*)out, H, S, D, NB, bs, MB,
                              ranks, kc, cpr, scale);
  if (e) return e;
  return (int)cudaGetLastError();
}

// S = 1 on CUDA cores, S <= 32 on 4 warps, longer chunks on 8
template <typename T, int DK>
int launch_dk(const void* q, const void* k_pool, const void* v_pool, const void* table,
              const void* q_pos, void* out, int B, int H, int S, int D, int NB, int bs, int MB,
              int ranks, int kc, int cpr, float scale, void* stream) {
#define DTF_PAGED_KERNEL_ARGS q, k_pool, v_pool, table, q_pos, out, B, H, S, D, NB, bs, MB, \
                              ranks, kc, cpr, scale, stream
  if (S == 1 && !PA_DECODE_MMA)
    return launch_kernel<T, DK, true, PA_THREADS / 32>(DTF_PAGED_KERNEL_ARGS);
  if (S <= 32) return launch_kernel<T, DK, false, PA_THREADS / 32>(DTF_PAGED_KERNEL_ARGS);
  return launch_kernel<T, DK, false, PA_WIDE_THREADS / 32>(DTF_PAGED_KERNEL_ARGS);
#undef DTF_PAGED_KERNEL_ARGS
}

// ranks, kc, cpr: the wrapper's paged_plan (every chunk of the table in
// exactly one rank's share, none empty)
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* q_pos, void* out, int B, int H, int S, int D, int NB, int bs, int MB,
           int ranks, int kc, int cpr, float scale, void* stream) {
  const long long total = (long long)MB * bs, chunks = (total + kc - 1) / (kc > 0 ? kc : 1);
  if (bs < 1 || NB < 1 || MB < 1 || B < 0 || S < 0 || H < 1 || total > 0x7fffffffLL ||
      ranks < 1 || ranks > PA_MAX_RANKS || kc < PA_KS || kc > PA_MAX_CHUNK || kc % PA_KS ||
      cpr < 1 || (long long)ranks * cpr < chunks || (long long)(ranks - 1) * cpr >= chunks ||
      !tile::aligned16(k_pool) || !tile::aligned16(v_pool) || !tile::aligned16(q) ||
      !tile::aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
#define DTF_PAGED_ARGS q, k_pool, v_pool, table, q_pos, out, B, H, S, D, NB, bs, MB, ranks, kc, \
                       cpr, scale, stream
  switch (D) {
    case 8:
    case 16: return launch_dk<T, 16>(DTF_PAGED_ARGS);
    case 32: return launch_dk<T, 32>(DTF_PAGED_ARGS);
    case 64: return launch_dk<T, 64>(DTF_PAGED_ARGS);
    case 128: return launch_dk<T, 128>(DTF_PAGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DTF_PAGED_ARGS
}

}  // namespace

extern "C" {

int paged_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                        const void* table, const void* q_pos, void* out, int B, int H, int S,
                        int D, int NB, int bs, int MB, int ranks, int kc, int cpr, float scale,
                        void* stream) {
  return launch<float>(q, k_pool, v_pool, table, q_pos, out, B, H, S, D, NB, bs, MB, ranks, kc,
                       cpr, scale, stream);
}

int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                         const void* table, const void* q_pos, void* out, int B, int H, int S,
                         int D, int NB, int bs, int MB, int ranks, int kc, int cpr, float scale,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, q_pos, out, B, H, S, D, NB, bs, MB,
                               ranks, kc, cpr, scale, stream);
}

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
