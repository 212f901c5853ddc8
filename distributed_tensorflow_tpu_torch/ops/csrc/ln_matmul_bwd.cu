// Fused LayerNorm + matmul backward for Hopper (sm_90a), plain C interface
// (ctypes): the kernels behind the backward of y = LN(x; gamma, beta) @ w + bias.
//
// Replaces, in distributed_tensorflow_tpu/ops/fused_ln_matmul.py:
//   ln_bwd_dh + ln_bwd_dx_rows  <- _bwd_dx_kernel  dh = dy @ w^T (f32), then the
//                                 coupled LayerNorm backward dx = (dh*gamma - m1 -
//                                 xhat*m2) * rstd with m1 = mean(dh*gamma), m2 =
//                                 mean(dh*gamma*xhat) over the row, and dgamma =
//                                 sum dh*xhat, dbeta = sum dh, dbias = sum dy (sums
//                                 over the rows, f32)
//   ln_bwd_dw  <- _bwd_dw_kernel  dw = h^T @ dy, h = (xhat*gamma + beta) rounded to
//                                 x's dtype, summed over the rows in f32 and cast to
//                                 w's dtype (one dtype for x, w, dy here)
// x is [M, d] (the raw residual rows), w [d, n] read through its strides (the
// contiguous array, or the transposed view of an nn.Linear weight [n, d]),
// dy [M, n] (already rounded to the forward's output dtype), gamma/beta [d] f32.
// Row statistics as the forward kernel takes them: the f32 mean, then the mean
// of squared deviations, rstd = rsqrt(var + eps).
//
// What bounds them on this card: at gpt_small's training shapes (M = 8192,
// d = 768, n = 768 or 3072, bf16) both are bound by operations (one
// 2*M*d*n product each) except dx at n = 768, which is bound by bytes
// (PERF.md).
//
// dx is two kernels (and one reduction) behind one entry point. The LayerNorm
// backward is row-local over the WHOLE d (m1 and m2 need every column of dh),
// so the product and the row pass are split, and dh makes one round trip
// through a workspace ([M, d] f32, 25 MB at gpt_small, much of it in L2):
//  1. ln_bwd_dh_kernel: dh = dy @ w^T as an ordinary 2-D tiled product. Each
//     CTA owns a 128 x 128 output tile (rows of dy x columns of d; 384 CTAs,
//     two an SM, at gpt_small), so w is read from L2 once per 128 rows, not
//     once per 32 as the earlier whole-row CTA did. Its operands stream
//     through a 3-stage ring of cp.async.cg 16-byte copies, 128 bytes of n a
//     stage (the ragged edges zero-filled by the src-size operand), one
//     __syncthreads per stage. 8 warps (2 x 4) each run mma.sync m16n8k16
//     bf16 over a 64 x 32 register tile, fed by ldmatrix.x4: dy's tile as it
//     lies (n contiguous), w's with .trans when d is contiguous (the model's
//     linear.weight.t()) and without when n is. Shared rows are padded by 16
//     bytes, which keeps ldmatrix free of bank conflicts (tile_mma.cuh). K
//     runs in one fixed order. f32 inputs take the same tiling with f32 FMAs
//     on CUDA cores (exact to f32 rounding; never the timed path). The CTAs
//     of the first
//     column tile of d also sum each staged dy tile over its rows (dbias)
//     into a partial [M / 128, n].
//  2. ln_bwd_dx_rows_kernel: each warp takes two rows side by side (twice the
//     loads in flight), computes their statistics (written as mean and rstd,
//     the dw kernel's input), forms dxhat, m1, m2 and writes dx; its lanes
//     keep running dgamma, dbeta sums of their columns in registers, folded
//     in warp order into the CTA's partial at the end.
//  3. reduce2_kernel adds the row pass's and dbias's partials, fixed order.
// What bounds it (PERF.md): the product runs at about 200 TFLOP/s, below the
// tensor cores' rate (mma.sync, not wgmma; 384 tiles on 264 CTA slots are
// 1.45 waves) and below L2's (a 128 x 128 tile does 64 operations per byte it
// reads); the row pass moves ~50 MB at about half the HBM rate, bound by the
// latency of its row-local reductions. Nothing limits d but the workspace: no
// whole row sits in shared memory. Later: wgmma and TMA for the product.
//
// dw is the same tiled product with the contraction over the rows: CTA
// (tile, c) owns a 128 x 256 tile of dw (columns of d x columns of n) and
// sums h^T dy over the rows of chunk c. A stage of the ring holds 128 bytes'
// worth of rows of x (the tile's 128 columns of d), of dy (its columns of n)
// and the rows' mean and rstd (the dx row pass writes them: a dw CTA sees
// only a slice of each row, so it cannot take the statistics itself). Once a
// stage lands, the CTA rewrites its x tile in place as h = (x - mean) * rstd
// * gamma + beta, rounded to x's dtype (gamma, beta of the thread's columns
// in registers), behind one barrier; h never reaches device memory. Both
// operands lie row-index-major, so both reach mma.sync through
// ldmatrix.x4.trans. What bounds it: 2*M*d*n operations; the tiles are too
// few to fill the card (36 at gpt_small's n = 768, 144 at 3072, on 132 SMs),
// hence the split over M.
//
// Reductions over M (dgamma, dbeta, dbias, dw) use no float atomics: the rows
// are dealt to G chunks, each CTA sums its chunk in a fixed order into a
// workspace, and reduce_kernel (dw) or reduce2_kernel (dx) adds the G
// partials of each output in a fixed order. G is a function of the shapes
// and the SM count alone (the wrapper's dx_plan, dw_plan), so a step is
// bitwise repeatable run to run on one card.
//
// Layout requirements (the wrapper checks, the launchers re-check): d and n
// multiples of 8; x, dy, dx contiguous with 16-byte aligned bases; w with a
// unit stride in one dim, the other a multiple of the 16-byte vector. Any M:
// rows past M are zero in every staged tile and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using namespace tile;

constexpr int DH_BM = tile::BM;  // rows of dy (and dh) per tile: 2 warps of 64
constexpr int DH_BN = 128;       // columns of d per tile
constexpr int DH_WN = 32;        // columns of d per warp
constexpr int DH_KB = tile::STAGE_BYTES;  // bytes of depth (along n) per stage
constexpr int DH_STAGES = tile::STAGES;
constexpr int DH_MIN_CTAS = 2;   // CTAs an SM keeps resident (caps the registers)
constexpr int DH_WARPS = tile::WARPS;
constexpr int DH_THREADS = tile::THREADS;

// The shared-memory ring of the dh product. A stage holds the dy tile As
// [BM][LDA] (n contiguous) and w's tile, either Bs[BN][LDK] (w with n
// contiguous, sn == 1) or Bs[BK][LDN] (d contiguous, sk == 1); every row
// padded by 16 bytes. BK, the depth of a stage, is DH_KB bytes of n. Then
// dbias's per-warp column sums, double-buffered: [2][WARPS][BK] f32.
template <typename T>
struct Dh {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BK = DH_KB / sizeof(T);
  static constexpr int NJ = DH_WN / 8;  // m16n8 fragments across a warp's columns
  static constexpr int LDA = BK + V, LDK = BK + V, LDN = DH_BN + V;
  static constexpr int A_ELEMS = DH_BM * LDA;
  static constexpr int B_ELEMS = DH_BN * LDK > BK * LDN ? DH_BN * LDK : BK * LDN;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM =
      sizeof(T) * (size_t)STAGE * DH_STAGES + sizeof(float) * 2 * DH_WARPS * BK;
};

template <typename T>
__device__ __forceinline__ void dh_load(T* As, T* Bs, const T* __restrict__ dy,
                                        const T* __restrict__ w, long long sk, long long sn,
                                        int M, int d, int n, int m0, int j0, int k0) {
  using S = Dh<T>;
  constexpr int V = S::V, BK = S::BK;
  copy_tile<T, DH_BM * BK / V, BK / V>(As, S::LDA, dy, n, m0, M, k0, n);
  if (sn == 1)  // w[j, k], k contiguous: Bs[j][k]
    copy_tile<T, DH_BN * BK / V, BK / V>(Bs, S::LDK, w, sk, j0, d, k0, n);
  else  // w[j, k], j contiguous: Bs[k][j]
    copy_tile<T, DH_BN * BK / V, DH_BN / V>(Bs, S::LDN, w, sn, k0, n, j0, d);
}

// dbias of one staged dy tile: warp w sums the rows w, w + WARPS, ... of
// its columns in order into red[w][c] (lane c; f32 stages are 16 wide)
template <typename T>
__device__ __forceinline__ void dh_bias_rows(float* red, const T* As, int warp, int lane) {
  using S = Dh<T>;
  for (int c = lane; c < S::BK; c += 32) {
    float s = 0.f;
    for (int r = warp; r < DH_BM; r += DH_WARPS) s += to_f32(As[r * S::LDA + c]);
    red[warp * S::BK + c] = s;
  }
}

// ... then one warp adds the warps' sums in order: bias_part[k0 + c]
template <typename T>
__device__ __forceinline__ void dh_bias_out(float* __restrict__ bias_part, const float* red,
                                           int k0, int n, int lane) {
  using S = Dh<T>;
  for (int c = lane; c < S::BK && k0 + c < n; c += 32) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < DH_WARPS; ++q) s += red[q * S::BK + c];
    bias_part[k0 + c] = s;
  }
}

// grid (M tiles x d tiles), d fastest so the CTAs that share a dy tile run
// together: CTA (mt, jt) writes dh[mt*BM.., jt*BN..] = dy @ w^T in f32; the
// CTAs with jt == 0 also write bias_part[mt][k] = sum of dy[mt*BM.., k] over
// the tile's rows (warp 0 adds the warps' sums one stage behind).
template <typename T>
__global__ void __launch_bounds__(DH_THREADS, DH_MIN_CTAS)
ln_bwd_dh_kernel(const T* __restrict__ dy, const T* __restrict__ w, long long sk, long long sn,
                 float* __restrict__ dh, float* __restrict__ bias_part, int M, int d, int n) {
  using S = Dh<T>;
  constexpr int BK = S::BK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(ring + DH_STAGES * S::STAGE);
  const int dtiles = (d + DH_BN - 1) / DH_BN;
  const int mt = blockIdx.x / dtiles, j0 = blockIdx.x % dtiles * DH_BN, m0 = mt * DH_BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * DH_WN;
  const int nk = (n + BK - 1) / BK;
  const bool kmajor = sn == 1, bias = j0 == 0;
  float* bias_row = bias_part + (size_t)mt * n;
  float acc[4][S::NJ][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < DH_STAGES - 1; ++s) {
    if (s < nk)
      dh_load(ring + s * S::STAGE, ring + s * S::STAGE + S::A_ELEMS, dy, w, sk, sn, M, d, n, m0,
              j0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<DH_STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; stage kt - 1 is consumed
    const int nx = kt + DH_STAGES - 1;
    if (nx < nk) {
      T* st = ring + nx % DH_STAGES * S::STAGE;
      dh_load(st, st + S::A_ELEMS, dy, w, sk, sn, M, d, n, m0, j0, nx * BK);
    }
    cp_async_commit();
    const T* As = ring + kt % DH_STAGES * S::STAGE;
    if (bias) {
      dh_bias_rows(red + (kt & 1) * DH_WARPS * BK, As, warp, lane);
      if (warp == 0 && kt > 0)
        dh_bias_out<T>(bias_row, red + ((kt - 1) & 1) * DH_WARPS * BK, (kt - 1) * BK, n, lane);
    }
    if (kmajor)  // one copy of the loop per w layout: constant pitches
      warp_tile<S::NJ, false, BK>(acc, As, S::LDA, As + S::A_ELEMS, S::LDK, false, wm, wn, lane);
    else
      warp_tile<S::NJ, false, BK>(acc, As, S::LDA, As + S::A_ELEMS, S::LDN, true, wm, wn, lane);
  }
  cp_async_wait<0>();
  if (bias) {  // the last stage's dbias sums
    __syncthreads();
    if (warp == 0)
      dh_bias_out<T>(bias_row, red + ((nk - 1) & 1) * DH_WARPS * BK, (nk - 1) * BK, n, lane);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) {
        const int c = j0 + wn + 8 * j + 2 * t;
        if (c < d)
          *reinterpret_cast<float2*>(dh + (size_t)r * d + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

constexpr int RW_WARPS = 8;
constexpr int RW_THREADS = 32 * RW_WARPS;
constexpr int RW_BM = 2 * RW_WARPS;  // rows of a row-pass tile: 2 a warp
constexpr int RW_CACHE = 3;  // 256-column chunks of a row summed in registers

__device__ __forceinline__ void warp_sum2(float (&v)[2]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    v[1] += __shfl_xor_sync(0xffffffffu, v[1], o);
  }
}

// Two rows of the LayerNorm backward, one warp, side by side so that twice
// the loads are in flight (rows at x + off[p], p = 0, 1; ok[p] false for a
// row past M). Lane l takes the 8-column chunks k = 8l, 8l + 256, ...; the
// first RW_CACHE of them hold x in registers (loaded once, dh prefetched
// beside it) and add the rows' dh*xhat and dh, row 0 then row 1, to the
// lane's running dgamma, dbeta sums (ag, ab); the rest are read again from
// memory in each pass. Writes dx; returns each row's (mean, rstd) in ms.
template <typename T>
__device__ __forceinline__ void dx_rows(const T* __restrict__ x, const float* __restrict__ dh,
                                        const float* __restrict__ gamma, T* __restrict__ dx,
                                        const size_t (&off)[2], const bool (&ok)[2], int d,
                                        float eps, int lane, float (&ag)[RW_CACHE][8],
                                        float (&ab)[RW_CACHE][8], float2 (&ms)[2]) {
  Raw8<T> xc[2][RW_CACHE];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < RW_CACHE; ++i) {
      const int k = 8 * lane + 256 * i;
      if (ok[p] && k < d) {
        load_raw(x + off[p] + k, xc[p][i]);
        asm volatile("prefetch.global.L1 [%0];" ::"l"(dh + off[p] + k));
      }
    }
  // each pass visits every chunk of both rows: f(p, k, x[8], the chunk's
  // dgamma and dbeta sums); past the cached chunks the sums go to a scratch
  // pair nobody reads
  auto pass = [&](auto&& f) {
#pragma unroll
    for (int i = 0; i < RW_CACHE; ++i) {
      const int k = 8 * lane + 256 * i;
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (ok[p] && k < d) {
          float v[8];
          unpack(xc[p][i], v);
          f(p, k, v, ag[i], ab[i]);
        }
    }
    float sg[8] = {}, sb[8] = {};
    for (int k = 8 * lane + 256 * RW_CACHE; k < d; k += 256)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (ok[p]) {
          float v[8];
          load8(x + off[p] + k, v);
          f(p, k, v, sg, sb);
        }
  };
  using F8 = float[8];
  float s[2] = {0.f, 0.f}, mu[2], rs[2];
  pass([&](int p, int, const F8& v, F8&, F8&) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s[p] += v[q];
  });
  warp_sum2(s);
#pragma unroll
  for (int p = 0; p < 2; ++p) mu[p] = s[p] / d, s[p] = 0.f;
  pass([&](int p, int, const F8& v, F8&, F8&) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s[p] += (v[q] - mu[p]) * (v[q] - mu[p]);
  });
  warp_sum2(s);
#pragma unroll
  for (int p = 0; p < 2; ++p) rs[p] = rsqrtf(s[p] / d + eps);
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  pass([&](int p, int k, const F8& v, F8&, F8&) {
    float h[8], gm[8];
    load8(dh + off[p] + k, h);
    load8(gamma + k, gm);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float dxh = h[q] * gm[q];
      s1[p] += dxh;
      s2[p] += dxh * ((v[q] - mu[p]) * rs[p]);
    }
  });
  warp_sum2(s1);
  warp_sum2(s2);
  float m1[2], m2[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) m1[p] = s1[p] / d, m2[p] = s2[p] / d;
  pass([&](int p, int k, const F8& v, F8& g, F8& b) {
    float h[8], gm[8], o[8];
    load8(dh + off[p] + k, h);
    load8(gamma + k, gm);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float xh = (v[q] - mu[p]) * rs[p];
      o[q] = (h[q] * gm[q] - m1[p] - xh * m2[p]) * rs[p];
      g[q] += h[q] * xh, b[q] += h[q];
    }
    store8(dx + off[p] + k, o);
  });
#pragma unroll
  for (int p = 0; p < 2; ++p) ms[p] = make_float2(mu[p], rs[p]);
}

// grid (G): CTA c takes the row tiles c, c+G, ...; warp w writes dx and the
// mean and rstd of the tile's rows w and w + RW_WARPS (dx_rows), its lanes
// summing dh*xhat and dh of the first HEAD = 256*RW_CACHE columns over the
// warp's rows in order. Columns past HEAD are summed per tile, the rows in
// order, by one thread per column. At the end the warps' sums are added in
// warp order into part[c][2d], which this CTA alone writes.
template <typename T>
__global__ void __launch_bounds__(RW_THREADS)
ln_bwd_dx_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ dh, T* __restrict__ dx,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      float* __restrict__ part, int M, int d, int G, float eps) {
  constexpr int HEAD = 256 * RW_CACHE;  // columns summed in registers
  __shared__ float st[2][RW_BM];
  __shared__ float fold[2][HEAD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mtiles = (M + RW_BM - 1) / RW_BM;
  float* run = part + (size_t)blockIdx.x * 2 * d;
  for (int c = HEAD + tid; c < d; c += RW_THREADS) run[c] = run[d + c] = 0.f;
  float ag[RW_CACHE][8], ab[RW_CACHE][8];
#pragma unroll
  for (int i = 0; i < RW_CACHE; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) ag[i][q] = ab[i][q] = 0.f;
  for (int mt = blockIdx.x; mt < mtiles; mt += G) {
    const int r0 = mt * RW_BM, rows = min(RW_BM, M - r0);
    __syncthreads();  // the previous tile's column pass is done with st
    {  // this warp's rows of the tile: warp and warp + RW_WARPS
      const int rr[2] = {warp, warp + RW_WARPS};
      const size_t off[2] = {(size_t)(r0 + rr[0]) * d, (size_t)(r0 + rr[1]) * d};
      const bool ok[2] = {rr[0] < rows, rr[1] < rows};
      float2 ms[2];
      dx_rows(x, dh, gamma, dx, off, ok, d, eps, lane, ag, ab, ms);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (lane == 0 && ok[p]) {
          st[0][rr[p]] = ms[p].x, st[1][rr[p]] = ms[p].y;
          mean[r0 + rr[p]] = ms[p].x, rstd[r0 + rr[p]] = ms[p].y;
        }
    }
    if (d <= HEAD) continue;
    __syncthreads();
    // the columns past HEAD: the tile's column sums, the rows in order
    for (int c = HEAD + tid; c < d; c += RW_THREADS) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        const size_t o = (size_t)(r0 + r) * d + c;
        const float h = dh[o];
        sg += h * ((to_f32(x[o]) - st[0][r]) * st[1][r]);
        sb += h;
      }
      run[c] += sg;
      run[d + c] += sb;
    }
  }
  for (int w = 0; w < RW_WARPS; ++w) {  // fold the warps' sums, in warp order
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < RW_CACHE; ++i) {
        const int k = 8 * lane + 256 * i;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          fold[0][k + q] = (w ? fold[0][k + q] : 0.f) + ag[i][q];
          fold[1][k + q] = (w ? fold[1][k + q] : 0.f) + ab[i][q];
        }
      }
    }
    __syncthreads();
  }
  for (int c = tid; c < d && c < HEAD; c += RW_THREADS)
    run[c] = fold[0][c], run[d + c] = fold[1][c];
}

// out[i] = sum over g < G of ws[g*len + i], in a fixed order: a block takes
// 32 outputs; warp w sums g = w, w + 8, ... in order, then the 8 warps' sums
// are added in order. Two such reductions in one launch: blocks [0, b0) take
// (ws0, G0, len0) -> out0, the rest (ws1, G1, len1) -> out1.
__global__ void __launch_bounds__(256)
reduce2_kernel(const float* __restrict__ ws0, float* __restrict__ out0, int G0, int len0,
               const float* __restrict__ ws1, float* __restrict__ out1, int G1, int len1,
               int b0) {
  __shared__ float part[8][32];
  const bool first = (int)blockIdx.x < b0;
  const float* ws = first ? ws0 : ws1;
  float* out = first ? out0 : out1;
  const int G = first ? G0 : G1, len = first ? len0 : len1;
  const int i = ((int)blockIdx.x - (first ? 0 : b0)) * 32 + (threadIdx.x & 31);
  const int w = threadIdx.x >> 5;
  float s = 0.f;
  if (i < len)
    for (int g = w; g < G; g += 8) s += ws[(size_t)g * len + i];
  part[w][threadIdx.x & 31] = s;
  __syncthreads();
  if (w == 0 && i < len) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += part[q][threadIdx.x];
    out[i] = t;
  }
}


// ---------------------------------------------------------------------------
// dw
// ---------------------------------------------------------------------------

// The ring of the dw product, for output tiles of 128 columns of d x BN = 4
// WN columns of n (WN = 64: 128 x 256 timed faster than 128 x 128 at
// gpt_small's shapes on an H100, PERF.md). One CTA an SM: the ring takes
// ~155 KB of shared memory (the wrapper's TILE_CTAS_PER_SM). A stage holds
// BK rows (128 bytes of a row of the tile's operands): x's [BK][LDX] (d
// contiguous; rewritten as h in place), dy's [BK][LDD] (n contiguous), then
// the rows' mean [BK] and rstd [BK] f32.
template <typename T>
struct Dw {
  static constexpr int WN = 64;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BN = 4 * WN;
  static constexpr int BK = tile::STAGE_BYTES / sizeof(T);
  static constexpr int NJ = WN / 8;
  static constexpr int LDX = pad_ld<T>(BM), LDD = pad_ld<T>(BN);
  static constexpr int X_ELEMS = BK * LDX, D_ELEMS = BK * LDD;
  static constexpr size_t STAGE = sizeof(T) * (X_ELEMS + D_ELEMS) + sizeof(float) * 2 * BK;
  static constexpr size_t SMEM = STAGE * STAGES;
  static_assert(STAGE % 16 == 0, "stages stay 16-byte aligned");
};

template <typename T>
__device__ __forceinline__ void dw_load(unsigned char* st, const T* __restrict__ x,
                                        const T* __restrict__ dy, const float* __restrict__ mean,
                                        const float* __restrict__ rstd, int M, int d, int n,
                                        int r0, int m0, int n0) {
  using S = Dw<T>;
  constexpr int V = S::V, BK = S::BK;
  T* Xs = reinterpret_cast<T*>(st);
  float* ms = reinterpret_cast<float*>(Xs + S::X_ELEMS + S::D_ELEMS);
  copy_tile<T, BK * BM / V, BM / V>(Xs, S::LDX, x, d, r0, M, m0, d);
  copy_tile<T, BK * S::BN / V, S::BN / V>(Xs + S::X_ELEMS, S::LDD, dy, n, r0, M, n0, n);
  if (threadIdx.x < 2 * BK) {  // mean, then rstd, one row a thread
    const int r = threadIdx.x % BK;
    const bool ok = r0 + r < M;
    cp_async4(ms + threadIdx.x, (threadIdx.x < BK ? mean : rstd) + (ok ? r0 + r : 0), ok);
  }
}

// grid (d tiles x n tiles, G), d fastest: CTA (tile, c) sums the tile's
// block of h^T @ dy over the row blocks of chunk c (BK rows each; chunk c
// takes blocks [c*nb/G, (c+1)*nb/G) in order) into ws[c][d][n]. Rows past M
// stage as zeros (h = beta there, dy = 0). Warp w holds rows wm.. of d and
// columns wn.. of n; thread i rewrites the x chunks i, i + THREADS, ... of
// each stage, all in the same columns of d, whose gamma and beta it keeps.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ln_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 float* __restrict__ ws, int M, int d, int n, int G) {
  using S = Dw<T>;
  constexpr int V = S::V, BK = S::BK, P = BM / V;
  static_assert(THREADS % P == 0, "a thread's chunks share their columns");
  extern __shared__ __align__(16) unsigned char smem[];
  const int dtiles = (d + BM - 1) / BM;
  const int m0 = blockIdx.x % dtiles * BM, n0 = blockIdx.x / dtiles * S::BN;
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * S::WN;
  const int nb = (M + BK - 1) / BK;
  const int b0 = (int)((long long)nb * c / G), nk = (int)((long long)nb * (c + 1) / G) - b0;
  // this thread's chunks: columns col.. of the tile, rows row0 + u * THREADS / P
  const int col = threadIdx.x % P * V, row0 = threadIdx.x / P;
  float gm[V], bt[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const bool ok = m0 + col + q < d;
    gm[q] = ok ? gamma[m0 + col + q] : 0.f;
    bt[q] = ok ? beta[m0 + col + q] : 0.f;
  }
  float acc[4][S::NJ][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      dw_load<T>(smem + s * S::STAGE, x, dy, mean, rstd, M, d, n, (b0 + s) * BK, m0, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; stage kt - 1 is consumed
    const int nx = kt + STAGES - 1;
    if (nx < nk)
      dw_load<T>(smem + nx % STAGES * S::STAGE, x, dy, mean, rstd, M, d, n,
                     (b0 + nx) * BK, m0, n0);
    cp_async_commit();
    T* Xs = reinterpret_cast<T*>(smem + kt % STAGES * S::STAGE);
    const float* ms = reinterpret_cast<const float*>(Xs + S::X_ELEMS + S::D_ELEMS);
#pragma unroll
    for (int u = 0; u < BK * P / THREADS; ++u) {
      const int r = row0 + u * (THREADS / P);
      ln_chunk(Xs + r * S::LDX + col, ms[r], ms[BK + r], gm, bt);
    }
    __syncthreads();  // h is whole
    warp_tile<S::NJ, true, BK>(acc, Xs, S::LDX, Xs + S::X_ELEMS, S::LDD, true, wm, wn, lane);
  }
  cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
  float* part = ws + (size_t)c * d * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= d) continue;
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) {
        const int col_n = n0 + wn + 8 * j + 2 * t;
        if (col_n < n)
          *reinterpret_cast<float2*>(part + (size_t)m * n + col_n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// out[i] = sum over g < G, in order, of ws[g*len + i], cast to TOut; four
// outputs a thread (len is a multiple of 4: n is one of 8)
template <typename TOut>
__global__ void __launch_bounds__(256)
reduce_kernel(const float4* __restrict__ ws, TOut* __restrict__ out, int G, long long len4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < len4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int g = 1; g < G; ++g) {
      const float4 v = ws[(size_t)g * len4 + i];
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    out[4 * i] = from_f32<TOut>(s.x), out[4 * i + 1] = from_f32<TOut>(s.y);
    out[4 * i + 2] = from_f32<TOut>(s.z), out[4 * i + 3] = from_f32<TOut>(s.w);
  }
}

bool shapes_ok(int M, int d, int n, int G) {
  return M >= 1 && d >= 8 && n >= 8 && d % 8 == 0 && n % 8 == 0 && G >= 1 && G <= 65535;
}

template <typename T>
int launch_dx(const void* x, const void* gamma, const void* w, long long sk, long long sn,
              const void* dy, void* dx, void* mean, void* rstd, void* ws, void* out, int M,
              int d, int n, int G, float eps, void* stream) {
  if (!shapes_ok(M, d, n, G) || !w_ok<T>(w, sk, sn, d, n) || !aligned16(x) ||
      !aligned16(dy) || !aligned16(dx))
    return (int)cudaErrorInvalidValue;
  const long long mtiles = (M + DH_BM - 1) / DH_BM, tiles = mtiles * ((d + DH_BN - 1) / DH_BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // ws: dh [M][d], then the row pass's partials [G][2d], then dbias's [M tiles][n]
  float* dh = (float*)ws;
  float* rows_part = dh + (size_t)M * d;
  float* bias_part = rows_part + (size_t)G * 2 * d;
  cudaStream_t st = (cudaStream_t)stream;
  auto kern = ln_bwd_dh_kernel<T>;
  int e = set_smem(kern, Dh<T>::SMEM);
  if (e) return e;
  kern<<<(unsigned)tiles, DH_THREADS, Dh<T>::SMEM, st>>>((const T*)dy, (const T*)w, sk, sn, dh,
                                                          bias_part, M, d, n);
  e = (int)cudaGetLastError();
  if (e) return e;
  ln_bwd_dx_rows_kernel<T><<<G, RW_THREADS, 0, st>>>((const T*)x, (const float*)gamma, dh,
                                                     (T*)dx, (float*)mean, (float*)rstd,
                                                     rows_part, M, d, G, eps);
  e = (int)cudaGetLastError();
  if (e) return e;
  const int b0 = (2 * d + 31) / 32, b1 = (n + 31) / 32;
  reduce2_kernel<<<b0 + b1, 256, 0, st>>>(rows_part, (float*)out, G, 2 * d, bias_part,
                                          (float*)out + 2 * d, (int)mtiles, n, b0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw_tiles(const void* x, const void* gamma, const void* beta, const void* dy,
                    const void* mean, const void* rstd, void* ws, int M, int d, int n, int G,
                    cudaStream_t st) {
  using S = Dw<T>;
  const long long tiles = (long long)((d + BM - 1) / BM) * ((n + S::BN - 1) / S::BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = ln_bwd_dw_kernel<T>;
  int e = set_smem(kern, S::SMEM);
  if (e) return e;
  kern<<<dim3((unsigned)tiles, G), THREADS, S::SMEM, st>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (const T*)dy, (const float*)mean,
      (const float*)rstd, (float*)ws, M, d, n, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* gamma, const void* beta, const void* dy,
              const void* mean, const void* rstd, void* ws, void* dw, int M, int d, int n, int G,
              void* stream) {
  if (!shapes_ok(M, d, n, G) || !aligned16(x) || !aligned16(dy) || !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = launch_dw_tiles<T>(x, gamma, beta, dy, mean, rstd, ws, M, d, n, G, st);
  if (e) return e;
  const long long len4 = (long long)d * n / 4, blocks = (len4 + 255) / 256;
  reduce_kernel<T><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      (const float4*)ws, (T*)dw, G, len4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define DTF_DX_ARGS                                                                        \
  const void *x, const void *gamma, const void *w, long long sk, long long sn,             \
      const void *dy, void *dx, void *mean, void *rstd, void *ws, void *out, int M, int d, \
      int n, int G, float eps, void *stream
#define DTF_DX_PASS x, gamma, w, sk, sn, dy, dx, mean, rstd, ws, out, M, d, n, G, eps, stream

int ln_bwd_dx_f32(DTF_DX_ARGS) { return launch_dx<float>(DTF_DX_PASS); }
int ln_bwd_dx_bf16(DTF_DX_ARGS) { return launch_dx<__nv_bfloat16>(DTF_DX_PASS); }

#define DTF_DW_ARGS                                                                  \
  const void *x, const void *gamma, const void *beta, const void *dy, const void *mean, \
      const void *rstd, void *ws, void *dw, int M, int d, int n, int G, void *stream
#define DTF_DW_PASS x, gamma, beta, dy, mean, rstd, ws, dw, M, d, n, G, stream

int ln_bwd_dw_f32(DTF_DW_ARGS) { return launch_dw<float>(DTF_DW_PASS); }
int ln_bwd_dw_bf16(DTF_DW_ARGS) { return launch_dw<__nv_bfloat16>(DTF_DW_PASS); }

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
