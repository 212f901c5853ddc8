// Fused 1x1-conv + BatchNorm kernels for Hopper (sm_90a), plain C interface
// (ctypes): the forward and its three backward kernels.
//
// Replaces, in distributed_tensorflow_tpu/ops/fused_conv_bn.py:
//   conv_bn_fwd         <- _fwd_kernel         y = [relu](x*scale+shift) @ w, and the
//                                              column sum / sum of squares of y
//   conv_bn_bwd_dx      <- _bwd_dx_kernel      dx, dscale, dshift (two-pass, part 1)
//   conv_bn_bwd_dw      <- _bwd_dw_kernel      dw (two-pass, part 2)
//   conv_bn_bwd_single  <- _bwd_single_kernel  dx, dw, dscale, dshift in one sweep
// x is [M, cin] (the raw previous conv output, NHWC rows), w is [cin, cout]
// read through its strides (either dim may be the unit one: the OIHW conv
// weight viewed as [cin, cout] has strides (1, cin)), scale/shift are the
// per-cin f32 affine of the previous BatchNorm (the prologue), y is [M, cout].
//
// Numerics (as the Pallas kernels): the prologue x*scale+shift (+ReLU) runs in
// f32, the product rounded before the add (as the plain version computes it:
// no fma), and h is rounded to x's dtype before the product; products
// accumulate in f32; y is rounded to its dtype and the statistics are taken
// from the ROUNDED y (what an unfused consumer would read back). In the
// backward the output gradient g = dy + dsum + 2*y*dssq (the stats outputs'
// cotangents folded in) is rounded to dy's dtype before both products; the
// ReLU mask is x*scale+shift > 0 in f32; dx = dh*scale rounded to x's dtype;
// dscale = sum_rows dh*x, dshift = sum_rows dh; dw in f32.
//
// What bounds them on this card: at ResNet-50's batch-256 shapes most are
// bound by bytes (x, y, dy, dx are up to 802816 rows; w is at most 4 MB), a
// few at stage 3 by operations (the bound per shape is in PERF.md). The
// design keeps the fused tensors out of device memory, as on the TPU: the
// prologue runs while a tile of x is staged in shared memory (the normalised
// tensor is never written), the statistics are summed from the y tile in
// shared memory (y is never read back), and the backward recomputes h from
// x. Products are mma.sync m16n8k16 bf16 tiles (f32 inputs: the same tile
// loops on CUDA cores, for checks). All four kernels are built on
// tile_mma.cuh (the cp.async ring, ldmatrix, the mma.sync warp tile).
//
// The forward kernel: y = h w is a 2-D tiled product, each CTA 128 rows of
// M x BN columns of cout (BN 64, 128 or 256: the wrapper's plan takes the
// width that pads cout least), 8 warps of 64 x BN/4 register tiles,
// contracted over cin through a cp.async.cg ring of 128-byte stages (ragged
// edges zero-filled). w lands as it lies (ldmatrix for the OIHW view,
// ldmatrix.trans for a contiguous [cin, cout] w), once for the CTA's sweep
// when cin fits one stage; h = prologue(x) is written over the staged x
// behind one barrier, rows past M left zero. One persistent CTA an SM
// takes its M tiles in turn as one sequence of stages, so the next tile's
// stages load during this tile's epilogue; the epilogue rounds the
// accumulators, passes each warp's rows of y through a shared buffer for
// 16-byte stores and keeps the column sums of the rounded y and of its
// squares in registers across the CTA's tiles. What bounds it at each
// shape is in PERF.md: at stage 0 HBM (68-76% of the byte bound), past it
// the per-stage chain of one CTA of 8 warps an SM (150-270 TFLOP/s).
//
// The dw kernel is built on tile_mma.cuh as LN+matmul's dw is: dw = h^T g
// is a 2-D tiled product, each CTA a 128 x BN block of dw (rows of cin x
// columns of cout; BN 128 or 256, the wrapper's launch plan), 8 warps of 64 x
// BN/4 mma.sync register tiles, contracted over one contiguous range of M
// rows through a cp.async.cg ring (ragged edges zero-filled). A stage holds
// 64 rows (bf16) of x, dy and, with the statistics, y, each as it lies
// (row-index-major), and ldmatrix.trans reads both operands from there:
// nothing is transposed by scalar stores. h = prologue(x) is written over
// the staged x and g over the staged dy, behind one barrier; rows past M stay
// zero in g's slot (g = 0 there, not dsum). Each chunk of rows writes its
// f32 partial of the tile and reduce_kernel sums them in chunk order. What
// bounds it (PERF.md): at every ResNet-50 shape the per-stage chain of one
// CTA of 8 warps an SM (the in-place passes, their barrier, the mma.sync
// product), at 140-170 TFLOP/s whatever bytes the shape moves, not HBM.
//
// The dx kernel is built on tile_mma.cuh (the LN+matmul products'
// machinery). dh = g @ w^T is a 2-D tiled product: each CTA owns 128 rows of
// M x 128 columns of cin (8 warps of 64 x 32 mma.sync register tiles) and
// contracts over cout through a cp.async.cg ring of 128-byte stages
// (ragged edges zero-filled). w lands as it lies, and its fragments come from
// ldmatrix.trans for the OIHW view (cin contiguous) and ldmatrix for a
// contiguous [cin, cout] w: nothing is transposed by scalar stores. With the
// statistics, the staged dy chunk is rewritten in place as g (y and the
// stage's dsum/dssq ride in the same stage) behind one barrier; without
// them y is never read. The epilogue works on the accumulators: the ReLU
// mask from the x tile (copied in by cp.async with the tile's first stage),
// dx = dh*scale in two-column stores, and the per-column sums of dh*x and
// dh kept in registers across the CTA's M tiles. One CTA an SM (~198 KB of
// shared memory) takes its M tiles in turn as one sequence of stages, so
// the next tile's first stages load during this tile's epilogue. What bounds
// it at each shape is in PERF.md: past stage 0 the per-stage loop of one CTA
// of 8 warps an SM (mma.sync, the g pass and its second barrier), not HBM.
//
// The single-pass kernel (ResNet-50's stage 0, where the f32 [cin, cout] dw
// fits one CTA's registers) fuses the two on the same machinery (ldmatrix
// fragments for both products, the cp.async ring, g formed in place, the
// epilogue from the registers): one persistent CTA an SM keeps w
// resident in shared memory and the whole dw accumulator in registers, and
// streams its 64-row M tiles of dy, y and x through a cp.async ring once,
// for dx, dscale, dshift and dw. Its bound is HBM (x, y, dy read once, dx
// written once) as long as the two mma.sync products, the g pass and the
// ring's barriers of a tile take less than its copies; the design at the
// kernel.
//
// Reductions over M (the statistics, dscale/dshift, dw) use no float atomics:
// the TPU kernels carry them across a sequential grid axis; here the M tiles
// are dealt to G chunks (chunk c takes tiles c, c+G, ...; in the dw kernel a
// contiguous range of row blocks), each CTA writes its chunk's partial to a
// workspace, and reduce_kernel sums the G partials of each output in chunk
// order. G is a function of the shapes and the card's SM count (the
// wrapper's), so a step is bitwise repeatable run to run.
//
// Layout requirements (the wrapper checks, the launchers re-check): cin and
// cout multiples of 8; x, y, dy, dx contiguous with 16-byte aligned bases; w
// with a unit stride in one dim, the other a multiple of 8 elements. Any M:
// rows past M are zero in every staged tile and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr size_t kSmemMax = 232448;  // the shared memory one CTA may hold (227 KB)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The previous BatchNorm's affine (+ReLU) of one f32 value: the product
// rounded, then the sum, as the plain version computes it (a contracted fma
// can put an x that cancels shift on the other side of the ReLU)
__device__ __forceinline__ float bn_act(float v, float scale, float shift, bool relu) {
  const float h = __fadd_rn(__fmul_rn(v, scale), shift);
  return relu ? fmaxf(h, 0.f) : h;
}

// The previous BatchNorm's per-cin affine (+ReLU); off: the identity.
struct Prologue {
  const float* scale;
  const float* shift;
  bool on, relu;
};

// h = [relu](x*scale + shift) on one staged chunk of V columns, in place in
// x's slot: f32 math and one rounding to T (sc, sh: the chunk's scale, shift)
template <typename T>
__device__ __forceinline__ void h_chunk(T* p, const float* sc, const float* sh, bool relu) {
  constexpr int V = 16 / sizeof(T);
  uint4 a = *reinterpret_cast<const uint4*>(p);
  T* e = reinterpret_cast<T*>(&a);
#pragma unroll
  for (int q = 0; q < V; ++q) e[q] = from_f32<T>(bn_act(to_f32(e[q]), sc[q], sh[q], relu));
  *reinterpret_cast<uint4*>(p) = a;
}

// ---------------------------------------------------------------------------
// forward: y = prologue(x) @ w, statistics of the rounded y
// ---------------------------------------------------------------------------

// The ring of the forward kernel (tile_mma.cuh's machinery). A CTA owns a
// tile::BM x BN output tile (rows of M x columns of cout; BN 64, 128 or
// 256, the wrapper's plan); 8 warps (2 x 4), each a 64 x BN/4 register
// tile. A stage is STAGE_BYTES deep along cin and holds x's tile As
// [BM][LDA] (cin contiguous; rewritten in place as h with the prologue),
// w's tile as it lies: Ws[BN][LDK] for the OIHW view (cin contiguous, sk
// == 1; ldmatrix) or Ws[BK][LDN] for a contiguous [cin, cout] w (sn == 1;
// ldmatrix.trans), then the stage's scale [BK] and shift [BK] f32 (copied
// only with the prologue). After the ring lie w's resident tile and the
// warps' y buffers [16][LDY].
//
// Two levers, each measured on an H100 (PERF.md; tools/conv_fwd_turns.py
// flips them): Y_VIA_SMEM passes each warp's rounded 16-row slice of y
// through its buffer for 16-byte stores of whole rows (two-column stores
// from the registers took 2.08x the time at 64->256, where y is 80% of the
// bytes); W_RESIDENT keeps w's tile in shared memory for the CTA's whole
// sweep when cin fits one stage, so the ring carries x alone (6.7% faster
// at 64->256, a wash elsewhere). As many bf16 stages as the 227 KB a CTA
// may hold take beside them, at most 4: 128 x 256 is 55,808 bytes a stage,
// so 3; 128 x 128 (37,376) and 128 x 64 (28,160) take 4. f32 (checks
// only, never timed): 2 stages of 32 of cin. One CTA an SM.
constexpr int kFwdCtasPerSm = 1;

template <typename T, int BN_>
struct Fwd {
  static constexpr bool W_RESIDENT = true;
  static constexpr bool Y_VIA_SMEM = true;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BN = BN_;
  static constexpr int WN = BN / 4;
  static constexpr int NJ = WN / 8;
  static constexpr int BK = tile::STAGE_BYTES / sizeof(T);
  static constexpr int LDA = tile::pad_ld<T>(BK), LDK = tile::pad_ld<T>(BK);
  static constexpr int LDN = tile::pad_ld<T>(BN), LDY = tile::pad_ld<T>(WN);
  static constexpr int A_ELEMS = tile::BM * LDA;
  static constexpr int B_ELEMS = BN * LDK > BK * LDN ? BN * LDK : BK * LDN;
  static constexpr size_t STAGE = sizeof(T) * (A_ELEMS + B_ELEMS) + sizeof(float) * 2 * BK;
  // after the ring: w's resident tile, then the warps' y buffers
  static constexpr size_t W_BYTES = W_RESIDENT ? sizeof(T) * B_ELEMS : 0;
  static constexpr size_t Y_BYTES = Y_VIA_SMEM ? sizeof(T) * tile::WARPS * 16 * LDY : 0;
  static constexpr int FIT = (int)((kSmemMax - W_BYTES - Y_BYTES) / STAGE);
  static constexpr int STAGES = sizeof(T) == 2 ? (FIT < 4 ? FIT : 4) : 2;
  static constexpr size_t SMEM = STAGE * STAGES + W_BYTES + Y_BYTES;
  // the prologue pass: 16-byte chunks a row of x's slot
  static constexpr int P = BK / V;
  static_assert(STAGES >= 2 && STAGES <= FIT && STAGE % 16 == 0, "a ring of two stages or more");
  static_assert(4 * WN == BN && NJ % 2 == 0, "8 warps of 64 x WN");
  static_assert(tile::THREADS % P == 0 && tile::BM * P % tile::THREADS == 0 &&
                    2 * BK / 4 <= tile::THREADS,
                "each thread rewrites whole rows' chunks in fixed columns; one copies scale");
  static_assert(4 * BN * sizeof(float) <= STAGE * STAGES, "the statistics' scratch");
};

// a, b rounded to T in place and, if store, written to p as a two-column pair
__device__ __forceinline__ void round_store2(float* p, float& a, float& b, bool store) {
  if (store) store2(p, a, b);
}
__device__ __forceinline__ void round_store2(__nv_bfloat16* p, float& a, float& b, bool store) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  if (store) *reinterpret_cast<__nv_bfloat162*>(p) = h;
  const float2 r = __bfloat1622float2(h);
  a = r.x, b = r.y;
}

// grid (cout tiles, G), cout tiles fastest so the CTAs that read the same x
// rows run side by side: CTA (n, c) writes columns n*BN.. of y for the M
// tiles c, c+G, ... The CTA's stages of all its tiles form one sequence
// through the ring, so the next tile's stages load while this tile's
// epilogue runs (at cin <= 64, a tile is one stage, and w's tile is
// resident). Each thread rewrites the same columns of every stage as h,
// behind one barrier, with the stage's scale and shift. Rows past M and
// columns past cin stay the zero fill (relu(shift) != 0 would put those
// rows into the statistics). The epilogue works on the accumulators: each
// pair is rounded to T, written to the warp's y buffer (16 rows at a time,
// then copied out in 16-byte chunks of whole rows) and summed (and
// squared) into the lane's running sums of its columns over every tile; at
// the end those are added over the warp's rows (shuffles), then the two
// row-warps in order into ws[0/1][c][cout].
template <typename T, int BN>
__global__ void __launch_bounds__(tile::THREADS, kFwdCtasPerSm)
conv_bn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, long long sk, long long sn,
                   Prologue pro, T* __restrict__ y, float* __restrict__ ws, int M, int cin,
                   int cout, int G, bool stats) {
  using S = Fwd<T, BN>;
  constexpr int V = S::V, BK = S::BK, BM = tile::BM, P = S::P, NJ = S::NJ, WN = S::WN;
  constexpr int STAGES = S::STAGES, THREADS = tile::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Wr = reinterpret_cast<T*>(smem + STAGES * S::STAGE);  // w's resident tile
  const int n0 = blockIdx.x * BN, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * WN;
  const int mtiles = (M + BM - 1) / BM, nk = (cin + BK - 1) / BK;
  const int tiles = c < mtiles ? (mtiles - 1 - c) / G + 1 : 0;
  const int total = tiles * nk;  // the CTA's stages, all tiles in order
  const bool kmajor = sk == 1;   // w's tile as it lies: Ws[BN][LDK], else Ws[BK][LDN]
  const bool resident = S::W_RESIDENT && nk == 1;
  auto load_w = [&](T* Ws, int k0) {
    if (kmajor)
      tile::copy_tile<T, BN * BK / V, BK / V>(Ws, S::LDK, w, sn, n0, cout, k0, cin);
    else
      tile::copy_tile<T, BK * BN / V, BN / V>(Ws, S::LDN, w, sk, k0, cin, n0, cout);
  };
  auto load = [&](int f) {  // stage f into its ring slot; past M, cin, cout zero-filled
    T* As = reinterpret_cast<T*>(smem + f % STAGES * S::STAGE);
    const int k0 = f % nk * BK;
    tile::copy_tile<T, BM * BK / V, BK / V>(As, S::LDA, x, cin, (c + f / nk * G) * BM, M, k0, cin);
    if (!resident) load_w(As + S::A_ELEMS, k0);
    if (pro.on && threadIdx.x < 2 * BK / 4) {  // scale, then shift, 4 columns a thread
      const int k = threadIdx.x % (BK / 4) * 4;
      const bool ok = k0 + k < cin;  // cin is a multiple of 8: whole chunks
      float* ss = reinterpret_cast<float*>(As + S::A_ELEMS + S::B_ELEMS);
      tile::cp_async16(ss + threadIdx.x * 4,
                       (threadIdx.x < BK / 4 ? pro.scale : pro.shift) + (ok ? k0 + k : 0), ok);
    }
  };
  if (resident) load_w(Wr, 0);  // rides in the first group
  float acc[4][NJ][4], su[NJ][2], sq[NJ][2];
  tile::zero(acc);
#pragma unroll
  for (int j = 0; j < NJ; ++j) su[j][0] = su[j][1] = sq[j][0] = sq[j][1] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    tile::cp_async_commit();
  }
  // this thread's prologue chunks: columns hcol.. of a stage, rows hrow + u * THREADS / P
  const int hcol = threadIdx.x % P * V, hrow = threadIdx.x / P;
  for (int f = 0; f < total; ++f) {
    const int kt = f % nk, m0 = (c + f / nk * G) * BM;
    tile::cp_async_wait<STAGES - 2>();  // stage f has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; stage f - 1 is consumed
    if (f + STAGES - 1 < total) load(f + STAGES - 1);
    tile::cp_async_commit();
    T* As = reinterpret_cast<T*>(smem + f % STAGES * S::STAGE);
    const T* Ws = resident ? Wr : As + S::A_ELEMS;
    if (pro.on) {
      const float* ss = reinterpret_cast<const float*>(As + S::A_ELEMS + S::B_ELEMS);
      float sc[V], sh[V];
#pragma unroll
      for (int q = 0; q < V; ++q) sc[q] = ss[hcol + q], sh[q] = ss[BK + hcol + q];
#pragma unroll
      for (int u = 0; u < BM * P / THREADS; ++u) {
        const int r = hrow + u * (THREADS / P);
        if (m0 + r < M) h_chunk(As + r * S::LDA + hcol, sc, sh, pro.relu);
      }
      __syncthreads();  // h is whole
    }
    if (kmajor)  // one copy of the loop per w layout: constant pitches
      tile::warp_tile<NJ, false, BK>(acc, As, S::LDA, Ws, S::LDK, false, wm, wn, lane);
    else
      tile::warp_tile<NJ, false, BK>(acc, As, S::LDA, Ws, S::LDN, true, wm, wn, lane);
    if (kt != nk - 1) continue;
    // the epilogue of this tile, from the registers
    T* Yw = reinterpret_cast<T*>(smem + STAGES * S::STAGE + S::W_BYTES) + warp * 16 * S::LDY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + g + 8 * h, row = m0 + r;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = wn + 8 * j + 2 * t;
          float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          T* dst = S::Y_VIA_SMEM ? Yw + (g + 8 * h) * S::LDY + 8 * j + 2 * t
                                 : y + (size_t)row * cout + n0 + col;
          round_store2(dst, v0, v1, S::Y_VIA_SMEM || (row < M && n0 + col < cout));
          if (stats) {
            su[j][0] += v0, su[j][1] += v1;
            sq[j][0] += v0 * v0, sq[j][1] += v1 * v1;
          }
        }
      }
      if (S::Y_VIA_SMEM) {  // the warp's 16 rows, whole 16-byte chunks of each
        constexpr int CPR = WN / V;
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 16 * CPR; e += 32) {
          const int rr = e / CPR, cc = e % CPR * V;
          const int row = m0 + wm + 16 * i + rr, col = n0 + wn + cc;
          if (row < M && col < cout)
            *reinterpret_cast<uint4*>(y + (size_t)row * cout + col) =
                *reinterpret_cast<const uint4*>(Yw + rr * S::LDY + cc);
        }
        __syncwarp();
      }
    }
    tile::zero(acc);
  }
  tile::cp_async_wait<0>();
  if (!stats) return;
  // rows past M and columns past cout added zeros (h and w are 0 there)
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        su[j][e] += __shfl_xor_sync(0xffffffffu, su[j][e], o);
        sq[j][e] += __shfl_xor_sync(0xffffffffu, sq[j][e], o);
      }
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);  // [2 (sum, sumsq)][2 (row-warps)][BN]
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn + 8 * j + 2 * t + e;
        red[(0 * 2 + (warp & 1)) * BN + col] = su[j][e];
        red[(1 * 2 + (warp & 1)) * BN + col] = sq[j][e];
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * BN; i += THREADS) {
    const int q = i / BN, col = i % BN;
    if (n0 + col < cout)
      ws[((size_t)q * G + c) * cout + n0 + col] =
          red[(q * 2 + 0) * BN + col] + red[(q * 2 + 1) * BN + col];
  }
}

// ---------------------------------------------------------------------------
// backward, two-pass part 1: dh = g @ w^T, dx, dscale, dshift
// ---------------------------------------------------------------------------

// The ring of the dx kernel (tile_mma.cuh's machinery). A CTA owns a
// tile::BM x BN output tile (rows of M x columns of cin); 8 warps (2 x 4),
// each a 64 x WN register tile. A stage is STAGE_BYTES deep along cout and
// holds dy's tile Ds [BM][LDA] (cout contiguous; rewritten in place as g),
// y's Ys [BM][LDA] (staged only with the statistics), w's tile, either
// Ws[BN][LDK] (cout contiguous, sn == 1) or Ws[BK][LDN] (cin contiguous,
// sk == 1: the OIHW weight's view), then dsum [BK] and dssq [BK] f32. After
// the ring, the x tile Xs [BM][LDX] of the epilogue. bf16: 3 stages, ~198 KB
// in all (one CTA an SM); f32 (checks only, never timed): 2 stages, as 3
// and its 4-byte x tile would exceed the 227 KB a CTA may hold.
// CTAs of the dx kernel an SM: its ring and x tile fill the shared memory
constexpr int kDxCtasPerSm = 1;

template <typename T>
struct Dx {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BN = 128;
  static constexpr int WN = 32;
  static constexpr int NJ = WN / 8;
  static constexpr int BK = tile::STAGE_BYTES / sizeof(T);
  static constexpr int STAGES = sizeof(T) == 2 ? tile::STAGES : 2;
  static constexpr int LDA = tile::pad_ld<T>(BK), LDK = tile::pad_ld<T>(BK);
  static constexpr int LDN = tile::pad_ld<T>(BN), LDX = tile::pad_ld<T>(BN);
  static constexpr int A_ELEMS = tile::BM * LDA;
  static constexpr int B_ELEMS = BN * LDK > BK * LDN ? BN * LDK : BK * LDN;
  static constexpr size_t STAGE = sizeof(T) * (2 * A_ELEMS + B_ELEMS) + sizeof(float) * 2 * BK;
  static constexpr size_t SMEM = STAGE * STAGES + sizeof(T) * tile::BM * LDX;
  static_assert(STAGE % 16 == 0, "stages stay 16-byte aligned");
  static_assert(4 * WN == BN && 2 * BK <= tile::THREADS, "8 warps of 64 x WN; one thread a stat");
};

// Issue the copies of one stage into st: rows m0.. of dy (and of y, with
// dsum and dssq, with the statistics) at depth k0.. of cout, and w's tile at
// (k0.., n0..). Past M, cin or cout the copies zero-fill.
template <typename T>
__device__ __forceinline__ void dx_load(unsigned char* st, const T* __restrict__ y,
                                        const T* __restrict__ dy, const T* __restrict__ w,
                                        long long sk, long long sn, const float* __restrict__ dsum,
                                        const float* __restrict__ dssq, bool stats, int M, int cin,
                                        int cout, int m0, int n0, int k0) {
  using S = Dx<T>;
  constexpr int V = S::V, BK = S::BK, BM = tile::BM;
  T* Ds = reinterpret_cast<T*>(st);
  T* Ws = Ds + 2 * S::A_ELEMS;
  tile::copy_tile<T, BM * BK / V, BK / V>(Ds, S::LDA, dy, cout, m0, M, k0, cout);
  if (stats) {
    float* sq = reinterpret_cast<float*>(Ws + S::B_ELEMS);
    tile::copy_tile<T, BM * BK / V, BK / V>(Ds + S::A_ELEMS, S::LDA, y, cout, m0, M, k0, cout);
    if (threadIdx.x < 2 * BK) {  // dsum, then dssq, one column a thread (no 16-byte alignment)
      const int k = threadIdx.x % BK;
      const bool ok = k0 + k < cout;
      tile::cp_async4(sq + threadIdx.x, (threadIdx.x < BK ? dsum : dssq) + (ok ? k0 + k : 0), ok);
    }
  }
  if (sk == 1)  // B(k, n) = w[n + k*sn], n contiguous: Ws[k][n]
    tile::copy_tile<T, BK * S::BN / V, S::BN / V>(Ws, S::LDN, w, sn, k0, cout, n0, cin);
  else  // k contiguous: Ws[n][k]
    tile::copy_tile<T, S::BN * BK / V, BK / V>(Ws, S::LDK, w, sk, n0, cin, k0, cout);
}

// g = dy + dsum + 2*y*dssq on one staged chunk of V columns, in place in
// dy's slot, f32 math and one rounding to T (ds, dq: the chunk's dsum, dssq)
template <typename T>
__device__ __forceinline__ void g_chunk(T* d, const T* yv, const float* ds, const float* dq) {
  constexpr int V = 16 / sizeof(T);
  uint4 a = *reinterpret_cast<const uint4*>(d);
  const uint4 b = *reinterpret_cast<const uint4*>(yv);
  T* e = reinterpret_cast<T*>(&a);
  const T* f = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int q = 0; q < V; ++q) e[q] = from_f32<T>(to_f32(e[q]) + ds[q] + 2.f * to_f32(f[q]) * dq[q]);
  *reinterpret_cast<uint4*>(d) = a;
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// grid (cin tiles, G), cin tiles fastest so the CTAs that read the same dy
// and y rows run side by side: CTA (n, c) writes columns n*BN.. of dx for
// the M tiles c, c+G, ... The CTA's stages of all its tiles form one
// sequence through the ring, so the next tile's first stages load while
// this tile's epilogue runs. The x tile is issued with a tile's first
// stage and lands by its last (a wait for everything when cout is shallower
// than the ring). Each lane keeps scale/shift of its 8 columns and running
// sums of dh*x and dh over its rows of every tile in registers; at the end
// they are added over the warp's rows (shuffles), then the two row-warps in
// order into ws[0/1][c][cin].
template <typename T>
__global__ void __launch_bounds__(tile::THREADS, kDxCtasPerSm)
conv_bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
                  const T* __restrict__ w, long long sk, long long sn, Prologue pro,
                  const float* __restrict__ dsum, const float* __restrict__ dssq, bool stats,
                  T* __restrict__ dx, float* __restrict__ ws, int M, int cin, int cout, int G) {
  using S = Dx<T>;
  constexpr int V = S::V, BK = S::BK, BM = tile::BM, P = BK / V, NJ = S::NJ;
  constexpr int STAGES = S::STAGES, THREADS = tile::THREADS;
  static_assert(THREADS % P == 0, "a thread's g chunks share their columns");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem + STAGES * S::STAGE);
  const int n0 = blockIdx.x * S::BN, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * S::WN;
  const int mtiles = (M + BM - 1) / BM, nk = (cout + BK - 1) / BK;
  const int tiles = c < mtiles ? (mtiles - 1 - c) / G + 1 : 0;
  const int total = tiles * nk;  // the CTA's stages, all tiles in order
  const bool kmajor = sk != 1;  // as dx_load: w's tile as it lies
  float sc[NJ][2], sh[NJ][2], sx[NJ][2], sd[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gc = n0 + wn + 8 * j + 2 * t + e;
      sc[j][e] = pro.on && gc < cin ? pro.scale[gc] : 0.f;
      sh[j][e] = pro.on && gc < cin ? pro.shift[gc] : 0.f;
      sx[j][e] = sd[j][e] = 0.f;
    }
  auto load = [&](int f) {
    dx_load<T>(smem + f % STAGES * S::STAGE, y, dy, w, sk, sn, dsum, dssq, stats, M, cin, cout,
               (c + f / nk * G) * BM, n0, f % nk * BK);
  };
  float acc[4][NJ][4];
  tile::zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    tile::cp_async_commit();
  }
  // this thread's g chunks: columns gcol.. of a stage, rows grow0 + u * THREADS / P
  const int gcol = threadIdx.x % P * V, grow0 = threadIdx.x / P;
  for (int f = 0; f < total; ++f) {
    const int kt = f % nk, m0 = (c + f / nk * G) * BM;
    tile::cp_async_wait<STAGES - 2>();  // stage f has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; stage f - 1 is consumed
    if (f + STAGES - 1 < total) load(f + STAGES - 1);
    if (pro.on && kt == 0)  // the previous tile's epilogue is done with Xs
      tile::copy_tile<T, BM * S::BN / V, S::BN / V>(Xs, S::LDX, x, cin, m0, M, n0, cin);
    tile::cp_async_commit();
    unsigned char* st = smem + f % STAGES * S::STAGE;
    T* Ds = reinterpret_cast<T*>(st);
    const T* Ws = Ds + 2 * S::A_ELEMS;
    if (stats) {
      const float* sq = reinterpret_cast<const float*>(Ws + S::B_ELEMS);
      float ds[V], dq[V];
#pragma unroll
      for (int q = 0; q < V; ++q) ds[q] = sq[gcol + q], dq[q] = sq[BK + gcol + q];
#pragma unroll
      for (int u = 0; u < BM * P / THREADS; ++u) {
        const int r = grow0 + u * (THREADS / P);
        if (m0 + r < M)  // rows past M stay zero (g = 0, not dsum)
          g_chunk(Ds + r * S::LDA + gcol, Ds + S::A_ELEMS + r * S::LDA + gcol, ds, dq);
      }
      __syncthreads();  // g is whole
    }
    if (kmajor)  // one copy of the loop per w layout: constant pitches
      tile::warp_tile<NJ, false, BK>(acc, Ds, S::LDA, Ws, S::LDK, false, wm, wn, lane);
    else
      tile::warp_tile<NJ, false, BK>(acc, Ds, S::LDA, Ws, S::LDN, true, wm, wn, lane);
    if (kt != nk - 1) continue;
    // the epilogue of this tile, from the registers
    if (pro.on && nk < STAGES) {  // the x tile's copies are younger than the last stage's
      tile::cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + g + 8 * h, row = m0 + r;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = wn + 8 * j + 2 * t;
          float out[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
          if (pro.on) {
            const float2 xv = load2(Xs + r * S::LDX + col);
            const float xe[2] = {xv.x, xv.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float d = out[e];
              // the mask as the plain version rounds it (product, then sum; no fma)
              if (pro.relu && !(__fadd_rn(__fmul_rn(xe[e], sc[j][e]), sh[j][e]) > 0.f)) d = 0.f;
              out[e] = d * sc[j][e];
              sx[j][e] += d * xe[e];
              sd[j][e] += d;
            }
          }
          if (row < M && n0 + col < cin) store2(dx + (size_t)row * cin + n0 + col, out[0], out[1]);
        }
      }
    tile::zero(acc);
  }
  tile::cp_async_wait<0>();
  if (!pro.on) return;
  // rows past M and columns past cin added zeros: dh is 0 there
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sx[j][e] += __shfl_xor_sync(0xffffffffu, sx[j][e], o);
        sd[j][e] += __shfl_xor_sync(0xffffffffu, sd[j][e], o);
      }
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);  // [2 (dscale, dshift)][2 (row-warps)][BN]
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn + 8 * j + 2 * t + e;
        red[(0 * 2 + (warp & 1)) * S::BN + col] = sx[j][e];
        red[(1 * 2 + (warp & 1)) * S::BN + col] = sd[j][e];
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * S::BN; i += THREADS) {
    const int q = i / S::BN, col = i % S::BN;
    if (n0 + col < cin)
      ws[((size_t)q * G + c) * cin + n0 + col] =
          red[(q * 2 + 0) * S::BN + col] + red[(q * 2 + 1) * S::BN + col];
  }
}

// ---------------------------------------------------------------------------
// backward, two-pass part 2: dw = prologue(x)^T @ g
// ---------------------------------------------------------------------------

// The ring of the dw kernel (tile_mma.cuh's machinery). A CTA owns a
// tile::BM x BN block of dw (rows of cin x columns of cout; BN 128 or 256,
// the wrapper's plan); 8 warps (2 x 4), each a 64 x BN/4 register tile. A
// stage is BK rows of M deep (STAGE_BYTES of a row of the tile's operands)
// and holds x's [BK][LDX] (cin contiguous; rewritten in place as h with the
// prologue), dy's [BK][LDG] (cout contiguous; rewritten in place as g with
// the statistics) and y's [BK][LDG] (staged only with the statistics). As
// many stages as the 227 KB a CTA may hold take, at most 4: bf16 128 x 256
// is 84,992 bytes a stage, so 2 (169,984); 128 x 128 is 52,224, so 4
// (208,896); f32 (checks only, never timed) the same counts at 32 rows a
// stage. One CTA an SM.
constexpr int kDwCtasPerSm = 1;

template <typename T, int BN_>
struct Dw {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BN = BN_;
  static constexpr int WN = BN / 4;
  static constexpr int NJ = WN / 8;
  static constexpr int BK = tile::STAGE_BYTES / sizeof(T);
  static constexpr int LDX = tile::pad_ld<T>(tile::BM), LDG = tile::pad_ld<T>(BN);
  static constexpr int X_ELEMS = BK * LDX, G_ELEMS = BK * LDG;
  static constexpr size_t STAGE = sizeof(T) * (X_ELEMS + 2 * G_ELEMS);
  static constexpr int FIT = (int)(kSmemMax / STAGE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = STAGE * STAGES;
  // the in-place passes: 16-byte chunks a row of x's and of dy's slot
  static constexpr int PX = tile::BM / V, PG = BN / V;
  static_assert(STAGES >= 2 && STAGE % 16 == 0, "a ring of two stages or more, aligned");
  static_assert(tile::THREADS % PX == 0 && tile::THREADS % PG == 0 &&
                    BK * PX % tile::THREADS == 0 && BK * PG % tile::THREADS == 0,
                "each thread rewrites whole rows' chunks in fixed columns");
};

// grid (cin tiles x cout tiles, G), cin tiles fastest so that the CTAs that
// restage the same dy and y rows run side by side and L2 serves the
// re-reads: CTA (tile, c) sums the tile's block of h^T g over the BK-row
// blocks [c*nb/G, (c+1)*nb/G) of chunk c, in order, into ws[c][cin][cout].
// Each thread rewrites the same columns of every stage, so it keeps their
// scale, shift (x's slot) and dsum, dssq (dy's slot) in registers; rows past
// M are left as the zero fill (g = 0 there: a zero dy and y would still give
// g = dsum, and h = relu(shift)).
template <typename T, int BN>
__global__ void __launch_bounds__(tile::THREADS, kDwCtasPerSm)
conv_bn_dw_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
                  Prologue pro, const float* __restrict__ dsum, const float* __restrict__ dssq,
                  bool stats, float* __restrict__ ws, int M, int cin, int cout, int G) {
  using S = Dw<T, BN>;
  constexpr int V = S::V, BK = S::BK, BM = tile::BM, STAGES = S::STAGES;
  constexpr int THREADS = tile::THREADS, PX = S::PX, PG = S::PG, NJ = S::NJ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int mtiles = (cin + BM - 1) / BM;
  const int m0 = blockIdx.x % mtiles * BM, n0 = blockIdx.x / mtiles * BN, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * S::WN;
  const int nb = (M + BK - 1) / BK;
  const int b0 = (int)((long long)nb * c / G), nk = (int)((long long)nb * (c + 1) / G) - b0;
  // this thread's chunks: x columns xcol.. (rows xrow + u * THREADS / PX) and
  // dy columns gcol.. (rows grow + u * THREADS / PG) of every stage
  const int xcol = threadIdx.x % PX * V, xrow = threadIdx.x / PX;
  const int gcol = threadIdx.x % PG * V, grow = threadIdx.x / PG;
  float sc[V], sh[V], ds[V], dq[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const bool okx = pro.on && m0 + xcol + q < cin, okg = stats && n0 + gcol + q < cout;
    sc[q] = okx ? pro.scale[m0 + xcol + q] : 0.f;
    sh[q] = okx ? pro.shift[m0 + xcol + q] : 0.f;
    ds[q] = okg ? dsum[n0 + gcol + q] : 0.f;
    dq[q] = okg ? dssq[n0 + gcol + q] : 0.f;
  }
  auto load = [&](int f) {  // block b0 + f of the chunk into its ring slot; past M zero-filled
    T* Xs = reinterpret_cast<T*>(smem + f % STAGES * S::STAGE);
    T* Ds = Xs + S::X_ELEMS;
    const int r0 = (b0 + f) * BK;
    tile::copy_tile<T, BK * PX, PX>(Xs, S::LDX, x, cin, r0, M, m0, cin);
    tile::copy_tile<T, BK * PG, PG>(Ds, S::LDG, dy, cout, r0, M, n0, cout);
    if (stats) tile::copy_tile<T, BK * PG, PG>(Ds + S::G_ELEMS, S::LDG, y, cout, r0, M, n0, cout);
  };
  float acc[4][NJ][4];
  tile::zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    tile::cp_async_commit();
  }
  for (int f = 0; f < nk; ++f) {
    tile::cp_async_wait<STAGES - 2>();  // stage f has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; stage f - 1 is consumed
    if (f + STAGES - 1 < nk) load(f + STAGES - 1);
    tile::cp_async_commit();
    T* Xs = reinterpret_cast<T*>(smem + f % STAGES * S::STAGE);
    T* Ds = Xs + S::X_ELEMS;
    const int r0 = (b0 + f) * BK;
    if (pro.on) {
#pragma unroll
      for (int u = 0; u < BK * PX / THREADS; ++u) {
        const int r = xrow + u * (THREADS / PX);
        if (r0 + r < M) h_chunk(Xs + r * S::LDX + xcol, sc, sh, pro.relu);
      }
    }
    if (stats) {
#pragma unroll
      for (int u = 0; u < BK * PG / THREADS; ++u) {
        const int r = grow + u * (THREADS / PG);
        if (r0 + r < M)  // rows past M stay zero (g = 0, not dsum)
          g_chunk(Ds + r * S::LDG + gcol, Ds + S::G_ELEMS + r * S::LDG + gcol, ds, dq);
      }
    }
    if (pro.on || stats) __syncthreads();  // h and g are whole
    tile::warp_tile<NJ, true, BK>(acc, Xs, S::LDX, Ds, S::LDG, true, wm, wn, lane);
  }
  tile::cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
  float* part = ws + (size_t)c * cin * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= cin) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n < cout) store2(part + (size_t)m * cout + n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// backward, single pass: dx, dscale, dshift and dw in one sweep over x, y, dy
// ---------------------------------------------------------------------------

// The single-pass kernel on tile_mma.cuh. One persistent CTA an SM (8
// warps) walks the M tiles c, c+G, ... of kSingleRows rows as one sequence
// through a cp.async ring; w lies resident in shared memory for the whole
// sweep. A ring stage holds one M tile: dy [BM][LDG] (cout contiguous;
// rewritten in place as g with the statistics), y [BM][LDG] (staged only
// with the statistics) and x [BM][LDX] (rewritten in place as h with the
// prologue). w lands once, as it lies: Ws[COUTP][LDX] for the OIHW view
// (cin contiguous, read by ldmatrix.trans) or Ws[CINP][LDG] for a
// contiguous [cin, cout] w (ldmatrix). CINP/COUTP are cin/cout rounded up
// to 64; the wrapper's rule (ceil64(cin) * ceil64(cout) <= 16384) leaves
// eight pairs, each its own instantiation.
//
// Shared memory, bf16 (pitches padded by 16 bytes; the budget is the 227 KB
// a CTA may hold): at 64->256 a stage is 64 * (2 * 264 + 72) * 2 = 76800
// bytes and w 256 * 72 * 2 = 36864, so two stages fit (190464 bytes) and
// three do not; at 256->64 a stage is 52224 and w 36864: three stages
// (193536); 64->64 and 128->64 take four, 128->128 three. f32 (checks
// only, never timed) takes what fits: one stage at 64->256, 256->64 and
// 128->128.
//
// Per tile: (1) with the statistics, g = dy + dsum + 2*y*dssq in place over
// the staged dy, rows past M left zero, then one barrier; (2) dh = g w^T,
// [BM][CINP] over COUTP, RG x CG warps of (16 MI) x (8 NJ) register tiles;
// (3) the epilogue from the registers: the ReLU mask from the staged x,
// dx = dh*scale in two-column stores, per-lane sums of dh*x and dh over
// all of the CTA's tiles, and h = prologue(x), rounded, written over the x
// it came from (each x element belongs to one lane's dh tile, so no
// barrier comes between the read and the write), then one barrier; (4) dw
// += h^T g, [CINP][COUTP] over the BM rows, both operands row-major and
// read by ldmatrix.trans, RW x CW warps of (16 MW) x (8 NW). The dw
// accumulator (at most 16384 f32: 64 registers a thread) stays in
// registers across all of the CTA's tiles and is written once, as the
// CTA's partial; so are the sums, after one shuffle tree and a fixed-order
// add over the row-warps.
constexpr int kSingleRows = 64;       // rows of an M tile
constexpr int kSingleCtasPerSm = 1;   // the ring and w fill the shared memory

template <typename T, int CINP, int COUTP>
struct Single {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BM = kSingleRows;
  static constexpr int LDG = tile::pad_ld<T>(COUTP), LDX = tile::pad_ld<T>(CINP);
  static constexpr int W_ELEMS = COUTP * LDX > CINP * LDG ? COUTP * LDX : CINP * LDG;
  static constexpr size_t W_BYTES = sizeof(T) * W_ELEMS;
  static constexpr size_t STAGE = sizeof(T) * BM * (2 * LDG + LDX);
  static constexpr int FIT = (int)((kSmemMax - W_BYTES) / STAGE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = W_BYTES + STAGES * STAGE;
  // dh [BM][CINP]: RG x CG warps of (16 MI) x (8 NJ)
  static constexpr int MI = CINP == 256 ? 4 : 2, RG = BM / (16 * MI), CG = tile::WARPS / RG;
  static constexpr int NJ = CINP / (8 * CG);
  // dw [CINP][COUTP]: RW x CW warps of (16 MW) x (8 NW)
  static constexpr int NW = COUTP == 192 ? 6 : 4, CW = COUTP / (8 * NW), RW = tile::WARPS / CW;
  static constexpr int MW = CINP / (16 * RW);
  // g pass: 16-byte chunks a row, rows a sweep of the CTA's threads
  static constexpr int P = COUTP / V, RSTEP = tile::THREADS / P;
  static_assert(STAGES >= 1 && STAGE % 16 == 0 && W_BYTES % 16 == 0, "the ring fits, aligned");
  static_assert(RG * CG == tile::WARPS && CG * 8 * NJ == CINP && NJ % 2 == 0, "dh warp tiles");
  static_assert(RW * CW == tile::WARPS && RW * 16 * MW == CINP && CW * 8 * NW == COUTP &&
                    MW * NW <= 16,
                "dw warp tiles, at most 64 accumulators a thread");
  static_assert(RSTEP >= 1 && 2 * RG * CINP * sizeof(float) <= STAGES * STAGE, "scratch");
};

template <typename T, int CINP, int COUTP>
__global__ void __launch_bounds__(tile::THREADS, kSingleCtasPerSm)
conv_bn_single_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
                      const T* __restrict__ w, long long sk, long long sn, Prologue pro,
                      const float* __restrict__ dsum, const float* __restrict__ dssq, bool stats,
                      T* __restrict__ dx, float* __restrict__ ws, int M, int cin, int cout,
                      int G) {
  using S = Single<T, CINP, COUTP>;
  constexpr int V = S::V, BM = S::BM, STAGES = S::STAGES, THREADS = tile::THREADS;
  constexpr int MI = S::MI, NJ = S::NJ, MW = S::MW, NW = S::NW, LDG = S::LDG, LDX = S::LDX;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ws = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + S::W_BYTES;
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / S::CG * 16 * MI, wn = warp % S::CG * 8 * NJ;  // this warp's dh tile
  const int dm = warp / S::CW * 16 * MW, dn = warp % S::CW * 8 * NW;  // ... and dw tile
  const int mtiles = (M + BM - 1) / BM;
  const int tiles = c < mtiles ? (mtiles - 1 - c) / G + 1 : 0;
  const bool kmajor = sk != 1;  // w's layout, as dx_load reads it
  if (kmajor)  // cout contiguous: Ws[n = cin][k = cout]
    tile::copy_tile<T, CINP * COUTP / V, COUTP / V>(Ws, LDG, w, sk, 0, cin, 0, cout);
  else  // cin contiguous: Ws[k = cout][n = cin]
    tile::copy_tile<T, COUTP * CINP / V, CINP / V>(Ws, LDX, w, sn, 0, cout, 0, cin);
  auto load = [&](int f) {  // M tile f of this CTA into its ring slot; past M zero-filled
    T* Ds = reinterpret_cast<T*>(ring + f % STAGES * S::STAGE);
    const int m0 = (c + f * G) * BM;
    tile::copy_tile<T, BM * COUTP / V, COUTP / V>(Ds, LDG, dy, cout, m0, M, 0, cout);
    if (stats)
      tile::copy_tile<T, BM * COUTP / V, COUTP / V>(Ds + BM * LDG, LDG, y, cout, m0, M, 0, cout);
    tile::copy_tile<T, BM * CINP / V, CINP / V>(Ds + 2 * BM * LDG, LDX, x, cin, m0, M, 0, cin);
  };
  // the g pass's columns gcol.. (rows grow, grow + RSTEP, ...) and their dsum, dssq
  const int gcol = threadIdx.x % S::P * V, grow = threadIdx.x / S::P;
  float ds[V], dq[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const bool ok = stats && gcol + q < cout;
    ds[q] = ok ? dsum[gcol + q] : 0.f;
    dq[q] = ok ? dssq[gcol + q] : 0.f;
  }
  // the epilogue's scale, shift and running sums of this lane's dh columns
  float sc[NJ][2], sh[NJ][2], sx[NJ][2], sd[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn + 8 * j + 2 * t + e;
      sc[j][e] = pro.on && col < cin ? pro.scale[col] : 0.f;
      sh[j][e] = pro.on && col < cin ? pro.shift[col] : 0.f;
      sx[j][e] = sd[j][e] = 0.f;
    }
  float dacc[MW][NW][4];
  tile::zero(dacc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {  // w rides in the first group
    if (s < tiles) load(s);
    tile::cp_async_commit();
  }
  for (int f = 0; f < tiles; ++f) {
    if constexpr (STAGES == 1) {  // f32 at the widest pairs: no copy overlaps the compute
      if (f) __syncthreads();     // tile f - 1 is consumed
      load(f);
      tile::cp_async_commit();
      tile::cp_async_wait<0>();
    } else {
      tile::cp_async_wait<STAGES - 2>();  // tile f has landed (this thread's copies)
    }
    __syncthreads();  // ... everyone's; tile f - 1 is consumed
    if constexpr (STAGES > 1) {
      if (f + STAGES - 1 < tiles) load(f + STAGES - 1);
      tile::cp_async_commit();
    }
    T* Ds = reinterpret_cast<T*>(ring + f % STAGES * S::STAGE);
    T* Xs = Ds + 2 * BM * LDG;
    const int m0 = (c + f * G) * BM;
    if (stats) {
#pragma unroll
      for (int u = 0; u < (BM + S::RSTEP - 1) / S::RSTEP; ++u) {
        const int r = grow + u * S::RSTEP;
        if (grow < S::RSTEP && r < BM && m0 + r < M)  // rows past M stay zero (g = 0, not dsum)
          g_chunk(Ds + r * LDG + gcol, Ds + (BM + r) * LDG + gcol, ds, dq);
      }
      __syncthreads();  // g is whole
    }
    float acc[MI][NJ][4];
    tile::zero(acc);
    if (kmajor)  // one copy of the loop per w layout: constant pitches
      tile::warp_tile_rows<MI, NJ, false, COUTP>(acc, Ds, LDG, Ws, LDG, false, wm, wn, lane);
    else
      tile::warp_tile_rows<MI, NJ, false, COUTP>(acc, Ds, LDG, Ws, LDX, true, wm, wn, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + g + 8 * h, row = m0 + r;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = wn + 8 * j + 2 * t;
          float out[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
          if (pro.on) {
            T* xp = Xs + r * LDX + col;
            const float2 xv = load2(xp);
            const float xe[2] = {xv.x, xv.y};
            float hv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // the product rounded, then the sum, as the plain version does: a
              // contracted fma can put a bf16 x that cancels shift on the other
              // side of the mask
              const float a = __fadd_rn(__fmul_rn(xe[e], sc[j][e]), sh[j][e]);
              float d = out[e];
              if (pro.relu && !(a > 0.f)) d = 0.f;
              out[e] = d * sc[j][e];
              sx[j][e] += d * xe[e];
              sd[j][e] += d;
              hv[e] = pro.relu ? fmaxf(a, 0.f) : a;
            }
            store2(xp, hv[0], hv[1]);  // h, rounded to T, over the x it came from
          }
          if (row < M && col < cin) store2(dx + (size_t)row * cin + col, out[0], out[1]);
        }
      }
    if (pro.on) __syncthreads();  // h is whole
    tile::warp_tile_rows<MW, NW, true, BM>(dacc, Xs, LDX, Ds, LDG, true, dm, dn, lane);
  }
  tile::cp_async_wait<0>();
  // the CTA's dw partial: ws[c][cin][cout]
  float* part = ws + (size_t)c * cin * cout;
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = dm + 16 * i + g + 8 * h;
      if (m >= cin) continue;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int n = dn + 8 * j + 2 * t;
        if (n < cout) store2(part + (size_t)m * cout + n, dacc[i][j][2 * h], dacc[i][j][2 * h + 1]);
      }
    }
  if (!pro.on) return;
  // dscale, dshift: over the warp's rows (shuffles), then the RG row-warps in
  // order into ws[G * cin * cout + (q * G + c) * cin]; rows past M and
  // columns past cin added zeros (dh is 0 there)
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sx[j][e] += __shfl_xor_sync(0xffffffffu, sx[j][e], o);
        sd[j][e] += __shfl_xor_sync(0xffffffffu, sd[j][e], o);
      }
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(ring);  // [2 (dscale, dshift)][RG][CINP]
  if (g == 0) {
    const int rg = warp / S::CG;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn + 8 * j + 2 * t + e;
        red[(0 * S::RG + rg) * CINP + col] = sx[j][e];
        red[(1 * S::RG + rg) * CINP + col] = sd[j][e];
      }
  }
  __syncthreads();
  float* sp = ws + (size_t)G * cin * cout;
  for (int i = threadIdx.x; i < 2 * CINP; i += THREADS) {
    const int q = i / CINP, col = i % CINP;
    if (col >= cin) continue;
    float v = red[q * S::RG * CINP + col];
#pragma unroll
    for (int rg = 1; rg < S::RG; ++rg) v += red[(q * S::RG + rg) * CINP + col];
    sp[((size_t)q * G + c) * cin + col] = v;
  }
}

// out[i] = sum over g < G, in order, of ws[g*n + i]
__global__ void reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int G,
                              long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += ws[(size_t)g * n + i];
    out[i] = s;
  }
}

int reduce(const float* ws, float* out, int G, long long n, cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  reduce_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(ws, out, G, n);
  return (int)cudaGetLastError();
}

template <typename T>
bool aligned(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// w [K, N] through strides (sk, sn): one unit stride, the other and the
// extent along the unit one multiples of the 16-byte vector
template <typename T>
bool w_ok(const void* w, long long sk, long long sn, int K, int N) {
  constexpr int V = 16 / sizeof(T);
  if (!aligned<T>(w)) return false;
  if (sk == 1) return sn % V == 0 && K % V == 0;
  if (sn == 1) return sk % V == 0 && N % V == 0;
  return false;
}

template <typename T>
bool shapes_ok(int M, int cin, int cout, int G) {
  return M >= 1 && cin >= 8 && cout >= 8 && cin % 8 == 0 && cout % 8 == 0 && G >= 1 &&
         G <= 65535;
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <typename T, int BN>
int launch_fwd_tiles(const T* x, const T* w, long long sk, long long sn, const Prologue& pro,
                     T* y, float* ws, int M, int cin, int cout, int G, bool stats,
                     cudaStream_t st) {
  using S = Fwd<T, BN>;
  auto kern = conv_bn_fwd_kernel<T, BN>;
  int e = set_smem(kern, S::SMEM);
  if (e) return e;
  kern<<<dim3((cout + BN - 1) / BN, G), tile::THREADS, S::SMEM, st>>>(x, w, sk, sn, pro, y, ws, M,
                                                                     cin, cout, G, stats);
  return (int)cudaGetLastError();
}

// bn: the tile's columns of cout (the wrapper's plan: 64, 128 or 256)
template <typename T>
int launch_fwd(const void* x, const void* w, long long sk, long long sn, const void* scale,
               const void* shift, void* y, void* ws, void* sum, void* ssq, int M, int cin,
               int cout, int G, int bn, int prologue, int relu, int stats, void* stream) {
  if (!shapes_ok<T>(M, cin, cout, G) || !w_ok<T>(w, sk, sn, cin, cout) || !aligned<T>(x) ||
      !aligned<T>(y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Prologue pro{(const float*)scale, (const float*)shift, prologue != 0, relu != 0};
#define DTF_FWD_TILES(BN)                                                                  \
  launch_fwd_tiles<T, BN>((const T*)x, (const T*)w, sk, sn, pro, (T*)y, (float*)ws, M, cin, \
                          cout, G, stats != 0, st)
  int e;
  if (bn == 64) e = DTF_FWD_TILES(64);
  else if (bn == 128) e = DTF_FWD_TILES(128);
  else if (bn == 256) e = DTF_FWD_TILES(256);
  else return (int)cudaErrorInvalidValue;
#undef DTF_FWD_TILES
  if (e || !stats) return e;
  e = reduce((const float*)ws, (float*)sum, G, cout, st);
  if (e) return e;
  return reduce((const float*)ws + (size_t)G * cout, (float*)ssq, G, cout, st);
}

template <typename T>
int launch_dx(const void* x, const void* y, const void* dy, const void* w, long long sk,
              long long sn, const void* scale, const void* shift, const void* dsum,
              const void* dssq, void* dx, void* ws, void* dscale, void* dshift, int M, int cin,
              int cout, int G, int prologue, int relu, int stats, void* stream) {
  if (!shapes_ok<T>(M, cin, cout, G) || !w_ok<T>(w, sk, sn, cin, cout) || !aligned<T>(x) ||
      !aligned<T>(y) || !aligned<T>(dy) || !aligned<T>(dx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Prologue pro{(const float*)scale, (const float*)shift, prologue != 0, relu != 0};
  using S = Dx<T>;
  auto kern = conv_bn_dx_kernel<T>;
  int e = set_smem(kern, S::SMEM);
  if (e) return e;
  kern<<<dim3((cin + S::BN - 1) / S::BN, G), tile::THREADS, S::SMEM, st>>>(
      (const T*)x, (const T*)y, (const T*)dy, (const T*)w, sk, sn, pro, (const float*)dsum,
      (const float*)dssq, stats != 0, (T*)dx, (float*)ws, M, cin, cout, G);
  e = (int)cudaGetLastError();
  if (e || !prologue) return e;
  e = reduce((const float*)ws, (float*)dscale, G, cin, st);
  if (e) return e;
  return reduce((const float*)ws + (size_t)G * cin, (float*)dshift, G, cin, st);
}

template <typename T, int BN>
int launch_dw_tiles(const T* x, const T* y, const T* dy, const Prologue& pro, const float* dsum,
                    const float* dssq, bool stats, float* ws, int M, int cin, int cout, int G,
                    cudaStream_t st) {
  using S = Dw<T, BN>;
  const long long tiles =
      (long long)((cin + tile::BM - 1) / tile::BM) * ((cout + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = conv_bn_dw_kernel<T, BN>;
  int e = set_smem(kern, S::SMEM);
  if (e) return e;
  kern<<<dim3((unsigned)tiles, G), tile::THREADS, S::SMEM, st>>>(x, y, dy, pro, dsum, dssq, stats,
                                                                  ws, M, cin, cout, G);
  return (int)cudaGetLastError();
}

// bn: the tile's columns of cout (the wrapper's plan: 128 or 256)
template <typename T>
int launch_dw(const void* x, const void* y, const void* dy, const void* scale, const void* shift,
              const void* dsum, const void* dssq, void* ws, void* dw, int M, int cin, int cout,
              int G, int bn, int prologue, int relu, int stats, void* stream) {
  if (!shapes_ok<T>(M, cin, cout, G) || !aligned<T>(x) || !aligned<T>(y) || !aligned<T>(dy) ||
      !aligned<T>(ws))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Prologue pro{(const float*)scale, (const float*)shift, prologue != 0, relu != 0};
#define DTF_DW_TILES(BN)                                                                      \
  launch_dw_tiles<T, BN>((const T*)x, (const T*)y, (const T*)dy, pro, (const float*)dsum,    \
                         (const float*)dssq, stats != 0, (float*)ws, M, cin, cout, G, st)
  int e;
  if (bn == 128) e = DTF_DW_TILES(128);
  else if (bn == 256) e = DTF_DW_TILES(256);
  else return (int)cudaErrorInvalidValue;
#undef DTF_DW_TILES
  if (e) return e;
  return reduce((const float*)ws, (float*)dw, G, (long long)cin * cout, st);
}

template <typename T, int CINP, int COUTP>
int launch_single_tiles(const T* x, const T* y, const T* dy, const T* w, long long sk,
                        long long sn, const Prologue& pro, const float* dsum, const float* dssq,
                        bool stats, T* dx, float* ws, int M, int cin, int cout, int G,
                        cudaStream_t st) {
  using S = Single<T, CINP, COUTP>;
  auto kern = conv_bn_single_kernel<T, CINP, COUTP>;
  int e = set_smem(kern, S::SMEM);
  if (e) return e;
  kern<<<G, tile::THREADS, S::SMEM, st>>>(x, y, dy, w, sk, sn, pro, dsum, dssq, stats, dx, ws, M,
                                          cin, cout, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_single(const void* x, const void* y, const void* dy, const void* w, long long sk,
                  long long sn, const void* scale, const void* shift, const void* dsum,
                  const void* dssq, void* dx, void* ws, void* dw, void* dscale, void* dshift,
                  int M, int cin, int cout, int G, int prologue, int relu, int stats,
                  void* stream) {
  if (!shapes_ok<T>(M, cin, cout, G) || !w_ok<T>(w, sk, sn, cin, cout) || !aligned<T>(x) ||
      !aligned<T>(y) || !aligned<T>(dy) || !aligned<T>(dx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Prologue pro{(const float*)scale, (const float*)shift, prologue != 0, relu != 0};
  const int cinp = round_up(cin, 64), coutp = round_up(cout, 64);
#define DTF_SINGLE_TILES(CI, CO)                                                               \
  launch_single_tiles<T, CI, CO>((const T*)x, (const T*)y, (const T*)dy, (const T*)w, sk, sn, \
                                 pro, (const float*)dsum, (const float*)dssq, stats != 0,     \
                                 (T*)dx, (float*)ws, M, cin, cout, G, st)
  // the eight (ceil64(cin), ceil64(cout)) pairs of the wrapper's rule
  int e;
  if (cinp == 64 && coutp == 64) e = DTF_SINGLE_TILES(64, 64);
  else if (cinp == 64 && coutp == 128) e = DTF_SINGLE_TILES(64, 128);
  else if (cinp == 64 && coutp == 192) e = DTF_SINGLE_TILES(64, 192);
  else if (cinp == 64 && coutp == 256) e = DTF_SINGLE_TILES(64, 256);
  else if (cinp == 128 && coutp == 64) e = DTF_SINGLE_TILES(128, 64);
  else if (cinp == 128 && coutp == 128) e = DTF_SINGLE_TILES(128, 128);
  else if (cinp == 192 && coutp == 64) e = DTF_SINGLE_TILES(192, 64);
  else if (cinp == 256 && coutp == 64) e = DTF_SINGLE_TILES(256, 64);
  else return (int)cudaErrorInvalidValue;  // outside the rule: the dx + dw pair's shapes
#undef DTF_SINGLE_TILES
  if (e) return e;
  e = reduce((const float*)ws, (float*)dw, G, (long long)cin * cout, st);
  if (e || !prologue) return e;
  const float* sp = (const float*)ws + (size_t)G * cin * cout;
  e = reduce(sp, (float*)dscale, G, cin, st);
  if (e) return e;
  return reduce(sp + (size_t)G * cin, (float*)dshift, G, cin, st);
}

}  // namespace

extern "C" {

#define DTF_FWD_ARGS                                                                      \
  const void *x, const void *w, long long sk, long long sn, const void *scale,            \
      const void *shift, void *y, void *ws, void *sum, void *ssq, int M, int cin, int cout, \
      int G, int bn, int prologue, int relu, int stats, void *stream
#define DTF_FWD_PASS \
  x, w, sk, sn, scale, shift, y, ws, sum, ssq, M, cin, cout, G, bn, prologue, relu, stats, stream

int conv_bn_fwd_f32(DTF_FWD_ARGS) { return launch_fwd<float>(DTF_FWD_PASS); }
int conv_bn_fwd_bf16(DTF_FWD_ARGS) { return launch_fwd<__nv_bfloat16>(DTF_FWD_PASS); }

// The forward kernel's plan inputs for the wrapper's G: 0 -> rows of M a
// tile, 1 -> CTAs an SM (every tile width and both dtypes take the same)
int conv_bn_fwd_tile(int what) { return what == 0 ? tile::BM : kFwdCtasPerSm; }

#define DTF_DX_ARGS                                                                        \
  const void *x, const void *y, const void *dy, const void *w, long long sk, long long sn, \
      const void *scale, const void *shift, const void *dsum, const void *dssq, void *dx,  \
      void *ws, void *dscale, void *dshift, int M, int cin, int cout, int G, int prologue,  \
      int relu, int stats, void *stream
#define DTF_DX_PASS                                                                          \
  x, y, dy, w, sk, sn, scale, shift, dsum, dssq, dx, ws, dscale, dshift, M, cin, cout, G, \
      prologue, relu, stats, stream

int conv_bn_bwd_dx_f32(DTF_DX_ARGS) { return launch_dx<float>(DTF_DX_PASS); }
int conv_bn_bwd_dx_bf16(DTF_DX_ARGS) { return launch_dx<__nv_bfloat16>(DTF_DX_PASS); }

// The dx kernel's plan inputs for the wrapper's G: 0 -> rows of M a tile,
// 1 -> columns of cin a tile, 2 -> CTAs an SM (both dtypes take the same)
int conv_bn_dx_tile(int what) {
  static_assert(Dx<float>::BN == Dx<__nv_bfloat16>::BN, "one dx tile for both dtypes");
  return what == 0 ? tile::BM : what == 1 ? Dx<float>::BN : kDxCtasPerSm;
}

#define DTF_DW_ARGS                                                                           \
  const void *x, const void *y, const void *dy, const void *scale, const void *shift,         \
      const void *dsum, const void *dssq, void *ws, void *dw, int M, int cin, int cout, int G, \
      int bn, int prologue, int relu, int stats, void *stream
#define DTF_DW_PASS \
  x, y, dy, scale, shift, dsum, dssq, ws, dw, M, cin, cout, G, bn, prologue, relu, stats, stream

int conv_bn_bwd_dw_f32(DTF_DW_ARGS) { return launch_dw<float>(DTF_DW_PASS); }
int conv_bn_bwd_dw_bf16(DTF_DW_ARGS) { return launch_dw<__nv_bfloat16>(DTF_DW_PASS); }

// The dw kernel's plan inputs for the wrapper's tile and G: 0 -> rows of cin
// a tile, 1 -> rows of M a block (a bf16 stage; chunks take whole blocks),
// 2 -> CTAs an SM (both tile widths and dtypes take the same)
int conv_bn_dw_tile(int what) {
  return what == 0 ? tile::BM : what == 1 ? Dw<__nv_bfloat16, 128>::BK : kDwCtasPerSm;
}

#define DTF_SINGLE_ARGS                                                                    \
  const void *x, const void *y, const void *dy, const void *w, long long sk, long long sn, \
      const void *scale, const void *shift, const void *dsum, const void *dssq, void *dx,  \
      void *ws, void *dw, void *dscale, void *dshift, int M, int cin, int cout, int G,      \
      int prologue, int relu, int stats, void *stream
#define DTF_SINGLE_PASS                                                                       \
  x, y, dy, w, sk, sn, scale, shift, dsum, dssq, dx, ws, dw, dscale, dshift, M, cin, cout, G, \
      prologue, relu, stats, stream

int conv_bn_bwd_single_f32(DTF_SINGLE_ARGS) { return launch_single<float>(DTF_SINGLE_PASS); }
int conv_bn_bwd_single_bf16(DTF_SINGLE_ARGS) {
  return launch_single<__nv_bfloat16>(DTF_SINGLE_PASS);
}

// The single-pass kernel's plan inputs for the wrapper's G: 0 -> rows of M
// a tile, 1 -> CTAs an SM (both dtypes and every channel pair take the same)
int conv_bn_single_tile(int what) { return what == 0 ? kSingleRows : kSingleCtasPerSm; }

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
