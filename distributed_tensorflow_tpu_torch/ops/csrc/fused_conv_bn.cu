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
// f32 and h is rounded to x's dtype before the product; products accumulate
// in f32; y is rounded to its dtype and the statistics are taken from the
// ROUNDED y (what an unfused consumer would read back). In the backward the
// output gradient g = dy + dsum + 2*y*dssq (the stats outputs' cotangents
// folded in) is rounded to dy's dtype before both products; the ReLU mask is
// x*scale+shift > 0 in f32; dx = dh*scale rounded to x's dtype;
// dscale = sum_rows dh*x, dshift = sum_rows dh; dw in f32.
//
// What bounds them on this card: at ResNet-50's batch-256 shapes every one is
// bound by bytes (x, y, dy, dx are up to 802816 rows; w is at most 4 MB), not
// by operations (the bound per shape is in PERF.md). The design keeps the
// fused tensors out of device memory, as on the TPU: the prologue runs while a
// tile of x is staged in shared memory (the normalised tensor is never
// written), the statistics are summed from the y tile in shared memory (y is
// never read back), and the backward recomputes h from x. Products are
// mma.sync m16n8k16 bf16 tiles (f32 inputs: the same tile loops on CUDA
// cores, for checks). The forward, dw and single-pass kernels are the first,
// simple design: 64x64 tiles, 4 warps, synchronous 16-byte staging, no
// cp.async pipelining, no wgmma.
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
// Reductions over M (the statistics, dscale/dshift, dw) use no float atomics:
// the TPU kernels carry them across a sequential grid axis; here the M tiles
// are dealt to G chunks (chunk c takes tiles c, c+G, ...), each CTA writes
// its chunk's partial to a workspace, and reduce_kernel sums the G partials
// of each output in chunk order. G is a function of the shapes alone (the
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

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;  // rows of an M tile, 16 per warp
constexpr int BN = 64;           // columns of a tile: 8 m16n8 fragments per warp
constexpr int BK = 64;           // depth of one staged chunk
constexpr int NT = BN / 8;
constexpr int LDT = BK + 2;      // row pitch of transposed (dw) tiles: even, off the bank stride

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

// row pitch of a row-major shared tile of n columns: 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int pad_ld(int n) { return n + 16 / (int)sizeof(T); }
__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

// two bf16 values at a[0] and a[s] in one register, the lower index in the
// lower half (the mma fragment order)
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* a, int s) {
  return s == 1 ? *reinterpret_cast<const uint32_t*>(a) : (bits(a[0]) | (bits(a[s]) << 16));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc (16 x BN, m16n8 fragments) += A (16 x K) * B (K x BN), both in
// shared memory: A(m, k) = a[m*am + k*ak], B(k, n) = b[n*bn + k*bk]; K a
// multiple of 16. Fragment layout (PTX m16n8k16): g = lane / 4, t = lane % 4;
// acc[j] holds rows g and g + 8, columns 8j + 2t and 8j + 2t + 1.
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const __nv_bfloat16* a, int am,
                                         int ak, const __nv_bfloat16* b, int bn, int bk, int K,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int kc = 0; kc < K; kc += 16) {
    const int k0 = kc + 2 * t;
    uint32_t af[4];
    af[0] = pair(a + g * am + k0 * ak, ak);
    af[1] = pair(a + (g + 8) * am + k0 * ak, ak);
    af[2] = pair(a + g * am + (k0 + 8) * ak, ak);
    af[3] = pair(a + (g + 8) * am + (k0 + 8) * ak, ak);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* bj = b + (8 * j + g) * bn;
      mma_bf16(acc[j], af, pair(bj + k0 * bk, bk), pair(bj + (k0 + 8) * bk, bk));
    }
  }
}

// The same tile product in f32 on CUDA cores, in the same fragment layout.
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, int am, int ak,
                                         const float* b, int bn, int bk, int K, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * am + k * ak], a1 = a[(g + 8) * am + k * ak];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = b[(8 * j + 2 * t) * bn + k * bk];
      const float b1 = b[(8 * j + 2 * t + 1) * bn + k * bk];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// The previous BatchNorm's affine (+ReLU), applied to one f32 value of
// column c; the identity when off.
struct Prologue {
  const float* scale;
  const float* shift;
  bool on, relu;
  __device__ __forceinline__ float operator()(float v, int c) const {
    if (!on) return v;
    const float h = v * scale[c] + shift[c];
    return relu ? fmaxf(h, 0.f) : h;
  }
};

// Stage the [rows x cols] window at (r0, c0) of a row-major [R, C] matrix into
// shared memory as f(value, column), rounded to T: dst[r*ld + c], or
// dst[c*ld + r] when kTrans. Elements outside [R, C) are zero (f is not
// applied to them). 16-byte loads: cols and C are multiples of the vector.
template <typename T, bool kTrans, typename F>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src, int R, int C,
                                      int r0, int c0, int rows, int cols, F f) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i - r * vpr) * V;
    const int gr = r0 + r, gc = c0 + c;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&out);
    if (gr < R && gc < C) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)gr * C + gc);
      const T* s = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_f32<T>(f(to_f32(s[j]), gc + j));
    }
    if constexpr (kTrans) {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[(c + j) * ld + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = out;
    }
  }
}

// Stage the output gradient g = dy (+ dsum + 2*y*dssq with the statistics),
// rounded to T, as ``stage`` does (dy and y row-major [M, C]).
template <typename T, bool kTrans>
__device__ __forceinline__ void stage_g(T* dst, int ld, const T* __restrict__ dy,
                                        const T* __restrict__ y, const float* __restrict__ dsum,
                                        const float* __restrict__ dssq, bool stats, int M, int C,
                                        int r0, int c0, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i - r * vpr) * V;
    const int gr = r0 + r, gc = c0 + c;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&out);
    if (gr < M && gc < C) {
      const size_t off = (size_t)gr * C + gc;
      const uint4 vd = *reinterpret_cast<const uint4*>(dy + off);
      const uint4 vy = stats ? *reinterpret_cast<const uint4*>(y + off) : make_uint4(0u, 0u, 0u, 0u);
      const T* d = reinterpret_cast<const T*>(&vd);
      const T* yy = reinterpret_cast<const T*>(&vy);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float gv = to_f32(d[j]);
        if (stats) gv = gv + dsum[gc + j] + 2.f * to_f32(yy[j]) * dssq[gc + j];
        e[j] = from_f32<T>(gv);
      }
    }
    if constexpr (kTrans) {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[(c + j) * ld + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = out;
    }
  }
}

// Stage B(k, n) = w[k*sk + n*sn] for k in [k0, k0+nk), n in [n0, n0+nn) as
// dst[n*ld + (k - k0)] (k contiguous: the fragment loads read it 32 bits at
// a time); zero outside [K, N). 16-byte loads along w's unit-stride dim.
template <typename T>
__device__ __forceinline__ void stage_w(T* dst, int ld, const T* __restrict__ w, long long sk,
                                        long long sn, int K, int N, int k0, int n0, int nk,
                                        int nn) {
  constexpr int V = 16 / sizeof(T);
  if (sk == 1) {
    const int vpr = nk / V;
    for (int i = threadIdx.x; i < nn * vpr; i += kThreads) {
      const int n = i / vpr, k = (i - n * vpr) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < N && k0 + k < K)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * sn + k0 + k);
      *reinterpret_cast<uint4*>(dst + n * ld + k) = v;
    }
  } else {
    const int vpr = nn / V;
    for (int i = threadIdx.x; i < nk * vpr; i += kThreads) {
      const int k = i / vpr, n = (i - k * vpr) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + k < K && n0 + n < N)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * sk + n0 + n);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[(n + j) * ld + k] = e[j];
    }
  }
}

// The dgrad epilogue of one warp's 16 x BN fragment dh (rows rw.., columns
// c0.. of cin): with the prologue, the ReLU mask from x (read from the shared
// x tile xs, row pitch ldx), dx = dh*scale, and the warp's column sums of
// dh*x and dh into red[0/1][warp][column]; without it dx = dh. dx is stored
// straight from the fragments, two columns per store.
template <typename T>
__device__ __forceinline__ void dh_epilogue(const float (&acc)[NT][4], const T* xs, int ldx,
                                            const Prologue& pro, int c0, int rw, int M, int C,
                                            T* __restrict__ dx, float* red, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t, gc = c0 + col;
    float sx[2] = {0.f, 0.f}, sd[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h, row = rw + r;
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float d = acc[j][2 * h + e];
        out[e] = d;
        if (pro.on && gc + e < C) {
          const float xv = row < M ? to_f32(xs[r * ldx + col + e]) : 0.f;
          if (pro.relu && !(xv * pro.scale[gc + e] + pro.shift[gc + e] > 0.f)) d = 0.f;
          out[e] = d * pro.scale[gc + e];
          sx[e] += d * xv;
          sd[e] += d;
        }
      }
      if (row < M && gc < C) store2(dx + (size_t)row * C + gc, out[0], out[1]);
    }
    if (pro.on) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sx[e] += __shfl_xor_sync(0xffffffffu, sx[e], o);
          sd[e] += __shfl_xor_sync(0xffffffffu, sd[e], o);
        }
      }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[(0 * kWarps + warp) * BN + col + e] = sx[e];
          red[(1 * kWarps + warp) * BN + col + e] = sd[e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward: y = prologue(x) @ w, statistics of the rounded y
// ---------------------------------------------------------------------------

// grid (cout tiles, G). CTA (n, c) computes columns n*BN.. of y for the M
// tiles c, c+G, ...; its running column sums go to ws[0/1][c][cout].
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, long long sk, long long sn,
                   Prologue pro, T* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
                   int G, bool stats) {
  constexpr int LD = pad_ld<T>(BK);  // BK == BN: one pitch for the A, B and y tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [BM][LD] prologue(x) chunk, then the rounded y tile
  T* Bs = As + BM * LD;                // [BN][LD] w chunk, B(k, n) at Bs[n*LD + k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, mtiles = (M + BM - 1) / BM;
  const int q = tid / BN, col = tid % BN;  // this thread's running sum (q 0) or sum of squares (q 1)
  constexpr int V = 16 / sizeof(T);
  float run = 0.f;
  for (int mt = blockIdx.y; mt < mtiles; mt += G) {
    const int r0 = mt * BM;
    float acc[NT][4];
    zero(acc);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();
      stage<T, false>(As, LD, x, M, K, r0, k0, BM, BK,
                      [=](float v, int c) { return pro(v, c); });
      stage_w<T>(Bs, LD, w, sk, sn, K, N, k0, n0, BK, BN);
      __syncthreads();
      warp_mma(acc, As + warp * 16 * LD, LD, 1, Bs, LD, 1, min(BK, round_up(K - k0, 16)), lane);
    }
    __syncthreads();
    {
      const int g = lane >> 2, t = lane & 3;
      T* cs = As + warp * 16 * LD;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        cs[g * LD + c] = from_f32<T>(acc[j][0]);
        cs[g * LD + c + 1] = from_f32<T>(acc[j][1]);
        cs[(g + 8) * LD + c] = from_f32<T>(acc[j][2]);
        cs[(g + 8) * LD + c + 1] = from_f32<T>(acc[j][3]);
      }
    }
    __syncthreads();
    const int rows = min(BM, M - r0);
    for (int i = tid; i < rows * (BN / V); i += kThreads) {
      const int r = i / (BN / V), c = (i % (BN / V)) * V;
      if (n0 + c < N)
        *reinterpret_cast<uint4*>(y + (size_t)(r0 + r) * N + n0 + c) =
            *reinterpret_cast<const uint4*>(As + r * LD + c);
    }
    if (stats && n0 + col < N) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float v = to_f32(As[r * LD + col]);
        s += q ? v * v : v;
      }
      run += s;
    }
  }
  if (stats && n0 + col < N) ws[((size_t)q * G + blockIdx.y) * N + n0 + col] = run;
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
              if (pro.relu && !(xe[e] * sc[j][e] + sh[j][e] > 0.f)) d = 0.f;
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

// grid (cout tiles, cin tiles, G): CTA (n, m, c) accumulates the [BM x BN]
// block (m, n) of dw over the row tiles c, c+G, ... into ws[c][cin][cout].
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bn_dw_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
                  Prologue pro, const float* __restrict__ dsum, const float* __restrict__ dssq,
                  bool stats, float* __restrict__ ws, int M, int cin, int cout, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [BM (cin)][LDT]: h^T, A(m, k) at As[m*LDT + k]
  T* Bs = As + BM * LDT;               // [BN (cout)][LDT]: g^T, B(k, n) at Bs[n*LDT + k]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, rtiles = (M + BK - 1) / BK;
  float acc[NT][4];
  zero(acc);
  for (int rt = blockIdx.z; rt < rtiles; rt += G) {
    const int r0 = rt * BK;
    __syncthreads();
    stage<T, true>(As, LDT, x, M, cin, r0, m0, BK, BM, [=](float v, int c) { return pro(v, c); });
    stage_g<T, true>(Bs, LDT, dy, y, dsum, dssq, stats, M, cout, r0, n0, BK, BN);
    __syncthreads();
    warp_mma(acc, As + warp * 16 * LDT, LDT, 1, Bs, LDT, 1, BK, lane);
  }
  const int g = lane >> 2, t = lane & 3;
  float* part = ws + (size_t)blockIdx.z * cin * cout;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + g + 8 * h;
      if (m < cin && n < cout) store2(part + (size_t)m * cout + n, acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, single pass: dx, dscale, dshift and dw in one sweep over x, y, dy
// ---------------------------------------------------------------------------

// grid (G): CTA c sweeps the M tiles c, c+G, ... with w resident in shared
// memory and its whole [cin, cout] f32 dw partial accumulated there; the
// partials go to ws: dw [G][cin][cout], then dscale/dshift [2][G][cin].
// cinp/coutp are cin/cout rounded up to BN.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bn_single_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
                      const T* __restrict__ w, long long sk, long long sn, Prologue pro,
                      const float* __restrict__ dsum, const float* __restrict__ dssq, bool stats,
                      T* __restrict__ dx, float* __restrict__ ws, int M, int cin, int cout,
                      int G, int cinp, int coutp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldg = pad_ld<T>(coutp), ldx = pad_ld<T>(cinp);
  float* dws = reinterpret_cast<float*>(smem);  // [cinp][coutp] dw accumulator
  float* red = dws + cinp * coutp;              // [2][kWarps][BN]
  float* run = red + 2 * kWarps * BN;           // [2][cinp] dscale, dshift
  T* Ws = reinterpret_cast<T*>(run + 2 * cinp);  // [cinp][ldg] B(k = cout, n = cin)
  T* Gs = Ws + cinp * ldg;                       // [BM][ldg] g tile
  T* Xs = Gs + BM * ldg;                         // [BM][ldx] x tile, then h
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (M + BM - 1) / BM, nb = coutp / BN;
  for (int i = tid; i < cinp * coutp; i += kThreads) dws[i] = 0.f;
  for (int i = tid; i < 2 * cinp; i += kThreads) run[i] = 0.f;
  stage_w<T>(Ws, ldg, w, sn, sk, cout, cin, 0, 0, coutp, cinp);
  for (int mt = blockIdx.x; mt < mtiles; mt += G) {
    const int r0 = mt * BM;
    __syncthreads();
    stage_g<T, false>(Gs, ldg, dy, y, dsum, dssq, stats, M, cout, r0, 0, BM, coutp);
    stage<T, false>(Xs, ldx, x, M, cin, r0, 0, BM, cinp, [](float v, int) { return v; });
    __syncthreads();
    for (int c0 = 0; c0 < cinp; c0 += BN) {
      float acc[NT][4];
      zero(acc);
      warp_mma(acc, Gs + warp * 16 * ldg, ldg, 1, Ws + c0 * ldg, ldg, 1, coutp, lane);
      dh_epilogue<T>(acc, Xs + warp * 16 * ldx + c0, ldx, pro, c0, r0 + warp * 16, M, cin, dx,
                     red, warp, lane);
      __syncthreads();
      if (pro.on) {
        const int q = tid / BN, col = tid % BN;
        run[q * cinp + c0 + col] += red[(q * kWarps + 0) * BN + col] +
                                    red[(q * kWarps + 1) * BN + col] +
                                    red[(q * kWarps + 2) * BN + col] +
                                    red[(q * kWarps + 3) * BN + col];
      }
      __syncthreads();
    }
    if (pro.on) {  // h = prologue(x), rounded, in place (padding rows/columns stay 0)
      for (int i = tid; i < BM * cinp; i += kThreads) {
        const int r = i / cinp, c = i - r * cinp;
        if (r0 + r < M && c < cin) Xs[r * ldx + c] = from_f32<T>(pro(to_f32(Xs[r * ldx + c]), c));
      }
      __syncthreads();
    }
    // dw += h^T g over this tile's rows: A(m = cin, k = row) = Xs[k*ldx + m],
    // B(k = row, n = cout) = Gs[k*ldg + n]; the accumulator round-trips
    // through shared memory in the fragment layout
    for (int b = warp; b < (cinp / 16) * nb; b += kWarps) {
      const int mb = b / nb, n0 = (b - mb * nb) * BN;
      float* d0 = dws + (mb * 16 + g) * coutp + n0 + 2 * t;
      float* d1 = d0 + 8 * coutp;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] = d0[8 * j], acc[j][1] = d0[8 * j + 1];
        acc[j][2] = d1[8 * j], acc[j][3] = d1[8 * j + 1];
      }
      warp_mma(acc, Xs + mb * 16, 1, ldx, Gs + n0, 1, ldg, BM, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        d0[8 * j] = acc[j][0], d0[8 * j + 1] = acc[j][1];
        d1[8 * j] = acc[j][2], d1[8 * j + 1] = acc[j][3];
      }
    }
  }
  __syncthreads();
  float* part = ws + (size_t)blockIdx.x * cin * cout;
  for (int i = tid; i < cin * cout; i += kThreads) {
    const int m = i / cout, n = i - m * cout;
    part[i] = dws[m * coutp + n];
  }
  if (pro.on) {
    float* sp = ws + (size_t)G * cin * cout;
    for (int i = tid; i < 2 * cin; i += kThreads) {
      const int q = i / cin, c = i - q * cin;
      sp[((size_t)q * G + blockIdx.x) * cin + c] = run[q * cinp + c];
    }
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

template <typename T>
int launch_fwd(const void* x, const void* w, long long sk, long long sn, const void* scale,
               const void* shift, void* y, void* ws, void* sum, void* ssq, int M, int cin,
               int cout, int G, int prologue, int relu, int stats, void* stream) {
  if (!shapes_ok<T>(M, cin, cout, G) || !w_ok<T>(w, sk, sn, cin, cout) || !aligned<T>(x) ||
      !aligned<T>(y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Prologue pro{(const float*)scale, (const float*)shift, prologue != 0, relu != 0};
  const size_t smem = sizeof(T) * 2 * BM * pad_ld<T>(BK);
  auto kern = conv_bn_fwd_kernel<T>;
  int e = set_smem(kern, smem);
  if (e) return e;
  kern<<<dim3((cout + BN - 1) / BN, G), kThreads, smem, st>>>(
      (const T*)x, (const T*)w, sk, sn, pro, (T*)y, (float*)ws, M, cin, cout, G, stats != 0);
  e = (int)cudaGetLastError();
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

template <typename T>
int launch_dw(const void* x, const void* y, const void* dy, const void* scale, const void* shift,
              const void* dsum, const void* dssq, void* ws, void* dw, int M, int cin, int cout,
              int G, int prologue, int relu, int stats, void* stream) {
  if (!shapes_ok<T>(M, cin, cout, G) || !aligned<T>(x) || !aligned<T>(y) || !aligned<T>(dy))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Prologue pro{(const float*)scale, (const float*)shift, prologue != 0, relu != 0};
  const size_t smem = sizeof(T) * (BM + BN) * LDT;
  auto kern = conv_bn_dw_kernel<T>;
  int e = set_smem(kern, smem);
  if (e) return e;
  kern<<<dim3((cout + BN - 1) / BN, (cin + BM - 1) / BM, G), kThreads, smem, st>>>(
      (const T*)x, (const T*)y, (const T*)dy, pro, (const float*)dsum, (const float*)dssq,
      stats != 0, (float*)ws, M, cin, cout, G);
  e = (int)cudaGetLastError();
  if (e) return e;
  return reduce((const float*)ws, (float*)dw, G, (long long)cin * cout, st);
}

template <typename T>
size_t single_smem(int cin, int cout) {
  const int cinp = round_up(cin, BN), coutp = round_up(cout, BN);
  return sizeof(float) * ((size_t)cinp * coutp + 2 * kWarps * BN + 2 * cinp) +
         sizeof(T) * ((size_t)(cinp + BM) * pad_ld<T>(coutp) + (size_t)BM * pad_ld<T>(cinp));
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
  const size_t smem = single_smem<T>(cin, cout);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // the wrapper's rule keeps it under
  cudaStream_t st = (cudaStream_t)stream;
  const Prologue pro{(const float*)scale, (const float*)shift, prologue != 0, relu != 0};
  auto kern = conv_bn_single_kernel<T>;
  int e = set_smem(kern, smem);
  if (e) return e;
  kern<<<G, kThreads, smem, st>>>((const T*)x, (const T*)y, (const T*)dy, (const T*)w, sk, sn,
                                  pro, (const float*)dsum, (const float*)dssq, stats != 0,
                                  (T*)dx, (float*)ws, M, cin, cout, G, round_up(cin, BN),
                                  round_up(cout, BN));
  e = (int)cudaGetLastError();
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
      int G, int prologue, int relu, int stats, void *stream
#define DTF_FWD_PASS x, w, sk, sn, scale, shift, y, ws, sum, ssq, M, cin, cout, G, prologue, relu, stats, stream

int conv_bn_fwd_f32(DTF_FWD_ARGS) { return launch_fwd<float>(DTF_FWD_PASS); }
int conv_bn_fwd_bf16(DTF_FWD_ARGS) { return launch_fwd<__nv_bfloat16>(DTF_FWD_PASS); }

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
      int prologue, int relu, int stats, void *stream
#define DTF_DW_PASS \
  x, y, dy, scale, shift, dsum, dssq, ws, dw, M, cin, cout, G, prologue, relu, stats, stream

int conv_bn_bwd_dw_f32(DTF_DW_ARGS) { return launch_dw<float>(DTF_DW_PASS); }
int conv_bn_bwd_dw_bf16(DTF_DW_ARGS) { return launch_dw<__nv_bfloat16>(DTF_DW_PASS); }

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

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
