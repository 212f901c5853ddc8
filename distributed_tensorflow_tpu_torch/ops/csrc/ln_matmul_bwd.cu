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
//     bytes, which keeps ldmatrix free of bank conflicts. K runs in one fixed
//     order. f32 inputs take the same tiling with f32 FMAs on CUDA cores
//     (exact to f32 rounding; never the timed path). The CTAs of the first
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
// Reductions over M (dgamma, dbeta, dbias, dw) use no float atomics: the row
// tiles are dealt to G chunks (chunk c takes tiles c, c+G, ...), each CTA sums
// its chunk in a fixed order into a workspace, and reduce_kernel (dw) or
// reduce2_kernel (dx) adds the G partials of each output in a fixed order. G
// is a function of the shapes and the SM count alone (the wrapper's), so a
// step is bitwise repeatable run to run on one card.
//
// The dx row pass writes each row's mean and rstd ([M] f32) as a by-product and
// the dw kernel reads them instead of re-reading whole rows of x in every CTA
// (a dw CTA sees only a 64-column slice of a row). The function computed is
// unchanged: they are the statistics JAX's dw kernel recomputes from x.
//
// Layout requirements (the wrapper checks, the launchers re-check): d and n
// multiples of 8; x, dy, dx contiguous with 16-byte aligned bases; w with a
// unit stride in one dim, the other a multiple of the 16-byte vector. Any M:
// rows past M are zero in every staged tile and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 8;  // m16n8 fragments per warp: 16 x 64 outputs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// row pitch of a row-major shared tile of n columns: 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int pad_ld(int n) { return n + 16 / (int)sizeof(T); }

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

// One warp: acc (16 x 64, m16n8 fragments) += A (16 x K) * B (K x 64), both in
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

// ---------------------------------------------------------------------------
// dx, dgamma, dbeta, dbias
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (src-size 0
// reads nothing, but the address must still be a valid one)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

constexpr int DH_BM = 128;      // rows of dy (and dh) per tile: 2 warps of 64
constexpr int DH_BN = 128;      // columns of d per tile
constexpr int DH_WN = 32;       // columns of d per warp
constexpr int DH_KB = 128;      // bytes of depth (along n) per stage
constexpr int DH_STAGES = 3;    // depth of the cp.async ring
constexpr int DH_MIN_CTAS = 2;  // CTAs an SM keeps resident (caps the registers)
constexpr int DH_WARPS = 2 * DH_BN / DH_WN;
constexpr int DH_THREADS = 32 * DH_WARPS;

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

// Stage the depth slice k0.. of the tile (m0.., j0..) with cp.async: C
// 16-byte chunks, chunk i at (row, col) = (i / P, i % P * V) of a tile with
// P chunks a row.
template <typename T, int C, int P>
__device__ __forceinline__ void dh_copy(T* dst, int ld, const T* __restrict__ src,
                                        long long sr, int r0, int rows, int c0, int cols) {
  constexpr int V = 16 / sizeof(T);
  static_assert(C % DH_THREADS == 0, "every thread copies as many chunks");
#pragma unroll
  for (int u = 0; u < C / DH_THREADS; ++u) {
    const int i = threadIdx.x + u * DH_THREADS;
    const int r = i / P, c = i % P * V;
    const bool ok = r0 + r < rows && c0 + c < cols;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(r0 + r) * sr + c0 + c : src, ok);
  }
}

template <typename T>
__device__ __forceinline__ void dh_load(T* As, T* Bs, const T* __restrict__ dy,
                                        const T* __restrict__ w, long long sk, long long sn,
                                        int M, int d, int n, int m0, int j0, int k0) {
  using S = Dh<T>;
  constexpr int V = S::V, BK = S::BK;
  dh_copy<T, DH_BM * BK / V, BK / V>(As, S::LDA, dy, n, m0, M, k0, n);
  if (sn == 1)  // w[j, k], k contiguous: Bs[j][k]
    dh_copy<T, DH_BN * BK / V, BK / V>(Bs, S::LDK, w, sk, j0, d, k0, n);
  else  // w[j, k], j contiguous: Bs[k][j]
    dh_copy<T, DH_BN * BK / V, DH_BN / V>(Bs, S::LDN, w, sn, k0, n, j0, d);
}

// One warp's 64 x WN tile += its rows of As times its columns of Bs over
// one stage, with mma.sync m16n8k16 on ldmatrix fragments. acc[i][j] is the
// m16n8 fragment (rows wm + 16i.., columns wn + 8j..): lane (g = lane / 4,
// t = lane % 4) holds rows g, g + 8 and columns 2t, 2t + 1.
__device__ __forceinline__ void dh_stage(float (&acc)[4][Dh<__nv_bfloat16>::NJ][4],
                                         const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                         bool kmajor, int wm, int wn, int lane) {
  using S = Dh<__nv_bfloat16>;
#pragma unroll
  for (int kk = 0; kk < S::BK; kk += 16) {
    uint32_t a[4][4];
    // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldsm_x4(a[i], As + (wm + 16 * i + (lane & 15)) * S::LDA + kk + 8 * (lane >> 4));
    // B, two m16n8 columns at a time: matrices (columns 8j.., k 0-7), (8j.., k
    // 8-15), (8j+8.., k 0-7), (8j+8.., k 8-15); lane gets B(k = 2t, 2t+1;
    // column g) from either layout
#pragma unroll
    for (int j = 0; j < S::NJ; j += 2) {
      uint32_t b[4];
      if (kmajor)
        ldsm_x4(b, Bs + (wn + 8 * j + (lane & 7) + 8 * (lane >> 4)) * S::LDK + kk +
                       8 * ((lane >> 3) & 1));
      else
        ldsm_x4_trans(b, Bs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * S::LDN + wn +
                             8 * j + 8 * (lane >> 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// The same tile product in f32 on CUDA cores, in the same fragment layout,
// each output summed over k in order.
__device__ __forceinline__ void dh_stage(float (&acc)[4][Dh<float>::NJ][4], const float* As,
                                         const float* Bs, bool kmajor, int wm, int wn,
                                         int lane) {
  using S = Dh<float>;
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < S::BK; ++k) {
    float a[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i][0] = As[(wm + 16 * i + g) * S::LDA + k];
      a[i][1] = As[(wm + 16 * i + g + 8) * S::LDA + k];
    }
#pragma unroll
    for (int j = 0; j < S::NJ; ++j) {
      const int c = wn + 8 * j + 2 * t;
      const float b0 = kmajor ? Bs[c * S::LDK + k] : Bs[k * S::LDN + c];
      const float b1 = kmajor ? Bs[(c + 1) * S::LDK + k] : Bs[k * S::LDN + c + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j][0] = fmaf(a[i][0], b0, acc[i][j][0]);
        acc[i][j][1] = fmaf(a[i][0], b1, acc[i][j][1]);
        acc[i][j][2] = fmaf(a[i][1], b0, acc[i][j][2]);
        acc[i][j][3] = fmaf(a[i][1], b1, acc[i][j][3]);
      }
    }
  }
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < S::NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
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
    dh_stage(acc, As, As + S::A_ELEMS, kmajor, wm, wn, lane);
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

// 8 consecutive elements (16-byte aligned): raw, then as f32
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ void load_raw(const T* p, Raw8<T>& r) {
#pragma unroll
  for (int q = 0; q < (int)sizeof(T) / 2; ++q) r.u[q] = reinterpret_cast<const uint4*>(p)[q];
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u[0]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x, v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(&r.u[0]);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = f[q];
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  Raw8<T> r;
  load_raw(p, r);
  unpack(r, v);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

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

constexpr int DW_WARPS = 4;
constexpr int DW_THREADS = 32 * DW_WARPS;
constexpr int DW_BM = 64;  // rows of d in a dw block (16 per warp)
constexpr int DW_BN = 64;  // columns of n
constexpr int DW_BK = 64;  // rows of x / dy per staged chunk

// grid (n tiles, d tiles, G): CTA (j, i, c) accumulates the [64 x 64] block
// (i, j) of dw over the row chunks c, c+G, ... into ws[c][d][n]. Both
// operands are staged as the rows lie (h = the normalised x chunk [BK][BM],
// the dy chunk [BK][BN]) and the fragment loads read them transposed: the row
// index is the contraction, A(m = d, k = row) = h^T, B(k = row, n) = dy.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
ln_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 float* __restrict__ ws, int M, int d, int n, int G) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LD = pad_ld<T>(DW_BM);  // DW_BM == DW_BN: one pitch for both tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* Hs = reinterpret_cast<T*>(smem);  // [BK][LD] h rows
  T* Ds = Hs + DW_BK * LD;             // [BK][LD] dy rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * DW_BN, m0 = blockIdx.y * DW_BM;
  const int rtiles = (M + DW_BK - 1) / DW_BK;
  float acc[NT][4];
  zero(acc);
  for (int rt = blockIdx.z; rt < rtiles; rt += G) {
    const int r0 = rt * DW_BK;
    __syncthreads();
    // h = (x - mean) * rstd * gamma + beta, rounded to T
    for (int i = tid; i < DW_BK * (DW_BM / V); i += DW_THREADS) {
      const int r = i / (DW_BM / V), c = (i % (DW_BM / V)) * V;
      const int gr = r0 + r, gc = m0 + c;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M && gc < d) {
        const uint4 v = *reinterpret_cast<const uint4*>(x + (size_t)gr * d + gc);
        const T* s = reinterpret_cast<const T*>(&v);
        T* e = reinterpret_cast<T*>(&out);
        const float mu = mean[gr], rs = rstd[gr];
#pragma unroll
        for (int q = 0; q < V; ++q)
          e[q] = from_f32<T>((to_f32(s[q]) - mu) * rs * gamma[gc + q] + beta[gc + q]);
      }
      *reinterpret_cast<uint4*>(Hs + r * LD + c) = out;
    }
    for (int i = tid; i < DW_BK * (DW_BN / V); i += DW_THREADS) {
      const int r = i / (DW_BN / V), c = (i % (DW_BN / V)) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < M && n0 + c < n)
        v = *reinterpret_cast<const uint4*>(dy + (size_t)(r0 + r) * n + n0 + c);
      *reinterpret_cast<uint4*>(Ds + r * LD + c) = v;
    }
    __syncthreads();
    warp_mma(acc, Hs + warp * 16, 1, LD, Ds, 1, LD, DW_BK, lane);
  }
  const int g = lane >> 2, t = lane & 3;
  float* part = ws + (size_t)blockIdx.z * d * n;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + g + 8 * h;
      if (m < d && c < n)
        *reinterpret_cast<float2*>(part + (size_t)m * n + c) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// out[i] = sum over g < G, in order, of ws[g*len + i], cast to TOut
template <typename TOut>
__global__ void reduce_kernel(const float* __restrict__ ws, TOut* __restrict__ out, int G,
                              long long len) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += ws[(size_t)g * len + i];
    out[i] = from_f32<TOut>(s);
  }
}

template <typename TOut>
int reduce(const float* ws, TOut* out, int G, long long len, cudaStream_t st) {
  const long long blocks = (len + 255) / 256;
  reduce_kernel<TOut><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(ws, out, G, len);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// w [K, N] through strides (sk, sn): one unit stride, the other and the
// extent along the unit one multiples of the 16-byte vector
template <typename T>
bool w_ok(const void* w, long long sk, long long sn, int K, int N) {
  constexpr int V = 16 / sizeof(T);
  if (!aligned(w)) return false;
  if (sk == 1) return sn % V == 0 && K % V == 0;
  if (sn == 1) return sk % V == 0 && N % V == 0;
  return false;
}

bool shapes_ok(int M, int d, int n, int G) {
  return M >= 1 && d >= 8 && n >= 8 && d % 8 == 0 && n % 8 == 0 && G >= 1 && G <= 65535;
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <typename T>
int launch_dx(const void* x, const void* gamma, const void* w, long long sk, long long sn,
              const void* dy, void* dx, void* mean, void* rstd, void* ws, void* out, int M,
              int d, int n, int G, float eps, void* stream) {
  if (!shapes_ok(M, d, n, G) || !w_ok<T>(w, sk, sn, d, n) || !aligned(x) || !aligned(dy) ||
      !aligned(dx))
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
int launch_dw(const void* x, const void* gamma, const void* beta, const void* dy,
              const void* mean, const void* rstd, void* ws, void* dw, int M, int d, int n, int G,
              void* stream) {
  if (!shapes_ok(M, d, n, G) || !aligned(x) || !aligned(dy)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(T) * 2 * DW_BK * pad_ld<T>(DW_BM);
  auto kern = ln_bwd_dw_kernel<T>;
  int e = set_smem(kern, smem);
  if (e) return e;
  kern<<<dim3((n + DW_BN - 1) / DW_BN, (d + DW_BM - 1) / DW_BM, G), DW_THREADS, smem, st>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (const T*)dy, (const float*)mean,
      (const float*)rstd, (float*)ws, M, d, n, G);
  e = (int)cudaGetLastError();
  if (e) return e;
  return reduce<T>((const float*)ws, (T*)dw, G, (long long)d * n, st);
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
