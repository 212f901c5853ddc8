// Fused LayerNorm + matmul backward for Hopper (sm_90a), plain C interface
// (ctypes): the two kernels behind the backward of y = LN(x; gamma, beta) @ w
// + bias.
//
// Replaces, in distributed_tensorflow_tpu/ops/fused_ln_matmul.py:
//   ln_bwd_dx  <- _bwd_dx_kernel  dh = dy @ w^T (f32), then the coupled LayerNorm
//                                 backward dx = (dh*gamma - m1 - xhat*m2) * rstd with
//                                 m1 = mean(dh*gamma), m2 = mean(dh*gamma*xhat) over
//                                 the row, and dgamma = sum dh*xhat, dbeta = sum dh,
//                                 dbias = sum dy (sums over the rows, f32)
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
// (PERF.md). The hard part of dx is that the LayerNorm backward is row-local
// over the WHOLE d: m1 and m2 need every column of dh. So a dx CTA owns BM = 32
// whole rows: it accumulates dh [32, d] in f32 in shared memory, one 256-column
// block at a time (8 warps: 2 row groups x 4 column groups of 16 x 64 mma.sync
// m16n8k16 bf16 fragments), looping the product over n, then runs the row-local
// backward from shared memory. dh never reaches device memory. Operands are
// staged as they lie in device memory (16-byte vectors along the unit-stride
// dim, no transpose through shared memory) and the fragment loads follow the
// layout; the next chunk is loaded into registers while the current one is
// multiplied. Simple first: w re-read (from L2) by every CTA, no cp.async,
// no TMA, no wgmma.
//
// Reductions over M (dgamma, dbeta, dbias, dw) use no float atomics: the row
// tiles are dealt to G chunks (chunk c takes tiles c, c+G, ...), each CTA sums
// its chunk in a fixed order into a workspace, and reduce_kernel adds the G
// partials of each output in chunk order. G is a function of the shapes alone
// (the wrapper's), so a step is bitwise repeatable run to run.
//
// The dx kernel writes each row's mean and rstd ([M] f32) as a by-product and
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
__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// The statistics of one row of x (one warp, every lane returns them): the f32
// mean, then the mean of squared deviations — the forward kernel's order.
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* __restrict__ xr, int d, float eps,
                                            int lane) {
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += to_f32(xr[k]);
  const float mu = warp_sum(s) / d;
  float v = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float t = to_f32(xr[k]) - mu;
    v += t * t;
  }
  return make_float2(mu, rsqrtf(warp_sum(v) / d + eps));
}

// ---------------------------------------------------------------------------
// dx, dgamma, dbeta, dbias
// ---------------------------------------------------------------------------

constexpr int DX_WARPS = 8;
constexpr int DX_THREADS = 32 * DX_WARPS;
constexpr int DX_BM = 32;   // rows a CTA owns: 2 row groups of 16
constexpr int DX_CB = 256;  // columns of d per product pass: 4 column groups of 64
constexpr int DX_BK = 64;   // depth (along n) of one staged chunk

__host__ __device__ constexpr int dh_pitch(int d) { return round_up(d, DX_CB) + 4; }

// the w chunk takes CB*pad_ld(BK) elements in the [j][k] layout and
// BK*pad_ld(CB), fewer, in the [k][j] one
template <typename T>
__host__ __device__ constexpr size_t dx_smem(int d, int n) {
  return sizeof(float) * ((size_t)DX_BM * dh_pitch(d) + 2 * DX_BM + 2 * (size_t)d + n) +
         sizeof(T) * ((size_t)DX_BM * pad_ld<T>(DX_BK) + (size_t)DX_CB * pad_ld<T>(DX_BK));
}

// One chunk of the dx product's operands in registers: the dy rows [BM x BK]
// and w's [CB (d) x BK (n)] slice, loaded with 16-byte vectors along each
// one's unit-stride dim and stored to shared memory as they lie — no
// transpose through shared memory (a transposing 2-byte scatter hit one bank
// 32 times): w with n contiguous (the [d, n] array, sn == 1) as Bs[j][k],
// w with d contiguous (nn.Linear's [n, d] weight viewed as [d, n], sk == 1)
// as Bs[k][j]; the fragment loads read either (warp_mma's strides). The
// kernel loads chunk q+1 while it multiplies chunk q.
template <typename T>
struct DxChunk {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int LDA = pad_ld<T>(DX_BK), LDB = pad_ld<T>(DX_CB);
  static constexpr int kA = DX_BM * DX_BK / V / DX_THREADS;
  static constexpr int kB = DX_CB * DX_BK / V / DX_THREADS;
  uint4 a[kA], b[kB];

  __device__ __forceinline__ void load(const T* __restrict__ dy, const T* __restrict__ w,
                                       long long sk, long long sn, int M, int d, int n, int r0,
                                       int c0, int k0) {
#pragma unroll
    for (int u = 0; u < kA; ++u) {
      const int i = threadIdx.x + u * DX_THREADS;
      const int r = i / (DX_BK / V), c = (i % (DX_BK / V)) * V;
      a[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < M && k0 + c < n)
        a[u] = *reinterpret_cast<const uint4*>(dy + (size_t)(r0 + r) * n + k0 + c);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int i = threadIdx.x + u * DX_THREADS;
      b[u] = make_uint4(0u, 0u, 0u, 0u);
      if (sn == 1) {
        const int j = i / (DX_BK / V), k = (i % (DX_BK / V)) * V;
        if (c0 + j < d && k0 + k < n)
          b[u] = *reinterpret_cast<const uint4*>(w + (size_t)(c0 + j) * sk + k0 + k);
      } else {
        const int k = i / (DX_CB / V), j = (i % (DX_CB / V)) * V;
        if (k0 + k < n && c0 + j < d)
          b[u] = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * sn + c0 + j);
      }
    }
  }

  __device__ __forceinline__ void store(T* As, T* Bs, long long sn) const {
#pragma unroll
    for (int u = 0; u < kA; ++u) {
      const int i = threadIdx.x + u * DX_THREADS;
      const int r = i / (DX_BK / V), c = (i % (DX_BK / V)) * V;
      *reinterpret_cast<uint4*>(As + r * LDA + c) = a[u];
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int i = threadIdx.x + u * DX_THREADS;
      if (sn == 1) {
        const int j = i / (DX_BK / V), k = (i % (DX_BK / V)) * V;
        *reinterpret_cast<uint4*>(Bs + j * LDA + k) = b[u];
      } else {
        const int k = i / (DX_CB / V), j = (i % (DX_CB / V)) * V;
        *reinterpret_cast<uint4*>(Bs + k * LDB + j) = b[u];
      }
    }
  }
};

// grid (G): CTA c handles the row tiles c, c+G, ...; for each it accumulates
// dh = dy @ w^T for its 32 rows in shared memory, writes dx, the rows' mean
// and rstd, and adds its column sums (dgamma, dbeta over d; dbias over n) to
// running partials, written to ws[c][2d + n] at the end.
template <typename T>
__global__ void __launch_bounds__(DX_THREADS)
ln_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const T* __restrict__ w, long long sk, long long sn, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ mean, float* __restrict__ rstd,
                 float* __restrict__ ws, int M, int d, int n, int G, float eps) {
  using Chunk = DxChunk<T>;
  constexpr int LDA = Chunk::LDA, LDB = Chunk::LDB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldh = dh_pitch(d);
  float* dh = reinterpret_cast<float*>(smem);  // [BM][ldh] f32
  float* st = dh + DX_BM * ldh;                // [2][BM] mean, rstd of the tile's rows
  float* run = st + 2 * DX_BM;                 // [2d + n] running dgamma, dbeta, dbias
  T* As = reinterpret_cast<T*>(run + 2 * d + n);  // [BM][LDA] dy chunk
  T* Bs = As + DX_BM * LDA;  // B(k = n, j = d) = w[j, k]: [CB][LDA] if sn == 1, else [BK][LDB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, cg = warp >> 1;
  const int mtiles = (M + DX_BM - 1) / DX_BM;
  const int nk = (n + DX_BK - 1) / DX_BK, nq = nk * ((d + DX_CB - 1) / DX_CB);
  const T* Bw = Bs + (sn == 1 ? cg * 64 * LDA : cg * 64);  // this warp's 64 columns of d
  const int bn = sn == 1 ? LDA : 1, bk = sn == 1 ? 1 : LDB;
  Chunk ch;
  for (int i = tid; i < 2 * d + n; i += DX_THREADS) run[i] = 0.f;
  for (int mt = blockIdx.x; mt < mtiles; mt += G) {
    const int r0 = mt * DX_BM, rows = min(DX_BM, M - r0);
    ch.load(dy, w, sk, sn, M, d, n, r0, 0, 0);  // in flight during the statistics
    __syncthreads();  // the previous tile's readers of dh and st are done
    for (int r = warp; r < DX_BM; r += DX_WARPS) {
      float2 s = make_float2(0.f, 0.f);  // padding rows: xhat = 0
      if (r < rows) s = row_stats(x + (size_t)(r0 + r) * d, d, eps, lane);
      if (lane == 0) {
        st[r] = s.x;
        st[DX_BM + r] = s.y;
        if (r < rows) mean[r0 + r] = s.x, rstd[r0 + r] = s.y;
      }
    }
    float acc[NT][4];
    for (int q = 0; q < nq; ++q) {  // chunk q: columns c0.. of d, depth k0.. of n
      const int c0 = q / nk * DX_CB, k0 = q % nk * DX_BK;
      if (k0 == 0) zero(acc);
      __syncthreads();  // the previous chunk is consumed
      ch.store(As, Bs, sn);
      __syncthreads();
      if (q + 1 < nq) ch.load(dy, w, sk, sn, M, d, n, r0, (q + 1) / nk * DX_CB, (q + 1) % nk * DX_BK);
      if (c0 == 0) {  // dbias: this chunk's columns of dy, summed over the rows in order
        for (int j = tid; j < DX_BK && k0 + j < n; j += DX_THREADS) {
          float s = 0.f;
          for (int r = 0; r < DX_BM; ++r) s += to_f32(As[r * LDA + j]);
          run[2 * d + k0 + j] += s;
        }
      }
      warp_mma(acc, As + rg * 16 * LDA, LDA, 1, Bw, bn, bk, min(DX_BK, round_up(n - k0, 16)),
               lane);
      if (k0 + DX_BK >= n) {  // this column pass is done: its dh fragments to shared memory
        float* d0 = dh + (rg * 16 + g) * ldh + c0 + cg * 64 + 2 * t;
        float* d1 = d0 + 8 * ldh;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          d0[8 * j] = acc[j][0], d0[8 * j + 1] = acc[j][1];
          d1[8 * j] = acc[j][2], d1[8 * j + 1] = acc[j][3];
        }
      }
    }
    __syncthreads();
    // the coupled LayerNorm backward, one warp per row
    for (int r = warp; r < rows; r += DX_WARPS) {
      const T* xr = x + (size_t)(r0 + r) * d;
      const float* hr = dh + r * ldh;
      const float mu = st[r], rs = st[DX_BM + r];
      float s1 = 0.f, s2 = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float xh = (to_f32(xr[k]) - mu) * rs, dxh = hr[k] * gamma[k];
        s1 += dxh;
        s2 += dxh * xh;
      }
      const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
      T* dr = dx + (size_t)(r0 + r) * d;
      for (int k = lane; k < d; k += 32) {
        const float xh = (to_f32(xr[k]) - mu) * rs, dxh = hr[k] * gamma[k];
        dr[k] = from_f32<T>((dxh - m1 - xh * m2) * rs);
      }
    }
    // dgamma, dbeta: this tile's column sums, the rows in order (x read 8
    // rows at a time, so its loads are in flight together)
    for (int c = tid; c < d; c += DX_THREADS) {
      float sg = 0.f, sb = 0.f;
      for (int rb = 0; rb < rows; rb += 8) {
        float xv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          xv[u] = rb + u < rows ? to_f32(x[(size_t)(r0 + rb + u) * d + c]) : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = rb + u;
          if (r < rows) {
            const float h = dh[r * ldh + c];
            sg += h * ((xv[u] - st[r]) * st[DX_BM + r]);
            sb += h;
          }
        }
      }
      run[c] += sg;
      run[d + c] += sb;
    }
  }
  __syncthreads();
  float* part = ws + (size_t)blockIdx.x * (2 * d + n);
  for (int i = tid; i < 2 * d + n; i += DX_THREADS) part[i] = run[i];
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
  const size_t smem = dx_smem<T>(d, n);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // the wrapper checks first
  cudaStream_t st = (cudaStream_t)stream;
  auto kern = ln_bwd_dx_kernel<T>;
  int e = set_smem(kern, smem);
  if (e) return e;
  kern<<<G, DX_THREADS, smem, st>>>((const T*)x, (const float*)gamma, (const T*)w, sk, sn,
                                    (const T*)dy, (T*)dx, (float*)mean, (float*)rstd,
                                    (float*)ws, M, d, n, G, eps);
  e = (int)cudaGetLastError();
  if (e) return e;
  return reduce<float>((const float*)ws, (float*)out, G, 2LL * d + n, st);
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
