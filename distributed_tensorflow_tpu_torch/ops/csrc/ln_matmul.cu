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
// slots, one prefill chunk). Bound: at decode the bytes of w, d*n*sizeof;
// at prefill the bytes of w and x. Each CTA normalises its rows straight
// into shared memory, so the normalised [M, d] tensor never reaches device
// memory, and w is streamed once per row tile. Any M: the ragged row edge
// is masked (the TPU's 8-row block rule does not apply), as is a ragged n
// edge. Layout: one CTA per (64-column tile, 16-row tile); 128 threads (4
// warps). bf16 input: each warp owns one 16x16 output fragment and runs
// WMMA bf16 x bf16 -> f32 on tensor cores; f32 input: CUDA-core FMAs, 8
// outputs a thread. x rows and w tiles move in 16-byte loads, several in
// flight per thread; the next w tile is loaded into registers while the
// current one is multiplied. Any d that fits 16 normalised rows in shared
// memory.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BM = 16;   // rows per CTA
constexpr int BN = 64;   // columns per CTA (4 warps x 16)
constexpr int BK = 128;  // depth of one staged w tile
constexpr int kPad = 8;  // shared-memory row padding, elements (16 bytes of bf16)
constexpr int kBatch = 4;  // 16-byte x loads a thread keeps in flight

using tile::from_f32;
using tile::to_f32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// One BK x BN tile of w as 16-byte vectors running along w's unit-stride
// dim (n when sn == 1, else k), kN per thread, all loads in flight before
// any is used. ``vec``: every vector that starts in range lies wholly in
// range and is 16-byte aligned (checked by the host); otherwise each
// element is loaded alone with its own bounds check.
template <typename T, int kN>
__device__ __forceinline__ void load_w(uint4 (&reg)[kN], const T* __restrict__ w, long long sk,
                                       long long sn, int d, int n, int k0, int n0, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int q = threadIdx.x + u * kThreads;
    int kk, c;
    if (sn == 1) {
      kk = q / (BN / kVec);
      c = (q % (BN / kVec)) * kVec;
    } else {
      c = q / (BK / kVec);
      kk = (q % (BK / kVec)) * kVec;
    }
    const int k = k0 + kk, col = n0 + c;
    if (vec && k < d && col < n) {
      reg[u] = *reinterpret_cast<const uint4*>(w + k * sk + col * sn);
    } else {
      T* e = reinterpret_cast<T*>(&reg[u]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int kj = sn == 1 ? k : k + j, cj = sn == 1 ? col + j : col;
        e[j] = (kj < d && cj < n) ? w[kj * sk + cj * sn] : from_f32<T>(0.f);
      }
    }
  }
}

// Park the registers in shared memory, B-operand layout: row-major
// [BK][BN + kPad] when w runs along n (sn == 1), column-major
// [BN][BK + kPad] when it runs along k — either way one 16-byte store per
// vector, no transpose through shared memory.
template <typename T, int kN>
__device__ __forceinline__ void store_w(T* ws, const uint4 (&reg)[kN], long long sn) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (sn == 1) {
      const int kk = q / (BN / kVec), c = (q % (BN / kVec)) * kVec;
      *reinterpret_cast<uint4*>(ws + kk * (BN + kPad) + c) = reg[u];
    } else {
      const int c = q / (BK / kVec), kk = (q % (BK / kVec)) * kVec;
      *reinterpret_cast<uint4*>(ws + c * (BK + kPad) + kk) = reg[u];
    }
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
ln_matmul_kernel(const TIn* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const TIn* __restrict__ w,
                 const float* __restrict__ bias, TOut* __restrict__ y, int M, int d, int n,
                 long long sk, long long sn, float eps, bool vec_x, bool vec_w) {
  constexpr bool kTensorCores = std::is_same<TIn, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(TIn);
  constexpr int kN = BK * BN / kVec / kThreads;  // w vectors per thread per tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kdim = round_up(d, BK);
  const int ldh = kdim + kPad;
  const bool w_rows = sn == 1;  // w tile row-major [BK][ldw], else col-major [BN][ldk]
  const int ldw = BN + kPad, ldk = BK + kPad;
  TIn* hs = reinterpret_cast<TIn*>(smem_raw);  // [BM][ldh] x rows, then LN(x)
  TIn* ws = hs + BM * ldh;                     // one w tile
  float* cs = reinterpret_cast<float*>(ws + BK * ldw);  // [BM][BN] epilogue staging

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  uint4 wr[kN];
  load_w<TIn, kN>(wr, w, sk, sn, d, n, 0, n0, vec_w);  // in flight during the prologue

  // prologue 1: this CTA's rows of x into shared memory (zeros past M, d)
  if (vec_x) {
    const int vpr = d / kVec;
    for (int base = tid; base < BM * vpr; base += kBatch * kThreads) {
      uint4 r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads, row = i / vpr;
        r[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < BM * vpr && m0 + row < M)
          r[u] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * d + (i % vpr) * kVec);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads, row = i / vpr;
        if (i < BM * vpr) {
          const TIn* e = reinterpret_cast<const TIn*>(&r[u]);
#pragma unroll
          for (int j = 0; j < kVec; ++j) hs[row * ldh + (i % vpr) * kVec + j] = e[j];
        }
      }
    }
  } else {
    for (int i = tid; i < BM * d; i += kThreads) {
      const int row = i / d, k = i - row * d;
      hs[row * ldh + k] = m0 + row < M ? x[(size_t)(m0 + row) * d + k] : from_f32<TIn>(0.f);
    }
  }
  for (int i = tid; i < BM * (kdim - d); i += kThreads) {
    const int row = i / (kdim - d);
    hs[row * ldh + d + i - row * (kdim - d)] = from_f32<TIn>(0.f);
  }
  __syncthreads();
  // prologue 2: LayerNorm in place, one warp per row, f32 statistics
  for (int r = warp; r < BM; r += kThreads / 32) {
    if (m0 + r >= M) continue;  // padding rows stay zero
    TIn* hr = hs + r * ldh;
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s += to_f32(hr[k]);
    const float mu = warp_sum(s) / d;
    float v = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float t = to_f32(hr[k]) - mu;
      v += t * t;
    }
    const float inv = rsqrtf(warp_sum(v) / d + eps);
    for (int k = lane; k < d; k += 32) {
      const float xhat = (to_f32(hr[k]) - mu) * inv;
      hr[k] = from_f32<TIn>(xhat * gamma[k] + beta[k]);
    }
  }

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cfrag;
  float acc[BM * BN / kThreads];
  if constexpr (kTensorCores) {
    nvcuda::wmma::fill_fragment(cfrag, 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < BM * BN / kThreads; ++i) acc[i] = 0.f;
  }
  const int fc = tid % BN;                           // f32 path: this thread's column
  const int fr = (tid / BN) * (BM * BN / kThreads);  // and its first row

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    __syncthreads();  // LN(x) written (first pass) / previous tile consumed
    store_w<TIn, kN>(ws, wr, sn);
    __syncthreads();
    if (k0 + BK < kdim)  // the next tile's loads fly during this tile's products
      load_w<TIn, kN>(wr, w, sk, sn, d, n, k0 + BK, n0, vec_w);
    if constexpr (kTensorCores) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             nvcuda::wmma::row_major> afrag;
      if (w_rows) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               nvcuda::wmma::row_major> bfrag;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          nvcuda::wmma::load_matrix_sync(afrag, hs + k0 + kk, ldh);
          nvcuda::wmma::load_matrix_sync(bfrag, ws + kk * ldw + warp * 16, ldw);
          nvcuda::wmma::mma_sync(cfrag, afrag, bfrag, cfrag);
        }
      } else {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               nvcuda::wmma::col_major> bfrag;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          nvcuda::wmma::load_matrix_sync(afrag, hs + k0 + kk, ldh);
          nvcuda::wmma::load_matrix_sync(bfrag, ws + warp * 16 * ldk + kk, ldk);
          nvcuda::wmma::mma_sync(cfrag, afrag, bfrag, cfrag);
        }
      }
    } else {
      for (int kk = 0; kk < BK; ++kk) {
        const float wv = to_f32(w_rows ? ws[kk * ldw + fc] : ws[fc * ldk + kk]);
#pragma unroll
        for (int i = 0; i < BM * BN / kThreads; ++i)
          acc[i] = fmaf(to_f32(hs[(fr + i) * ldh + k0 + kk]), wv, acc[i]);
      }
    }
  }

  // epilogue: + bias in f32, cast, masked store
  if constexpr (kTensorCores) {
    nvcuda::wmma::store_matrix_sync(cs + warp * 16, cfrag, BN, nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i - r * BN;
      const int m = m0 + r, col = n0 + c;
      if (m < M && col < n) y[(size_t)m * n + col] = from_f32<TOut>(cs[i] + bias[col]);
    }
  } else {
    const int col = n0 + fc;
#pragma unroll
    for (int i = 0; i < BM * BN / kThreads; ++i) {
      const int m = m0 + fr + i;
      if (m < M && col < n) y[(size_t)m * n + col] = from_f32<TOut>(acc[i] + bias[col]);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           const void* bias, void* y, int M, int d, int n, int sk, int sn, float eps,
           void* stream) {
  if (d < 1 || n < 1 || (sk != 1 && sn != 1)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / sizeof(TIn);
  const bool vec_x = d % kVec == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  // vectors run along the unit-stride dim: its extent and the other
  // stride must keep every vector whole and 16-byte aligned
  const bool vec_w = reinterpret_cast<size_t>(w) % 16 == 0 &&
                     (sn == 1 ? n % kVec == 0 && sk % kVec == 0
                              : d % kVec == 0 && sn % kVec == 0);
  const size_t smem = sizeof(TIn) * ((size_t)BM * (round_up(d, BK) + kPad) +
                                     (size_t)BK * (BN + kPad)) +
                      sizeof(float) * BM * BN;
  auto kern = ln_matmul_kernel<TIn, TOut>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const TIn*)x, (const float*)gamma, (const float*)beta, (const TIn*)w,
      (const float*)bias, (TOut*)y, M, d, n, (long long)sk, (long long)sn, eps, vec_x, vec_w);
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

int ln_matmul_f32(const void* x, const void* gamma, const void* beta, const void* w,
                  const void* bias, void* y, int M, int d, int n, int sk, int sn, float eps,
                  void* stream) {
  return launch<float, float>(x, gamma, beta, w, bias, y, M, d, n, sk, sn, eps, stream);
}

int ln_matmul_bf16(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* bias, void* y, int M, int d, int n, int sk, int sn, float eps,
                   void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, w, bias, y, M, d, n, sk, sn,
                                              eps, stream);
}

int ln_matmul_bf16_f32(const void* x, const void* gamma, const void* beta, const void* w,
                       const void* bias, void* y, int M, int d, int n, int sk, int sn,
                       float eps, void* stream) {
  return launch<__nv_bfloat16, float>(x, gamma, beta, w, bias, y, M, d, n, sk, sn, eps,
                                      stream);
}

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
