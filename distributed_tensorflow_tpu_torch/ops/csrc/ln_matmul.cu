// Fused LayerNorm + matmul (+bias) forward for Hopper (sm_90a), plain C
// interface (ctypes).
//
// Replaces distributed_tensorflow_tpu/ops/fused_ln_matmul.py::_fwd_kernel:
// y = (LN(x; gamma, beta, eps) cast to x's dtype) @ w + bias, with the row
// statistics in f32 (mean, then the mean of squared deviations, as in that
// file's _ln) and the product accumulated in f32, cast to the output dtype.
//
// Bound: at decode (M = decode slots) the bytes of w, d*n*sizeof; at
// prefill (M = one chunk) the bytes of w and x. Design against that bound:
// each CTA normalises its rows straight into shared memory, so the
// normalised [M, d] tensor never reaches device memory, and w is streamed
// once per row tile. Any M: the ragged row edge is masked (the TPU's
// 8-row block rule does not apply), as is a ragged n edge.
//
// Layout: one CTA per (64-column tile, 16-row tile); 128 threads (4 warps).
// w is [d, n] with element (k, c) at w[k*sk + c*sn]: the contiguous [d, n]
// array (sn == 1) and the transposed view of an nn.Linear weight [n, d]
// (sk == 1) both load coalesced. bf16 input: each warp owns one 16x16
// output fragment and runs WMMA bf16 x bf16 -> f32 on tensor cores; f32
// input: CUDA-core FMAs, 8 outputs a thread.
//
// x rows and w tiles move in 16-byte loads, several in flight per thread;
// the next w tile is loaded into registers while the current one is
// multiplied. Simple first: no TMA, no wgmma, no split-K (at decode only
// n/64 CTAs stream w).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int BM = 16;   // rows per CTA
constexpr int BN = 64;   // columns per CTA (4 warps x 16)
constexpr int BK = 128;  // depth of one staged w tile
constexpr int kPad = 8;  // shared-memory row padding, elements (16 bytes of bf16)
constexpr int kBatch = 4;  // 16-byte x loads a thread keeps in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
