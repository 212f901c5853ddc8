// The tiled-product machinery of the LN+matmul kernels (ln_matmul.cu,
// ln_matmul_bwd.cu), for Hopper (sm_90a): asynchronous 16-byte copies into
// a shared-memory ring, ldmatrix fragment loads, and mma.sync m16n8k16 bf16
// warp tiles with f32 accumulation; the same warp tile in f32 on CUDA cores.
//
// A CTA of 8 warps (2 x 4) owns a 128 x (4 * WN) output tile; each warp a
// 64 x WN register tile (warp_tile_rows: any 16 MI rows), acc[i][j] the
// m16n8 fragment at rows wm + 16i.., columns wn + 8j..: lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 2t and 2t + 1 (the PTX
// fragment layout). Each operand tile
// lies in shared memory either with the contraction index contiguous or
// with the output index contiguous; ldmatrix reads the first as it lies and
// the second with .trans, so no operand is ever transposed by scalar loads.
// Every shared row is padded by 16 bytes, which keeps ldmatrix's eight row
// addresses on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int WARPS = 8;  // 2 (rows) x 4 (columns) warp tiles of 64 x WN
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 128;  // rows of an output tile
constexpr int STAGE_BYTES = 128;  // depth of one ring stage, in bytes of one operand row
constexpr int STAGES = 3;  // depth of the cp.async ring

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// row pitch of a shared tile of n contiguous elements: 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int pad_ld(int n) { return n + 16 / (int)sizeof(T); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously, through L2 only; zero-filled
// when !ok (src-size 0 reads nothing, but the address must still be valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes, for arrays with no 16-byte alignment (row statistics)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// Stage a tile with cp.async: C 16-byte chunks shared by the CTA's
// THREADS, chunk i at (row, col) = (i / P, i % P * V) of a tile with P
// chunks a row; source row r0 + row at src + (r0 + row) * sr, unit stride
// along the row. Chunks past (rows, cols) are zero-filled.
template <typename T, int C, int P>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* __restrict__ src, long long sr,
                                          int r0, int rows, int c0, int cols) {
  constexpr int V = 16 / sizeof(T);
  static_assert(C % THREADS == 0, "every thread copies as many chunks");
#pragma unroll
  for (int u = 0; u < C / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / P, c = i % P * V;
    const bool ok = r0 + r < rows && c0 + c < cols;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(r0 + r) * sr + c0 + c : src, ok);
  }
}

// One warp's (16 MI) x (8 NJ) tile += A (16 MI x KB) B (KB x 8 NJ), KB a
// multiple of 16, both operands in shared memory, with mma.sync on ldmatrix
// fragments. A_T false: A(m, k) = As[m * lda + k] (k contiguous);
// true: As[k * lda + m]. b_t false: B(k, c) = Bs[c * ldb + k]; true:
// Bs[k * ldb + c]. wm, wn: the warp tile's first row and column.
template <int MI, int NJ, bool A_T, int KB>
__device__ __forceinline__ void warp_tile_rows(float (&acc)[MI][NJ][4], const __nv_bfloat16* As,
                                               int lda, const __nv_bfloat16* Bs, int ldb,
                                               bool b_t, int wm, int wn, int lane) {
  static_assert(NJ % 2 == 0 && KB % 16 == 0, "two n8 columns, 16 of k at a time");
#pragma unroll
  for (int kk = 0; kk < KB; kk += 16) {
    uint32_t a[MI][4];
    // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (A_T)
        ldsm_x4_trans(a[i], As + (kk + (lane & 7) + 8 * (lane >> 4)) * lda + wm + 16 * i +
                                8 * ((lane >> 3) & 1));
      else
        ldsm_x4(a[i], As + (wm + 16 * i + (lane & 15)) * lda + kk + 8 * (lane >> 4));
    }
    // B, two n8 columns at a time: matrices (columns 8j.., k 0-7), (8j.., k
    // 8-15), (8j+8.., k 0-7), (8j+8.., k 8-15); lane gets B(k = 2t, 2t+1;
    // column g) from either layout
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      if (b_t)
        ldsm_x4_trans(b, Bs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldb + wn + 8 * j +
                             8 * (lane >> 4));
      else
        ldsm_x4(b, Bs + (wn + 8 * j + (lane & 7) + 8 * (lane >> 4)) * ldb + kk +
                       8 * ((lane >> 3) & 1));
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// The same warp tile in f32 on CUDA cores, in the same fragment layout,
// each output summed over k in order (exact to f32 rounding).
template <int MI, int NJ, bool A_T, int KB>
__device__ __forceinline__ void warp_tile_rows(float (&acc)[MI][NJ][4], const float* As, int lda,
                                               const float* Bs, int ldb, bool b_t, int wm, int wn,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < KB; ++k) {
    float a[MI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = wm + 16 * i + g;
      a[i][0] = A_T ? As[k * lda + m] : As[m * lda + k];
      a[i][1] = A_T ? As[k * lda + m + 8] : As[(m + 8) * lda + k];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = wn + 8 * j + 2 * t;
      const float b0 = b_t ? Bs[k * ldb + c] : Bs[c * ldb + k];
      const float b1 = b_t ? Bs[k * ldb + c + 1] : Bs[(c + 1) * ldb + k];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        acc[i][j][0] = fmaf(a[i][0], b0, acc[i][j][0]);
        acc[i][j][1] = fmaf(a[i][0], b1, acc[i][j][1]);
        acc[i][j][2] = fmaf(a[i][1], b0, acc[i][j][2]);
        acc[i][j][3] = fmaf(a[i][1], b1, acc[i][j][3]);
      }
    }
  }
}

// The 64-row warp tile of the 2 x 4 warp layout (either element type)
template <int NJ, bool A_T, int KB, typename T>
__device__ __forceinline__ void warp_tile(float (&acc)[4][NJ][4], const T* As, int lda,
                                          const T* Bs, int ldb, bool b_t, int wm, int wn,
                                          int lane) {
  warp_tile_rows<4, NJ, A_T, KB>(acc, As, lda, Bs, ldb, b_t, wm, wn, lane);
}

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

// The LayerNorm prologue on one staged chunk of one row, V = 16 /
// sizeof(T) elements, in place: h = (x - mu) * rs * g + b in f32, rounded
// to T once (the row's mean mu and rstd rs; g, b the chunk's gamma, beta).
template <typename T>
__device__ __forceinline__ void ln_chunk(T* p, float mu, float rs, const float* g,
                                         const float* b) {
  constexpr int V = 16 / sizeof(T);
  uint4 v = *reinterpret_cast<const uint4*>(p);
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int q = 0; q < V; ++q) e[q] = from_f32<T>((to_f32(e[q]) - mu) * rs * g[q] + b[q]);
  *reinterpret_cast<uint4*>(p) = v;
}

inline bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// w [K, N] through strides (sk, sn): one unit stride, the other and the
// extent along the unit one multiples of the 16-byte vector
template <typename T>
bool w_ok(const void* w, long long sk, long long sn, int K, int N) {
  constexpr int V = 16 / sizeof(T);
  if (!aligned16(w)) return false;
  if (sk == 1) return sn % V == 0 && K % V == 0;
  if (sn == 1) return sk % V == 0 && N % V == 0;
  return false;
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

}  // namespace tile
