// FlashAttention-2 forward and its two backward kernels for Hopper (sm_90a),
// plain C interface (ctypes).
//
// Replaces, in distributed_tensorflow_tpu/ops/flash_attention.py:
//   flash_fwd      <- _fwd_kernel      (out + LSE, online softmax)
//   flash_bwd_dkv  <- _bwd_dkv_kernel  (dK, dV with the kv tile resident)
//   flash_bwd_dq   <- _bwd_dq_kernel   (dQ with the q tile resident)
// Contract as flash_attention there: q [B,H,Sq,D], k/v [B,H,Sk,D], optional
// kv_mask [B,Sk] (bool bytes, nonzero attends), causal aligned by
// q_offset = Sk - Sq (query row r attends key c iff c <= r + q_offset),
// output in q's dtype, LSE f32 [B,H,Sq] (the TPU's 8-lane stat padding is
// dropped). A row that attends nothing comes out 0 with LSE = NEG_INF
// (-1e30, not -inf) and gets zero gradients: p is forced to 0 under the
// mask, never exp(NEG_INF - NEG_INF).
//
// What bounds it on this card: at the training shapes (B=8, H=12, S=1024,
// D=64, causal, bf16) every kernel does 2-3 S*S*D products per (b, h), so it
// is bound by tensor-core operations, not bytes (forward 12.9 GFLOP against
// 50 MB). The design answers that with bf16 tensor-core tiles: every product
// is mma.sync m16n8k16 (bf16 in, f32 accumulate), one warp per 16 rows of a
// 64-row tile, operands staged in shared memory. Simple first: no TMA, no
// wgmma, no software pipelining of the tile loads, operands fetched from
// shared memory with plain 16/32-bit loads. For f32 inputs the same tile
// loops run on CUDA cores (scalar FMAs in the mma's fragment layout), so
// f32 keeps full f32 products; that path is for checks, not for speed.
//
// Numerics (as the Pallas kernels): f32 logits, f32 softmax statistics and
// f32 accumulation; delta = rowsum(dO * O) in f32, once per row tile inside
// each backward kernel (the Pallas kernels recompute it per tile: the same
// function). The probabilities P and dS are rounded to the input dtype
// before they enter a product (a no-op for f32), as the dense reference
// rounds its probabilities to v's dtype; the plain PyTorch version in
// ops/flash_attention.py rounds at the same places.
//
// Differences from the TPU kernels, deliberate:
//  - the TPU grid's sequential kv axis (forward, dQ) and q axis (dK/dV)
//    become loops inside one block; blocks run in parallel in no order;
//  - the ragged edge is masked in the kernel (rows >= Sq are not stored,
//    keys >= Sk never attend), so any Sq/Sk works without padding;
//  - dQ is its own kernel with the q tile resident, as on the TPU, instead
//    of dK/dV/dQ in one pass with float atomics on dQ: no atomics keeps a
//    training step bitwise deterministic run to run;
//  - causal tiles strictly above the diagonal band are skipped, the
//    diagonal tile is masked element by element.
//
// Layout: every [B,H,S,D] input is read through its strides (b, h, s) with
// D contiguous, so the [B,S,H,D]->[B,H,S,D] transposed views of the model
// need no copy; rows are loaded 16 bytes at a time, so each stride and the
// base pointer must be 16-byte multiples (the wrapper checks, the launcher
// re-checks). Outputs and LSE are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // rows of a q tile and of a kv tile
constexpr float kNegInf = -1e30f;

struct Strided {
  const void* p;
  long long sb, sh, ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// padded shared-memory row: 16 bytes past the data keeps the rows of one
// fragment load on different banks
template <typename T>
__host__ __device__ constexpr int padded(int n) { return n + 16 / (int)sizeof(T); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

// two bf16 values at a[0] and a[stride] packed into one register, the lower
// index in the lower half (the mma fragment order)
template <int S>
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* a) {
  if constexpr (S == 1) {
    return *reinterpret_cast<const uint32_t*>(a);
  } else {
    return bits(a[0]) | (bits(a[S]) << 16);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc (16 x 8*NT, the m16n8 accumulator fragments) += A (16 x K)
// times B (K x 8*NT), both read from shared memory:
//   A(m, k) = a[m * AM + k * AK],  B(k, n) = b[n * BN + k * BK].
// Fragment layout (PTX m16n8k16): g = lane / 4, t = lane % 4; acc[j] holds
// rows g and g + 8, columns 8j + 2t and 8j + 2t + 1.
template <int NT, int K, int AM, int AK, int BN, int BK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int lane) {
  static_assert(K % 16 == 0, "K must be a multiple of 16");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < K; kc += 16) {
    const int k0 = kc + 2 * t;
    uint32_t af[4];
    af[0] = pair<AK>(a + g * AM + k0 * AK);
    af[1] = pair<AK>(a + (g + 8) * AM + k0 * AK);
    af[2] = pair<AK>(a + g * AM + (k0 + 8) * AK);
    af[3] = pair<AK>(a + (g + 8) * AM + (k0 + 8) * AK);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* bj = b + (8 * j + g) * BN;
      mma_bf16(acc[j], af, pair<BK>(bj + k0 * BK), pair<BK>(bj + (k0 + 8) * BK));
    }
  }
}

// The same tile product in f32 on CUDA cores, in the same fragment layout.
template <int NT, int K, int AM, int AK, int BN, int BK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, const float* b,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * AM + k * AK], a1 = a[(g + 8) * AM + k * AK];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = b[(8 * j + 2 * t) * BN + k * BK];
      const float b1 = b[(8 * j + 2 * t + 1) * BN + k * BK];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Stage rows [r0, r0 + kTile) of one (b, h) slice of a [B,H,S,D] tensor in
// shared memory (row pitch LD), 16 bytes per load; rows >= S are zeroed.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const Strided& src, int b, int h, int r0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  const T* base = (const T*)src.p + b * src.sb + h * src.sh;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(base + (r0 + r) * src.ss + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// The row stats of a tile: for row r of [r0, r0 + kTile), delta = sum_d
// dO * O in f32 (two threads a row), and the row's LSE.
template <typename T, int D>
__device__ __forceinline__ void row_stats(float* delta_s, float* lse_s, const Strided& o,
                                          const Strided& dout, const float* lse, int b, int h,
                                          int H, int r0, int Sq) {
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  float acc = 0.f;
  if (r0 + r < Sq) {
    const T* op = (const T*)o.p + b * o.sb + h * o.sh + (r0 + r) * o.ss;
    const T* dp = (const T*)dout.p + b * dout.sb + h * dout.sh + (r0 + r) * dout.ss;
    for (int d = half; d < D; d += 2) acc = fmaf(to_f32(dp[d]), to_f32(op[d]), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) {
    delta_s[r] = acc;
    lse_s[r] = r0 + r < Sq ? lse[((size_t)b * H + h) * Sq + r0 + r] : 0.f;
  }
}

// kv_mask slice of keys [c0, c0 + kTile): 1 where the key exists and attends
__device__ __forceinline__ void load_key_mask(unsigned char* dst, const unsigned char* mask,
                                              int b, int c0, int Sk) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int c = c0 + i;
    dst[i] = c < Sk && (mask == nullptr || mask[(size_t)b * Sk + c] != 0);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, h, b); kv tiles in a loop, online softmax.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Strided q, Strided k, Strided v, const unsigned char* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                 int causal, int q_offset, float scale) {
  constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
  constexpr int NS = kTile / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kTile * LD;
  T* Vs = Ks + kTile * LD;
  T* Ps = Vs + kTile * LD;  // [kTile][LDP], 16 rows per warp
  unsigned char* keep = reinterpret_cast<unsigned char*>(Ps + kTile * LDP);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  T* Pw = Ps + warp * 16 * LDP;

  load_tile<T, D, LD>(Qs, q, b, h, q0, Sq);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
  zero(o);
  // keys past the diagonal band of the tile's last row are never attended
  const int kv_end = causal ? min(Sk, q0 + kTile + q_offset) : Sk;
  for (int c0 = 0; c0 < kv_end; c0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, LD>(Ks, k, b, h, c0, Sk);
    load_tile<T, D, LD>(Vs, v, b, h, c0, Sk);
    load_key_mask(keep, mask, b, c0, Sk);
    __syncthreads();
    float s[NS][4];
    zero(s);
    warp_mma<NS, D, LD, 1, LD, 1>(s, Qs + warp * 16 * LD, Ks, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), r = row[e >> 1];
        const bool ok = keep[col] && (!causal || c0 + col <= r + q_offset);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];  // this thread's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), r = row[e >> 1];
        const bool ok = keep[col] && (!causal || c0 + col <= r + q_offset);
        const float p = ok ? expf(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p;
        Pw[(g + 8 * (e >> 1)) * LDP + col] = from_f32<T>(p);
      }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    __syncwarp();
    // O += P V: A(row, key) = P[row][key], B(key, d) = V[key][d]
    warp_mma<NO, kTile, LDP, 1, 1, LD>(o, Pw, Vs, lane);
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const size_t bh = (size_t)b * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (bh * Sq + row[i]) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      orow[8 * j + 2 * t] = from_f32<T>(o[j][2 * i] * inv);
      orow[8 * j + 2 * t + 1] = from_f32<T>(o[j][2 * i + 1] * inv);
    }
    if (t == 0) lse[bh * Sq + row[i]] = l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (kv tile, h, b), the kv tile resident; q tiles in a
// loop. Each warp owns 16 keys and works on transposed tiles (keys x rows).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Strided q, Strided k, Strided v, Strided o, Strided dout,
                     const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
                     int causal, int q_offset, float scale) {
  constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
  constexpr int NS = kTile / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTile * LD;
  T* Qs = Vs + kTile * LD;
  T* dOs = Qs + kTile * LD;
  T* Ps = dOs + kTile * LD;   // P^T  [kTile keys][LDP]
  T* dSs = Ps + kTile * LDP;  // dS^T [kTile keys][LDP]
  float* lse_s = reinterpret_cast<float*>(dSs + kTile * LDP);
  float* delta_s = lse_s + kTile;
  unsigned char* keep = reinterpret_cast<unsigned char*>(delta_s + kTile);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int key[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
  T* Pw = Ps + warp * 16 * LDP;
  T* dSw = dSs + warp * 16 * LDP;

  load_tile<T, D, LD>(Ks, k, b, h, c0, Sk);
  load_tile<T, D, LD>(Vs, v, b, h, c0, Sk);
  load_key_mask(keep, mask, b, c0, Sk);
  __syncthreads();
  const bool key_ok[2] = {keep[warp * 16 + g] != 0, keep[warp * 16 + g + 8] != 0};
  float dka[NO][4], dva[NO][4];
  zero(dka);
  zero(dva);
  // rows whose band reaches this tile's first key: r + q_offset >= c0
  const int r_begin = causal ? max(0, c0 - q_offset) / kTile * kTile : 0;
  for (int r0 = r_begin; r0 < Sq; r0 += kTile) {
    __syncthreads();
    load_tile<T, D, LD>(Qs, q, b, h, r0, Sq);
    load_tile<T, D, LD>(dOs, dout, b, h, r0, Sq);
    row_stats<T, D>(delta_s, lse_s, o, dout, lse, b, h, H, r0, Sq);
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T, 16 keys x kTile rows per warp
    float st[NS][4], dpt[NS][4];
    zero(st);
    zero(dpt);
    warp_mma<NS, D, LD, 1, LD, 1>(st, Ks + warp * 16 * LD, Qs, lane);
    warp_mma<NS, D, LD, 1, LD, 1>(dpt, Vs + warp * 16 * LD, dOs, lane);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), r = r0 + col, i = e >> 1;
        const bool ok = key_ok[i] && r < Sq && (!causal || key[i] <= r + q_offset);
        const float p = ok ? expf(st[j][e] * scale - lse_s[col]) : 0.f;
        const float ds = p * (dpt[j][e] - delta_s[col]) * scale;
        Pw[(g + 8 * i) * LDP + col] = from_f32<T>(p);
        dSw[(g + 8 * i) * LDP + col] = from_f32<T>(ds);
      }
    __syncwarp();
    // dV += P^T dO, dK += dS^T Q: A(key, row) from this warp's rows, B(row, d)
    warp_mma<NO, kTile, LDP, 1, 1, LD>(dva, Pw, dOs, lane);
    warp_mma<NO, kTile, LDP, 1, 1, LD>(dka, dSw, Qs, lane);
    __syncwarp();
  }
  const size_t bh = (size_t)b * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
    T* kr = dk + (bh * Sk + key[i]) * D;
    T* vr = dv + (bh * Sk + key[i]) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      kr[8 * j + 2 * t] = from_f32<T>(dka[j][2 * i]);
      kr[8 * j + 2 * t + 1] = from_f32<T>(dka[j][2 * i + 1]);
      vr[8 * j + 2 * t] = from_f32<T>(dva[j][2 * i]);
      vr[8 * j + 2 * t + 1] = from_f32<T>(dva[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, h, b), the q tile resident; kv tiles in a loop.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Strided q, Strided k, Strided v, Strided o, Strided dout,
                    const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                    T* __restrict__ dq, int H, int Sq, int Sk, int causal, int q_offset,
                    float scale) {
  constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
  constexpr int NS = kTile / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kTile * LD;
  T* Ks = dOs + kTile * LD;
  T* Vs = Ks + kTile * LD;
  T* dSs = Vs + kTile * LD;  // [kTile rows][LDP]
  float* lse_s = reinterpret_cast<float*>(dSs + kTile * LDP);
  float* delta_s = lse_s + kTile;
  unsigned char* keep = reinterpret_cast<unsigned char*>(delta_s + kTile);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows within the tile
  T* dSw = dSs + warp * 16 * LDP;

  load_tile<T, D, LD>(Qs, q, b, h, q0, Sq);
  load_tile<T, D, LD>(dOs, dout, b, h, q0, Sq);
  row_stats<T, D>(delta_s, lse_s, o, dout, lse, b, h, H, q0, Sq);
  __syncthreads();
  const float row_lse[2] = {lse_s[lrow[0]], lse_s[lrow[1]]};
  const float row_delta[2] = {delta_s[lrow[0]], delta_s[lrow[1]]};
  float dqa[NO][4];
  zero(dqa);
  const int kv_end = causal ? min(Sk, q0 + kTile + q_offset) : Sk;
  for (int c0 = 0; c0 < kv_end; c0 += kTile) {
    __syncthreads();
    load_tile<T, D, LD>(Ks, k, b, h, c0, Sk);
    load_tile<T, D, LD>(Vs, v, b, h, c0, Sk);
    load_key_mask(keep, mask, b, c0, Sk);
    __syncthreads();
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    warp_mma<NS, D, LD, 1, LD, 1>(s, Qs + warp * 16 * LD, Ks, lane);
    warp_mma<NS, D, LD, 1, LD, 1>(dp, dOs + warp * 16 * LD, Vs, lane);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), i = e >> 1, r = q0 + lrow[i];
        const bool ok = keep[col] && r < Sq && (!causal || c0 + col <= r + q_offset);
        const float p = ok ? expf(s[j][e] * scale - row_lse[i]) : 0.f;
        dSw[(g + 8 * i) * LDP + col] = from_f32<T>(p * (dp[j][e] - row_delta[i]) * scale);
      }
    __syncwarp();
    // dQ += dS K: A(row, key) = dS[row][key], B(key, d) = K[key][d]
    warp_mma<NO, kTile, LDP, 1, 1, LD>(dqa, dSw, Ks, lane);
    __syncwarp();
  }
  const size_t bh = (size_t)b * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + lrow[i];
    if (r >= Sq) continue;
    T* qr = dq + (bh * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      qr[8 * j + 2 * t] = from_f32<T>(dqa[j][2 * i]);
      qr[8 * j + 2 * t + 1] = from_f32<T>(dqa[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
bool aligned(const Strided& s) {
  constexpr long long kVec = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(s.p) % 16 == 0 && s.sb % kVec == 0 && s.sh % kVec == 0 &&
         s.ss % kVec == 0;
}

template <typename K>
cudaError_t smem_attr(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int fwd(Strided q, Strided k, Strided v, const void* mask, void* out, void* lse, int B, int H,
        int Sq, int Sk, int causal, float scale, cudaStream_t st) {
  constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
  const size_t smem = sizeof(T) * (3 * kTile * LD + kTile * LDP) + kTile;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = smem_attr(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((Sq + kTile - 1) / kTile, H, B), kThreads, smem, st>>>(
      q, k, v, (const unsigned char*)mask, (T*)out, (float*)lse, H, Sq, Sk, causal, Sk - Sq,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dkv(Strided q, Strided k, Strided v, Strided o, Strided dout, const void* mask,
            const void* lse, void* dk, void* dv, int B, int H, int Sq, int Sk, int causal,
            float scale, cudaStream_t st) {
  constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
  const size_t smem =
      sizeof(T) * (4 * kTile * LD + 2 * kTile * LDP) + 2 * sizeof(float) * kTile + kTile;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t e = smem_attr(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((Sk + kTile - 1) / kTile, H, B), kThreads, smem, st>>>(
      q, k, v, o, dout, (const unsigned char*)mask, (const float*)lse, (T*)dk, (T*)dv, H, Sq,
      Sk, causal, Sk - Sq, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dq(Strided q, Strided k, Strided v, Strided o, Strided dout, const void* mask,
           const void* lse, void* dq, int B, int H, int Sq, int Sk, int causal, float scale,
           cudaStream_t st) {
  constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
  const size_t smem =
      sizeof(T) * (4 * kTile * LD + kTile * LDP) + 2 * sizeof(float) * kTile + kTile;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = smem_attr(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((Sq + kTile - 1) / kTile, H, B), kThreads, smem, st>>>(
      q, k, v, o, dout, (const unsigned char*)mask, (const float*)lse, (T*)dq, H, Sq, Sk,
      causal, Sk - Sq, scale);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int H, int Sq, int Sk) {
  return B >= 0 && H >= 0 && Sq >= 0 && Sk >= 0 && H <= 65535 && B <= 65535;
}

#define DTF_DISPATCH_D(T, D, CALL)                           \
  switch (D) {                                               \
    case 64: { constexpr int kD = 64; return CALL; }         \
    case 128: { constexpr int kD = 128; return CALL; }       \
    default: return (int)cudaErrorInvalidValue;              \
  }

template <typename T>
int fwd_entry(const void* q, long long qb, long long qh, long long qs, const void* k,
              long long kb, long long kh, long long ks, const void* v, long long vb,
              long long vh, long long vs, const void* mask, void* out, void* lse, int B, int H,
              int Sq, int Sk, int D, int causal, float scale, void* stream) {
  const Strided Q{q, qb, qh, qs}, K{k, kb, kh, ks}, V{v, vb, vh, vs};
  if (!shapes_ok(B, H, Sq, Sk) || !aligned<T>(Q) || !aligned<T>(K) || !aligned<T>(V))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  DTF_DISPATCH_D(T, D, (fwd<T, kD>(Q, K, V, mask, out, lse, B, H, Sq, Sk, causal, scale, st)))
}

template <typename T>
int dkv_entry(const void* q, long long qb, long long qh, long long qs, const void* k,
              long long kb, long long kh, long long ks, const void* v, long long vb,
              long long vh, long long vs, const void* o, long long ob, long long oh,
              long long os, const void* dout, long long db, long long dh, long long ds,
              const void* mask, const void* lse, void* dk, void* dv, int B, int H, int Sq,
              int Sk, int D, int causal, float scale, void* stream) {
  const Strided Q{q, qb, qh, qs}, K{k, kb, kh, ks}, V{v, vb, vh, vs}, O{o, ob, oh, os},
      dO{dout, db, dh, ds};
  if (!shapes_ok(B, H, Sq, Sk) || !aligned<T>(Q) || !aligned<T>(K) || !aligned<T>(V) ||
      !aligned<T>(dO))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sk == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  DTF_DISPATCH_D(T, D,
                 (bwd_dkv<T, kD>(Q, K, V, O, dO, mask, lse, dk, dv, B, H, Sq, Sk, causal,
                                 scale, st)))
}

template <typename T>
int dq_entry(const void* q, long long qb, long long qh, long long qs, const void* k,
             long long kb, long long kh, long long ks, const void* v, long long vb,
             long long vh, long long vs, const void* o, long long ob, long long oh,
             long long os, const void* dout, long long db, long long dh, long long ds,
             const void* mask, const void* lse, void* dq, int B, int H, int Sq, int Sk, int D,
             int causal, float scale, void* stream) {
  const Strided Q{q, qb, qh, qs}, K{k, kb, kh, ks}, V{v, vb, vh, vs}, O{o, ob, oh, os},
      dO{dout, db, dh, ds};
  if (!shapes_ok(B, H, Sq, Sk) || !aligned<T>(Q) || !aligned<T>(K) || !aligned<T>(V) ||
      !aligned<T>(dO))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  DTF_DISPATCH_D(T, D,
                 (bwd_dq<T, kD>(Q, K, V, O, dO, mask, lse, dq, B, H, Sq, Sk, causal, scale,
                                st)))
}

}  // namespace

extern "C" {

// Each tensor argument is (pointer, stride_b, stride_h, stride_s) in
// elements, D contiguous; mask may be null; out/lse/dq/dk/dv contiguous.

#define DTF_FWD_ARGS                                                                     \
  const void *q, long long qb, long long qh, long long qs, const void *k, long long kb, \
      long long kh, long long ks, const void *v, long long vb, long long vh, long long vs, \
      const void *mask, void *out, void *lse, int B, int H, int Sq, int Sk, int D,       \
      int causal, float scale, void *stream
#define DTF_FWD_PASS q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, mask, out, lse, B, H, Sq, Sk, \
                     D, causal, scale, stream

int flash_fwd_f32(DTF_FWD_ARGS) { return fwd_entry<float>(DTF_FWD_PASS); }
int flash_fwd_bf16(DTF_FWD_ARGS) { return fwd_entry<__nv_bfloat16>(DTF_FWD_PASS); }

#define DTF_BWD_HEAD                                                                     \
  const void *q, long long qb, long long qh, long long qs, const void *k, long long kb, \
      long long kh, long long ks, const void *v, long long vb, long long vh, long long vs, \
      const void *o, long long ob, long long oh, long long os, const void *dout,         \
      long long db, long long dh, long long ds, const void *mask, const void *lse
#define DTF_BWD_TAIL int B, int H, int Sq, int Sk, int D, int causal, float scale, void *stream
#define DTF_BWD_HEAD_PASS \
  q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, o, ob, oh, os, dout, db, dh, ds, mask, lse
#define DTF_BWD_TAIL_PASS B, H, Sq, Sk, D, causal, scale, stream

int flash_bwd_dkv_f32(DTF_BWD_HEAD, void* dk, void* dv, DTF_BWD_TAIL) {
  return dkv_entry<float>(DTF_BWD_HEAD_PASS, dk, dv, DTF_BWD_TAIL_PASS);
}
int flash_bwd_dkv_bf16(DTF_BWD_HEAD, void* dk, void* dv, DTF_BWD_TAIL) {
  return dkv_entry<__nv_bfloat16>(DTF_BWD_HEAD_PASS, dk, dv, DTF_BWD_TAIL_PASS);
}
int flash_bwd_dq_f32(DTF_BWD_HEAD, void* dq, DTF_BWD_TAIL) {
  return dq_entry<float>(DTF_BWD_HEAD_PASS, dq, DTF_BWD_TAIL_PASS);
}
int flash_bwd_dq_bf16(DTF_BWD_HEAD, void* dq, DTF_BWD_TAIL) {
  return dq_entry<__nv_bfloat16>(DTF_BWD_HEAD_PASS, dq, DTF_BWD_TAIL_PASS);
}

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
