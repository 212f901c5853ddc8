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
// D=64, causal, bf16) every kernel does 2-4 S*S*D products per (b, h), so it
// is bound by tensor-core operations, not bytes (forward 12.9 GFLOP against
// 50 MB). Every bf16 product is mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// For f32 inputs the forward, dK/dV and dQ are the first design: one warp
// per 16 rows of a 64-row tile, 4 warps, operands staged synchronously in
// shared memory, P and dS written to shared memory and read back, the tile
// loops on CUDA cores (scalar FMAs in the mma's fragment layout), so f32
// keeps full f32 products; that path is for checks, not for speed.
//
// The forward for bf16 inputs (flash_fwd_kernel, traits Fwd) is built on
// tile_mma.cuh. Its work is 2 products of 2*D operations per attended
// (row, key) pair against 3 reads of [B,H,S,D] and one write, so, as for
// dK/dV, what bounds it is how fast a CTA feeds its mma.sync chain:
//  - Queries are the mma rows: each warp owns 16 * MI rows. Q's A fragments
//    are read once by ldmatrix and stay in registers for the whole key loop.
//  - K and V stream through a cp.async ring of STAGES [BN keys][D] tiles,
//    one __syncthreads an iteration, tile i + STAGES - 1 in flight while
//    tile i computes; keys past Sk are zero-filled.
//  - S = Q K^T takes K as it lies ([key][d]) by ldsm_x4; P V takes V as it
//    lies by ldsm_x4_trans.
//  - Online softmax in the log2 domain: p = exp2(s * scale * log2(e) - m),
//    one FMA and one exp2 an element; row max and sum over the quad by
//    shuffles. The m16n8 accumulators of two adjacent key n-tiles, packed to
//    bf16 pairs, are the m16k16 A fragment of P V: nothing goes through
//    shared memory.
//  - The kv_mask is a per-key bit word for the tile (a warp ballot over
//    mask bytes read one tile ahead); the mask and causal tests run only on
//    tiles that hold masked or missing keys or cross the diagonal band of
//    the warp's rows; tiles wholly above the band skip their products.
//  - The grid is (B * H, q tiles), the heaviest causal q tile first. out
//    leaves through shared memory in 16-byte rows, scaled by 1 / l and
//    rounded once; the LSE in natural-log units, (m + log2 l) * ln 2.
//
// dK/dV for bf16 inputs (flash_bwd_dkv_kernel, traits Dkv) is built on
// tile_mma.cuh. Its work is 4 products of 2*D operations per attended
// (key, row) pair against 5 reads of [B,H,S,D], so what bounds it is how
// fast a CTA can feed its mma.sync chain. The design keeps that chain fed:
//  - Keys are the mma rows: each warp owns 16 keys and computes
//    S^T = K Q^T and dP^T = V dO^T for a q tile. The m16n8 accumulators of
//    two adjacent n-tiles, packed to bf16 pairs, are the m16k16 A fragment
//    of P^T dO (dS^T Q), so p and ds go from the softmax arithmetic straight
//    into the next mma.sync, in registers; nothing round-trips through
//    shared memory.
//  - Q and dO are staged as they lie ([row][d]) and read by ldmatrix: as the
//    B operand of S^T and dP^T with ldsm_x4, as the B operand of dK and dV
//    with ldsm_x4_trans, from the one staged copy. K and V are read once
//    into register A fragments (D = 64), or by ldsm_x4 at every use where
//    registers are short (D = 128).
//  - Q, dO, O (cp.async, 16 bytes) and the LSE (4 bytes) of q tile i+2 are
//    copied into a 3-stage ring while tile i computes, one __syncthreads an
//    iteration; rows past Sq are zero-filled (they add exactly 0: dO = O = 0
//    there).
//  - delta = rowsum(dO * O) is computed in f32 from the staged dO and O
//    tiles with 16-byte shared reads, one tile ahead, together with
//    LSE * log2(e), so p = exp2(s * scale * log2(e) - LSE * log2(e)).
//  - The kv_mask is a per-key predicate held in registers; the causal test
//    runs only where a warp's 16 keys cross the diagonal band of a q
//    sub-tile; sub-tiles wholly above the band, past Sq, or of a warp whose
//    keys are all masked skip their products.
//  A CTA is 4 warps (64 keys) at D = 64, two CTAs an SM, and 8 warps (128
//  keys) at D = 128, one (Dkv); the grid puts the key tile on its slowest
//  axis so the heaviest causal tiles (lowest keys) launch first. dK and dV
//  leave through shared memory in 16-byte rows, each rounded once.
//
// dQ for bf16 inputs (flash_bwd_dq_kernel, traits Dq) is built on
// tile_mma.cuh and laid out like the forward. Its work is 3 products of 2*D
// operations per attended (row, key) pair (S = Q K^T, dP = dO V^T, dQ +=
// dS K) against 5 reads of [B,H,S,D] and one write, and it has no online
// max: the LSE is final, so each key tile is independent of the last.
//  - Queries are the mma rows: each warp owns 16 * MI rows. Q's and dO's A
//    fragments are read once by ldmatrix and stay in registers for the
//    whole key loop.
//  - K and V stream through a cp.async ring of STAGES [BN keys][D] tiles,
//    one __syncthreads an iteration; keys past Sk are zero-filled. S takes
//    K as it lies by ldsm_x4, dP takes V as it lies by ldsm_x4, and dS K
//    takes K by ldsm_x4_trans from the same staged copy.
//  - p = exp2(s * scale * log2(e) - LSE * log2(e)), one FMA and one exp2
//    an element; ds = p (dp - delta) scale. The m16n8 accumulators of two
//    adjacent key n-tiles, packed to bf16 pairs, are the m16k16 A fragment
//    of dS K: nothing goes through shared memory.
//  - delta = rowsum(dO * O) in f32 is computed once a CTA, each warp for
//    its own rows, from the O and dO tiles staged with Q (16-byte shared
//    reads), together with LSE * log2(e); both reach their lanes by
//    shuffles.
//  - The kv_mask bit word and the masked / unmasked instantiations are the
//    forward's; tiles wholly above the band of a warp's rows skip their
//    products. The grid is (B * H, q tiles), the heaviest causal q tile
//    first. dq leaves through the warp's own rows of the O tile in 16-byte
//    rows, rounded once.
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

#include <type_traits>

#include "tile_mma.cuh"

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
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// padded shared-memory row: 16 bytes past the data keeps the rows of one
// fragment load on different banks
template <typename T>
__host__ __device__ constexpr int padded(int n) { return n + 16 / (int)sizeof(T); }

// One warp, on CUDA cores (the f32 kernels): acc (16 x 8*NT, in the layout
// of the m16n8 mma accumulator fragments) += A (16 x K) times B (K x 8*NT),
// both read from shared memory:
//   A(m, k) = a[m * AM + k * AK],  B(k, n) = b[n * BN + k * BK].
// Fragment layout (PTX m16n8k16): g = lane / 4, t = lane % 4; acc[j] holds
// rows g and g + 8, columns 8j + 2t and 8j + 2t + 1.
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
// Forward for f32 inputs (the first design, on CUDA cores): one block per
// (q tile, h, b); kv tiles in a loop, online softmax.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(Strided q, Strided k, Strided v, const unsigned char* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                     int causal, int q_offset, float scale) {
  using T = float;
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
// dK, dV for f32 inputs (the first design, on CUDA cores): one block per
// (kv tile, h, b), the kv tile resident; q tiles in a loop. Each warp owns 16
// keys and works on transposed tiles (keys x rows).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(Strided q, Strided k, Strided v, Strided o, Strided dout,
                         const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int Sq,
                         int Sk, int causal, int q_offset, float scale) {
  using T = float;
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
// dK, dV for bf16 inputs (see the note at the top): one CTA per (b, h, key
// tile), the key tile resident; q tiles stream through a cp.async ring.
// ---------------------------------------------------------------------------

// The CTA shape and shared-memory layout of flash_bwd_dkv_kernel<D>. On an
// H100 (PERF.md): at D = 64, 4 warps (64 keys; 248 registers, 103 KB,
// two CTAs an SM) beat 8 (128 keys, one CTA) by 6%; at D = 128 the ring
// takes 193 KB at 4 warps, one CTA of 4 warps an SM, so 8 warps (228 KB),
// 1.35x faster; 16-row sub-tiles there keep ptxas from spilling.
template <int D>
struct Dkv {
  using bf16 = __nv_bfloat16;
  static constexpr int WARPS = D <= 64 ? 4 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = 16 * WARPS;  // keys of a CTA, 16 a warp
  static constexpr int BQ = 64;          // rows of a staged q tile
  static constexpr int NQ = D <= 64 ? 64 : 16;  // rows of it in registers at once
  static constexpr bool KV_REGS = D <= 64;      // K, V A fragments held in registers
  static constexpr int STAGES = 3;
  static constexpr int LD = tile::pad_ld<bf16>(D);
  static constexpr int TILE = BQ * LD;  // elements of one staged [BQ][D] tile
  static constexpr int TPR = THREADS / BQ;  // threads a row in the delta pass
  // K, V [BK][LD]; STAGES x {Q, dO, O [BQ][LD], LSE [BQ]}; delta and
  // LSE * log2(e) of two tiles [2][BQ] each; the key mask [BK]
  static constexpr size_t KV_BYTES = 2 * sizeof(bf16) * BK * LD;
  static constexpr size_t STAGE_BYTES = 3 * sizeof(bf16) * TILE + sizeof(float) * BQ;
  static constexpr size_t SMEM = KV_BYTES + STAGES * STAGE_BYTES + 4 * sizeof(float) * BQ + BK;
  static_assert(BQ % NQ == 0 && NQ % 16 == 0 && D % 16 == 0, "16-row, 16-deep mma steps");
  static_assert(THREADS % BQ == 0 && (D / TPR) % 8 == 0 && THREADS >= BQ, "the row pass");
  static_assert(STAGE_BYTES % 16 == 0 && SMEM <= 232448, "16-byte stages in 227 KB");
};

// Stage rows [r0, r0 + ROWS) of one (b, h) slice of a [B,H,S,D] bf16 tensor
// in shared memory (row pitch LD) with cp.async, 16 bytes a copy, shared by
// THREADS threads; rows >= S are zero-filled.
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const Strided& src, int b, int h,
                                           int r0, int S) {
  constexpr int P = D / 8, C = ROWS * P;
  static_assert(C % THREADS == 0, "every thread copies as many chunks");
  const __nv_bfloat16* base = (const __nv_bfloat16*)src.p + b * src.sb + h * src.sh;
#pragma unroll
  for (int u = 0; u < C / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS, r = i / P, c = i % P * 8;
    const bool ok = r0 + r < S;
    tile::cp_async16(dst + r * LD + c, ok ? base + (r0 + r) * src.ss + c : base, ok);
  }
}

// two f32 values rounded to one bf16 pair, lo in the lower half (the mma
// fragment order)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Dkv<D>::THREADS, 1)
flash_bwd_dkv_kernel(Strided q, Strided k, Strided v, Strided o, Strided dout,
                     const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                     int Sq, int Sk, int causal, int q_offset, float scale) {
  using S = Dkv<D>;
  using bf16 = __nv_bfloat16;
  constexpr int BK = S::BK, BQ = S::BQ, NQ = S::NQ, LD = S::LD, THREADS = S::THREADS;
  constexpr int NJ = NQ / 8, NO = D / 8, KS = D / 16, P = D / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  unsigned char* ring = smem_raw + S::KV_BYTES;
  float* delta_s = reinterpret_cast<float*>(ring + S::STAGES * S::STAGE_BYTES);  // [2][BQ]
  float* lse2_s = delta_s + 2 * BQ;                                              // [2][BQ]
  unsigned char* keep = reinterpret_cast<unsigned char*>(lse2_s + 2 * BQ);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c0 = blockIdx.y * BK, kw0 = c0 + 16 * warp;  // the CTA's, the warp's first key
  const int key[2] = {kw0 + g, kw0 + g + 8};
  const float sl2 = scale * kLog2e;
  // rows whose band reaches the tile's first key: r + q_offset >= c0
  const int r_begin = causal ? max(0, c0 - q_offset) : 0;
  const int n_tiles = Sq > r_begin ? (Sq - r_begin + BQ - 1) / BQ : 0;

  auto stage = [&](int i) { return reinterpret_cast<bf16*>(ring + i % S::STAGES * S::STAGE_BYTES); };
  // copy Q, dO, O and the LSE of q tile i into its stage; one commit group
  // a call (empty past the last tile)
  auto load_tile_async = [&](int i) {
    if (i < n_tiles) {
      const int r0 = r_begin + i * BQ;
      bf16* st = stage(i);
      stage_rows<BQ, D, LD, THREADS>(st, q, b, h, r0, Sq);
      stage_rows<BQ, D, LD, THREADS>(st + S::TILE, dout, b, h, r0, Sq);
      stage_rows<BQ, D, LD, THREADS>(st + 2 * S::TILE, o, b, h, r0, Sq);
      const int r = threadIdx.x;
      if (r < BQ) {
        const bool ok = r0 + r < Sq;
        tile::cp_async4(reinterpret_cast<float*>(st + 3 * S::TILE) + r,
                        lse + (size_t)bh * Sq + (ok ? r0 + r : 0), ok);
      }
    }
    tile::cp_async_commit();
  };
  // delta = rowsum(dO * O) in f32 and LSE * log2(e) of q tile i, from its
  // stage, TPR threads a row
  auto row_pass = [&](int i) {
    if (i >= n_tiles) return;
    constexpr int PER = D / S::TPR;
    const bf16* st = stage(i);
    const int r = threadIdx.x / S::TPR, part = threadIdx.x % S::TPR;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < PER / 8; ++u) {
      const int c = part * PER + 8 * u;
      float d8[8], o8[8];
      tile::load8(st + S::TILE + r * LD + c, d8);
      tile::load8(st + 2 * S::TILE + r * LD + c, o8);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(d8[e], o8[e], acc);
    }
#pragma unroll
    for (int m = 1; m < S::TPR; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (part == 0) {
      delta_s[(i & 1) * BQ + r] = acc;
      lse2_s[(i & 1) * BQ + r] = reinterpret_cast<const float*>(st + 3 * S::TILE)[r] * kLog2e;
    }
  };

  // K, V and q tile 0 in the first group, q tile 1 in the second
  stage_rows<BK, D, LD, THREADS>(Ks, k, b, h, c0, Sk);
  stage_rows<BK, D, LD, THREADS>(Vs, v, b, h, c0, Sk);
  for (int i = threadIdx.x; i < BK; i += THREADS)
    keep[i] = c0 + i < Sk && (mask == nullptr || mask[(size_t)b * Sk + c0 + i] != 0);
  load_tile_async(0);
  load_tile_async(1);
  tile::cp_async_wait<1>();
  __syncthreads();
  row_pass(0);
  const bool key_ok[2] = {keep[16 * warp + g] != 0, keep[16 * warp + g + 8] != 0};
  const bool live = __ballot_sync(0xffffffffu, key_ok[0] || key_ok[1]) != 0;
  // the A fragments of this warp's 16 keys: (keys, d 16kk..16kk+15)
  const int a_off = (16 * warp + (lane & 15)) * LD + 8 * (lane >> 4);
  uint32_t kf[S::KV_REGS ? KS : 1][4], vf[S::KV_REGS ? KS : 1][4];
  if constexpr (S::KV_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      tile::ldsm_x4(kf[kk], Ks + a_off + 16 * kk);
      tile::ldsm_x4(vf[kk], Vs + a_off + 16 * kk);
    }
  }
  float dka[NO][4], dva[NO][4];
  zero(dka);
  zero(dva);

  for (int i = 0; i < n_tiles; ++i) {
    tile::cp_async_wait<0>();  // q tile i + 1 has landed (this thread's copies)
    __syncthreads();  // ... every thread's; tile i - 1 and its stage are done with
    load_tile_async(i + 2);
    row_pass(i + 1);
    const bf16* Qs = stage(i);
    const bf16* dOs = Qs + S::TILE;
    const float* l2 = lse2_s + (i & 1) * BQ;
    const float* dl = delta_s + (i & 1) * BQ;
    const int r0 = r_begin + i * BQ;
#pragma unroll
    for (int qc = 0; qc < BQ; qc += NQ) {
      const int rq = r0 + qc;  // the sub-tile's rows [rq, rq + NQ)
      // nothing to add: keys all masked, rows past Sq, or wholly above the band
      if (!live || rq >= Sq || (causal && rq + NQ - 1 + q_offset < kw0)) continue;
      const bool diag = causal && rq + q_offset < kw0 + 15;  // some pair above the band
      // S^T = K Q^T and dP^T = V dO^T over d: B(d, row) = Q[row][d] as it lies
      float st[NJ][4], dpt[NJ][4];
      zero(st);
      zero(dpt);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (S::KV_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ka[e] = kf[kk][e], va[e] = vf[kk][e];
        } else {
          tile::ldsm_x4(ka, Ks + a_off + 16 * kk);
          tile::ldsm_x4(va, Vs + a_off + 16 * kk);
        }
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          const int off = (qc + 8 * j + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                          8 * ((lane >> 3) & 1);
          uint32_t bq[4], bo[4];
          tile::ldsm_x4(bq, Qs + off);
          tile::ldsm_x4(bo, dOs + off);
          tile::mma_bf16(st[j], ka, bq[0], bq[1]);
          tile::mma_bf16(st[j + 1], ka, bq[2], bq[3]);
          tile::mma_bf16(dpt[j], va, bo[0], bo[1]);
          tile::mma_bf16(dpt[j + 1], va, bo[2], bo[3]);
        }
      }
      // p = exp(s * scale - LSE) (0 under the masks), ds = p (dp - delta)
      // scale, rounded to bf16 pairs: n-tiles 2kk and 2kk + 1 of the
      // accumulators are the A fragment kk (keys x rows 16kk..) of P^T, dS^T
      uint32_t pa[NQ / 16][4], da[NQ / 16][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = qc + 8 * j + 2 * t;  // the stage row of elements 0, 2
        const float2 ls = *reinterpret_cast<const float2*>(l2 + col);
        const float2 de = *reinterpret_cast<const float2*>(dl + col);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = e >> 1;
          const bool ok =
              key_ok[ki] && (!diag || key[ki] <= r0 + col + (e & 1) + q_offset);
          p[e] = ok ? exp2f(fmaf(st[j][e], sl2, -((e & 1) ? ls.y : ls.x))) : 0.f;
          ds[e] = p[e] * (dpt[j][e] - ((e & 1) ? de.y : de.x)) * scale;
        }
        pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
        da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += P^T dO, dK += dS^T Q: B(row, d) = dO[row][d] as it lies, by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          const int off = (qc + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * j +
                          8 * (lane >> 4);
          uint32_t bo[4], bq[4];
          tile::ldsm_x4_trans(bo, dOs + off);
          tile::ldsm_x4_trans(bq, Qs + off);
          tile::mma_bf16(dva[j], pa[kk], bo[0], bo[1]);
          tile::mma_bf16(dva[j + 1], pa[kk], bo[2], bo[3]);
          tile::mma_bf16(dka[j], da[kk], bq[0], bq[1]);
          tile::mma_bf16(dka[j + 1], da[kk], bq[2], bq[3]);
        }
    }
  }

  // dK, dV rounded once, through the K, V tiles to 16-byte rows; keys past
  // Sk are not stored
  tile::cp_async_wait<0>();
  __syncthreads();  // every warp is done with K and V
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = (16 * warp + g + 8 * i) * LD + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(Ks + at) =
          __floats2bfloat162_rn(dka[j][2 * i], dka[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(Vs + at) =
          __floats2bfloat162_rn(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  __syncthreads();
  for (int u = threadIdx.x; u < BK * P; u += THREADS) {
    const int r = u / P, c = u % P * 8;
    if (c0 + r >= Sk) continue;
    const size_t at = ((size_t)bh * Sk + c0 + r) * D + c;
    *reinterpret_cast<uint4*>(dk + at) = *reinterpret_cast<const uint4*>(Ks + r * LD + c);
    *reinterpret_cast<uint4*>(dv + at) = *reinterpret_cast<const uint4*>(Vs + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// Forward for bf16 inputs (see the note at the top): one CTA per (b, h, q
// tile), the q tile's fragments in registers; key tiles stream through a
// cp.async ring.
// ---------------------------------------------------------------------------

// The CTA shape and shared-memory layout of flash_fwd_kernel<D>. On an
// H100 (PERF.md): at D = 64, 128 rows of 4 warps (32 a warp: each K and V
// fragment feeds two row groups; 247 registers, two CTAs an SM) beat 64 x
// 4 by 16% and 128 x 8 by 27%; at D = 128, 32 rows a warp spill, and 64 x
// 4 with 2 stages (two CTAs an SM) beat 128 x 8 by 4% and 3 stages (one
// CTA) by 36%.
template <int D>
struct Fwd {
  using bf16 = __nv_bfloat16;
  static constexpr int WARPS = 4;                 // warps of a forward CTA
  static constexpr int MI = D <= 64 ? 2 : 1;      // 16-row groups of a warp
  static constexpr int BN = 64;                   // keys of a ring stage
  static constexpr int STAGES = D <= 64 ? 3 : 2;  // depth of the K, V ring
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 16 * MI * WARPS;  // query rows of a CTA
  static constexpr int LD = tile::pad_ld<bf16>(D);
  // Q (then out) [BM][LD]; STAGES x {K, V [BN][LD]}
  static constexpr size_t Q_BYTES = sizeof(bf16) * BM * LD;
  static constexpr size_t STAGE_BYTES = 2 * sizeof(bf16) * BN * LD;
  static constexpr size_t SMEM = Q_BYTES + STAGES * STAGE_BYTES;
  static_assert(BN % 32 == 0 && D % 16 == 0, "32-key mask words, 16-deep mma steps");
  static_assert(STAGES >= 2 && SMEM <= 232448, "a ring of at least 2 stages in 227 KB");
};

template <int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
flash_fwd_kernel(Strided q, Strided k, Strided v, const unsigned char* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                 int Sk, int causal, int q_offset, float scale) {
  using S = Fwd<D>;
  using bf16 = __nv_bfloat16;
  constexpr int BM = S::BM, BN = S::BN, MI = S::MI, LD = S::LD, THREADS = S::THREADS;
  constexpr int KS = D / 16, NB = BN / 8, NO = D / 8, NW = BN / 32, P = D / 8;
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + S::Q_BYTES;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = (Sq + BM - 1) / BM;
  // the last q tiles attend the most keys under the causal mask: first
  const int q0 = (causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int rw = q0 + 16 * MI * warp;  // the warp's first row
  // keys past the diagonal band of the tile's last row are never attended
  const int kv_end = causal ? min(Sk, q0 + BM + q_offset) : Sk;
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  auto stage = [&](int i) { return reinterpret_cast<bf16*>(ring + i % S::STAGES * S::STAGE_BYTES); };
  // copy K, V of key tile i into its stage; one commit group a call (empty
  // past the last tile)
  auto load_kv_async = [&](int i) {
    if (i < n_tiles) {
      bf16* st = stage(i);
      stage_rows<BN, D, LD, THREADS>(st, k, b, h, i * BN, Sk);
      stage_rows<BN, D, LD, THREADS>(st + BN * LD, v, b, h, i * BN, Sk);
    }
    tile::cp_async_commit();
  };
  // the kv_mask bytes of key tile i, key lane + 32 u of the tile in mb[u]:
  // read a tile ahead of their ballot, so the load is in flight meanwhile
  unsigned char mb[NW];
  auto load_mask = [&](int i) {
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      const int c = i * BN + lane + 32 * u;
      mb[u] = mask != nullptr && c < Sk ? mask[(size_t)b * Sk + c] : 1;
    }
  };

  // Q and key tile 0 in the first group, tiles 1.. STAGES - 2 in the next
  stage_rows<BM, D, LD, THREADS>(Qs, q, b, h, q0, Sq);
#pragma unroll
  for (int i = 0; i < S::STAGES - 1; ++i) load_kv_async(i);
  load_mask(0);
  tile::cp_async_wait<S::STAGES - 2>();
  __syncthreads();
  // the A fragments of the warp's rows: (rows rw + 16 mi.., d 16 kk..); for
  // a negative scale, -Q (exact in bf16) against a positive one, so that the
  // row max of the raw products is the max of the scaled logits
  float sl2 = scale * kLog2e;
  uint32_t qf[MI][KS][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tile::ldsm_x4(qf[mi][kk], Qs + (16 * (MI * warp + mi) + (lane & 15)) * LD + 16 * kk +
                                    8 * (lane >> 4));
  if (sl2 < 0.f) {
    sl2 = -sl2;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[mi][kk][e] ^= 0x80008000u;
  }
  // running max (log2 units), this thread's share of the row sum, and the
  // output accumulators of rows g and g + 8 of each 16-row group
  float m[MI][2], l[MI][2], o[MI][NO][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    m[mi][0] = m[mi][1] = kNegInf;
    l[mi][0] = l[mi][1] = 0.f;
    zero(o[mi]);
  }

  for (int i = 0; i < n_tiles; ++i) {
    tile::cp_async_wait<S::STAGES - 2>();  // key tile i has landed (this thread's copies)
    __syncthreads();  // ... every thread's; tile i - 1 and its stage are done with
    load_kv_async(i + S::STAGES - 1);
    const int c0 = i * BN;
    // bit c % 32 of kw[c / 32]: key c0 + c exists and attends
    uint32_t kw[NW];
#pragma unroll
    for (int u = 0; u < NW; ++u)
      kw[u] = __ballot_sync(0xffffffffu, c0 + lane + 32 * u < Sk && mb[u] != 0);
    if (i + 1 < n_tiles) load_mask(i + 1);
    // nothing to add: rows all past Sq, or the tile wholly above their band
    if (rw >= Sq || (causal && c0 > rw + 16 * MI - 1 + q_offset)) continue;
    const bool diag = causal && c0 + BN - 1 > rw + q_offset;  // some pair above the band
    const bool masked = diag || mask != nullptr || c0 + BN > Sk;
    const bf16* Ks = stage(i);
    const bf16* Vs = Ks + BN * LD;

    // S = Q K^T over d: B(d, key) = K[key][d] as it lies
    float s[MI][NB][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) zero(s[mi]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t kb[4];
        tile::ldsm_x4(kb, Ks + (8 * j + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                              8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          tile::mma_bf16(s[mi][j], qf[mi][kk], kb[0], kb[1]);
          tile::mma_bf16(s[mi][j + 1], qf[mi][kk], kb[2], kb[3]);
        }
      }

    // online softmax; p = exp2(s * scale * log2(e) - m), 0 under the masks,
    // rounded to bf16 pairs: n-tiles 2kk and 2kk + 1 of the accumulators are
    // the A fragment kk (rows x keys 16kk..) of P V
    uint32_t pa[MI][BN / 16][4];
    auto softmax = [&](auto masked_tag) {
      constexpr bool MASKED = decltype(masked_tag)::value;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // element e of n-tile j: key c0 + 8j + 2t + (e & 1), row r = rw +
        // 16 mi + g + 8 (e >> 1); attended iff its kv bit is set and, on a
        // diagonal tile, 8j + (e & 1) <= r + q_offset - c0 - 2t
        int lim[2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
          lim[r2] = diag ? rw + 16 * mi + g + 8 * r2 + q_offset - c0 - 2 * t : BN;
        auto ok = [&](int j, int e) {
          return ((kw[j >> 2] >> (8 * (j & 3) + 2 * t + (e & 1))) & 1u) &&
                 8 * j + (e & 1) <= lim[e >> 1];
        };
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], !MASKED || ok(j, e) ? s[mi][j][e] : kNegInf);
        float corr[2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          mx[r2] = fmaxf(mx[r2], __shfl_xor_sync(0xffffffffu, mx[r2], 1));
          mx[r2] = fmaxf(mx[r2], __shfl_xor_sync(0xffffffffu, mx[r2], 2));
          const float m_new = fmaxf(m[mi][r2], mx[r2] * sl2);
          corr[r2] = exp2f(m[mi][r2] - m_new);
          m[mi][r2] = m_new;
          l[mi][r2] *= corr[r2];
        }
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          o[mi][j][0] *= corr[0];
          o[mi][j][1] *= corr[0];
          o[mi][j][2] *= corr[1];
          o[mi][j][3] *= corr[1];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2f(fmaf(s[mi][j][e], sl2, -m[mi][e >> 1]));
            if (MASKED && !ok(j, e)) p[e] = 0.f;
          }
          l[mi][0] += p[0] + p[1];
          l[mi][1] += p[2] + p[3];
          pa[mi][j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
          pa[mi][j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
        }
      }
    };
    if (masked)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    // O += P V: B(key, d) = V[key][d] as it lies, by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t vb[4];
        tile::ldsm_x4_trans(vb, Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                    8 * j + 8 * (lane >> 4));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          tile::mma_bf16(o[mi][j], pa[mi][kk], vb[0], vb[1]);
          tile::mma_bf16(o[mi][j + 1], pa[mi][kk], vb[2], vb[3]);
        }
      }
  }

  // out = O / l rounded once, through the warp's own rows of the Q tile to
  // 16-byte rows; LSE = (m + log2 l) ln 2. Rows past Sq are not stored; a
  // row that attends nothing has l = 0 and O = 0: out 0, LSE NEG_INF.
  tile::cp_async_wait<0>();
  bf16* Ow = Qs + 16 * MI * warp * LD;
  __syncwarp();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float sum = l[mi][r2];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int r = 16 * mi + g + 8 * r2;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<__nv_bfloat162*>(Ow + r * LD + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[mi][j][2 * r2] * inv, o[mi][j][2 * r2 + 1] * inv);
      if (t == 0 && rw + r < Sq)
        lse[(size_t)bh * Sq + rw + r] = sum > 0.f ? (m[mi][r2] + log2f(sum)) * kLn2 : kNegInf;
    }
  __syncwarp();
  static_assert(16 * MI * P % 32 == 0, "whole 16-byte chunks a lane");
#pragma unroll
  for (int x = 0; x < 16 * MI * P / 32; ++x) {
    const int u = lane + 32 * x, r = u / P, c = u % P * 8;
    if (rw + r < Sq)
      *reinterpret_cast<uint4*>(out + ((size_t)bh * Sq + rw + r) * D + c) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// dQ for f32 inputs (the first design, on CUDA cores): one block per (q
// tile, h, b), the q tile resident; kv tiles in a loop.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(Strided q, Strided k, Strided v, Strided o, Strided dout,
                        const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                        float* __restrict__ dq, int H, int Sq, int Sk, int causal, int q_offset,
                        float scale) {
  using T = float;
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
// dQ for bf16 inputs (see the note at the top): one CTA per (b, h, q tile),
// the q tile's fragments in registers; key tiles stream through a cp.async
// ring.
// ---------------------------------------------------------------------------

// The CTA shape and shared-memory layout of flash_bwd_dq_kernel<D>: each
// warp owns 16 * MI query rows; a stage holds BN keys of K and V. On an
// H100 (PERF.md): at D = 64, 128 rows of 4 warps (32 a warp: each K and V
// fragment feeds two row groups; 255 registers, two CTAs an SM) with 32
// keys a stage; 64 x 4 with 64 keys takes 9% longer, 128 x 8 17%. At D =
// 128, 32 rows a warp spill; 64 x 4 with 32 keys (244 registers, two CTAs
// an SM); 64 keys a stage (one CTA an SM by shared memory) takes 33% longer.
template <int D>
struct Dq {
  using bf16 = __nv_bfloat16;
  static constexpr int WARPS = 4;                 // warps of a dQ CTA
  static constexpr int MI = D <= 64 ? 2 : 1;      // 16-row groups of a dQ warp
  static constexpr int BN = 32;                   // keys of a dQ ring stage
  static constexpr int STAGES = D <= 64 ? 3 : 2;  // depth of the dQ K, V ring
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 16 * MI * WARPS;  // query rows of a CTA
  static constexpr int TPR = 2 / MI;          // threads a row in the delta pass
  static constexpr int LD = tile::pad_ld<bf16>(D);
  // Q, dO, O (then dq) [BM][LD]; STAGES x {K, V [BN][LD]}
  static constexpr size_t ROW_BYTES = 3 * sizeof(bf16) * BM * LD;
  static constexpr size_t STAGE_BYTES = 2 * sizeof(bf16) * BN * LD;
  static constexpr size_t SMEM = ROW_BYTES + STAGES * STAGE_BYTES;
  static_assert(MI == 1 || MI == 2, "a warp's 16 MI rows, TPR lanes a row in the delta pass");
  static_assert(BN % 32 == 0 && D % 16 == 0 && (D / TPR) % 8 == 0, "mask words, mma steps");
  static_assert(STAGES >= 2 && SMEM <= 232448, "a ring of at least 2 stages in 227 KB");
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::THREADS, 1)
flash_bwd_dq_kernel(Strided q, Strided k, Strided v, Strided o, Strided dout,
                    const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk, int causal,
                    int q_offset, float scale) {
  using S = Dq<D>;
  using bf16 = __nv_bfloat16;
  constexpr int BM = S::BM, BN = S::BN, MI = S::MI, LD = S::LD, THREADS = S::THREADS;
  constexpr int TPR = S::TPR, KS = D / 16, NB = BN / 8, NO = D / 8, NW = BN / 32, P = D / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * LD;
  bf16* Os = dOs + BM * LD;
  unsigned char* ring = smem_raw + S::ROW_BYTES;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = (Sq + BM - 1) / BM;
  // the last q tiles attend the most keys under the causal mask: first
  const int q0 = (causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int rw = q0 + 16 * MI * warp;  // the warp's first row
  // keys past the diagonal band of the tile's last row are never attended
  const int kv_end = causal ? min(Sk, q0 + BM + q_offset) : Sk;
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  auto stage = [&](int i) { return reinterpret_cast<bf16*>(ring + i % S::STAGES * S::STAGE_BYTES); };
  // copy K, V of key tile i into its stage; one commit group a call (empty
  // past the last tile)
  auto copy_kv = [&](int i) {
    if (i < n_tiles) {
      bf16* st = stage(i);
      stage_rows<BN, D, LD, THREADS>(st, k, b, h, i * BN, Sk);
      stage_rows<BN, D, LD, THREADS>(st + BN * LD, v, b, h, i * BN, Sk);
    }
    tile::cp_async_commit();
  };
  // the kv_mask bytes of key tile i, key lane + 32 u of the tile in mb[u]:
  // read a tile ahead of their ballot, so the load is in flight meanwhile
  unsigned char mb[NW];
  auto load_mask = [&](int i) {
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      const int c = i * BN + lane + 32 * u;
      mb[u] = mask != nullptr && c < Sk ? mask[(size_t)b * Sk + c] : 1;
    }
  };
  // delta = rowsum(dO * O) in f32 and LSE * log2(e) of the warp's own rows
  // (TPR lanes a row), from the staged dO and O tiles; rows of elements g
  // and g + 8 of each 16-row group to dl, l2 by shuffles
  const int r_own = 16 * MI * warp + lane / TPR;  // this lane's row in the delta pass
  const float ls = q0 + r_own < Sq ? lse[(size_t)bh * Sq + q0 + r_own] * kLog2e : 0.f;
  float dl[MI][2], l2[MI][2];
  auto row_pass = [&] {
    constexpr int PER = D / TPR;
    const int r = r_own, part = lane % TPR;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < PER / 8; ++u) {
      const int c = part * PER + 8 * u;
      float d8[8], o8[8];
      tile::load8(dOs + r * LD + c, d8);
      tile::load8(Os + r * LD + c, o8);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(d8[e], o8[e], acc);
    }
    if constexpr (TPR == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int src = (16 * mi + g + 8 * r2) * TPR;
        dl[mi][r2] = __shfl_sync(0xffffffffu, acc, src);
        l2[mi][r2] = __shfl_sync(0xffffffffu, ls, src);
      }
  };

  // Q, dO, O and key tile 0 in the first group, tiles 1.. STAGES - 2 in
  // the next
  stage_rows<BM, D, LD, THREADS>(Qs, q, b, h, q0, Sq);
  stage_rows<BM, D, LD, THREADS>(dOs, dout, b, h, q0, Sq);
  stage_rows<BM, D, LD, THREADS>(Os, o, b, h, q0, Sq);
#pragma unroll
  for (int i = 0; i < S::STAGES - 1; ++i) copy_kv(i);
  load_mask(0);
  tile::cp_async_wait<S::STAGES - 2>();
  __syncthreads();
  row_pass();
  const float sl2 = scale * kLog2e;
  // the A fragments of the warp's rows: (rows rw + 16 mi.., d 16 kk..)
  uint32_t qf[MI][KS][4], of[MI][KS][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int off = (16 * (MI * warp + mi) + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4);
      tile::ldsm_x4(qf[mi][kk], Qs + off);
      tile::ldsm_x4(of[mi][kk], dOs + off);
    }
  float dqa[MI][NO][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) zero(dqa[mi]);

  for (int i = 0; i < n_tiles; ++i) {
    tile::cp_async_wait<S::STAGES - 2>();  // key tile i has landed (this thread's copies)
    __syncthreads();  // ... every thread's; tile i - 1 and its stage are done with
    copy_kv(i + S::STAGES - 1);
    const int c0 = i * BN;
    // bit c % 32 of kw[c / 32]: key c0 + c exists and attends
    uint32_t kw[NW];
#pragma unroll
    for (int u = 0; u < NW; ++u)
      kw[u] = __ballot_sync(0xffffffffu, c0 + lane + 32 * u < Sk && mb[u] != 0);
    if (i + 1 < n_tiles) load_mask(i + 1);
    // nothing to add: rows all past Sq, or the tile wholly above their band
    if (rw >= Sq || (causal && c0 > rw + 16 * MI - 1 + q_offset)) continue;
    const bool diag = causal && c0 + BN - 1 > rw + q_offset;  // some pair above the band
    const bool masked = diag || mask != nullptr || c0 + BN > Sk;
    const bf16* Ks = stage(i);
    const bf16* Vs = Ks + BN * LD;

    // S = Q K^T and dP = dO V^T over d: B(d, key) = K[key][d], V[key][d]
    // as they lie
    float s[MI][NB][4], dp[MI][NB][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      zero(s[mi]);
      zero(dp[mi]);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        const int off = (8 * j + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                        8 * ((lane >> 3) & 1);
        uint32_t kb[4], vb[4];
        tile::ldsm_x4(kb, Ks + off);
        tile::ldsm_x4(vb, Vs + off);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          tile::mma_bf16(s[mi][j], qf[mi][kk], kb[0], kb[1]);
          tile::mma_bf16(s[mi][j + 1], qf[mi][kk], kb[2], kb[3]);
          tile::mma_bf16(dp[mi][j], of[mi][kk], vb[0], vb[1]);
          tile::mma_bf16(dp[mi][j + 1], of[mi][kk], vb[2], vb[3]);
        }
      }

    // p = exp2(s * scale * log2(e) - LSE * log2(e)), 0 under the masks; ds
    // = p (dp - delta) scale, rounded to bf16 pairs: n-tiles 2kk and 2kk + 1
    // of the accumulators are the A fragment kk (rows x keys 16kk..) of dS K
    uint32_t da[MI][BN / 16][4];
    auto grad = [&](auto masked_tag) {
      constexpr bool MASKED = decltype(masked_tag)::value;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // element e of n-tile j: key c0 + 8j + 2t + (e & 1), row r = rw +
        // 16 mi + g + 8 (e >> 1); attended iff its kv bit is set and, on a
        // diagonal tile, 8j + (e & 1) <= r + q_offset - c0 - 2t
        int lim[2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
          lim[r2] = diag ? rw + 16 * mi + g + 8 * r2 + q_offset - c0 - 2 * t : BN;
        auto ok = [&](int j, int e) {
          return ((kw[j >> 2] >> (8 * (j & 3) + 2 * t + (e & 1))) & 1u) &&
                 8 * j + (e & 1) <= lim[e >> 1];
        };
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[mi][j][e], sl2, -l2[mi][e >> 1]));
            if (MASKED && !ok(j, e)) p = 0.f;
            ds[e] = p * (dp[mi][j][e] - dl[mi][e >> 1]) * scale;
          }
          da[mi][j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
          da[mi][j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }
      }
    };
    if (masked)
      grad(std::true_type{});
    else
      grad(std::false_type{});

    // dQ += dS K: B(key, d) = K[key][d] as it lies, by ldmatrix.trans from
    // the same staged copy
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t kb[4];
        tile::ldsm_x4_trans(kb, Ks + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                    8 * j + 8 * (lane >> 4));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          tile::mma_bf16(dqa[mi][j], da[mi][kk], kb[0], kb[1]);
          tile::mma_bf16(dqa[mi][j + 1], da[mi][kk], kb[2], kb[3]);
        }
      }
  }

  // dq rounded once, through the warp's own rows of the O tile (the delta
  // pass read no others) to 16-byte rows; rows past Sq are not stored; a
  // row that attends nothing has p = 0 everywhere: dq 0
  tile::cp_async_wait<0>();
  bf16* Dw = Os + 16 * MI * warp * LD;
  __syncwarp();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = 16 * mi + g + 8 * r2;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<__nv_bfloat162*>(Dw + r * LD + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dqa[mi][j][2 * r2], dqa[mi][j][2 * r2 + 1]);
    }
  __syncwarp();
  static_assert(16 * MI * P % 32 == 0, "whole 16-byte chunks a lane");
#pragma unroll
  for (int x = 0; x < 16 * MI * P / 32; ++x) {
    const int u = lane + 32 * x, r = u / P, c = u % P * 8;
    if (rw + r < Sq)
      *reinterpret_cast<uint4*>(dq + ((size_t)bh * Sq + rw + r) * D + c) =
          *reinterpret_cast<const uint4*>(Dw + r * LD + c);
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
  if constexpr (std::is_same<T, float>::value) {  // f32: the CUDA-core kernel
    constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
    const size_t smem = sizeof(T) * (3 * kTile * LD + kTile * LDP) + kTile;
    auto kern = flash_fwd_f32_kernel<D>;
    cudaError_t e = smem_attr(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((Sq + kTile - 1) / kTile, H, B), kThreads, smem, st>>>(
        q, k, v, (const unsigned char*)mask, (T*)out, (float*)lse, H, Sq, Sk, causal, Sk - Sq,
        scale);
  } else {  // bf16: the tile_mma.cuh kernel, q tiles on the slowest grid axis
    using S = Fwd<D>;
    if ((long long)B * H > 0x7fffffffLL || (Sq + S::BM - 1) / S::BM > 65535)
      return (int)cudaErrorInvalidValue;
    auto kern = flash_fwd_kernel<D>;
    const int e = tile::set_smem(kern, S::SMEM);
    if (e != 0) return e;
    kern<<<dim3(B * H, (Sq + S::BM - 1) / S::BM), S::THREADS, S::SMEM, st>>>(
        q, k, v, (const unsigned char*)mask, (T*)out, (float*)lse, H, Sq, Sk, causal, Sk - Sq,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dkv(Strided q, Strided k, Strided v, Strided o, Strided dout, const void* mask,
            const void* lse, void* dk, void* dv, int B, int H, int Sq, int Sk, int causal,
            float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {  // f32: the CUDA-core kernel
    constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
    const size_t smem =
        sizeof(T) * (4 * kTile * LD + 2 * kTile * LDP) + 2 * sizeof(float) * kTile + kTile;
    auto kern = flash_bwd_dkv_f32_kernel<D>;
    cudaError_t e = smem_attr(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((Sk + kTile - 1) / kTile, H, B), kThreads, smem, st>>>(
        q, k, v, o, dout, (const unsigned char*)mask, (const float*)lse, (T*)dk, (T*)dv, H, Sq,
        Sk, causal, Sk - Sq, scale);
  } else {  // bf16: the tile_mma.cuh kernel, key tiles on the slowest grid axis
    using S = Dkv<D>;
    if ((long long)B * H > 0x7fffffffLL || (Sk + S::BK - 1) / S::BK > 65535)
      return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dkv_kernel<D>;
    const int e = tile::set_smem(kern, S::SMEM);
    if (e != 0) return e;
    kern<<<dim3(B * H, (Sk + S::BK - 1) / S::BK), S::THREADS, S::SMEM, st>>>(
        q, k, v, o, dout, (const unsigned char*)mask, (const float*)lse, (T*)dk, (T*)dv, H, Sq,
        Sk, causal, Sk - Sq, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dq(Strided q, Strided k, Strided v, Strided o, Strided dout, const void* mask,
           const void* lse, void* dq, int B, int H, int Sq, int Sk, int causal, float scale,
           cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {  // f32: the CUDA-core kernel
    constexpr int LD = padded<T>(D), LDP = padded<T>(kTile);
    const size_t smem =
        sizeof(T) * (4 * kTile * LD + kTile * LDP) + 2 * sizeof(float) * kTile + kTile;
    auto kern = flash_bwd_dq_f32_kernel<D>;
    cudaError_t e = smem_attr(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((Sq + kTile - 1) / kTile, H, B), kThreads, smem, st>>>(
        q, k, v, o, dout, (const unsigned char*)mask, (const float*)lse, (T*)dq, H, Sq, Sk,
        causal, Sk - Sq, scale);
  } else {  // bf16: the tile_mma.cuh kernel, q tiles on the slowest grid axis
    using S = Dq<D>;
    if ((long long)B * H > 0x7fffffffLL || (Sq + S::BM - 1) / S::BM > 65535)
      return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dq_kernel<D>;
    const int e = tile::set_smem(kern, S::SMEM);
    if (e != 0) return e;
    kern<<<dim3(B * H, (Sq + S::BM - 1) / S::BM), S::THREADS, S::SMEM, st>>>(
        q, k, v, o, dout, (const unsigned char*)mask, (const float*)lse, (T*)dq, H, Sq, Sk,
        causal, Sk - Sq, scale);
  }
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
      !aligned<T>(O) || !aligned<T>(dO))
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
      !aligned<T>(O) || !aligned<T>(dO))
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
