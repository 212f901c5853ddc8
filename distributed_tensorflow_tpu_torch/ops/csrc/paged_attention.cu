// Paged attention forward for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces distributed_tensorflow_tpu/ops/flash_attention.py::_paged_fwd_kernel
// (entry paged_flash_attention): attention of q [B,H,S,D] read IN PLACE from
// the KV block pool k/v [NB,H,bs,D] through a block table [B,MB] (int32),
// key position p attending iff p <= q_pos[b,s]. Sentinel table ids (>= NB)
// clamp to NB-1; their positions lie above every live q_pos, so the mask
// drops them (an idle slot's past-the-table q_pos attends them: garbage,
// but finite and equal to the plain version's).
//
// Bound: the bytes of K/V it reads, B*H*ctx*D*2*sizeof(T) per call (ctx =
// the positions the rows attend). Design against that bound: the pool is
// read once, in place, and the gathered [B,H,MB*bs,D] view the "gather"
// path materialises never exists; blocks past every row's q_pos are not
// read at all (a split holding only such blocks writes m = NEG_INF, l = 0,
// which the merge weighs by exactly 0).
//
// Layout (flash-decoding): the logical blocks of a row are cut into splits
// of up to 128 keys, and one CTA of 128 threads takes (query tile of <= 16
// rows, head, batch row, split), so even one decode row spreads over
// MB*bs/128 CTAs. The TPU kernel's sequential grid axis over blocks becomes
// these parallel splits plus a second pass that merges them; the TPU's
// scalar-prefetched table becomes each CTA reading its slice of table[b]
// itself. Per split: softmax in f32 with NEG_INF = -1e30 and an explicit
// zero under the mask (never exp(NEG_INF - NEG_INF)); the merge divides by
// max(l, 1e-30), so a row that attends nothing (padded q_pos = -1) comes
// out exactly 0.
//
// K/V of a split arrive in one wave of 16-byte loads, all in flight at
// once (D * sizeof(T) a multiple of 16, pools 16-byte aligned). The math
// runs on f32 copies in shared memory with CUDA-core FMAs: a thread per key
// for q.k (every row at once, 16-byte reads), a warp per row for the
// softmax, and for p @ V a thread per (4 output columns, slice of the keys)
// with the slices summed through shared memory. Simple first: no tensor
// cores, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;     // query rows per CTA
constexpr int kMaxKeys = 128; // keys per CTA (whole blocks; one thread per key for q.k)
constexpr int kLoads = 8;     // 16-byte loads per thread per tensor
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Blocks per split: as many as give at most 128 keys, few enough that K
// and V of a split fit in kLoads 16-byte registers per thread.
int blocks_per_split(int D, int bs, int esz) {
  const int cap = min(kMaxKeys, kLoads * kThreads * 16 / (D * esz));
  return max(1, cap / bs);
}

// Pass 1: one CTA per (query tile, head, batch row, split of the logical
// blocks). It softmaxes its rows over its split's keys alone and writes the
// unnormalised p @ V with the split's max m and sum l (f32) to scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_split(const T* __restrict__ q, const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool, const int* __restrict__ table,
                      const int* __restrict__ q_pos, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int H, int S, int D, int NB, int bs,
                      int MB, int bps, int splits, int rows, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_here;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int nq = min(kRows, S - s0);
  const int j0 = sp * bps;  // first logical block of this split
  const int keys = bps * bs;
  const int Dp = D + 4;  // padded K/V rows: 16-byte row access, fewer bank conflicts
  const int quads = D / 4, groups = kThreads / quads;

  float* qs = smem;                      // [rows][D]
  float* ks = qs + rows * D;             // [keys][D+4]
  float* vs = ks + keys * Dp;            // [keys][D+4]
  float* red = vs + keys * Dp;           // [groups][rows][D] partial p @ V
  float* ps = red + groups * rows * D;   // [rows][keys]  logits, then p
  int* pos_s = reinterpret_cast<int*>(ps + rows * keys);  // [rows]
  int* ids = pos_s + rows;                                // [bps] clamped block ids

  const size_t q_off = (((size_t)b * H + h) * S + s0) * D;
  const size_t p_row = (((size_t)b * H + h) * splits + sp) * S + s0;  // scratch row
  for (int i = tid; i < nq * D; i += kThreads) qs[i] = to_f32(q[q_off + i]);
  if (tid < nq) pos_s[tid] = q_pos[(size_t)b * S + s0 + tid];
  __syncthreads();
  if (tid == 0) {
    // blocks past every row's position are fully masked: a split that
    // holds only such blocks contributes nothing, exactly
    int hi = -1;
    for (int r = 0; r < nq; ++r) hi = max(hi, pos_s[r]);
    const int nb = hi < 0 ? 0 : min(MB, hi / bs + 1);
    n_here = max(0, min(bps, nb - j0));
  }
  __syncthreads();
  const int nk = n_here * bs;
  if (nk == 0) {
    for (int i = tid; i < nq * D; i += kThreads) part_acc[p_row * D + i] = 0.f;
    if (tid < nq) {
      part_ml[(p_row + tid) * 2] = kNegInf;
      part_ml[(p_row + tid) * 2 + 1] = 0.f;
    }
    return;
  }
  // the CTA reads its part of the table itself (the TPU prefetched it as
  // scalars); sentinel ids clamp to NB-1
  if (tid < n_here) ids[tid] = min(max(table[(size_t)b * MB + j0 + tid], 0), NB - 1);
  __syncthreads();

  // stage K and V: every 16-byte load in flight before any is used
  const int vpk = D / kVec;  // vectors per key
  uint4 kr[kLoads], vr[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = tid + u * kThreads;
    if (i < nk * vpk) {
      const int key = i / vpk, d0 = (i - key * vpk) * kVec;
      const int jj = key / bs, kk = key - jj * bs;
      const size_t src = (((size_t)ids[jj] * H + h) * bs + kk) * D + d0;
      kr[u] = *reinterpret_cast<const uint4*>(k_pool + src);
      vr[u] = *reinterpret_cast<const uint4*>(v_pool + src);
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = tid + u * kThreads;
    if (i < nk * vpk) {
      const int key = i / vpk, d0 = (i - key * vpk) * kVec;
      const T* ke = reinterpret_cast<const T*>(&kr[u]);
      const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(ks + key * Dp + d0 + e) = make_float4(
            to_f32(ke[e]), to_f32(ke[e + 1]), to_f32(ke[e + 2]), to_f32(ke[e + 3]));
        *reinterpret_cast<float4*>(vs + key * Dp + d0 + e) = make_float4(
            to_f32(ve[e]), to_f32(ve[e + 1]), to_f32(ve[e + 2]), to_f32(ve[e + 3]));
      }
    }
  }
  __syncthreads();
  // masked logits: thread `tid` owns key `tid`, all rows
  if (tid < nk) {
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + tid * Dp);
    for (int d4 = 0; d4 < quads; ++d4) {
      const float4 kv = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nq) {
          const float4 qv = reinterpret_cast<const float4*>(qs + r * D)[d4];
          s[r] = fmaf(qv.x, kv.x, s[r]);
          s[r] = fmaf(qv.y, kv.y, s[r]);
          s[r] = fmaf(qv.z, kv.z, s[r]);
          s[r] = fmaf(qv.w, kv.w, s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nq) ps[r * keys + tid] = (j0 * bs + tid <= pos_s[r]) ? s[r] * scale : kNegInf;
  }
  __syncthreads();
  // softmax over the split, one warp per row; an explicit zero under the
  // mask, so a row that attends nothing here keeps m = NEG_INF, l = 0
  for (int r = warp; r < nq; r += kWarps) {
    float* pr = ps + r * keys;
    float m = kNegInf;
    for (int key = lane; key < nk; key += 32) m = fmaxf(m, pr[key]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int lim = pos_s[r] - j0 * bs;  // key attends iff key <= lim
    float l = 0.f;
    for (int key = lane; key < nk; key += 32) {
      const float p = key <= lim ? expf(pr[key] - m) : 0.f;
      pr[key] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      part_ml[(p_row + r) * 2] = m;
      part_ml[(p_row + r) * 2 + 1] = l;
    }
  }
  __syncthreads();
  // p @ V: thread owns 4 consecutive d and the keys of one slice; the
  // slices are summed through shared memory
  const int dq = tid % quads, slice = tid / quads;
  for (int r = 0; r < nq; ++r) {
    const float* pr = ps + r * keys;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int key = slice; key < nk; key += groups) {
      const float p = pr[key];
      const float4 v = reinterpret_cast<const float4*>(vs + key * Dp)[dq];
      a.x = fmaf(p, v.x, a.x);
      a.y = fmaf(p, v.y, a.y);
      a.z = fmaf(p, v.z, a.z);
      a.w = fmaf(p, v.w, a.w);
    }
    reinterpret_cast<float4*>(red + (slice * rows + r) * D)[dq] = a;
  }
  __syncthreads();
  for (int i = tid; i < nq * D; i += kThreads) {
    float pv = 0.f;
    for (int g = 0; g < groups; ++g) pv += red[g * rows * D + i];
    part_acc[p_row * D + i] = pv;
  }
}

// Pass 2: one CTA per query row (b, h, s): rescale the splits to their
// common max and normalise, out = sum(acc_i e^(m_i - M)) / max(sum(l_i
// e^(m_i - M)), 1e-30) — 0 for a row no split attended.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                        T* __restrict__ out, int S, int D, int splits) {
  const int row = blockIdx.x;  // (b * H + h) * S + s
  const size_t first = (size_t)(row / S) * splits * S + row % S;  // split 0's scratch row
  float M = kNegInf;
  for (int i = 0; i < splits; ++i) M = fmaxf(M, part_ml[(first + (size_t)i * S) * 2]);
  float L = 0.f;
  for (int i = 0; i < splits; ++i) {
    const size_t r = first + (size_t)i * S;
    L += part_ml[r * 2 + 1] * expf(part_ml[r * 2] - M);
  }
  L = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < splits; ++i) {
      const size_t r = first + (size_t)i * S;
      acc += part_acc[r * D + d] * expf(part_ml[r * 2] - M);
    }
    store(out + (size_t)row * D + d, acc / L);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* q_pos, void* out, void* part_acc, void* part_ml, int B, int H, int S,
           int D, int NB, int bs, int MB, float scale, void* stream) {
  // 16-byte K/V loads: D * sizeof(T) a multiple of 16, pools 16-byte
  // aligned; D / 4 divides the 128 threads (a quad of output columns per
  // thread, the key slices filling the rest), so D <= 128
  if (D < 4 || D > 128 || (D * sizeof(T)) % 16 != 0 || kThreads % (D / 4) != 0 ||
      bs < 1 || NB < 1 || MB < 1 || (reinterpret_cast<size_t>(k_pool) % 16) != 0 ||
      (reinterpret_cast<size_t>(v_pool) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const int bps = blocks_per_split(D, bs, sizeof(T));
  const int keys = bps * bs;
  if (keys > kMaxKeys || keys * (int)(D * sizeof(T)) > kLoads * kThreads * 16)
    return (int)cudaErrorInvalidValue;  // one block alone exceeds a split
  const int splits = (MB + bps - 1) / bps;
  const int rows = min(kRows, S);
  const int groups = kThreads / (D / 4);
  const size_t smem = sizeof(float) * ((size_t)rows * D * (1 + groups) +
                                       2 * (size_t)keys * (D + 4) + (size_t)rows * keys) +
                      sizeof(int) * (rows + bps);
  auto split = paged_attention_split<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  split<<<dim3((S + kRows - 1) / kRows, H, B * splits), kThreads, smem, st>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)table, (const int*)q_pos,
      (float*)part_acc, (float*)part_ml, H, S, D, NB, bs, MB, bps, splits, rows, scale);
  paged_attention_combine<T><<<B * H * S, kThreads, 0, st>>>(
      (const float*)part_acc, (const float*)part_ml, (T*)out, S, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Splits of the logical blocks for one call: the wrapper sizes the f32
// scratch as [B, H, splits, S, D] (acc) and [B, H, splits, S, 2] (m, l).
int paged_attention_splits(int D, int bs, int MB, int elem_size) {
  const int bps = blocks_per_split(D, bs, elem_size);
  return (MB + bps - 1) / bps;
}

int paged_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                        const void* table, const void* q_pos, void* out, void* part_acc,
                        void* part_ml, int B, int H, int S, int D, int NB, int bs, int MB,
                        float scale, void* stream) {
  return launch<float>(q, k_pool, v_pool, table, q_pos, out, part_acc, part_ml, B, H, S, D,
                       NB, bs, MB, scale, stream);
}

int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                         const void* table, const void* q_pos, void* out, void* part_acc,
                         void* part_ml, int B, int H, int S, int D, int NB, int bs, int MB,
                         float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, q_pos, out, part_acc, part_ml, B, H,
                               S, D, NB, bs, MB, scale, stream);
}

const char* dtf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
