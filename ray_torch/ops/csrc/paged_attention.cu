// Paged attention for the serving path: hand-written CUDA C++ for Hopper
// (sm_90a), built by ray_torch/ops/_build.py and bound with ctypes by
// ray_torch/ops/paged_attention.py.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_attn_kernel (Pallas TPU,
// launched by paged_attention() there), with the same semantics and layouts:
//   q [B, T, H, D]; k/v pools [Hkv, P, page, D]; page_tables [B, max_pages]
//   int32; base, limit [B] int32. Query (slot b, position t, head h) attends
//   the key columns col <= base[b] + t and col < limit[b] of the slot's paged
//   view, where column c lives in pool page page_tables[b][c / page] at offset
//   c % page. Output [B, T, H, D] in q's dtype (fp32 or bf16).
//
// Numerics are the gather path's, so greedy tokens match it: q.k accumulated
// in fp32, ROUNDED TO THE INPUT DTYPE, then scaled in fp32 (the reference's
// einsum(...).astype(f32) * sm_scale has no preferred_element_type); masked
// columns are -1e30; exact row max m, then l = sum exp(s - m), then
// p = exp(s - m) / l rounded to the input dtype; p.V accumulated in fp32 and
// rounded to the output dtype. A dense three-pass softmax, not an online
// (flash) one: rescaling would change the floats.
//
// Bound on an H100: memory. A launch has to read each slot's LIVE K/V once:
// 2 * live_tokens * Hkv * D * sizeof(T) bytes over all slots, against
// 3.35 TB/s. Its arithmetic (4 * n_rep * T * live * D flop per kv head) is
// ~2 flop/byte at decode, far under the ~295 flop/byte ridge of bf16. For
// example, B=32 slots with ~1,024 live tokens each, one layer:
// 32 * 8 * 1024 * 128 * 2 * 2 B = 134 MB, about 40 us.
//
// What the design does about that bound:
//  - one block per (slot, kv head, tile of query rows); the block reads its
//    slot's page ids itself (no scalar prefetch) and loops ONLY over live
//    columns, col < max over its rows of min(limit, base + t + 1). A masked
//    column contributes exactly 0 after the fp32 exp, so skipping it changes
//    no value, and a slot 100 tokens deep reads 100 keys, not its table span;
//  - the n_rep query heads of a kv head share the block (GQA rows are
//    kv-major, row = rep * T + t, as in the reference), so a K/V page is read
//    from device memory once per row tile, not once per query head;
//  - three kernels. bf16 decode and verify (at most 16 query rows a slot
//    and kv head) take paged_decode_hopper, which streams the live K and
//    then V pages through a ring of bf16 tiles in shared memory with bulk
//    copies (cp.async.bulk) on mbarriers, so copies stay in flight while
//    all 8 warps compute (its note below). bf16 launches of more rows (the
//    chunked prefill) at D = 64 or 128 with pages that tile a 64-key tile
//    take paged_chunk_hopper: TMA page loads into a ring of swizzled tiles
//    and wgmma for Q K^T and P V, the three passes recomputing S on the
//    tensor cores (its note below). fp32, other head dims and page sizes
//    take paged_attention_kernel: K/V tiles staged through shared memory
//    as fp32 by 16-byte vector loads, the tile's fp32 scores kept in
//    shared memory when rows * table_span * 4 B fits in the 227 KB (16
//    rows of a 2,048-token span take 128 KB) and recomputed in each pass
//    otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;      // key columns staged per shared-memory tile
constexpr int kMaxRows = 16;      // query rows per block
constexpr int kMaxHeadDim = 256;
constexpr int kAccPerThread = kMaxRows * kMaxHeadDim / kThreads;
constexpr float kMasked = -1e30f;
// 226 KB: the 227 KB opt-in of sm_90 less room for the static `span`
constexpr size_t kSmemLimit = 231424;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// an fp32 value rounded to T's precision (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T from global memory (16-byte aligned) into fp32 shared memory
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, float* dst) {
  constexpr int kN = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kN; ++i) dst[i] = to_float(v[i]);
}

template <typename T>
struct Args {
  const T* q;
  const T* k_pages;
  const T* v_pages;
  const int* page_tables;
  const int* base;
  const int* limit;
  T* out;
  int t_span, heads, n_rep, head_dim, num_pages, page_size, max_pages;
  int rows_per_block, score_ld;
  float sm_scale;
};

// Columns [c0, c0 + ncols) of slot b, kv head g, read through the page
// table into dst [ncols][ld] (fp32).
template <typename T>
__device__ void load_tile(const Args<T>& a, const T* __restrict__ pool, int b,
                          int g, int c0, int ncols, float* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = a.head_dim / kVec;
  const int* pt = a.page_tables + (size_t)b * a.max_pages;
  for (int i = threadIdx.x; i < ncols * vecs; i += kThreads) {
    const int cc = i / vecs;
    const int d = (i - cc * vecs) * kVec;
    const int c = c0 + cc;
    const int page = pt[c / a.page_size];
    const T* src = pool + ((((size_t)g * a.num_pages + page) * a.page_size
                            + c % a.page_size) * a.head_dim + d);
    load16(src, dst + cc * ld + d);
  }
}

// Masked, scaled scores of the block's rows against one staged K tile:
// s[r * score_ld + cc] for cc < ncols. Lanes of a warp take consecutive
// columns (the odd row stride ld keeps their shared-memory reads
// conflict-free) and share one query row (a broadcast read).
template <typename T>
__device__ void tile_scores(const Args<T>& a, const float* q_s,
                            const float* k_s, int ld, int rows, int c0,
                            int ncols, const int* valid_s, float* s) {
  for (int i = threadIdx.x; i < rows * kKeyTile; i += kThreads) {
    const int r = i / kKeyTile;
    const int cc = i - r * kKeyTile;
    if (cc >= ncols) continue;
    const float* qr = q_s + r * ld;
    const float* kr = k_s + cc * ld;
    float acc = 0.f;
    for (int d = 0; d < a.head_dim; ++d) acc = fmaf(qr[d], kr[d], acc);
    s[r * a.score_ld + cc] =
        (c0 + cc < valid_s[r]) ? round_to<T>(acc) * a.sm_scale : kMasked;
  }
}

// Grid (row tiles, Hkv, B). kStore: the fp32 scores of the whole live span
// stay in shared memory across the three passes; otherwise each pass
// recomputes its tile's scores from K.
template <typename T, bool kStore>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  __shared__ int span;
  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * a.rows_per_block;
  const int rows = min(a.rows_per_block, a.n_rep * a.t_span - r0);
  const int ld = a.head_dim + 1;
  const int max_len = a.max_pages * a.page_size;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* q_s = smem;                                // [rows_per_block][ld]
  float* kv_s = q_s + a.rows_per_block * ld;        // [kKeyTile][ld]
  float* s_buf = kv_s + kKeyTile * ld;              // [rows_per_block][score_ld]
  float* m_s = s_buf + a.rows_per_block * a.score_ld;
  float* l_s = m_s + a.rows_per_block;
  int* valid_s = reinterpret_cast<int*>(l_s + a.rows_per_block);

  if (threadIdx.x == 0) span = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int t = (r0 + r) % a.t_span;
    int valid = min(min(a.limit[b], a.base[b] + t + 1), max_len);
    int row_span = valid;
    if (valid <= 0) {
      // no live key: every column is -1e30 and the dense softmax is
      // uniform over the whole table span — computed, not special-cased
      valid = 0;
      row_span = max_len;
    }
    valid_s[r] = valid;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    atomicMax(&span, row_span);
  }
  {
    // query rows: row r -> (rep, t) = divmod(r0 + r, T), head g * n_rep + rep
    constexpr int kVec = 16 / sizeof(T);
    const int vecs = a.head_dim / kVec;
    for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
      const int r = i / vecs;
      const int d = (i - r * vecs) * kVec;
      const int rep = (r0 + r) / a.t_span;
      const int t = (r0 + r) % a.t_span;
      load16(a.q + ((((size_t)b * a.t_span + t) * a.heads + g * a.n_rep + rep)
                    * a.head_dim + d),
             q_s + r * ld + d);
    }
  }
  __syncthreads();
  const int hi = span;

  // pass 1: scores and the exact row max
  for (int c0 = 0; c0 < hi; c0 += kKeyTile) {
    const int ncols = min(kKeyTile, hi - c0);
    float* s = kStore ? s_buf + c0 : s_buf;
    load_tile(a, a.k_pages, b, g, c0, ncols, kv_s, ld);
    __syncthreads();
    tile_scores(a, q_s, kv_s, ld, rows, c0, ncols, valid_s, s);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float m = -INFINITY;
      for (int cc = lane; cc < ncols; cc += 32)
        m = fmaxf(m, s[r * a.score_ld + cc]);
      m = warp_max(m);
      if (lane == 0) m_s[r] = fmaxf(m_s[r], m);
    }
    __syncthreads();
  }

  // pass 2: l = sum exp(s - m)
  for (int c0 = 0; c0 < hi; c0 += kKeyTile) {
    const int ncols = min(kKeyTile, hi - c0);
    float* s = kStore ? s_buf + c0 : s_buf;
    if (!kStore) {
      load_tile(a, a.k_pages, b, g, c0, ncols, kv_s, ld);
      __syncthreads();
      tile_scores(a, q_s, kv_s, ld, rows, c0, ncols, valid_s, s);
      __syncthreads();
    }
    for (int r = warp; r < rows; r += kWarps) {
      const float m = m_s[r];
      float l = 0.f;
      for (int cc = lane; cc < ncols; cc += 32)
        l += expf(s[r * a.score_ld + cc] - m);
      l = warp_sum(l);
      if (lane == 0) l_s[r] += l;
    }
    if (!kStore) __syncthreads();
  }
  __syncthreads();

  // pass 3: p = exp(s - m) / l in the input dtype, accumulated against V
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;
  const int n_out = rows * a.head_dim;
  for (int c0 = 0; c0 < hi; c0 += kKeyTile) {
    const int ncols = min(kKeyTile, hi - c0);
    float* s = kStore ? s_buf + c0 : s_buf;
    if (!kStore) {
      load_tile(a, a.k_pages, b, g, c0, ncols, kv_s, ld);
      __syncthreads();
      tile_scores(a, q_s, kv_s, ld, rows, c0, ncols, valid_s, s);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < rows * kKeyTile; i += kThreads) {
      const int r = i / kKeyTile;
      const int cc = i - r * kKeyTile;
      if (cc < ncols) {
        float* p = s + r * a.score_ld + cc;
        *p = round_to<T>(expf(*p - m_s[r]) / l_s[r]);
      }
    }
    load_tile(a, a.v_pages, b, g, c0, ncols, kv_s, ld);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int o = threadIdx.x + j * kThreads;
      if (o < n_out) {
        const int r = o / a.head_dim;
        const int d = o - r * a.head_dim;
        const float* p = s + r * a.score_ld;
        float v = acc[j];
        for (int cc = 0; cc < ncols; ++cc) v = fmaf(p[cc], kv_s[cc * ld + d], v);
        acc[j] = v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < n_out) {
      const int r = o / a.head_dim;
      const int d = o - r * a.head_dim;
      const int rep = (r0 + r) / a.t_span;
      const int t = (r0 + r) % a.t_span;
      a.out[(((size_t)b * a.t_span + t) * a.heads + g * a.n_rep + rep)
                * a.head_dim + d] = from_float<T>(acc[j]);
    }
  }
}

template <typename T, bool kStore>
cudaError_t launch(const Args<T>& a, int batch, int kv_heads,
                   size_t smem_bytes, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, kStore>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int n_rows = a.n_rep * a.t_span;
  const dim3 grid((n_rows + a.rows_per_block - 1) / a.rows_per_block,
                  kv_heads, batch);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k_pages,
                         const void* v_pages, const int* page_tables,
                         const int* base, const int* limit, void* out,
                         int batch, int t_span, int heads, int kv_heads,
                         int head_dim, int num_pages, int page_size,
                         int max_pages, int rows_per_block, int store_scores,
                         float sm_scale, cudaStream_t stream) {
  const int max_len = max_pages * page_size;
  const int ld = head_dim + 1;
  const int score_ld = store_scores ? max_len : kKeyTile;
  // the same layout as the kernel's carve-up of smem (and as
  // ray_torch/ops/paged_attention.py::_smem_bytes, which plans the launch)
  const size_t smem =
      sizeof(float) * ((size_t)rows_per_block * ld + (size_t)kKeyTile * ld
                       + (size_t)rows_per_block * score_ld
                       + 2 * (size_t)rows_per_block)
      + sizeof(int) * (size_t)rows_per_block;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k_pages),
            static_cast<const T*>(v_pages), page_tables, base, limit,
            static_cast<T*>(out), t_span, heads, heads / kv_heads, head_dim,
            num_pages, page_size, max_pages, rows_per_block, score_ld,
            sm_scale};
  return store_scores ? launch<T, true>(a, batch, kv_heads, smem, stream)
                      : launch<T, false>(a, batch, kv_heads, smem, stream);
}

// ---------------------------------------------------------------------------
// bf16 decode and verify: paged_decode_hopper. A launch takes it when a
// (slot, kv head) has at most kDecodeMaxRows query rows (decode: n_rep;
// verify: n_rep (k + 1)), D is 64 or 128, and the rows' fp32 scores over
// the table span fit in shared memory (ray_torch/ops/paged_attention.py::
// decode_rows plans it); bf16 launches of more rows take the chunk route
// below, the rest paged_attention_kernel. The numerics are that kernel's,
// to the float, but for the order of the fp32 sums (q.k, l and p.V).
//
// Grid (Hkv, B); 8 consumer warps and one producer warp a block. Lane 0 of
// the producer streams the slot's live K columns, then its live V columns,
// through a ring of kDecodeStages bf16 tiles of kDecodeKeys keys: a page
// of one kv head is one contiguous run of the pool, so each page run of a
// tile is one cp.async.bulk, completed on the stage's full mbarrier; the
// consumers free a stage on its empty mbarrier. V's copies are issued as
// soon as K's stages free up, so the V pass starts on landed tiles.
//  pass 1: each warp takes 8 keys of a tile; kLanes lanes share a key and
//          split D, with the rows' q slices in registers. The rows' partial
//          dot products are reduce-scattered over those lanes (each lane
//          ends with one row's sum), rounded to bf16, scaled, masked, kept
//          in shared memory as fp32, and maxed into the exact row max;
//  pass 2: e = exp(s - m) in place, l = sum e, then p = round_bf16(e / l);
//  pass 3: each warp accumulates p V over its 8 keys of each V tile, the
//          lanes splitting D; the 8 warps' sums are added in a fixed order
//          through the drained ring.
// ---------------------------------------------------------------------------

constexpr int kDecodeWarps = 8;       // consumer warps
constexpr int kDecodeThreads = 32 * (kDecodeWarps + 1);
constexpr int kDecodeKeys = 64;       // keys of a ring tile, 8 a warp
constexpr int kDecodeStages = 4;      // ring tiles
constexpr int kDecodeMaxRows = 16;

using bf16 = __nv_bfloat16;

struct DecodeArgs {
  const bf16* q;
  const bf16* k_pages;
  const bf16* v_pages;
  const int* page_tables;
  const int* base;
  const int* limit;
  bf16* out;
  int t_span, heads, n_rep, num_pages, page_size, max_pages;
  float sm_scale;
};

// kN bf16 values (2 kN bytes, aligned to min(2 kN, 16)) as fp32
template <int kN>
__device__ __forceinline__ void load_bf16(const bf16* src, float (&dst)[kN]) {
  static_assert(kN == 2 || kN == 4 || kN % 8 == 0, "2, 4 or 8 n values");
  uint32_t w[kN / 2];
  if constexpr (kN % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + 8 * i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (kN == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Sum of v[0, kN) over the lanes of a group that differ in bits kO, kO / 2,
// ..., 1 of their lane index, reduce-scattered: while kN > 1 a step halves
// the rows (the lane with bit kO set keeps the upper half and adds its
// partner's share of it), then it adds over the lanes that hold the same
// row. A lane ends with the sum of row scatter_row(part) in v[0].
template <int kN, int kO, int kR>
__device__ __forceinline__ void reduce_scatter(float (&v)[kR], int part) {
  if constexpr (kN > 1) {
    constexpr int kH = kN / 2;
    const bool upper = (part & kO) != 0;
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const float send = upper ? v[i] : v[i + kH];
      const float keep = upper ? v[i + kH] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kO);
    }
    if constexpr (kO > 1) reduce_scatter<kH, kO / 2>(v, part);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], kO);
    if constexpr (kO > 1) reduce_scatter<1, kO / 2>(v, part);
  }
}

// the row whose sum reduce_scatter<kR, kL / 2> leaves in lane `part`
template <int kR, int kL>
__device__ __forceinline__ int scatter_row(int part) {
  int row = 0;
#pragma unroll
  for (int o = kL / 2, n = kR; n > 1; o /= 2, n /= 2)
    if (part & o) row += n / 2;
  return row;
}

__device__ __forceinline__ unsigned char* align_128(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 127) & ~uintptr_t(127));
}

template <int D, int kRows>
__global__ void __launch_bounds__(kDecodeThreads, kRows <= 4 ? 2 : 1)
    paged_decode_hopper(const DecodeArgs a) {
  // lanes sharing a key: q's slices take kRows * D / kLanes registers
  constexpr int kLanes = kRows <= 2 ? 8 : kRows <= 4 ? 16 : 32;
  constexpr int kE = D / kLanes;                // their slice of D
  constexpr int kStep = 32 / kLanes;            // keys a warp step
  constexpr int kWarpKeys = kDecodeKeys / kDecodeWarps;
  constexpr int kE3 = D / 32;                   // a lane's slice in pass 3
  // lane bits that name the row a lane holds after reduce_scatter
  constexpr int kRowBits = (kLanes - 1) & ~(kLanes / kRows - 1);
  static_assert(kRows <= kLanes && kE >= 2 && kE3 >= 2, "rows or D");

  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(align_128(smem_raw));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kDecodeStages * kDecodeKeys * D);
  uint64_t* empty = full + kDecodeStages;
  float* s_buf = reinterpret_cast<float*>(empty + kDecodeStages);
  const int g = blockIdx.x, b = blockIdx.y;
  const int n_rows = a.n_rep * a.t_span;
  const int max_len = a.max_pages * a.page_size;
  float* max_red = s_buf + (size_t)kRows * max_len;  // [warp][row]
  float* sum_red = max_red + kDecodeWarps * kRows;   // [warp][row]
  int* pt_s = reinterpret_cast<int*>(sum_red + kDecodeWarps * kRows);

  // live columns, as paged_attention_kernel bounds them: row (rep, t) sees
  // col < valid(t) = min(limit, base + t + 1, max_len), and the block reads
  // col < hi, the largest valid, or the whole table span when a row has no
  // live key (its dense softmax is then uniform over the span)
  const int bs = a.base[b], lm = a.limit[b];
  int hi = 0;
  for (int t = 0; t < a.t_span; ++t) {
    const int valid = min(min(lm, bs + t + 1), max_len);
    hi = max(hi, valid > 0 ? valid : max_len);
  }
  const int n = (hi + kDecodeKeys - 1) / kDecodeKeys;   // tiles a pass

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDecodeStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kDecodeWarps);
    }
    hopper::mbar_init_fence();
  }
  for (int i = threadIdx.x; i < a.max_pages; i += kDecodeThreads)
    pt_s[i] = a.page_tables[(size_t)b * a.max_pages + i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kDecodeWarps) {
    // the producer: K tiles 0..n-1, then V tiles 0..n-1, through the ring
    if (lane == 0) {
      for (int i = 0; i < 2 * n; ++i) {
        const int s = i % kDecodeStages;
        if (i >= kDecodeStages)
          hopper::mbar_wait(&empty[s], (i / kDecodeStages - 1) & 1);
        const bf16* pool = i < n ? a.k_pages : a.v_pages;
        const int c0 = (i < n ? i : i - n) * kDecodeKeys;
        const int c1 = min(c0 + kDecodeKeys, hi);
        hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)(c1 - c0) * D * 2);
        bf16* dst = ring + (size_t)s * kDecodeKeys * D;
        for (int c = c0; c < c1;) {
          const int off = c % a.page_size;
          const int run = min(a.page_size - off, c1 - c);
          const bf16* src =
              pool + (((size_t)g * a.num_pages + pt_s[c / a.page_size])
                          * a.page_size + off) * D;
          hopper::bulk_load(dst + (size_t)(c - c0) * D, src,
                            (uint32_t)run * D * 2, &full[s]);
          c += run;
        }
      }
    }
    return;
  }

  // pass 1: scores and the exact row max
  const int part = lane % kLanes, sub = lane / kLanes;
  const int my_row = scatter_row<kRows, kLanes>(part);
  const bool writer = (part & (kLanes / kRows - 1)) == 0 && my_row < n_rows;
  const int my_valid =
      max(min(min(lm, bs + my_row % a.t_span + 1), max_len), 0);
  float mx = -INFINITY;
  {
    float qr[kRows][kE];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < n_rows) {
        const int rep = r / a.t_span, t = r % a.t_span;
        load_bf16(a.q + (((size_t)b * a.t_span + t) * a.heads
                         + g * a.n_rep + rep) * D + part * kE, qr[r]);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) qr[r][e] = 0.f;
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % kDecodeStages;
      hopper::mbar_wait(&full[s], (i / kDecodeStages) & 1);
      const bf16* tile = ring + (size_t)s * kDecodeKeys * D;
      const int c0 = i * kDecodeKeys;
      const int ncols = min(kDecodeKeys, hi - c0);
#pragma unroll
      for (int j = 0; j < kWarpKeys; j += kStep) {
        const int cc = warp * kWarpKeys + j + sub;
        float kv[kE];
        if (cc < ncols) {
          load_bf16(tile + cc * D + part * kE, kv);
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e) kv[e] = 0.f;
        }
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[r] = fmaf(qr[r][e], kv[e], acc[r]);
        }
        reduce_scatter<kRows, kLanes / 2>(acc, part);
        if (writer && cc < ncols) {
          const int c = c0 + cc;
          const float x =
              c < my_valid
                  ? __bfloat162float(__float2bfloat16(acc[0])) * a.sm_scale
                  : kMasked;
          s_buf[(size_t)my_row * max_len + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
  }
  // the warp's max of each row, over the lanes that hold that row
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (!(o & kRowBits)) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (writer && sub == 0) max_red[warp * kRows + my_row] = mx;
  hopper::bar_sync<1, 32 * kDecodeWarps>();

  // pass 2: e = exp(s - m) in place and l = sum e; then p = round(e / l)
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= n_rows) break;
    float m = max_red[r];
    for (int w = 1; w < kDecodeWarps; ++w)
      m = fmaxf(m, max_red[w * kRows + r]);
    float l = 0.f;
    float* row = s_buf + (size_t)r * max_len;
    for (int c = tid; c < hi; c += 32 * kDecodeWarps) {
      const float e = expf(row[c] - m);
      row[c] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) sum_red[warp * kRows + r] = l;
  }
  hopper::bar_sync<1, 32 * kDecodeWarps>();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= n_rows) break;
    float l = 0.f;
    for (int w = 0; w < kDecodeWarps; ++w) l += sum_red[w * kRows + r];
    float* row = s_buf + (size_t)r * max_len;
    for (int c = tid; c < hi; c += 32 * kDecodeWarps)
      row[c] = __bfloat162float(__float2bfloat16(row[c] / l));
  }
  hopper::bar_sync<1, 32 * kDecodeWarps>();

  // pass 3: p V, each warp over its keys of every V tile
  float acc[kRows][kE3];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < kE3; ++e) acc[r][e] = 0.f;
  for (int i = n; i < 2 * n; ++i) {
    const int s = i % kDecodeStages;
    hopper::mbar_wait(&full[s], (i / kDecodeStages) & 1);
    const bf16* tile = ring + (size_t)s * kDecodeKeys * D;
    const int c0 = (i - n) * kDecodeKeys;
    const int c_end = min(warp * kWarpKeys + kWarpKeys, hi - c0);
    for (int cc = warp * kWarpKeys; cc < c_end; ++cc) {
      float v[kE3];
      load_bf16(tile + cc * D + lane * kE3, v);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < n_rows) {
          const float p = s_buf[(size_t)r * max_len + c0 + cc];
#pragma unroll
          for (int e = 0; e < kE3; ++e) acc[r][e] = fmaf(p, v[e], acc[r][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // the warps' sums through the drained ring, added in warp order
  float* part_s = reinterpret_cast<float*>(ring);   // [warp][row][D]
  hopper::bar_sync<1, 32 * kDecodeWarps>();
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < n_rows)
#pragma unroll
      for (int e = 0; e < kE3; ++e)
        part_s[(warp * kRows + r) * D + lane * kE3 + e] = acc[r][e];
  hopper::bar_sync<1, 32 * kDecodeWarps>();
  for (int o = tid; o < n_rows * D; o += 32 * kDecodeWarps) {
    const int r = o / D, d = o - r * D;
    float sum = 0.f;
    for (int w = 0; w < kDecodeWarps; ++w)
      sum += part_s[(w * kRows + r) * D + d];
    const int rep = r / a.t_span, t = r % a.t_span;
    a.out[(((size_t)b * a.t_span + t) * a.heads + g * a.n_rep + rep) * D + d] =
        __float2bfloat16(sum);
  }
}

// dynamic shared memory of a decode-route block (its carve-up above; the
// same as ray_torch/ops/paged_attention.py::_decode_smem_bytes)
size_t decode_smem(int rows, int head_dim, int max_len, int max_pages) {
  return 128 + (size_t)2 * kDecodeStages * kDecodeKeys * head_dim
         + 16 * kDecodeStages
         + 4 * ((size_t)rows * max_len + 2 * kDecodeWarps * rows + max_pages);
}

template <int D, int kRows>
cudaError_t launch_decode(const DecodeArgs& a, int batch, int kv_heads,
                          size_t smem, cudaStream_t stream) {
  auto kernel = paged_decode_hopper<D, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kv_heads, batch), kDecodeThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_decode_rows(const DecodeArgs& a, int rows, int batch,
                               int kv_heads, size_t smem,
                               cudaStream_t stream) {
  switch (rows) {
    case 2: return launch_decode<D, 2>(a, batch, kv_heads, smem, stream);
    case 4: return launch_decode<D, 4>(a, batch, kv_heads, smem, stream);
    case 8: return launch_decode<D, 8>(a, batch, kv_heads, smem, stream);
    case 16: return launch_decode<D, 16>(a, batch, kv_heads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 chunked prefill: paged_chunk_hopper. A launch takes it when a (slot,
// kv head) has more than kDecodeMaxRows query rows, D is 64 or 128, and a
// page is a multiple of 8 keys that divides kChunkKeys or a multiple of it
// (ray_torch/ops/paged_attention.py::chunk_plan plans it). The numerics are
// paged_attention_kernel's, to the float, but for the order of the fp32
// sums (q.k and p.V inside wgmma, l and O over the two consumers).
//
// Bound: operations. A 512-token chunk at llama3_1b (n_rep 2, D 128) does
// 4 D flop per (row, live key) on 3.7 MB of K/V, ~700 flop/byte, above
// the bf16 ridge. So the products run on the tensor cores (wgmma), and the
// exact three-pass softmax recomputes S = Q K^T in each pass rather than
// keeping fp32 scores (the identity contract forbids an online rescale).
// What bounds the kernel in practice is each tile's chain of wgmma waits
// and per-score softmax work (IEEE expf and division), so a block's key
// tiles are split over two consumer warpgroups.
//
// Grid (units, Hkv, B). A unit is kChunkRows query rows of one rep at
// consecutive positions (u = position tile * n_rep + rep). Warpgroup 0 is
// the producer (one thread issues every TMA load; setmaxnreg gives its
// registers away); consumer warpgroup c takes the unit's key tiles kt = c,
// c + 2, ... through a ring of its own. The producer loads the unit's Q
// tile once (a 4-d map over q [B, T, H, D]; positions past T read as zeros
// and are never written), then streams the block's live span [0, hi)
// three times as 64-key tiles: K for pass 1, K for pass 2, then K and V
// for pass 3. A tile is 64 / page boxes (page <= 64) or one box (page >=
// 64) of a 4-d map over the pool [Hkv, P, page, D] at (d, key in page,
// page_tables[b][c / page], g), landing in the 128-byte swizzled layout:
// desc_kmajor reads it as K for S = Q K^T, desc_mnmajor as V for O += P V,
// so V needs no transpose copy.
//  pass 1: S by wgmma, q.k rounded to bf16, scaled, masked (-1e30 past a
//          row's valid length; -inf, i.e. no column at all, past hi), and
//          maxed; the two consumers' maxes give the exact row max m;
//  pass 2: the same S (same tiles, same instructions: bit-identical), and
//          l = sum expf(s - m), the two consumers' sums added in order;
//  pass 3: the same S, p = bf16(expf(s - m) / l) packed into wgmma's A
//          fragments in registers (acc_to_a), O += P V by wgmma; consumer
//          1's O is added to consumer 0's through its drained ring.
// A row's 64 columns of a tile sit in one quad of lanes (the m64 layout),
// so the row max and sum are quad shuffles. No atomics: each block owns
// its output rows and adds in a fixed order, so reruns are bit-identical.
// ---------------------------------------------------------------------------

constexpr int kChunkConsumers = 2;    // consumer warpgroups, each every
                                      // other key tile of the block's unit
constexpr int kChunkThreads = 128 * (1 + kChunkConsumers);
constexpr int kChunkRows = 64;        // query rows of a unit (a block)
constexpr int kChunkKeys = 64;        // keys of a ring tile
constexpr int kChunkStages = 4;       // ring tiles of each consumer
constexpr int kChunkProducerRegs = 40;   // 128 x 40 + 256 x 232 <= 65,536
constexpr int kChunkConsumerRegs = 232;

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct ChunkArgs {
  const int* page_tables;
  const int* base;
  const int* limit;
  bf16* out;
  int t_span, heads, n_rep, page_size, max_pages;
  float sm_scale;
};

// The masked, scaled scores of the unit's 64 rows against one K tile of
// columns [c0, c0 + 64): the m64n64 accumulator layout, the thread's rows
// 16 w + g and 16 w + g + 8 with valid lengths valid[0] and valid[1].
// `mask` false: every column is below every row's valid length.
template <int D>
__device__ __forceinline__ void chunk_scores(float (&sc)[kChunkKeys / 2],
                                             uint32_t q_tile, uint32_t k_tile,
                                             int c0, bool mask, int hi,
                                             const int (&valid)[2], int t4,
                                             float sm_scale) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::Wgmma<kChunkKeys>::ss<0, 0>(
        sc, hopper::desc_kmajor<D, kChunkRows>(q_tile, 0, kk),
        hopper::desc_kmajor<D, kChunkKeys>(k_tile, 0, kk), kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
#pragma unroll
  for (int i = 0; i < kChunkKeys / 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = c0 + 8 * i + 2 * t4 + (r & 1);
      const float x =
          __bfloat162float(__float2bfloat16(sc[4 * i + r])) * sm_scale;
      sc[4 * i + r] = !mask ? x
                      : col >= hi ? -INFINITY
                      : col < valid[r >> 1] ? x : kMasked;
    }
}

template <int D>
__global__ void __launch_bounds__(kChunkThreads, 1)
    paged_chunk_hopper(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const ChunkArgs a) {
  using Tl = hopper::Tile<D>;
  constexpr int kQBytes = 2 * kChunkRows * D;
  constexpr int kTileBytes = 2 * kChunkKeys * D;
  constexpr int kRing = kChunkStages * kTileBytes;      // a consumer's ring
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1024(smem_raw);
  unsigned char* ring = q_s + kQBytes;                  // [consumers] rings
  float* red_m = reinterpret_cast<float*>(ring + kChunkConsumers * kRing);
  float* red_l = red_m + kChunkConsumers * kChunkRows;  // [consumer][row]
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(red_l + kChunkConsumers * kChunkRows);
  uint64_t* full = q_full + 1;                          // [consumer][stage]
  uint64_t* empty = full + kChunkConsumers * kChunkStages;
  int* pt_s = reinterpret_cast<int*>(empty + kChunkConsumers * kChunkStages);

  const int u = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int t_first = u / a.n_rep * kChunkRows;
  const int head = g * a.n_rep + u % a.n_rep;
  const int max_len = a.max_pages * a.page_size;
  const int bs = a.base[b], lm = a.limit[b];
  // live columns, as paged_attention_kernel bounds them: row t sees col <
  // valid(t) = min(limit, base + t + 1, max_len), which grows with t; the
  // block reads col < hi, the valid of its last row, or the whole table
  // span when a row has no live key (its dense softmax is then uniform)
  const int first = min(min(lm, bs + t_first + 1), max_len);
  const int t_last = min(t_first + kChunkRows, a.t_span) - 1;
  const int hi = first <= 0 ? max_len : min(min(lm, bs + t_last + 1), max_len);
  const int n = (hi + kChunkKeys - 1) / kChunkKeys;     // tiles a pass

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kChunkConsumers * kChunkStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);                  // the consumer's warps
    }
    hopper::mbar_init_fence();
  }
  for (int i = threadIdx.x; i < a.max_pages; i += kChunkThreads)
    pt_s[i] = a.page_tables[(size_t)b * a.max_pages + i];
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::regs_dec<kChunkProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, kQBytes);
      for (int cb = 0; cb < Tl::kBoxes; ++cb)
        hopper::tma_load_4d(q_s + cb * kChunkRows * Tl::kRowBytes, &q_map,
                            q_full, cb * Tl::kBoxCols, head, t_first, b);
      // K tiles 0..n-1 for pass 1 and for pass 2, then K, V, K, V, ...
      // for pass 3; tile kt goes to consumer kt % 2's ring, where it is
      // item j of that consumer's sequence
      const int box_keys = min(kChunkKeys, a.page_size);
      for (int pass = 0; pass < 3; ++pass)
        for (int kt = 0; kt < n; ++kt)
          for (int v = 0; v < (pass == 2 ? 2 : 1); ++v) {
            const int c = kt % kChunkConsumers;
            const int tiles = (n - c + kChunkConsumers - 1) / kChunkConsumers;
            const int k = kt / kChunkConsumers;
            const int j = pass < 2 ? pass * tiles + k : 2 * tiles + 2 * k + v;
            const int s = c * kChunkStages + j % kChunkStages;
            if (j >= kChunkStages)
              hopper::mbar_wait(&empty[s], (j / kChunkStages - 1) & 1);
            hopper::mbar_arrive_expect_tx(&full[s], kTileBytes);
            unsigned char* dst = ring + s * kTileBytes;
            for (int jk = 0; jk < kChunkKeys; jk += box_keys) {
              // columns past the table span (a span that ends mid-tile)
              // read a page of the table; they are no column of any row
              const int col = kt * kChunkKeys + jk;
              const int page = pt_s[min(col / a.page_size, a.max_pages - 1)];
              for (int cb = 0; cb < Tl::kBoxes; ++cb)
                hopper::tma_load_4d(
                    dst + (cb * kChunkKeys + jk) * Tl::kRowBytes,
                    v ? &v_map : &k_map, &full[s], cb * Tl::kBoxCols,
                    col % a.page_size, page, g);
            }
          }
    }
    return;
  }

  hopper::regs_inc<kChunkConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
  const int row = 16 * warp + gq;                       // rows row, row + 8
  int valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)   // no live key: every column is -1e30
    valid[r] = max(min(min(lm, bs + t_first + row + 8 * r + 1), max_len), 0);
  uint64_t* my_full = full + c * kChunkStages;
  uint64_t* my_empty = empty + c * kChunkStages;
  unsigned char* my_ring = ring + c * kRing;
  hopper::mbar_wait(q_full, 0);

  float sc[kChunkKeys / 2];
  int j = 0;                    // the consumer's ring items so far
  // pass 1: the exact row max
  float m[2] = {-INFINITY, -INFINITY};
  for (int kt = c; kt < n; kt += kChunkConsumers, ++j) {
    const int s = j % kChunkStages;
    hopper::mbar_wait(&my_full[s], (j / kChunkStages) & 1);
    const int c0 = kt * kChunkKeys;
    chunk_scores<D>(sc, hopper::opaque_addr(q_s),
                    hopper::smem_addr(my_ring + s * kTileBytes), c0,
                    c0 + kChunkKeys > first, hi, valid, t4, a.sm_scale);
    if (lane == 0) hopper::mbar_arrive(&my_empty[s]);
#pragma unroll
    for (int e = 0; e < kChunkKeys / 2; ++e)
      m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], sc[e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = quad_max(m[r]);
    if (t4 == 0) red_m[c * kChunkRows + row + 8 * r] = m[r];
  }
  hopper::bar_sync<1, 128 * kChunkConsumers>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = red_m[row + 8 * r];
    for (int cc = 1; cc < kChunkConsumers; ++cc)
      m[r] = fmaxf(m[r], red_m[cc * kChunkRows + row + 8 * r]);
  }

  // pass 2: l = sum exp(s - m)
  float l[2] = {0.f, 0.f};
  for (int kt = c; kt < n; kt += kChunkConsumers, ++j) {
    const int s = j % kChunkStages;
    hopper::mbar_wait(&my_full[s], (j / kChunkStages) & 1);
    const int c0 = kt * kChunkKeys;
    chunk_scores<D>(sc, hopper::opaque_addr(q_s),
                    hopper::smem_addr(my_ring + s * kTileBytes), c0,
                    c0 + kChunkKeys > first, hi, valid, t4, a.sm_scale);
    if (lane == 0) hopper::mbar_arrive(&my_empty[s]);
#pragma unroll
    for (int e = 0; e < kChunkKeys / 2; ++e)
      l[(e >> 1) & 1] += expf(sc[e] - m[(e >> 1) & 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (t4 == 0) red_l[c * kChunkRows + row + 8 * r] = l[r];
  }
  hopper::bar_sync<1, 128 * kChunkConsumers>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = red_l[row + 8 * r];
    for (int cc = 1; cc < kChunkConsumers; ++cc)
      l[r] += red_l[cc * kChunkRows + row + 8 * r];
  }

  // pass 3: p = bf16(exp(s - m) / l) as A fragments, O += P V
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  for (int kt = c; kt < n; kt += kChunkConsumers, j += 2) {
    const int s = j % kChunkStages;
    hopper::mbar_wait(&my_full[s], (j / kChunkStages) & 1);
    const int c0 = kt * kChunkKeys;
    chunk_scores<D>(sc, hopper::opaque_addr(q_s),
                    hopper::smem_addr(my_ring + s * kTileBytes), c0,
                    c0 + kChunkKeys > first, hi, valid, t4, a.sm_scale);
    if (lane == 0) hopper::mbar_arrive(&my_empty[s]);
#pragma unroll
    for (int e = 0; e < kChunkKeys / 2; ++e)
      sc[e] = expf(sc[e] - m[(e >> 1) & 1]) / l[(e >> 1) & 1];
    uint32_t pa[kChunkKeys / 16][4];
#pragma unroll
    for (int jj = 0; jj < kChunkKeys / 16; ++jj)
      hopper::acc_to_a(sc, jj, pa[jj]);
    const int sv = (j + 1) % kChunkStages;
    hopper::mbar_wait(&my_full[sv], ((j + 1) / kChunkStages) & 1);
    const uint32_t v_tile = hopper::smem_addr(my_ring + sv * kTileBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kChunkKeys / 16; ++jj)
      hopper::Wgmma<D>::template rs<1>(
          o, pa[jj], hopper::desc_mnmajor<D, kChunkKeys>(v_tile, jj), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (lane == 0) hopper::mbar_arrive(&my_empty[sv]);
  }

  // O = O_0 + O_1: consumer 1's partial sums through its drained ring
  // ([element][thread], so a warp's stores and loads are conflict-free)
  float* part = reinterpret_cast<float*>(ring + kRing);
  if (c == 1) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) part[e * 128 + tid] = o[e];
  }
  hopper::bar_sync<1, 128 * kChunkConsumers>();
  if (c != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t_first + row + 8 * r;
    if (t >= a.t_span) continue;
    bf16* dst = a.out + (((size_t)b * a.t_span + t) * a.heads + head) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int e = 4 * jj + 2 * r;
      *reinterpret_cast<uint32_t*>(dst + 8 * jj + 2 * t4) =
          hopper::pack_bf16(o[e] + part[e * 128 + tid],
                            o[e + 1] + part[(e + 1) * 128 + tid]);
    }
  }
}

// dynamic shared memory of a chunk-route block (its carve-up above; the
// same as ray_torch/ops/paged_attention.py::_chunk_smem_bytes)
size_t chunk_smem(int head_dim, int max_pages) {
  return 1024
         + (size_t)2 * (kChunkRows
                        + kChunkConsumers * kChunkStages * kChunkKeys)
               * head_dim
         + 4 * 2 * kChunkConsumers * kChunkRows
         + 8 * (1 + 2 * kChunkConsumers * kChunkStages)
         + 4 * (size_t)max_pages;
}

// Tensor map of a [Hkv, P, page, D] bf16 pool: dims {D, page, P, Hkv}, box
// {W / 2, min(64, page), 1, 1} (one column box of a page's run of keys),
// the W-byte swizzle. False if the encoding is refused.
template <int D>
bool encode_pool(CUtensorMap* map, const void* pool, int kv_heads,
                 int num_pages, int page_size) {
  using T = hopper::Tile<D>;
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)page_size,
                              (cuuint64_t)num_pages, (cuuint64_t)kv_heads};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * page_size,
                                 2ull * D * page_size * num_pages};
  const int box_keys = page_size < kChunkKeys ? page_size : kChunkKeys;
  const cuuint32_t box[4] = {(cuuint32_t)T::kBoxCols, (cuuint32_t)box_keys,
                             1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(pool), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_chunk(const void* q, const void* k_pages,
                         const void* v_pages, const ChunkArgs& a, int batch,
                         int kv_heads, int num_pages, size_t smem,
                         cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!hopper::encode_bthd<D>(&q_map, q, batch, a.t_span, a.heads,
                              kChunkRows)
      || !encode_pool<D>(&k_map, k_pages, kv_heads, num_pages, a.page_size)
      || !encode_pool<D>(&v_map, v_pages, kv_heads, num_pages, a.page_size))
    return cudaErrorInvalidValue;
  auto kernel = paged_chunk_hopper<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_rep = a.heads / kv_heads;
  const dim3 grid(n_rep * ((a.t_span + kChunkRows - 1) / kChunkRows),
                  kv_heads, batch);
  kernel<<<grid, kChunkThreads, smem, stream>>>(q_map, k_map, v_map, a);
  return cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Pointers are device pointers from Tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream. Returns the
// cudaError_t of the launch (0 = launched); the caller raises on non-zero.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* base, const void* limit, void* out,
    int batch, int t_span, int heads, int kv_heads, int head_dim,
    int num_pages, int page_size, int max_pages, int rows_per_block,
    int store_scores, float sm_scale, int is_bf16, void* stream) {
  if (batch < 1 || t_span < 1 || kv_heads < 1 || heads % kv_heads != 0
      || head_dim % 8 != 0 || head_dim < 8 || head_dim > kMaxHeadDim
      || rows_per_block < 1 || rows_per_block > kMaxRows || batch > 65535
      || kv_heads > 65535 || page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* bs = static_cast<const int*>(base);
  const int* lm = static_cast<const int*>(limit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_typed<__nv_bfloat16>(
        q, k_pages, v_pages, pt, bs, lm, out, batch, t_span, heads, kv_heads,
        head_dim, num_pages, page_size, max_pages, rows_per_block,
        store_scores, sm_scale, st);
  return (int)launch_typed<float>(
      q, k_pages, v_pages, pt, bs, lm, out, batch, t_span, heads, kv_heads,
      head_dim, num_pages, page_size, max_pages, rows_per_block, store_scores,
      sm_scale, st);
}

// The bf16 chunk route (paged_chunk_hopper): the same arguments as the
// decode route's but for `rows`; the block shape is fixed (kChunk*).
extern "C" int paged_chunk_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* base, const void* limit, void* out,
    int batch, int t_span, int heads, int kv_heads, int head_dim,
    int num_pages, int page_size, int max_pages, float sm_scale,
    void* stream) {
  if (batch < 1 || batch > 65535 || t_span < 1 || kv_heads < 1
      || kv_heads > 65535 || heads % kv_heads != 0 || page_size < 8
      || page_size % 8 != 0
      || (kChunkKeys % page_size != 0 && page_size % kChunkKeys != 0)
      || max_pages < 1 || num_pages < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = chunk_smem(head_dim, max_pages);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int n_rep = heads / kv_heads;
  const ChunkArgs a{static_cast<const int*>(page_tables),
                    static_cast<const int*>(base),
                    static_cast<const int*>(limit), static_cast<bf16*>(out),
                    t_span, heads, n_rep, page_size, max_pages, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return (int)launch_chunk<64>(q, k_pages, v_pages, a, batch, kv_heads,
                                   num_pages, smem, st);
    case 128:
      return (int)launch_chunk<128>(q, k_pages, v_pages, a, batch, kv_heads,
                                    num_pages, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 decode route (paged_decode_hopper): the same arguments but for
// `rows`, the block's query rows (2, 4, 8 or 16, at least n_rep * t_span),
// in place of the general kernel's launch plan.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* base, const void* limit, void* out,
    int batch, int t_span, int heads, int kv_heads, int head_dim,
    int num_pages, int page_size, int max_pages, int rows, float sm_scale,
    void* stream) {
  if (batch < 1 || batch > 65535 || t_span < 1 || kv_heads < 1
      || heads % kv_heads != 0 || heads / kv_heads * t_span > rows
      || rows > kDecodeMaxRows || page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      decode_smem(rows, head_dim, max_pages * page_size, max_pages);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const DecodeArgs a{static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k_pages),
                     static_cast<const bf16*>(v_pages),
                     static_cast<const int*>(page_tables),
                     static_cast<const int*>(base),
                     static_cast<const int*>(limit), static_cast<bf16*>(out),
                     t_span, heads, heads / kv_heads, num_pages, page_size,
                     max_pages, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return (int)launch_decode_rows<64>(a, rows, batch, kv_heads, smem, st);
    case 128:
      return (int)launch_decode_rows<128>(a, rows, batch, kv_heads, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
