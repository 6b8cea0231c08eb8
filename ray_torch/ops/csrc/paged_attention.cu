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
//  - K/V tiles are staged through shared memory with 16-byte vector loads;
//    the tile's fp32 scores stay in shared memory when
//    rows * table_span * 4 B fits in the 227 KB (16 rows of a 2,048-token
//    span take 128 KB) and are recomputed in each pass otherwise.
// Tensor cores (wgmma), TMA and a software pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
