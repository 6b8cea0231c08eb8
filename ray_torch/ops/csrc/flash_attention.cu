// Flash attention for the training path: three hand-written CUDA C++
// kernels for Hopper (sm_90a), built by ray_torch/ops/_build.py and bound
// with ctypes by ray_torch/ops/attention.py.
//
// What each replaces (Pallas TPU kernels of ray_tpu/ops/attention.py):
//   flash_fwd_kernel       <- _flash_kernel (:26, launched by _flash_bh)
//   flash_bwd_dkdv_kernel  <- _flash_bwd_dkdv_kernel (:120, _flash_bwd_bh)
//   flash_bwd_dq_kernel    <- _flash_bwd_dq_kernel (:172, _flash_bwd_bh)
// Layouts: q, k, v, out, dout, dq, dk, dv are [B, T, H, D] (heads already
// GQA-expanded), lse and delta [B, H, T] fp32. The causal mask keeps key
// col <= query row; masked scores are -1e30, as in the reference.
//
// Numerics are the Pallas kernels': s = q.k in fp32 from exact products of
// the input dtype, times sm_scale; an online softmax with fp32 running max,
// sum and accumulator; p rounded to the input dtype before p.V; LSE =
// m + log(l) with l > 0 guarded; in the backward p = exp(s - lse),
// ds = p * (dO.V^T - delta) * scale rounded to the input dtype before ds.K
// and ds^T.Q; every output cast once at the end. In bf16 every product runs
// on the tensor cores as mma.sync.m16n8k16 (bf16 inputs, fp32 accumulate),
// which computes exactly these roundings; the fp32 instantiation does the
// same products as FMAs on the same fragment layout (TF32 would round the
// inputs).
//
// Bound on an H100 at the training shapes (B=4, H=16, T=2048, D=128,
// causal, bf16): operations. The forward does 4 * D flop per causal
// (query, key) pair, 68.75 GFLOP, 0.0695 ms at 989 TFLOP/s, against
// 135 MB of q, k, v, out and lse (0.040 ms at 3.35 TB/s). The backward pair
// does 5 products, 171.9 GFLOP (0.174 ms), against 236 MB (0.070 ms).
//
// What the design does about that bound:
//  - every product is a tensor-core mma on 16-row warp tiles (4 warps, 64
//    rows a block), fed from shared memory; the fp32 score tile, the running
//    statistics and the output accumulators stay in registers;
//  - Hopper blocks run in no order, so nothing carries across blocks as the
//    TPU grid carried VMEM scratch: each block loops over the other axis
//    itself. Forward: one block per (b*h, 64-row query tile) over the key
//    tiles up to the diagonal. dk/dv: one block per (b*h, 64-row key tile)
//    over the query tiles from the diagonal on. dq: one block per (b*h,
//    64-row query tile) over the key tiles up to the diagonal. Fully masked
//    tiles are skipped, so causal work is T(T+1)/2 pairs, not T^2;
//  - the reference's two-kernel backward is kept: no atomics, so gradients
//    are deterministic run to run;
//  - causal query tiles run heaviest first, so the long tiles do not finish
//    last.
// Not yet: wgmma, TMA, a software pipeline between tile loads and mma,
// ldmatrix for the transposed operands. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // rows of a block's own tile, 16 a warp
constexpr int kKeys = 64;            // key tile of the forward and dq loops
constexpr int kBwdQueries = 32;      // query tile of the dk/dv loop
constexpr float kMasked = -1e30f;

// shared-memory row padding, 16 bytes: keeps rows 16-byte aligned for the
// vector loads and spreads a warp's fragment reads over the 32 banks
template <typename T>
struct Pad { static constexpr int value = 16 / sizeof(T); };

// two consecutive elements from fp32 values (one 4- or 8-byte store); bf16
// rounds to nearest even, as XLA's convert
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [row0, row0 + nrows) of one head's [T, D] slice (row stride
// `stride` elements) into shared memory dst[nrows][ld]; rows >= t_len are
// zero (a zero key or query row contributes nothing that is kept).
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int stride, int row0, int nrows,
                                          int t_len, T* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = D / kVec;
  for (int i = threadIdx.x; i < nrows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_len)
      val = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * stride + c));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// n fp32 statistics from one head's [T] row of lse / delta, zero past t_len
__device__ __forceinline__ void load_stats(const float* __restrict__ src,
                                           int row0, int n, int t_len,
                                           float* dst) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = (row0 + i < t_len) ? src[row0 + i] : 0.f;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's product over its 16 rows: c(r, n) += sum_k A(r, k) B(k, n),
// n < 8 * NT, k < K, from shared memory. A(r, k) = A[r * lda + k];
// B(k, n) = kTransB ? B[n * ldb + k] : B[k * ldb + n].
// c is the m16n8 accumulator fragment of each 8-column tile nt: lane
// (g = lane / 4, t = lane % 4) holds c[nt][0..1] at row g, columns
// nt * 8 + 2t + {0, 1}, and c[nt][2..3] at row g + 8 (see frag_row/frag_col).
template <int NT, int K, bool kTransB>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const bf16* A,
                                        int lda, const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    a[0] = ld32(A + g * lda + k0 + 2 * t);
    a[1] = ld32(A + (g + 8) * lda + k0 + 2 * t);
    a[2] = ld32(A + g * lda + k0 + 2 * t + 8);
    a[3] = ld32(A + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t b[2];
      if (kTransB) {
        b[0] = ld32(B + n * ldb + k0 + 2 * t);
        b[1] = ld32(B + n * ldb + k0 + 2 * t + 8);
      } else {
        b[0] = pack(B[(k0 + 2 * t) * ldb + n], B[(k0 + 2 * t + 1) * ldb + n]);
        b[1] = pack(B[(k0 + 2 * t + 8) * ldb + n],
                    B[(k0 + 2 * t + 9) * ldb + n]);
      }
      mma_bf16(c[nt], a, b);
    }
  }
}

// The same product in fp32 FMAs, on the same fragment ownership.
template <int NT, int K, bool kTransB>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const float* A,
                                        int lda, const float* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k];
    const float a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      const float b0 = kTransB ? B[n * ldb + k] : B[k * ldb + n];
      const float b1 = kTransB ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
      c[nt][0] = fmaf(a0, b0, c[nt][0]);
      c[nt][1] = fmaf(a0, b1, c[nt][1]);
      c[nt][2] = fmaf(a1, b0, c[nt][2]);
      c[nt][3] = fmaf(a1, b1, c[nt][3]);
    }
  }
}

// row and column, within the warp's 16 x (8 NT) tile, of fragment element i
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int nt, int i) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// reduce over the 4 lanes that share a fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
}

// A warp's 16 x (8 NT) fragment, rounded to T, into shared memory dst[16][ld]
template <typename T, int NT>
__device__ __forceinline__ void store_frag(const float (&c)[NT][4], T* dst,
                                           int ld) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      store_pair(dst + frag_row(i) * ld + frag_col(nt, i), c[nt][i],
                 c[nt][i + 1]);
}

// A warp's 16 x D fp32 accumulator into rows [row0, row0 + 16) of one
// head's [T, D] slice in global memory, rows >= t_len dropped.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(const float (&c)[NT][4], T* dst,
                                           int stride, int row0, int t_len) {
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const int row = row0 + frag_row(i);
    if (row >= t_len) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      store_pair(dst + (size_t)row * stride + frag_col(nt, i), c[nt][i],
                 c[nt][i + 1]);
  }
}

struct Geometry {
  int t_len, heads, causal;
  float sm_scale;
};

// Forward. Grid (query tiles, B * H); 4 warps, each owning 16 query rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const Geometry geo) {
  constexpr int LD = D + Pad<T>::value;
  constexpr int LDP = kKeys + Pad<T>::value;
  constexpr int NS = kKeys / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [kRows][LD]
  T* k_s = q_s + kRows * LD;                  // [kKeys][LD]
  T* v_s = k_s + kKeys * LD;                  // [kKeys][LD]
  T* p_s = v_s + kKeys * LD;                  // [kRows][LDP]

  const int t_len = geo.t_len;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int stride = geo.heads * D;
  const size_t head = ((size_t)(bh / geo.heads) * t_len * geo.heads
                       + bh % geo.heads) * D;
  const int q0 = qt * kRows;
  const int warp = threadIdx.x >> 5;
  const int wrow0 = q0 + warp * 16;           // the warp's first query row
  const T* q_w = q_s + warp * 16 * LD;
  T* p_w = p_s + warp * 16 * LDP;

  load_rows<T, D>(q + head, stride, q0, kRows, t_len, q_s, LD);
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero(acc);
  const int n_k = (t_len + kKeys - 1) / kKeys;
  const int k_end = geo.causal ? min(n_k, (q0 + kRows - 1) / kKeys + 1) : n_k;

  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_rows<T, D>(k + head, stride, k0, kKeys, t_len, k_s, LD);
    load_rows<T, D>(v + head, stride, k0, kKeys, t_len, v_s, LD);
    __syncthreads();

    float s[NS][4];
    zero(s);
    warp_mm<NS, D, true>(s, q_w, LD, k_s, LD);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wrow0 + frag_row(i);
        const int col = k0 + frag_col(nt, i);
        float x = s[nt][i] * geo.sm_scale;
        if (col >= t_len || (geo.causal && col > row)) x = kMasked;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] - mx[i >> 1]);
        s[nt][i] = p;
        rsum[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(rsum[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha[i >> 1];
    store_frag(s, p_w, LDP);  // p in the input dtype
    __syncwarp();
    warp_mm<NO, kKeys, false>(acc, p_w, LDP, v_s, LD);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = acc[nt][i] / l[i >> 1];
  store_rows(acc, out + head, stride, wrow0, t_len);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow0 + frag_row(2 * r);
      if (row < t_len) lse[(size_t)bh * t_len + row] = m[r] + logf(l[r]);
    }
  }
}

// dk/dv. Grid (key tiles, B * H); 4 warps, each owning 16 key rows, over
// query tiles of kBwdQueries. Scores are taken transposed, s^T(key, query),
// so each warp's dk and dv rows come out of its own fragments.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          const Geometry geo) {
  constexpr int BQ = kBwdQueries;
  constexpr int LD = D + Pad<T>::value;
  constexpr int LDQ = BQ + Pad<T>::value;
  constexpr int NQ = BQ / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);   // [kRows][LD]
  T* v_s = k_s + kRows * LD;                  // [kRows][LD]
  T* q_s = v_s + kRows * LD;                  // [BQ][LD]
  T* do_s = q_s + BQ * LD;                    // [BQ][LD]
  T* pt_s = do_s + BQ * LD;                   // [kRows][LDQ]
  T* dst_s = pt_s + kRows * LDQ;              // [kRows][LDQ]
  float* lse_s = reinterpret_cast<float*>(dst_s + kRows * LDQ);  // [BQ]
  float* delta_s = lse_s + BQ;                                   // [BQ]

  const int t_len = geo.t_len;
  const int bh = blockIdx.y;
  const int stride = geo.heads * D;
  const size_t head = ((size_t)(bh / geo.heads) * t_len * geo.heads
                       + bh % geo.heads) * D;
  const float* lse_h = lse + (size_t)bh * t_len;
  const float* delta_h = delta + (size_t)bh * t_len;
  const int k0 = blockIdx.x * kRows;          // low key tiles have most work
  const int warp = threadIdx.x >> 5;
  const int wkey0 = k0 + warp * 16;
  const T* k_w = k_s + warp * 16 * LD;
  const T* v_w = v_s + warp * 16 * LD;
  T* pt_w = pt_s + warp * 16 * LDQ;
  T* dst_w = dst_s + warp * 16 * LDQ;

  load_rows<T, D>(k + head, stride, k0, kRows, t_len, k_s, LD);
  load_rows<T, D>(v + head, stride, k0, kRows, t_len, v_s, LD);
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);
  const int n_q = (t_len + BQ - 1) / BQ;
  const int q_begin = geo.causal ? k0 / BQ : 0;

  for (int qt = q_begin; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Q/dO/stats are no longer read
    load_rows<T, D>(q + head, stride, q0, BQ, t_len, q_s, LD);
    load_rows<T, D>(dout + head, stride, q0, BQ, t_len, do_s, LD);
    load_stats(lse_h, q0, BQ, t_len, lse_s);
    load_stats(delta_h, q0, BQ, t_len, delta_s);
    __syncthreads();

    float p[NQ][4];  // p^T(key, query)
    zero(p);
    warp_mm<NQ, D, true>(p, k_w, LD, q_s, LD);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = wkey0 + frag_row(i);
        const int qc = frag_col(nt, i);
        float x = p[nt][i] * geo.sm_scale;
        if (q0 + qc >= t_len || (geo.causal && key > q0 + qc)) x = kMasked;
        p[nt][i] = expf(x - lse_s[qc]);
      }
    store_frag(p, pt_w, LDQ);  // p rounded to dO's dtype, for dv

    float ds[NQ][4];  // dp^T(key, query) = V[key] . dO[query], then ds^T
    zero(ds);
    warp_mm<NQ, D, true>(ds, v_w, LD, do_s, LD);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[nt][i] = p[nt][i] * (ds[nt][i] - delta_s[frag_col(nt, i)])
                    * geo.sm_scale;
    store_frag(ds, dst_w, LDQ);  // ds rounded to q's dtype
    __syncwarp();
    warp_mm<NO, BQ, false>(dv_acc, pt_w, LDQ, do_s, LD);
    warp_mm<NO, BQ, false>(dk_acc, dst_w, LDQ, q_s, LD);
  }

  store_rows(dk_acc, dk + head, stride, wkey0, t_len);
  store_rows(dv_acc, dv + head, stride, wkey0, t_len);
}

// dq. Grid (query tiles, B * H); 4 warps, each owning 16 query rows, over
// the key tiles up to the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        const Geometry geo) {
  constexpr int LD = D + Pad<T>::value;
  constexpr int LDK = kKeys + Pad<T>::value;
  constexpr int NS = kKeys / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [kRows][LD]
  T* do_s = q_s + kRows * LD;                 // [kRows][LD]
  T* k_s = do_s + kRows * LD;                 // [kKeys][LD]
  T* v_s = k_s + kKeys * LD;                  // [kKeys][LD]
  T* ds_s = v_s + kKeys * LD;                 // [kRows][LDK]

  const int t_len = geo.t_len;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int stride = geo.heads * D;
  const size_t head = ((size_t)(bh / geo.heads) * t_len * geo.heads
                       + bh % geo.heads) * D;
  const int q0 = qt * kRows;
  const int warp = threadIdx.x >> 5;
  const int wrow0 = q0 + warp * 16;
  const T* q_w = q_s + warp * 16 * LD;
  const T* do_w = do_s + warp * 16 * LD;
  T* ds_w = ds_s + warp * 16 * LDK;

  load_rows<T, D>(q + head, stride, q0, kRows, t_len, q_s, LD);
  load_rows<T, D>(dout + head, stride, q0, kRows, t_len, do_s, LD);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + frag_row(2 * r);
    row_lse[r] = row < t_len ? lse[(size_t)bh * t_len + row] : 0.f;
    row_delta[r] = row < t_len ? delta[(size_t)bh * t_len + row] : 0.f;
  }
  float dq_acc[NO][4];
  zero(dq_acc);
  const int n_k = (t_len + kKeys - 1) / kKeys;
  const int k_end = geo.causal ? min(n_k, (q0 + kRows - 1) / kKeys + 1) : n_k;

  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_rows<T, D>(k + head, stride, k0, kKeys, t_len, k_s, LD);
    load_rows<T, D>(v + head, stride, k0, kKeys, t_len, v_s, LD);
    __syncthreads();

    float p[NS][4];
    zero(p);
    warp_mm<NS, D, true>(p, q_w, LD, k_s, LD);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wrow0 + frag_row(i);
        const int col = k0 + frag_col(nt, i);
        float x = p[nt][i] * geo.sm_scale;
        if (col >= t_len || (geo.causal && col > row)) x = kMasked;
        p[nt][i] = expf(x - row_lse[i >> 1]);
      }
    float ds[NS][4];  // dp(query, key) = dO[query] . V[key], then ds
    zero(ds);
    warp_mm<NS, D, true>(ds, do_w, LD, v_s, LD);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[nt][i] = p[nt][i] * (ds[nt][i] - row_delta[i >> 1]) * geo.sm_scale;
    store_frag(ds, ds_w, LDK);  // ds rounded to q's dtype
    __syncwarp();
    warp_mm<NO, kKeys, false>(dq_acc, ds_w, LDK, k_s, LD);
  }

  store_rows(dq_acc, dq + head, stride, wrow0, t_len);
}

// dynamic shared memory of each kernel (its carve-up above)
template <typename T, int D>
size_t fwd_smem() {
  return sizeof(T) * ((size_t)(kRows + 2 * kKeys) * (D + Pad<T>::value)
                      + (size_t)kRows * (kKeys + Pad<T>::value));
}
template <typename T, int D>
size_t dkdv_smem() {
  return sizeof(T) * ((size_t)(2 * kRows + 2 * kBwdQueries)
                          * (D + Pad<T>::value)
                      + 2 * (size_t)kRows * (kBwdQueries + Pad<T>::value))
         + 2 * sizeof(float) * kBwdQueries;
}
template <typename T, int D>
size_t dq_smem() {
  return sizeof(T) * ((size_t)(2 * kRows + 2 * kKeys) * (D + Pad<T>::value)
                      + (size_t)kRows * (kKeys + Pad<T>::value));
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Ptrs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *lse_out, *dq, *dk, *dv;
};

enum class Which { kFwd, kDkdv, kDq };

template <typename T, int D>
cudaError_t launch(Which which, const Ptrs& p, int batch, const Geometry& geo,
                   cudaStream_t stream) {
  const int n_tiles = (geo.t_len + kRows - 1) / kRows;
  const dim3 grid(n_tiles, batch * geo.heads);
  cudaError_t err = cudaSuccess;
  switch (which) {
    case Which::kFwd: {
      auto kernel = flash_fwd_kernel<T, D>;
      err = set_smem(kernel, fwd_smem<T, D>());
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, fwd_smem<T, D>(), stream>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k),
          static_cast<const T*>(p.v), static_cast<T*>(p.out),
          static_cast<float*>(p.lse_out), geo);
      break;
    }
    case Which::kDkdv: {
      auto kernel = flash_bwd_dkdv_kernel<T, D>;
      err = set_smem(kernel, dkdv_smem<T, D>());
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, dkdv_smem<T, D>(), stream>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k),
          static_cast<const T*>(p.v), static_cast<const T*>(p.dout),
          static_cast<const float*>(p.lse), static_cast<const float*>(p.delta),
          static_cast<T*>(p.dk), static_cast<T*>(p.dv), geo);
      break;
    }
    case Which::kDq: {
      auto kernel = flash_bwd_dq_kernel<T, D>;
      err = set_smem(kernel, dq_smem<T, D>());
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, dq_smem<T, D>(), stream>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k),
          static_cast<const T*>(p.v), static_cast<const T*>(p.dout),
          static_cast<const float*>(p.lse), static_cast<const float*>(p.delta),
          static_cast<T*>(p.dq), geo);
      break;
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(Which which, const Ptrs& p, int batch, int head_dim,
                         const Geometry& geo, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(which, p, batch, geo, stream);
    case 32: return launch<T, 32>(which, p, batch, geo, stream);
    case 64: return launch<T, 64>(which, p, batch, geo, stream);
    case 128: return launch<T, 128>(which, p, batch, geo, stream);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(Which which, const Ptrs& p, int batch, int t_len, int heads,
             int head_dim, int causal, float sm_scale, int is_bf16,
             void* stream) {
  if (batch < 1 || t_len < 1 || heads < 1 || batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry geo{t_len, heads, causal, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch_typed<bf16>(which, p, batch, head_dim, geo, st)
                   : launch_typed<float>(which, p, batch, head_dim, geo, st));
}

}  // namespace

// C interface (ctypes). Pointers are device pointers from Tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream. Each returns the
// cudaError_t of its launch (0 = launched); the caller raises on non-zero.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int batch, int t_len,
                                int heads, int head_dim, int causal,
                                float sm_scale, int is_bf16, void* stream) {
  Ptrs p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse_out = lse;
  return dispatch(Which::kFwd, p, batch, t_len, heads, head_dim, causal,
                  sm_scale, is_bf16, stream);
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int batch, int t_len,
                                     int heads, int head_dim, int causal,
                                     float sm_scale, int is_bf16,
                                     void* stream) {
  Ptrs p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dk = dk; p.dv = dv;
  return dispatch(Which::kDkdv, p, batch, t_len, heads, head_dim, causal,
                  sm_scale, is_bf16, stream);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int batch, int t_len, int heads,
                                   int head_dim, int causal, float sm_scale,
                                   int is_bf16, void* stream) {
  Ptrs p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq;
  return dispatch(Which::kDq, p, batch, t_len, heads, head_dim, causal,
                  sm_scale, is_bf16, stream);
}
