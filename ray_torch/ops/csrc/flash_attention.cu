// Flash attention for the training path: hand-written CUDA C++ kernels for
// Hopper (sm_90a), built by ray_torch/ops/_build.py and bound with ctypes
// by ray_torch/ops/attention.py.
//
// What each replaces (Pallas TPU kernels of ray_tpu/ops/attention.py):
//   flash_fwd_hopper (bf16), flash_fwd_kernel (fp32)
//       <- _flash_kernel (:26, launched by _flash_bh)
//   flash_bwd_dkdv_hopper (bf16), flash_bwd_dkdv_kernel (fp32)
//       <- _flash_bwd_dkdv_kernel (:120, _flash_bwd_bh)
//   flash_bwd_dq_hopper (bf16), flash_bwd_dq_kernel (fp32)
//       <- _flash_bwd_dq_kernel (:172, _flash_bwd_bh)
// Layouts: q, k, v, out, dout, dq, dk, dv are [B, T, H, D] (heads already
// GQA-expanded), lse and delta [B, H, T] fp32. The causal mask keeps key
// col <= query row; masked scores are -1e30, as in the reference.
//
// Numerics are the Pallas kernels': s = q.k in fp32 from exact products of
// the input dtype, times sm_scale; an online softmax with fp32 running max,
// sum and accumulator; p rounded to the input dtype before p.V; LSE =
// m + log(l) with l > 0 guarded; in the backward p = exp(s - lse),
// ds = p * (dO.V^T - delta) * scale rounded to the input dtype before ds.K
// and ds^T.Q; every output cast once at the end. bf16 products run on the
// tensor cores (wgmma) with bf16 inputs and fp32 accumulation, which
// computes exactly these roundings; the Hopper kernels take exp as 2^x of
// scores in log2 units (ex2.approx, ~2^-22 relative). fp32 runs the same
// products as FMAs (wgmma's fp32 path is TF32, which would round the
// inputs).
//
// Bound on an H100 at the training shapes (B=4, H=16, T=2048, D=128,
// causal, bf16): operations. The forward does 2 products of 2 D flop per
// causal (query, key) pair, 68.75 GFLOP, 0.0695 ms at 989 TFLOP/s, against
// 135 MB of q, k, v, out and lse (0.040 ms at 3.35 TB/s); dk/dv 4 products
// (s, dp, dv, dk), 137.5 GFLOP (0.139 ms) against 202 MB; dq 3 products
// (0.104 ms).
//
// What the design does about that bound:
//  - bf16 (flash_fwd_hopper, flash_bwd_dkdv_hopper, flash_bwd_dq_hopper,
//    every D of 16, 32, 64, 128): three warpgroups a block. One producer
//    thread keeps TMA tile loads in flight through a 2-stage ring with
//    full/empty mbarriers (setmaxnreg hands its registers to the
//    consumers); two consumer warpgroups of 64 rows each run wgmma
//    m64nNk16 on the tiles that have arrived. Scores come from shared
//    memory with both operands K-major; the probability tile (P in the
//    forward, P^T and dS^T in dk/dv, dS in dq) is rounded to bf16 in
//    registers and is the register A operand of the next product, whose B
//    operand (V, dO, Q, K) is read MN-major with wgmma's transpose bit.
//    Nothing round-trips through shared memory and no operand is
//    assembled from scalar loads. Forward: one block per
//    (b*h, 128-row query tile) over 128-key tiles up to the diagonal.
//    dk/dv: one block per (b*h, 128-key tile), K and V resident, over
//    64-row Q/dO tiles (with their LSE and delta rows) from the diagonal on.
//    dq: one block per (b*h, 128-row query tile), Q and dO resident, over
//    64-key K/V tiles up to the diagonal (a 64-key tile keeps the S and dP
//    accumulators at 32 registers each beside dQ's 64 at D=128).
//    The TMA maps are 4-d over [B, T, H, D] (hopper.cuh), so rows past T
//    read as zeros and never from the next batch;
//  - fp32: FMAs on 16-row warp tiles (4 warps, 64 rows a block) fed from
//    shared memory by synchronous loads;
//  - Hopper blocks run in no order, so nothing carries across blocks as the
//    TPU grid carried VMEM scratch: each block loops over the other axis
//    itself; fully masked tiles are skipped (causal work is T(T+1)/2 pairs,
//    not T^2), and only diagonal and ragged tiles are masked;
//  - the reference's two-kernel backward is kept: no atomics, so gradients
//    are deterministic run to run;
//  - causal tiles run heaviest first (the Hopper grids put the heavy tile
//    index in y, so every head's heaviest tiles launch before any light
//    one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// One warp's product over its 16 rows in fp32 FMAs: c(r, n) += sum_k
// A(r, k) B(k, n), n < 8 * NT, k < K, from shared memory. A(r, k) =
// A[r * lda + k]; B(k, n) = kTransB ? B[n * ldb + k] : B[k * ldb + n].
// c holds the m16n8 fragment layout of each 8-column tile nt: lane
// (g = lane / 4, t = lane % 4) holds c[nt][0..1] at row g, columns
// nt * 8 + 2t + {0, 1}, and c[nt][2..3] at row g + 8 (see frag_row/frag_col).
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

// Forward, fp32. Grid (query tiles, B * H); 4 warps, each owning 16 query
// rows.
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

// dk/dv, fp32. Grid (key tiles, B * H); 4 warps, each owning 16 key rows, over
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

// ---------------------------------------------------------------------------
// bf16: the Hopper design. Three warpgroups a block: warpgroup 0 is the
// producer (one thread issues every TMA load; setmaxnreg gives its
// registers away), warpgroups 1 and 2 are consumers of 64 rows each that
// run wgmma on the tiles that have arrived. Loads go through a ring of
// tiles with a full and an empty mbarrier a stage.
// ---------------------------------------------------------------------------

constexpr int kHopperThreads = 3 * 128;
constexpr int kProducerRegs = 40;    // 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kFwdStages = 2;       // K/V tiles of the forward ring
constexpr int kBwdStages = 2;       // Q/dO tiles of the dk/dv ring
constexpr int kConsumerWarps = 8;   // empty barriers count one arrive each
constexpr int kFwdRows = 128;       // query rows of a forward block
constexpr int kFwdKeys = 128;       // key tile of the forward ring
constexpr int kBwdKeys = 128;       // key rows of a dk/dv block
constexpr int kBwdRows = 64;        // query tile of the dk/dv ring
constexpr int kDqStages = 2;        // K/V tiles of the dq ring
constexpr int kDqRows = 128;        // query rows of a dq block
constexpr int kDqKeys = 64;         // key tile of the dq ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory carve-up: tiles first (each a multiple of 1024 bytes from
// a 1024-aligned base), then fp32 statistics, then the barriers
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int D>
constexpr size_t fwd_hopper_smem() {
  return 1024 + 2 * ((size_t)kFwdRows + 2 * kFwdStages * kFwdKeys) * D
         + 8 * (1 + 2 * kFwdStages);
}
template <int D>
constexpr size_t dkdv_hopper_smem() {
  return 1024 + 2 * ((size_t)2 * kBwdKeys + 2 * kBwdStages * kBwdRows) * D
         + 4 * 2 * kBwdStages * kBwdRows + 8 * (1 + 2 * kBwdStages);
}
template <int D>
constexpr size_t dq_hopper_smem() {
  return 1024 + 2 * ((size_t)2 * kDqRows + 2 * kDqStages * kDqKeys) * D
         + 8 * (1 + 2 * kDqStages);
}

// Forward, bf16. Grid (B * H, query tiles of kFwdRows); consumer c owns query
// rows [64 c, 64 c + 64) of the tile and walks the key tiles up to the
// diagonal: S = Q K^T by wgmma from shared memory, the online softmax on
// the accumulator, then O += P V with P rounded to bf16 in registers as
// the A operand and V MN-major from shared memory.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     const Geometry geo) {
  using Tl = hopper::Tile<D>;
  constexpr int kQBytes = 2 * kFwdRows * D;
  constexpr int kKBytes = 2 * kFwdKeys * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(base);
  unsigned char* k_s = base + kQBytes;               // [kFwdStages] tiles
  unsigned char* v_s = k_s + kFwdStages * kKBytes;   // [kFwdStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kFwdStages * kKBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;

  const int t_len = geo.t_len;
  const int bh = blockIdx.x;
  const int b = bh / geo.heads, h = bh % geo.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;  // heaviest first
  const int n_k = (t_len + kFwdKeys - 1) / kFwdKeys;
  const int k_end =
      geo.causal ? min(n_k, (q0 + kFwdRows - 1) / kFwdKeys + 1) : n_k;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, kQBytes);
      for (int c = 0; c < Tl::kBoxes; ++c)
        hopper::tma_load_4d(q_s + c * kFwdRows * Tl::kBoxCols, &q_map,
                            q_full, c * Tl::kBoxCols, h, q0, b);
      for (int kt = 0; kt < k_end; ++kt) {
        const int s = kt % kFwdStages;
        if (kt >= kFwdStages)
          hopper::mbar_wait(&empty[s], (kt / kFwdStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kKBytes);
        for (int c = 0; c < Tl::kBoxes; ++c) {
          const int off = c * kFwdKeys * Tl::kRowBytes;
          hopper::tma_load_4d(k_s + s * kKBytes + off, &k_map, &full[s],
                              c * Tl::kBoxCols, h, kt * kFwdKeys, b);
          hopper::tma_load_4d(v_s + s * kKBytes + off, &v_map, &full[s],
                              c * Tl::kBoxCols, h, kt * kFwdKeys, b);
        }
      }
    }
  } else {
    hopper::regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int wrow0 = q0 + 64 * c;               // the consumer's first row
    const int row0 = wrow0 + 16 * (tid / 32) + g;  // rows row0, row0 + 8
    const float scale2 = geo.sm_scale * kLog2e;  // scores in log2 units

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kMasked, kMasked};
    float l[2] = {0.f, 0.f};
    hopper::mbar_wait(q_full, 0);

    for (int kt = 0; kt < k_end; ++kt) {
      const int s = kt % kFwdStages;
      const int k0 = kt * kFwdKeys;
      hopper::mbar_wait(&full[s], (kt / kFwdStages) & 1);
      const uint32_t q_a = hopper::opaque_addr(q_s);
      const uint32_t k_t = hopper::smem_addr(k_s + s * kKBytes);
      const uint32_t v_t = hopper::smem_addr(v_s + s * kKBytes);

      float sc[kFwdKeys / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<kFwdKeys>::ss<0, 0>(
            sc, hopper::desc_kmajor<D, kFwdRows>(q_a, 64 * c, kk),
            hopper::desc_kmajor<D, kFwdKeys>(k_t, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // mask only the diagonal and ragged tiles: key column k0 + 8 i +
      // 2 t + (r & 1) is masked past t_len and, when causal, past its row
      const bool mask = k0 + kFwdKeys > t_len
                        || (geo.causal && k0 + kFwdKeys - 1 > wrow0);
      const int end = t_len - k0 - 2 * t4;
      const int diag = geo.causal ? row0 - k0 - 2 * t4 : end;
      float mx[2] = {kMasked, kMasked};  // the tile's row max, unscaled
#pragma unroll
      for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = 8 * i + (r & 1);
          if (mask && (col >= end || col > diag + 8 * (r >> 1)))
            sc[4 * i + r] = kMasked;
          mx[r >> 1] = fmaxf(mx[r >> 1], sc[4 * i + r]);
        }
      // the running max in log2 units; p = 2^(s scale log2(e) - max)
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(m[r], quad_max(mx[r]) * scale2);
        alpha[r] = hopper::exp2_approx(m[r] - mx[r]);
      }
#pragma unroll
      for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = hopper::exp2_approx(
              fmaf(sc[4 * i + r], scale2, -mx[r >> 1]));
          sc[4 * i + r] = p;
          rsum[r >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + quad_sum(rsum[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[4 * i + r] *= alpha[r >> 1];

      // O += P V: P in bf16 registers, V MN-major
      uint32_t pa[kFwdKeys / 16][4];
#pragma unroll
      for (int j = 0; j < kFwdKeys / 16; ++j) hopper::acc_to_a(sc, j, pa[j]);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kFwdKeys / 16; ++j)
        hopper::Wgmma<D>::template rs<1>(
            o, pa[j], hopper::desc_mnmajor<D, kFwdKeys>(v_t, j), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const size_t head = ((size_t)b * t_len * geo.heads + h) * D;
    const int stride = geo.heads * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= t_len) continue;
      const float lr = l[r] > 0.f ? l[r] : 1.f;
      const float inv = 1.f / lr;
      bf16* dst = out + head + (size_t)row * stride;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        store_pair(dst + 8 * i + 2 * t4, o[4 * i + 2 * r] * inv,
                   o[4 * i + 2 * r + 1] * inv);
      if (t4 == 0)
        lse[(size_t)bh * t_len + row] = m[r] * kLn2 + logf(lr);
    }
  }
}

// dk/dv, bf16. Grid (B * H, key tiles of kBwdKeys); consumer c owns key rows
// [64 c, 64 c + 64) of the tile, K and V stay resident, and Q, dO and
// their LSE and delta rows come through the ring in kBwdRows-query tiles
// from the diagonal on. Scores are taken transposed: S^T = K Q^T and
// dP^T = V dO^T by wgmma from shared memory; P^T and dS^T stay in
// registers as bf16 A operands of dV += P^T dO and dK += dS^T Q, with dO
// and Q MN-major from shared memory.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dkdv_hopper(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          const Geometry geo) {
  using Tl = hopper::Tile<D>;
  constexpr int kKBytes = 2 * kBwdKeys * D;
  constexpr int kQBytes = 2 * kBwdRows * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* k_s = base;
  unsigned char* v_s = k_s + kKBytes;
  unsigned char* q_s = v_s + kKBytes;                // [kBwdStages] tiles
  unsigned char* do_s = q_s + kBwdStages * kQBytes;  // [kBwdStages] tiles
  float* lse_s = reinterpret_cast<float*>(do_s + kBwdStages * kQBytes);
  float* delta_s = lse_s + kBwdStages * kBwdRows;    // [stage][row]
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(delta_s + kBwdStages * kBwdRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kBwdStages;

  const int t_len = geo.t_len;
  const int bh = blockIdx.x;
  const int b = bh / geo.heads, h = bh % geo.heads;
  const int k0 = blockIdx.y * kBwdKeys;       // low key tiles have most work
  const int n_q = (t_len + kBwdRows - 1) / kBwdRows;
  const int q_begin = geo.causal ? k0 / kBwdRows : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(&full[s], 32);          // the producer warp's lanes
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_h = lse + (size_t)bh * t_len;
      const float* delta_h = delta + (size_t)bh * t_len;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * kKBytes);
        for (int c = 0; c < Tl::kBoxes; ++c) {
          const int off = c * kBwdKeys * Tl::kRowBytes;
          hopper::tma_load_4d(k_s + off, &k_map, kv_full, c * Tl::kBoxCols,
                              h, k0, b);
          hopper::tma_load_4d(v_s + off, &v_map, kv_full, c * Tl::kBoxCols,
                              h, k0, b);
        }
      }
      for (int qt = q_begin, i = 0; qt < n_q; ++qt, ++i) {
        const int s = i % kBwdStages;
        const int q0 = qt * kBwdRows;
        if (i >= kBwdStages)
          hopper::mbar_wait(&empty[s], (i / kBwdStages - 1) & 1);
        // LSE (in log2 units) and delta of the tile's rows; past t_len the
        // LSE is +inf, so p = exp2(s - lse) = 0 masks those queries
        for (int j = lane; j < kBwdRows; j += 32) {
          const bool in = q0 + j < t_len;
          lse_s[s * kBwdRows + j] = in ? lse_h[q0 + j] * kLog2e : INFINITY;
          delta_s[s * kBwdRows + j] = in ? delta_h[q0 + j] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
          for (int c = 0; c < Tl::kBoxes; ++c) {
            const int off = s * kQBytes + c * kBwdRows * Tl::kRowBytes;
            hopper::tma_load_4d(q_s + off, &q_map, &full[s],
                                c * Tl::kBoxCols, h, q0, b);
            hopper::tma_load_4d(do_s + off, &do_map, &full[s],
                                c * Tl::kBoxCols, h, q0, b);
          }
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    hopper::regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int wkey0 = k0 + 64 * c;               // the consumer's first key
    const int key0 = wkey0 + 16 * (tid / 32) + g;  // keys key0, key0 + 8
    const float scale2 = geo.sm_scale * kLog2e;  // scores in log2 units

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hopper::mbar_wait(kv_full, 0);

    for (int qt = q_begin, i = 0; qt < n_q; ++qt, ++i) {
      const int s = i % kBwdStages;
      const int q0 = qt * kBwdRows;
      hopper::mbar_wait(&full[s], (i / kBwdStages) & 1);
      if (geo.causal && wkey0 > q0 + kBwdRows - 1) {
        // every key of this consumer lies above every query of the tile
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t k_a = hopper::opaque_addr(k_s);
      const uint32_t v_a = hopper::opaque_addr(v_s);
      const uint32_t q_t = hopper::smem_addr(q_s + s * kQBytes);
      const uint32_t do_t = hopper::smem_addr(do_s + s * kQBytes);
      const float* lse_t = lse_s + s * kBwdRows;
      const float* delta_t = delta_s + s * kBwdRows;

      float p[kBwdRows / 2], ds[kBwdRows / 2];   // p^T, dp^T (key, query)
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<kBwdRows>::ss<0, 0>(
            p, hopper::desc_kmajor<D, kBwdKeys>(k_a, 64 * c, kk),
            hopper::desc_kmajor<D, kBwdRows>(q_t, 0, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<kBwdRows>::ss<0, 0>(
            ds, hopper::desc_kmajor<D, kBwdKeys>(v_a, 64 * c, kk),
            hopper::desc_kmajor<D, kBwdRows>(do_t, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(p);

      // p^T = exp(scale s^T - lse[query]), zero above the diagonal (the
      // query column 8 j + 2 t + (r & 1) < key - q0) and past t_len (by
      // the +inf LSE)
      const bool diag = geo.causal && wkey0 + 63 > q0;
      const int lim = key0 - q0 - 2 * t4;
#pragma unroll
      for (int j = 0; j < kBwdRows / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = hopper::exp2_approx(
              fmaf(p[4 * j + r], scale2, -lse_t[8 * j + 2 * t4 + (r & 1)]));
          if (diag && 8 * j + (r & 1) < lim + 8 * (r >> 1)) x = 0.f;
          p[4 * j + r] = x;
        }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(ds);

      // ds^T = p^T (dp^T - delta[query]) scale; both rounded to bf16 A
      // fragments slice by slice, so p^T and dp^T die as the fragments
      // fill (the accumulators of dK and dV hold 64 registers each at
      // D=128)
      uint32_t pa[kBwdRows / 16][4], da[kBwdRows / 16][4];
#pragma unroll
      for (int j = 0; j < kBwdRows / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[4 * j + r] = p[4 * j + r]
                          * (ds[4 * j + r] - delta_t[8 * j + 2 * t4 + (r & 1)])
                          * geo.sm_scale;
#pragma unroll
      for (int j = 0; j < kBwdRows / 16; ++j) {
        hopper::acc_to_a(p, j, pa[j]);
        hopper::acc_to_a(ds, j, da[j]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBwdRows / 16; ++j)
        hopper::Wgmma<D>::template rs<1>(
            dv_acc, pa[j], hopper::desc_mnmajor<D, kBwdRows>(do_t, j), 1);
#pragma unroll
      for (int j = 0; j < kBwdRows / 16; ++j)
        hopper::Wgmma<D>::template rs<1>(
            dk_acc, da[j], hopper::desc_mnmajor<D, kBwdRows>(q_t, j), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const size_t head = ((size_t)b * t_len * geo.heads + h) * D;
    const int stride = geo.heads * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= t_len) continue;
      const size_t at = head + (size_t)key * stride + 2 * t4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        store_pair(dk + at + 8 * i, dk_acc[4 * i + 2 * r],
                   dk_acc[4 * i + 2 * r + 1]);
        store_pair(dv + at + 8 * i, dv_acc[4 * i + 2 * r],
                   dv_acc[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dq, bf16. Grid (B * H, query tiles of kDqRows); consumer c owns query rows
// [64 c, 64 c + 64) of the tile, Q and dO stay resident, and K and V come
// through the ring in kDqKeys-key tiles up to the diagonal. S = Q K^T and
// dP = dO V^T by wgmma from shared memory, both operands K-major; dS is
// rounded to bf16 in registers as the A operand of dQ += dS K, with K
// MN-major from shared memory. Each block owns its dq rows: no atomics.
// Key rows past T land as zeros, so their dS multiplies a zero K row and
// adds nothing; query rows past T have a +inf LSE (p = 0) and are not
// stored.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, const Geometry geo) {
  using Tl = hopper::Tile<D>;
  constexpr int kQBytes = 2 * kDqRows * D;
  constexpr int kKBytes = 2 * kDqKeys * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* q_s = base;
  unsigned char* do_s = q_s + kQBytes;
  unsigned char* k_s = do_s + kQBytes;               // [kDqStages] tiles
  unsigned char* v_s = k_s + kDqStages * kKBytes;    // [kDqStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kDqStages * kKBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int t_len = geo.t_len;
  const int bh = blockIdx.x;
  const int b = bh / geo.heads, h = bh % geo.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // heaviest first
  const int n_k = (t_len + kDqKeys - 1) / kDqKeys;
  const int k_end =
      geo.causal ? min(n_k, (q0 + kDqRows - 1) / kDqKeys + 1) : n_k;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * kQBytes);
      for (int c = 0; c < Tl::kBoxes; ++c) {
        const int off = c * kDqRows * Tl::kRowBytes;
        hopper::tma_load_4d(q_s + off, &q_map, q_full, c * Tl::kBoxCols, h,
                            q0, b);
        hopper::tma_load_4d(do_s + off, &do_map, q_full, c * Tl::kBoxCols,
                            h, q0, b);
      }
      for (int kt = 0; kt < k_end; ++kt) {
        const int s = kt % kDqStages;
        if (kt >= kDqStages)
          hopper::mbar_wait(&empty[s], (kt / kDqStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kKBytes);
        for (int c = 0; c < Tl::kBoxes; ++c) {
          const int off = s * kKBytes + c * kDqKeys * Tl::kRowBytes;
          hopper::tma_load_4d(k_s + off, &k_map, &full[s], c * Tl::kBoxCols,
                              h, kt * kDqKeys, b);
          hopper::tma_load_4d(v_s + off, &v_map, &full[s], c * Tl::kBoxCols,
                              h, kt * kDqKeys, b);
        }
      }
    }
  } else {
    hopper::regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int wrow0 = q0 + 64 * c;               // the consumer's first row
    const int row0 = wrow0 + 16 * (tid / 32) + g;  // rows row0, row0 + 8
    const float scale2 = geo.sm_scale * kLog2e;  // scores in log2 units

    // the rows' LSE (in log2 units) and delta; past t_len the LSE is +inf,
    // so p = exp2(s - lse) = 0 there
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool in = row < t_len;
      lse2[r] = in ? lse[(size_t)bh * t_len + row] * kLog2e : INFINITY;
      dlt[r] = in ? delta[(size_t)bh * t_len + row] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    hopper::mbar_wait(q_full, 0);

    for (int kt = 0; kt < k_end; ++kt) {
      const int s = kt % kDqStages;
      const int k0 = kt * kDqKeys;
      hopper::mbar_wait(&full[s], (kt / kDqStages) & 1);
      if (geo.causal && k0 > wrow0 + 63) {
        // every key of this tile lies right of every row of this consumer
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t q_a = hopper::opaque_addr(q_s);
      const uint32_t do_a = hopper::opaque_addr(do_s);
      const uint32_t k_t = hopper::smem_addr(k_s + s * kKBytes);
      const uint32_t v_t = hopper::smem_addr(v_s + s * kKBytes);

      float p[kDqKeys / 2], ds[kDqKeys / 2];   // s, dp (query, key)
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<kDqKeys>::ss<0, 0>(
            p, hopper::desc_kmajor<D, kDqRows>(q_a, 64 * c, kk),
            hopper::desc_kmajor<D, kDqKeys>(k_t, 0, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<kDqKeys>::ss<0, 0>(
            ds, hopper::desc_kmajor<D, kDqRows>(do_a, 64 * c, kk),
            hopper::desc_kmajor<D, kDqKeys>(v_t, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(p);

      // p = exp(scale s - lse[row]), zero right of the diagonal (the key
      // column 8 i + 2 t + (r & 1) > row - k0)
      const bool diag = geo.causal && k0 + kDqKeys - 1 > wrow0;
      const int lim = row0 - k0 - 2 * t4;
#pragma unroll
      for (int i = 0; i < kDqKeys / 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = hopper::exp2_approx(
              fmaf(p[4 * i + r], scale2, -lse2[r >> 1]));
          if (diag && 8 * i + (r & 1) > lim + 8 * (r >> 1)) x = 0.f;
          p[4 * i + r] = x;
        }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(ds);

      // ds = p (dp - delta[row]) scale, rounded to bf16 A fragments
      uint32_t da[kDqKeys / 16][4];
#pragma unroll
      for (int i = 0; i < kDqKeys / 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[4 * i + r] = p[4 * i + r] * (ds[4 * i + r] - dlt[r >> 1])
                          * geo.sm_scale;
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j) hopper::acc_to_a(ds, j, da[j]);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j)
        hopper::Wgmma<D>::template rs<1>(
            dq_acc, da[j], hopper::desc_mnmajor<D, kDqKeys>(k_t, j), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq_acc);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const size_t head = ((size_t)b * t_len * geo.heads + h) * D;
    const int stride = geo.heads * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= t_len) continue;
      bf16* dst = dq + head + (size_t)row * stride + 2 * t4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        store_pair(dst + 8 * i, dq_acc[4 * i + 2 * r],
                   dq_acc[4 * i + 2 * r + 1]);
    }
  }
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

// bf16: the Hopper kernels, on tensor maps of this launch's tensors
template <int D>
cudaError_t launch_hopper(Which which, const Ptrs& p, int batch,
                          const Geometry& geo, cudaStream_t stream) {
  const int t = geo.t_len, hs = geo.heads;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = cudaSuccess;
  if (which == Which::kDq) {
    if (!hopper::encode_bthd<D>(&q_map, p.q, batch, t, hs, kDqRows)
        || !hopper::encode_bthd<D>(&k_map, p.k, batch, t, hs, kDqKeys)
        || !hopper::encode_bthd<D>(&v_map, p.v, batch, t, hs, kDqKeys)
        || !hopper::encode_bthd<D>(&do_map, p.dout, batch, t, hs, kDqRows))
      return cudaErrorInvalidValue;
    auto kernel = flash_bwd_dq_hopper<D>;
    err = set_smem(kernel, dq_hopper_smem<D>());
    if (err != cudaSuccess) return err;
    const dim3 grid(batch * hs, (t + kDqRows - 1) / kDqRows);
    kernel<<<grid, kHopperThreads, dq_hopper_smem<D>(), stream>>>(
        q_map, k_map, v_map, do_map, static_cast<const float*>(p.lse),
        static_cast<const float*>(p.delta), static_cast<bf16*>(p.dq), geo);
  } else if (which == Which::kFwd) {
    if (!hopper::encode_bthd<D>(&q_map, p.q, batch, t, hs, kFwdRows)
        || !hopper::encode_bthd<D>(&k_map, p.k, batch, t, hs, kFwdKeys)
        || !hopper::encode_bthd<D>(&v_map, p.v, batch, t, hs, kFwdKeys))
      return cudaErrorInvalidValue;
    auto kernel = flash_fwd_hopper<D>;
    err = set_smem(kernel, fwd_hopper_smem<D>());
    if (err != cudaSuccess) return err;
    const dim3 grid(batch * hs, (t + kFwdRows - 1) / kFwdRows);
    kernel<<<grid, kHopperThreads, fwd_hopper_smem<D>(), stream>>>(
        q_map, k_map, v_map, static_cast<bf16*>(p.out),
        static_cast<float*>(p.lse_out), geo);
  } else {
    if (!hopper::encode_bthd<D>(&q_map, p.q, batch, t, hs, kBwdRows)
        || !hopper::encode_bthd<D>(&k_map, p.k, batch, t, hs, kBwdKeys)
        || !hopper::encode_bthd<D>(&v_map, p.v, batch, t, hs, kBwdKeys)
        || !hopper::encode_bthd<D>(&do_map, p.dout, batch, t, hs, kBwdRows))
      return cudaErrorInvalidValue;
    auto kernel = flash_bwd_dkdv_hopper<D>;
    err = set_smem(kernel, dkdv_hopper_smem<D>());
    if (err != cudaSuccess) return err;
    const dim3 grid(batch * hs, (t + kBwdKeys - 1) / kBwdKeys);
    kernel<<<grid, kHopperThreads, dkdv_hopper_smem<D>(), stream>>>(
        q_map, k_map, v_map, do_map, static_cast<const float*>(p.lse),
        static_cast<const float*>(p.delta), static_cast<bf16*>(p.dk),
        static_cast<bf16*>(p.dv), geo);
  }
  return cudaGetLastError();
}

// bf16: the three Hopper kernels; fp32: the three FMA kernels. (wgmma's
// fp32 path is TF32, which would round the inputs.)
template <typename T, int D>
cudaError_t launch(Which which, const Ptrs& p, int batch, const Geometry& geo,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const int n_tiles = (geo.t_len + kRows - 1) / kRows;
  const dim3 grid(n_tiles, batch * geo.heads);
  cudaError_t err = cudaSuccess;
  switch (which) {
    case Which::kFwd:
      if constexpr (kBf16) {
        return launch_hopper<D>(which, p, batch, geo, stream);
      } else {
        auto kernel = flash_fwd_kernel<T, D>;
        err = set_smem(kernel, fwd_smem<T, D>());
        if (err != cudaSuccess) return err;
        kernel<<<grid, kThreads, fwd_smem<T, D>(), stream>>>(
            static_cast<const T*>(p.q), static_cast<const T*>(p.k),
            static_cast<const T*>(p.v), static_cast<T*>(p.out),
            static_cast<float*>(p.lse_out), geo);
      }
      break;
    case Which::kDkdv:
      if constexpr (kBf16) {
        return launch_hopper<D>(which, p, batch, geo, stream);
      } else {
        auto kernel = flash_bwd_dkdv_kernel<T, D>;
        err = set_smem(kernel, dkdv_smem<T, D>());
        if (err != cudaSuccess) return err;
        kernel<<<grid, kThreads, dkdv_smem<T, D>(), stream>>>(
            static_cast<const T*>(p.q), static_cast<const T*>(p.k),
            static_cast<const T*>(p.v), static_cast<const T*>(p.dout),
            static_cast<const float*>(p.lse),
            static_cast<const float*>(p.delta), static_cast<T*>(p.dk),
            static_cast<T*>(p.dv), geo);
      }
      break;
    case Which::kDq:
      if constexpr (kBf16) {
        return launch_hopper<D>(which, p, batch, geo, stream);
      } else {
        auto kernel = flash_bwd_dq_kernel<T, D>;
        err = set_smem(kernel, dq_smem<T, D>());
        if (err != cudaSuccess) return err;
        kernel<<<grid, kThreads, dq_smem<T, D>(), stream>>>(
            static_cast<const T*>(p.q), static_cast<const T*>(p.k),
            static_cast<const T*>(p.v), static_cast<const T*>(p.dout),
            static_cast<const float*>(p.lse),
            static_cast<const float*>(p.delta), static_cast<T*>(p.dq), geo);
      }
      break;
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
