// Hopper (sm_90a) building blocks for the port's hand-written kernels, as
// inline PTX: TMA tile loads into shared memory and the tensor maps that
// describe them, 1-d bulk copies, mbarriers, named barriers, wgmma
// (warpgroup matrix multiply) with its shared-memory descriptors and
// synchronisation, and setmaxnreg. Included by the kernels' sources under
// csrc/ (a build rehashes when it changes).
//
// Tile layout. A [rows, D] bf16 tile of a [B, T, H, D] tensor is loaded
// by TMA as D / (W / 2) column boxes of W bytes a row, W = min(2 D, 128),
// one box after the other in shared memory; inside a box row r sits at
// r * W and its 16-byte chunks are XOR-swizzled by the row (the W-byte
// swizzle mode). That is exactly wgmma's canonical W-byte-swizzled layout,
// both K-major (an operand whose reduction dimension is D: Q, K, V, dO in
// q.k^T-shaped products) and MN-major (an operand whose output dimension
// is D: V in p.V, dO and Q in the gradient products), so a descriptor
// addresses the tile as it landed:
//   K-major:  SBO = 8 W (the next 8 rows); LBO unused; the k-th 16-wide
//             slice of D starts 32 k bytes into its box's rows;
//   MN-major: SBO = 8 W (the next 8 rows of the reduction dimension),
//             LBO = rows * W (the next box of D); the k-th 16-row slice
//             starts 16 k W bytes in.
// Tiles start on 1024-byte boundaries, so the descriptors' base offset is 0.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// after the inits, before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA traffic in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completion is counted on `bar` in bytes.
// Coordinates past the tensor's end read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 1-d bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory; completion is counted on `bar`
// in bytes. One contiguous run, so no tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a barrier among the first kThreads threads of the block (a multiple of
// 32), barrier id kId > 0 (0 is __syncthreads')
template <int kId, int kThreads>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kId), "n"(kThreads) : "memory");
}

// ---------------------------------------------------------------------------
// setmaxnreg: move registers between warpgroups (every warp of the
// warpgroup executes it; the roles must never reconverge afterwards)
// ---------------------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ---------------------------------------------------------------------------
// wgmma: synchronisation and descriptors
// ---------------------------------------------------------------------------

// before a batch of wgmma that reads registers (A fragments, accumulators)
// written by ordinary instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most kPending committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// keep the compiler from moving reads of wgmma-written registers above
// the wait that completes them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// W-byte rows of a tile in shared memory, and the descriptor's layout
// code for that swizzle: 1 = 128 bytes, 2 = 64, 3 = 32
template <int D>
struct Tile {
  static constexpr int kRowBytes = 2 * D < 128 ? 2 * D : 128;   // W
  static constexpr int kBoxCols = kRowBytes / 2;                 // elements
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kSlicesPerBox = kRowBytes / 32;           // k16 slices
  static constexpr uint64_t kMode =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static_assert(D % 16 == 0 && kRowBytes >= 32, "D must be 16, 32, 64, ...");
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (mode << 62);
}

// K-major operand: 16-wide slice k of D, rows [r0, r0 + 8 n) of a tile of
// kRows rows at shared address `tile`
template <int D, int kRows>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int r0,
                                                int k) {
  using T = Tile<D>;
  const uint32_t off = (k / T::kSlicesPerBox) * kRows * T::kRowBytes
                       + r0 * T::kRowBytes + (k % T::kSlicesPerBox) * 32;
  return make_desc(tile + off, 16, 8 * T::kRowBytes, T::kMode);
}

// MN-major operand: rows [16 k, 16 k + 16) of a tile of kRows rows at
// shared address `tile`, all D columns
template <int D, int kRows>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int k) {
  using T = Tile<D>;
  return make_desc(tile + k * 16 * T::kRowBytes, kRows * T::kRowBytes,
                   8 * T::kRowBytes, T::kMode);
}

// The shared address of a resident tile, opaque to the compiler: taken
// inside a loop, it keeps the loop's descriptors from being hoisted out
// of it and held in registers across every iteration (8 of 64 bits a
// tile at D=128)
__device__ __forceinline__ uint32_t opaque_addr(const void* tile) {
  uint32_t addr = smem_addr(tile);
  asm volatile("" : "+r"(addr));
  return addr;
}

// 2^x on the MUFU unit alone (ex2.approx.ftz: relative error about 2^-22,
// results below 2^-126 flush to zero; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 accumulator values -> one bf16x2 register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the 16-wide k slice j of a product from an m64 fp32
// accumulator over that k dimension: its 8-column tiles 2 j and 2 j + 1,
// rounded to bf16. (wgmma's register A fragment for k16 has the layout of
// the accumulator's two 8-column tiles: rows g and g + 8, columns 2 t, 2 t
// + 1 and 8 + 2 t, 9 + 2 t.)
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N], int j,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[8 * j + 0], acc[8 * j + 1]);
  a[1] = pack_bf16(acc[8 * j + 2], acc[8 * j + 3]);
  a[2] = pack_bf16(acc[8 * j + 4], acc[8 * j + 5]);
  a[3] = pack_bf16(acc[8 * j + 6], acc[8 * j + 7]);
}

// ---------------------------------------------------------------------------
// wgmma.mma_async m64nNk16, bf16 inputs, fp32 accumulators. Accumulator
// layout (each of the 4 warps owns 16 rows): thread (warp w, lane = 4 g +
// t) holds d[4 i + {0, 1}] at row 16 w + g, columns 8 i + 2 t + {0, 1},
// and d[4 i + {2, 3}] at row 16 w + g + 8. `accumulate` 0 overwrites d.
// ---------------------------------------------------------------------------

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D (+)= A * B, A from registers (the m64k16 fragment), B from shared
  // memory
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(kTransB)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  // D (+)= A * B, A from registers (the m64k16 fragment), B from shared
  // memory
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(kTransB)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  // D (+)= A * B, A and B from shared memory (descriptors); kTransA,
  // kTransB: 0 = K-major, 1 = MN-major
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB)
        : "memory");
  }
  // D (+)= A * B, A from registers (the m64k16 fragment), B from shared
  // memory
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(kTransB)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  // D (+)= A * B, A and B from shared memory (descriptors); kTransA,
  // kTransB: 0 = K-major, 1 = MN-major
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB)
        : "memory");
  }
  // D (+)= A * B, A from registers (the m64k16 fragment), B from shared
  // memory
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(kTransB)
        : "memory");
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the CUDA
// runtime (so the library needs no -lcuda); null if it is missing
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map of a [B, T, H, D] bf16 tensor: dims {D, H, T, B}, box {W / 2,
// 1, box_rows, 1} (one column box of box_rows tokens of one head), the
// W-byte swizzle, zeros past the end. False if the encoding is refused.
template <int D>
bool encode_bthd(CUtensorMap* map, const void* base, int batch, int t_len,
                 int heads, int box_rows) {
  using T = Tile<D>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * t_len};
  const cuuint32_t box[4] = {(cuuint32_t)T::kBoxCols, 1u,
                             (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
