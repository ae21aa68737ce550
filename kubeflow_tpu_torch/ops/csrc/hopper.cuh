// Hopper building blocks shared by the wgmma kernels (flash_fwd_wgmma.cu,
// flash_dq_wgmma.cu, flash_dkv_wgmma.cu): TMA tensor maps and loads,
// mbarriers, and the warpgroup matrix multiply (wgmma) with its
// shared-memory descriptors.
//
// Shared-memory tiles: every bf16 operand tile is what one TMA box of
// 64 columns (128 bytes) by R rows writes with CU_TENSOR_MAP_SWIZZLE_128B:
// R rows of 128 bytes, the 16-byte chunks of row r XOR-permuted by r % 8.
// A row of D = 128 columns is two such boxes, stored one after the other
// (R * 128 bytes apart). Tiles start on 1024-byte boundaries, so the
// swizzle pattern lines up with the one the wgmma descriptors assume
// (base offset 0).
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"; the same fields as
// CUTLASS's GmmaDescriptor): bits 0-13 start address >> 4, 16-29 leading
// byte offset >> 4, 32-45 stride byte offset >> 4, 62-63 layout
// (1 = 128-byte swizzle).
//   K-major (the contraction dim contiguous, as q, k, v, dO rows are when
//   the contraction runs over D): 8-row groups 1024 bytes apart (SBO); a
//   16-wide k step moves the start address by 32 bytes inside the swizzled
//   row; LBO is unused (1).
//   MN-major (the output dim contiguous, as v, k, q and dO are when the
//   contraction runs over rows): 8-row groups of the contraction dim 1024
//   bytes apart (SBO); the next 64 output columns are the next box (LBO);
//   a 16-wide k step moves the start address by 16 rows, 2048 bytes.
//
// Accumulator layout of a m64nNk16 product with f32 D: thread t of the
// warpgroup (warp w = t / 32, lane l = t % 32) holds d[i] at row
// 16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.
// Columns 16 s .. 16 s + 15 of it, packed to bf16 pairs (d[8s], d[8s+1]),
// (d[8s+2], d[8s+3]), (d[8s+4], d[8s+5]), (d[8s+6], d[8s+7]), are exactly the
// register A fragment of a k16 step s, so a product's output feeds the next
// product without a trip through shared memory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kfx {
namespace hopper {

// Error codes above this are a failed cuTensorMapEncodeTiled (CUresult
// added to it); below it they are cudaError_t.
constexpr int TENSOR_MAP_ERROR = 10000;

// ---------------------------------------------------------------------------
// Host: a TMA tensor map over a contiguous bf16 [B, S, H, D] tensor
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, fetched once through the
// runtime, so the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map with dims (D, H, S, B), innermost first, so a box of
// (64, 1, rows, 1) at (d0, h, s0, b) is rows s0 .. s0 + rows - 1 of head h,
// columns d0 .. d0 + 63, with no transpose. Rows at or past S read as zeros.
inline int make_bshd_map(CUtensorMap* map, const void* ptr, int B, int S,
                         int H, int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase with this parity has completed. A wait
// that outlasts ~2^34 clocks (seconds; a lost TMA transaction or a
// mismatched arrival count) traps, so the launch fails instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One TMA box of `map` at (c0, c1, c2, c3) into shared memory at `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The same rows (r0 .. r0 + rows - 1 of head h, batch b) of two [B, S, H, D]
// tensors into the tiles at `dst_x` and `dst_y`, each D / 64 boxes of
// `box_bytes` (rows * 128), both completing on `bar`, which is told their
// byte count. Issued by one thread.
template <int D>
__device__ __forceinline__ void tma_load_pair(const CUtensorMap* x,
                                              uint32_t dst_x,
                                              const CUtensorMap* y,
                                              uint32_t dst_y, uint64_t* bar,
                                              uint32_t box_bytes, int h,
                                              int r0, int b) {
  mbar_expect_tx(bar, 2 * (D / 64) * box_bytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load_4d(dst_x + c * box_bytes, x, bar, c * 64, h, r0, b);
    tma_load_4d(dst_y + c * box_bytes, y, bar, c * 64, h, r0, b);
  }
}

// Barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is
// __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand tile (rows x 64-column boxes, 128-byte swizzle) at
// `addr`, 16-wide k step `k`; `box_bytes` is one box (rows * 128).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int k,
                                           uint32_t box_bytes) {
  return desc(addr + (k / 4) * box_bytes + (k % 4) * 32, 16, 1024);
}

// MN-major operand tile: contraction rows 16 k .. 16 k + 15 of a tile whose
// 64-column boxes are `box_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int k,
                                            uint32_t box_bytes) {
  return desc(addr + k * 16 * 128, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins accumulator registers at this point of the program, so the compiler
// neither reads them before a wgmma_wait nor moves writes past a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (MUFU.EX2); the kernels keep exponents in log2 units, so exp(s - m)
// is one FFMA and one ex2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16 bf16 x bf16 -> f32 products, N = 64 or 128.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D[64 x 64] = A[64 x 16] B[16 x 64] (+ D when scale_d != 0); A and B
  // K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers (four bf16 pairs
  // a thread, the layout of a m64nNk16 accumulator), B MN-major in shared
  // memory.
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] = A[64 x 16] B[16 x 128] (+ D when scale_d != 0); A and B
  // K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // D[64 x 128] += A[64 x 16] B[16 x 128]; A in registers (four bf16 pairs
  // a thread, the layout of a m64nNk16 accumulator), B MN-major in shared
  // memory.
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

}  // namespace hopper

// The design rule, the same as design() in ops/flash_attention.py: bf16
// (dtype code 1) at head dim 64 or 128 runs the wgmma kernels; everything
// else the FMA kernels.
inline bool use_wgmma(int dtype, int D) {
  return dtype == 1 && (D == 64 || D == 128);
}

// flash_fwd_wgmma.cu, flash_dq_wgmma.cu, flash_dkv_wgmma.cu: bf16 tensors,
// D in {64, 128}; return 0 or a CUDA error (or TENSOR_MAP_ERROR + CUresult).
int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int S, int H, int D,
                    cudaStream_t stream);
int flash_dq_wgmma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int S, int H, int D, cudaStream_t stream);
int flash_dkv_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int H, int D,
                    cudaStream_t stream);

}  // namespace kfx
