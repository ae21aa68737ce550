// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: every [B, S, H, D] tensor is contiguous, so row s of head h of
// batch b starts at ((b*S + s)*H + h)*D; per-row f32 vectors (lse, delta)
// are [B, S, H, 1] and sit at (b*S + s)*H + h.
//
// Thread layout, all three kernels: 256 threads as a 16 x 16 grid
// (ty = tid / 16, tx = tid % 16). A BLK x BLK score tile gives each thread
// rows ty + 16*i and columns tx + 16*c; a BLK x D accumulator gives it rows
// ty + 16*i and columns tx + 16*j. Row reductions run over the 16 lanes that
// share a ty, which are 16 consecutive lanes of one warp (shfl_xor 8..1).
// Shared-memory tiles hold f32 with a row stride of D + 1, so the 16 rows
// that a warp reads at one column fall in 16 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace kfx {

constexpr float NEG_INF = -1e30f;  // as the reference: finite, never -inf
constexpr int NTHREADS = 256;
constexpr int TGRID = 16;

// Rows per tile: 64 while three or four f32 tiles of D + 1 floats fit in
// shared memory next to the score tiles, 32 above D = 128.
template <int D>
struct Tile {
  static constexpr int BLK = D <= 128 ? 64 : 32;
  static constexpr int LD = D + 1;      // padded row stride of a [BLK][D] tile
  static constexpr int LDS = BLK + 1;   // padded row stride of a score tile
  static constexpr int R = BLK / TGRID;   // tile rows per thread
  static constexpr int C = BLK / TGRID;   // score columns per thread
  static constexpr int DC = D / TGRID;    // accumulator columns per thread
  static constexpr int TILE = BLK * LD;   // floats in one [BLK][D] tile
  static constexpr int STILE = BLK * LDS; // floats in one score tile
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + BLK) of one head into a padded f32 tile. `head` points
// at x[b, 0, h, 0]; consecutive rows are H*D elements apart.
template <typename T, int D, int BLK>
__device__ __forceinline__ void load_tile(float* tile, const T* head,
                                          int row0, int H) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < BLK * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    tile[r * LD + c] = to_f32(head[(size_t)(row0 + r) * H * D + c]);
  }
}

// Sum and max over the 16 lanes that share one tile row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
}

}  // namespace kfx

// Dispatch on the dtype code (0 = float32, 1 = bfloat16) and on the head
// dim, for the D values supported() admits up to 256.
#define KFX_DISPATCH(DTYPE, HEAD_DIM, LAUNCH)                       \
  do {                                                              \
    if ((DTYPE) == 0) {                                             \
      using T = float;                                              \
      switch (HEAD_DIM) {                                           \
        case 64: { constexpr int D = 64; return LAUNCH; }           \
        case 128: { constexpr int D = 128; return LAUNCH; }         \
        case 192: { constexpr int D = 192; return LAUNCH; }         \
        case 256: { constexpr int D = 256; return LAUNCH; }         \
      }                                                             \
    } else if ((DTYPE) == 1) {                                      \
      using T = __nv_bfloat16;                                      \
      switch (HEAD_DIM) {                                           \
        case 64: { constexpr int D = 64; return LAUNCH; }           \
        case 128: { constexpr int D = 128; return LAUNCH; }         \
        case 192: { constexpr int D = 192; return LAUNCH; }         \
        case 256: { constexpr int D = 256; return LAUNCH; }         \
      }                                                             \
    }                                                               \
    return (int)cudaErrorInvalidValue;                              \
  } while (0)
