// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (launched by `_fwd`) in
// kubeflow_tpu/ops/flash_attention.py. Computes, per (batch, head), the
// causal softmax(q k^T) v with q pre-scaled, and the per-row log-sum-exp
// lse = m + log(den) that the backward kernels recompute probabilities from.
//
// What bounds it on the H100: at the main path's S = 2048, D = 64 the work is
// about 2*B*H*S^2*D FLOPs (two products over the causal half of S^2) against
// 4*B*S*H*D*2 bytes of q, k, v, o: about 500 FLOPs per byte, above the
// card's ~295 FLOP/byte ridge in bf16, so the kernel is compute-bound and its
// floor is the tensor cores' 989 TFLOP/s.
//
// This is the FMA design, for f32 inputs at every head dim and bf16 at
// D in {192, 256}; bf16 at D in {64, 128} (every preset) runs the tensor-core
// kernel of flash_fwd_wgmma.cu instead, chosen by (dtype, D) alone in
// kfx_flash_fwd below. It does not reach that floor. One 256-thread block
// per (64-row Q tile, head, batch) stages Q, then each K/V tile up to the
// diagonal, in shared memory as f32 and runs the online softmax with f32
// running max, denominator and accumulator in registers.
// Both products are plain FMA on the CUDA cores (each thread a 4 x 4 score
// tile and a 4 x D/16 slice of the output), so its ceiling is the f32 FMA
// rate, not the tensor cores'. Tiles above the diagonal are skipped, so the
// work is triangular like the math.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace kfx {

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H) {
  using Tl = Tile<D>;
  constexpr int BLK = Tl::BLK, LD = Tl::LD, LDS = Tl::LDS;
  constexpr int R = Tl::R, C = Tl::C, DC = Tl::DC;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + Tl::TILE;
  float* sV = sK + Tl::TILE;
  float* sP = sV + Tl::TILE;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % TGRID, ty = threadIdx.x / TGRID;
  const size_t head = ((size_t)b * S * H + h) * D;

  load_tile<T, D, BLK>(sQ, q + head, qi * BLK, H);

  float acc[R][DC];
  float m[R], den[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb <= qi; ++kb) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, BLK>(sK, k + head, kb * BLK, H);
    load_tile<T, D, BLK>(sV, v + head, kb * BLK, H);
    __syncthreads();

    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], bk[C];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = sQ[(ty + TGRID * i) * LD + d];
#pragma unroll
      for (int c = 0; c < C; ++c) bk[c] = sK[(tx + TGRID * c) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) s[i][c] = fmaf(a[i], bk[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + TGRID * i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (kb == qi && tx + TGRID * c > row) s[i][c] = NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
        sP[row * LDS + tx + TGRID * c] = s[i][c];
      }
      den[i] = den[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BLK; ++c) {
      float p[R], vv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = sP[(ty + TGRID * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sV[c * LD + tx + TGRID * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = qi * BLK + ty + TGRID * i;
    const float inv = 1.f / den[i];
    T* out = o + head + (size_t)row * H * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[tx + TGRID * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0) lse[((size_t)b * S + row) * H + h] = m[i] + logf(den[i]);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, cudaStream_t stream) {
  using Tl = Tile<D>;
  const size_t smem = (3 * Tl::TILE + Tl::STILE) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / Tl::BLK, H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), S, H);
  return (int)cudaGetLastError();
}

}  // namespace kfx

extern "C" int kfx_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int D,
                             int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kfx::use_wgmma(dtype, D))
    return kfx::flash_fwd_wgmma(q, k, v, o, lse, B, S, H, D, st);
  KFX_DISPATCH(dtype, D,
               (kfx::launch_fwd<T, D>(q, k, v, o, lse, B, S, H, st)));
}

extern "C" const char* kfx_cuda_error_string(int code) {
  if (code >= kfx::hopper::TENSOR_MAP_ERROR)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
