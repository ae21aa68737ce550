// Causal flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` (both
// launched by `_bwd`) in kubeflow_tpu/ops/flash_attention.py. As there, the
// probabilities are recomputed from (q, k, lse) instead of stored:
// p = exp(q k^T - lse), ds = p * (dO v^T - delta), and
//   dQ kernel:    dQ = sum over K tiles up to the diagonal of ds k,
//   dK/dV kernel: dV = sum over Q tiles from the diagonal down of p^T dO,
//                 dK = the same sum of ds^T q,
// where delta = rowsum(dO * O) comes from a plain torch op outside.
//
// What bounds them on the H100: at the main path's S = 2048, D = 64 the dQ
// kernel does three products and the dK/dV kernel four over the causal half
// of S^2 (about 3*B*H*S^2*D and 4*B*H*S^2*D FLOPs) against 5 and 6 tensors of
// B*S*H*D elements moved: several hundred FLOPs per byte, so both are
// compute-bound, and their floor is the tensor cores' 989 TFLOP/s in bf16.
//
// This first design is the simple, right one and does not reach that floor:
// the TPU kernels kept whole K/V (or Q/dO) rows of one head in VMEM, which
// does not fit in an SM's shared memory, so here each 256-thread block owns
// one 64-row tile (32 rows above D = 128) and streams the other operand's
// tiles through shared memory as f32. The products are plain FMA on the CUDA
// cores, so the f32 FMA rate is the ceiling; wgmma and TMA come later
// (ROADMAP). Tiles on the far side of the diagonal are skipped.

#include "flash_common.cuh"

namespace kfx {

// One block per (Q tile, head, batch); loops over K/V tiles 0..qi.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int S, int H) {
  using Tl = Tile<D>;
  constexpr int BLK = Tl::BLK, LD = Tl::LD, LDS = Tl::LDS;
  constexpr int R = Tl::R, C = Tl::C, DC = Tl::DC;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + Tl::TILE;
  float* sK = sDO + Tl::TILE;
  float* sV = sK + Tl::TILE;
  float* sDS = sV + Tl::TILE;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % TGRID, ty = threadIdx.x / TGRID;
  const size_t head = ((size_t)b * S * H + h) * D;

  load_tile<T, D, BLK>(sQ, q + head, qi * BLK, H);
  load_tile<T, D, BLK>(sDO, dout + head, qi * BLK, H);

  float row_lse[R], row_delta[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t at = ((size_t)b * S + qi * BLK + ty + TGRID * i) * H + h;
    row_lse[i] = lse[at];
    row_delta[i] = delta[at];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb <= qi; ++kb) {
    __syncthreads();
    load_tile<T, D, BLK>(sK, k + head, kb * BLK, H);
    load_tile<T, D, BLK>(sV, v + head, kb * BLK, H);
    __syncthreads();

    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], g[R], bk[C], bv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = sQ[(ty + TGRID * i) * LD + d];
        g[i] = sDO[(ty + TGRID * i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        bk[c] = sK[(tx + TGRID * c) * LD + d];
        bv[c] = sV[(tx + TGRID * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[i][c] = fmaf(a[i], bk[c], s[i][c]);
          dp[i][c] = fmaf(g[i], bv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + TGRID * i;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tx + TGRID * c;
        const float p = (kb == qi && col > row)
                            ? 0.f : expf(s[i][c] - row_lse[i]);
        sDS[row * LDS + col] = p * (dp[i][c] - row_delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BLK; ++c) {
      float ds[R], kk[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = sDS[(ty + TGRID * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kk[j] = sK[c * LD + tx + TGRID * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    T* out = dq + head + (size_t)(qi * BLK + ty + TGRID * i) * H * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) out[tx + TGRID * j] = from_f32<T>(acc[i][j]);
  }
}

// One block per (K tile, head, batch); loops over Q tiles ki..S/BLK-1. In the
// per-thread score tile, rows are keys (ty) and columns are queries (tx), so
// the tile is the transpose p^T that both dV and dK consume.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int H) {
  using Tl = Tile<D>;
  constexpr int BLK = Tl::BLK, LD = Tl::LD, LDS = Tl::LDS;
  constexpr int R = Tl::R, C = Tl::C, DC = Tl::DC;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + Tl::TILE;
  float* sQ = sV + Tl::TILE;
  float* sDO = sQ + Tl::TILE;
  float* sPt = sDO + Tl::TILE;
  float* sDSt = sPt + Tl::STILE;
  float* sLse = sDSt + Tl::STILE;
  float* sDelta = sLse + BLK;

  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % TGRID, ty = threadIdx.x / TGRID;
  const size_t head = ((size_t)b * S * H + h) * D;
  const int n_blocks = S / BLK;

  load_tile<T, D, BLK>(sK, k + head, ki * BLK, H);
  load_tile<T, D, BLK>(sV, v + head, ki * BLK, H);

  float acc_k[R][DC], acc_v[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int qb = ki; qb < n_blocks; ++qb) {
    __syncthreads();
    load_tile<T, D, BLK>(sQ, q + head, qb * BLK, H);
    load_tile<T, D, BLK>(sDO, dout + head, qb * BLK, H);
    for (int r = threadIdx.x; r < BLK; r += NTHREADS) {
      const size_t at = ((size_t)b * S + qb * BLK + r) * H + h;
      sLse[r] = lse[at];
      sDelta[r] = delta[at];
    }
    __syncthreads();

    float st[R][C], dpt[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[R], vv[R], qq[C], gg[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kk[i] = sK[(ty + TGRID * i) * LD + d];
        vv[i] = sV[(ty + TGRID * i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        qq[c] = sQ[(tx + TGRID * c) * LD + d];
        gg[c] = sDO[(tx + TGRID * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          st[i][c] = fmaf(kk[i], qq[c], st[i][c]);
          dpt[i][c] = fmaf(vv[i], gg[c], dpt[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = ty + TGRID * i;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int qrow = tx + TGRID * c;
        const float p = (qb == ki && qrow < key)
                            ? 0.f : expf(st[i][c] - sLse[qrow]);
        sPt[key * LDS + qrow] = p;
        sDSt[key * LDS + qrow] = p * (dpt[i][c] - sDelta[qrow]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BLK; ++c) {
      float p[R], ds[R], g[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p[i] = sPt[(ty + TGRID * i) * LDS + c];
        ds[i] = sDSt[(ty + TGRID * i) * LDS + c];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        g[j] = sDO[c * LD + tx + TGRID * j];
        qv[j] = sQ[c * LD + tx + TGRID * j];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          acc_v[i][j] = fmaf(p[i], g[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t row = (size_t)(ki * BLK + ty + TGRID * i) * H * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[head + row + tx + TGRID * j] = from_f32<T>(acc_k[i][j]);
      dv[head + row + tx + TGRID * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, cudaStream_t stream) {
  using Tl = Tile<D>;
  const size_t smem = (4 * Tl::TILE + Tl::STILE) * sizeof(float);
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / Tl::BLK, H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, H);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int H, cudaStream_t stream) {
  using Tl = Tile<D>;
  const size_t smem =
      (4 * Tl::TILE + 2 * Tl::STILE + 2 * Tl::BLK) * sizeof(float);
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / Tl::BLK, H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H);
  return (int)cudaGetLastError();
}

}  // namespace kfx

extern "C" int kfx_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int S, int H,
                            int D, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KFX_DISPATCH(dtype, D, (kfx::launch_dq<T, D>(q, k, v, dout, lse, delta, dq,
                                                B, S, H, st)));
}

extern "C" int kfx_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int H, int D, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KFX_DISPATCH(dtype, D, (kfx::launch_dkv<T, D>(q, k, v, dout, lse, delta,
                                                 dk, dv, B, S, H, st)));
}
