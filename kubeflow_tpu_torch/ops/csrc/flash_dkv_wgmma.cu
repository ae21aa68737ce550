// Causal flash-attention dK/dV kernel for Hopper (sm_90a) on the tensor
// cores: bf16 at head dim 64 and 128.
//
// Replaces the Pallas TPU kernel `_dkv_kernel`
// (kubeflow_tpu/ops/flash_attention.py:158) for bf16 inputs at D in
// {64, 128}. Same function as flash_dkv_kernel in flash_bwd.cu: per K tile,
// over the Q tiles from the diagonal down, p = exp(q k^T - lse) (masked to 0
// where query < key), dV += p^T dO and dK += ds^T q with
// ds = p * (dO v^T - delta).
//
// What bounds it on the H100: four products, about 8 D FLOPs per (query,
// key) pair over the causal half of S^2, against q, k, v, dO, lse, delta read
// once and dk, dv written once. At S = 2048, D = 64 that is several hundred
// FLOP per byte: compute-bound, with a floor at the tensor cores' 989
// TFLOP/s in bf16.
//
// What the design does about it: all four products run on wgmma (bf16
// operands, f32 accumulators). Products of bf16 numbers are exact in f32, so
// k q^T and v dO^T match the reference up to summation order; the new
// roundings are p^T and ds^T to bf16 before the dV and dK products, as in
// FlashAttention-2/3.
// - One 256-thread block per (128-row K tile, head, batch): two warpgroups of
//   64 keys each. K and V stay in shared memory, loaded once by TMA.
// - Q and dO tiles of 64 rows stream through a ring of STAGES slots filled by
//   TMA (thread 0 issues; a "full" mbarrier per slot with its byte count, an
//   "empty" one counting the eight warps done with it), from the diagonal
//   down, as in the reference. The load of tile t + STAGES - 1 is in flight
//   while tile t is computed. lse and delta are per column (query) here: each
//   warpgroup stages a tile's 64 + 64 values in shared memory (one value a
//   thread, loaded from device memory one tile ahead) and each thread reads
//   its columns from there.
// - The products keep the FMA kernel's transposed form, so the M dimension
//   of each is the warpgroup's 64 keys: S^T = K Q^T and dP^T = V dO^T are
//   m64n64k16 with both operands in shared memory (K-major, issued
//   together); P^T and dS^T come out in the accumulator layout, which
//   packed to bf16 pairs is the register A operand of dV += P^T dO and
//   dK += dS^T Q (m64nDk16, dO and Q the MN-major B operand as stored).
// - Registers are the constraint: dK and dV take 2 x D/2 f32 a thread, S^T
//   and dP^T 2 x 32 more; 64-row Q tiles keep D = 128 within 255 registers
//   (the build log's ptxas report shows no spills).
// - Blocks of the heaviest K tiles (near the start of the sequence) launch
//   first. dK and dV are written once from registers: no atomics, so results
//   are the same run to run. When S % 128 == 64 the last K tile's second
//   warpgroup lies past S: TMA reads zeros, every query masks those keys, and
//   they are not stored.
// Not done yet (later work): warp specialisation with setmaxnreg, overlapping
// the elementwise work with the next products, persistent blocks.
//
// f32 inputs (every D) and bf16 at D in {192, 256} keep the FMA design of
// flash_bwd.cu: f32 on wgmma would be TF32, which cannot hold the f32
// instantiations' 1e-4 bound, and no preset uses D > 128.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace kfx {
namespace {

using namespace hopper;

constexpr int DKV_THREADS = 256;
constexpr int DKV_BK = 128;  // keys per block
constexpr int DKV_BQ = 64;   // query rows per ring slot
constexpr int DKV_STAGES = 3;

template <int D>
struct DkvCfg {
  static constexpr uint32_t KV_BYTES = DKV_BK * D * 2;  // K or V
  static constexpr uint32_t KV_BOX = DKV_BK * 128;
  static constexpr uint32_t Q_BYTES = DKV_BQ * D * 2;   // one Q or dO tile
  static constexpr uint32_t Q_BOX = DKV_BQ * 128;
  // K, V, then DKV_STAGES Q slots, then DKV_STAGES dO slots; 1024 bytes of
  // slack to align the start.
  static constexpr size_t SMEM = 2 * KV_BYTES + 2 * DKV_STAGES * Q_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int S, int H) {
  using C = DkvCfg<D>;
  constexpr int STAGES = DKV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  // [warpgroup][tile parity][lse 0..63, delta 64..127]
  __shared__ __align__(16) float s_ld[2][2][2 * DKV_BQ];

  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t sQ = sV + C::KV_BYTES;
  const uint32_t sDO = sQ + STAGES * C::Q_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * DKV_BK;  // heaviest tiles (near 0) first
  const int first = k0 / DKV_BQ;       // the diagonal Q tile
  const int count = S / DKV_BQ - first;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int tl = tid % 128;
  // Thread 0 fills ring slot t % STAGES with the Q and dO tiles t places
  // below the diagonal.
  auto issue_q = [&](int t) {
    const int slot = t % STAGES;
    tma_load_pair<D>(&tq, sQ + slot * C::Q_BYTES, &tdo,
                     sDO + slot * C::Q_BYTES, &full[slot], C::Q_BOX, h,
                     (first + t) * DKV_BQ, b);
  };

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DKV_THREADS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid == 0) {
    tma_load_pair<D>(&tk, sK, &tv, sV, &bar_kv, C::KV_BOX, h, k0, b);
    for (int t = 0; t < STAGES - 1 && t < count; ++t) issue_q(t);
  }
  __syncwarp();

  float acc_dk[D / 2], acc_dv[D / 2];
  float st[DKV_BQ / 2], dpt[DKV_BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DKV_BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  // Keys of this thread: key_lo and key_lo + 8.
  const int key_lo = k0 + 64 * wg + 16 * warp + lane / 4;
  const uint32_t sK_wg = sK + wg * 64 * 128;  // this warpgroup's 64 keys
  const uint32_t sV_wg = sV + wg * 64 * 128;
  // This thread stages one value a tile: lse in log2 units (tl < 64) or
  // delta, of query row tl % 64.
  const float* vec = tl < DKV_BQ ? lse : delta;
  const float scale = tl < DKV_BQ ? LOG2E : 1.f;
  const size_t vec_at = ((size_t)b * S + tl % DKV_BQ) * H + h;
  const size_t vec_step = (size_t)DKV_BQ * H;  // one Q tile further
  float staged = vec[vec_at + first * vec_step] * scale;

  mbar_wait(&bar_kv, 0);
  __syncwarp();

  for (int t = 0; t < count; ++t) {
    const int q0 = (first + t) * DKV_BQ;
    if (tid == 0) {
      const int tt = t + STAGES - 1;
      if (tt < count) {
        // The slot last held tile tt - STAGES; wait until all warps are done.
        if (tt >= STAGES) mbar_wait(&empty[tt % STAGES], (tt / STAGES - 1) & 1);
        issue_q(tt);
      }
    }
    __syncwarp();  // warp 0 whole again before the .aligned ops

    // Stage this tile's lse and delta; prefetch the next tile's.
    const float* ld = s_ld[wg][t & 1];
    s_ld[wg][t & 1][tl] = staged;
    warpgroup_sync(1 + wg);
    if (t + 1 < count)
      staged = vec[vec_at + (first + t + 1) * vec_step] * scale;

    const int slot = t % STAGES;
    const uint32_t q_tile = sQ + slot * C::Q_BYTES;
    const uint32_t do_tile = sDO + slot * C::Q_BYTES;
    mbar_wait(&full[slot], (t / STAGES) & 1);
    __syncwarp();

    // S^T = K Q^T and dP^T = V dO^T, two commit groups.
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<DKV_BQ>::ss(st, desc_k(sK_wg, k, C::KV_BOX),
                        desc_k(q_tile, k, C::Q_BOX), k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<DKV_BQ>::ss(dpt, desc_k(sV_wg, k, C::KV_BOX),
                        desc_k(do_tile, k, C::Q_BOX), k > 0);
    wgmma_commit();

    // P^T = exp(S^T - lse[query]), 0 where query < key.
    wgmma_wait<1>();
    fence_regs(st);
    const bool diag = q0 < k0 + 64 * wg + 64;  // some query precedes a key
#pragma unroll
    for (int i = 0; i < DKV_BQ / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const int key = key_lo + 8 * ((i / 2) % 2);
      const float p = ex2(fmaf(st[i], LOG2E, -ld[col]));
      st[i] = (diag && q0 + col < key) ? 0.f : p;
    }
    uint32_t pa[DKV_BQ / 16][4];
#pragma unroll
    for (int k = 0; k < DKV_BQ / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[k][r] = pack_bf16(st[8 * k + 2 * r], st[8 * k + 2 * r + 1]);

    // dS^T = P^T * (dP^T - delta[query]).
    wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t dsa[DKV_BQ / 16][4];
#pragma unroll
    for (int i = 0; i < DKV_BQ / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      dpt[i] = st[i] * (dpt[i] - ld[DKV_BQ + col]);
    }
#pragma unroll
    for (int k = 0; k < DKV_BQ / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dsa[k][r] = pack_bf16(dpt[8 * k + 2 * r], dpt[8 * k + 2 * r + 1]);

    // dV += P^T dO, dK += dS^T Q.
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DKV_BQ / 16; ++k)
      Wgmma<D>::rs(acc_dv, pa[k], desc_mn(do_tile, k, C::Q_BOX));
#pragma unroll
    for (int k = 0; k < DKV_BQ / 16; ++k)
      Wgmma<D>::rs(acc_dk, dsa[k], desc_mn(q_tile, k, C::Q_BOX));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // Epilogue: dK and dV rows of this thread to bf16; keys past S are not
  // stored.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key_lo + 8 * hh;
    if (key >= S) continue;
    const size_t at = (((size_t)b * S + key) * H + h) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int col = 8 * g + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(dk + at + col) =
          pack_bf16(acc_dk[4 * g + 2 * hh], acc_dk[4 * g + 2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + col) =
          pack_bf16(acc_dv[4 * g + 2 * hh], acc_dv[4 * g + 2 * hh + 1]);
    }
  }
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int S, int H,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map(&tq, q, B, S, H, D, DKV_BQ);
  if (!err) err = make_bshd_map(&tdo, dout, B, S, H, D, DKV_BQ);
  if (!err) err = make_bshd_map(&tk, k, B, S, H, D, DKV_BK);
  if (!err) err = make_bshd_map(&tv, v, B, S, H, D, DKV_BK);
  if (err) return err;
  auto kernel = flash_dkv_wgmma_kernel<D>;
  cudaError_t e = prepare(kernel, DkvCfg<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (S + DKV_BK - 1) / DKV_BK);
  kernel<<<grid, DKV_THREADS, DkvCfg<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_dkv_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int H, int D,
                    cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                  stream);
    case 128:
      return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                   H, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace kfx
