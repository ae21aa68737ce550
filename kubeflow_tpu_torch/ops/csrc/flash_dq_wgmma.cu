// Causal flash-attention dQ kernel for Hopper (sm_90a) on the tensor cores:
// bf16 at head dim 64 and 128.
//
// Replaces the Pallas TPU kernel `_dq_kernel`
// (kubeflow_tpu/ops/flash_attention.py:127) for bf16 inputs at D in
// {64, 128}. Same function as flash_dq_kernel in flash_bwd.cu: per Q tile,
// over the K tiles up to the diagonal, p = exp(q k^T - lse) (masked to 0
// where key > query), ds = p * (dO v^T - delta) and dQ += ds k.
//
// What bounds it on the H100: three products, about 6 D FLOPs per (query,
// key) pair over the causal half of S^2, against q, k, v, dO, lse, delta
// read once and dq written once. At S = 2048, D = 64 that is several hundred
// FLOP per byte: compute-bound, with a floor at the tensor cores' 989 TFLOP/s
// in bf16.
//
// What the design does about it: all three products run on wgmma (bf16
// operands, f32 accumulators). Products of bf16 numbers are exact in f32, so
// q k^T and dO v^T match the reference up to summation order; the one new
// rounding is dS to bf16 before dS K, as in FlashAttention-2/3. The loop
// has the forward's shape (flash_fwd_wgmma.cu):
// - One 256-thread block per (128-row Q tile, head, batch): two warpgroups of
//   64 query rows each. Q and dO are loaded once by TMA and stay in shared
//   memory; each thread keeps the lse (in log2 units) and delta of its two
//   rows in registers, loaded once.
// - K and V tiles of 64 keys stream through a ring of three shared-memory
//   slots, filled by TMA (thread 0 issues each load; a "full" mbarrier per
//   slot with its byte count, an "empty" one counting the eight warps done
//   with it). The loads of tiles j + 1 and j + 2 are in flight while tile j
//   is computed. A warpgroup stops at its own diagonal tile, so warpgroup 0
//   skips the block's last tile, which would be all masked for it.
// - S = Q K^T and dP = dO V^T are m64n64k16 with both operands in shared
//   memory (K-major), issued as two commit groups, so P = exp2(S log2e -
//   lse log2e) is computed while dP's product runs. Only a warpgroup's
//   diagonal tile is masked.
// - dS = P * (dP - delta) comes out in the accumulator layout; packed to
//   bf16 pairs it is the register A operand of dQ += dS K (m64nDk16), K the
//   MN-major B operand as stored. Nothing but the TMA tiles goes through
//   shared memory.
// - Registers: S and dP take 32 f32 a thread each, dQ D / 2, packed dS 16.
//   At D = 64 that keeps a thread within 128 registers, so two blocks (80 KB
//   of shared memory each) share an SM; D = 128 runs one block (160 KB).
// - Blocks of the heaviest Q tiles (nearest the end of the sequence) launch
//   first. dQ is written once from registers: no atomics, so results are the
//   same run to run. When S % 128 == 64 the last Q tile's second half lies
//   past S: TMA reads those rows of Q and dO as zeros, their lse and delta
//   are taken as 0 (the [B, S, H, 1] vectors end at S), and they are not
//   stored.
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

constexpr int DQ_THREADS = 256;
constexpr int DQ_BQ = 128;    // query rows per block
constexpr int DQ_BK = 64;     // keys per ring slot
constexpr int DQ_STAGES = 3;

template <int D>
struct DqCfg {
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;  // blocks per SM
  static constexpr uint32_t Q_BYTES = DQ_BQ * D * 2;   // Q or dO
  static constexpr uint32_t Q_BOX = DQ_BQ * 128;       // one 64-col box
  static constexpr uint32_t KV_BYTES = DQ_BK * D * 2;  // one K or V tile
  static constexpr uint32_t KV_BOX = DQ_BK * 128;
  // Q, dO, then DQ_STAGES K slots, then DQ_STAGES V slots; 1024 bytes of
  // slack to align the start.
  static constexpr size_t SMEM = 2 * Q_BYTES + 2 * DQ_STAGES * KV_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, DqCfg<D>::MIN_BLOCKS)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int S, int H) {
  using C = DqCfg<D>;
  constexpr int STAGES = DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + C::Q_BYTES;
  const uint32_t sK = sDO + C::Q_BYTES;
  const uint32_t sV = sK + STAGES * C::KV_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int q0 = qi * DQ_BQ;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // K tiles up to the diagonal: the block's (warpgroup 1's) and this
  // warpgroup's. Warpgroup 0 stops one tile early; the producer never waits
  // to refill the last tile's slot, so its missing arrivals hold up nothing.
  const int n_kv = (q0 + DQ_BQ) / DQ_BK;
  const int n_wg = (q0 + 64 * wg + 64) / DQ_BK;
  // Thread 0 fills ring slot t % STAGES with K and V tile t.
  auto issue_kv = [&](int t) {
    const int slot = t % STAGES;
    tma_load_pair<D>(&tk, sK + slot * C::KV_BYTES, &tv,
                     sV + slot * C::KV_BYTES, &full[slot], C::KV_BOX, h,
                     t * DQ_BK, b);
  };

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DQ_THREADS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid == 0) {
    tma_load_pair<D>(&tq, sQ, &tdo, sDO, &bar_q, C::Q_BOX, h, q0, b);
    for (int t = 0; t < STAGES - 1 && t < n_kv; ++t) issue_kv(t);
  }
  __syncwarp();

  float acc[D / 2];
  float s[DQ_BK / 2], dp[DQ_BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DQ_BK / 2; ++i) s[i] = dp[i] = 0.f;
  // Query rows of this thread: q0 + r_lo and q0 + r_lo + 8, with their lse
  // in log2 units and delta; rows past S read as 0.
  const int r_lo = 64 * wg + 16 * warp + lane / 4;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r_lo + 8 * hh;
    const size_t at = ((size_t)b * S + row) * H + h;
    lse2[hh] = row < S ? lse[at] * LOG2E : 0.f;
    dlt[hh] = row < S ? delta[at] : 0.f;
  }
  const uint32_t sQ_wg = sQ + wg * 64 * 128;  // this warpgroup's 64 rows
  const uint32_t sDO_wg = sDO + wg * 64 * 128;

  mbar_wait(&bar_q, 0);
  __syncwarp();

  for (int j = 0; j < n_wg; ++j) {
    if (tid == 0) {
      const int t = j + STAGES - 1;
      if (t < n_kv) {
        // The slot last held tile t - STAGES; wait until all warps are done.
        if (t >= STAGES) mbar_wait(&empty[t % STAGES], (t / STAGES - 1) & 1);
        issue_kv(t);
      }
    }
    __syncwarp();  // warp 0 whole again before the .aligned wgmma ops
    const int slot = j % STAGES;
    const uint32_t k_tile = sK + slot * C::KV_BYTES;
    const uint32_t v_tile = sV + slot * C::KV_BYTES;
    mbar_wait(&full[slot], (j / STAGES) & 1);
    __syncwarp();

    // S = Q K^T and dP = dO V^T, two commit groups.
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<DQ_BK>::ss(s, desc_k(sQ_wg, k, C::Q_BOX),
                       desc_k(k_tile, k, C::KV_BOX), k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<DQ_BK>::ss(dp, desc_k(sDO_wg, k, C::Q_BOX),
                       desc_k(v_tile, k, C::KV_BOX), k > 0);
    wgmma_commit();

    // P = exp(S - lse), 0 where key > query on this warpgroup's diagonal
    // tile; hh = 0 is row r_lo, 1 is r_lo + 8.
    wgmma_wait<1>();
    fence_regs(s);
    const bool diag = j == n_wg - 1;
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i) {
      const int hh = (i / 2) % 2;
      const int key = j * DQ_BK + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const float p = ex2(fmaf(s[i], LOG2E, -lse2[hh]));
      s[i] = (diag && key > q0 + r_lo + 8 * hh) ? 0.f : p;
    }

    // dS = P * (dP - delta), as bf16 A fragments, one per 16 keys.
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t dsa[DQ_BK / 16][4];
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i)
      dp[i] = s[i] * (dp[i] - dlt[(i / 2) % 2]);
#pragma unroll
    for (int k = 0; k < DQ_BK / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dsa[k][r] = pack_bf16(dp[8 * k + 2 * r], dp[8 * k + 2 * r + 1]);

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DQ_BK / 16; ++k)
      Wgmma<D>::rs(acc, dsa[k], desc_mn(k_tile, k, C::KV_BOX));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // Epilogue: dQ rows of this thread to bf16; rows past S are not stored.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r_lo + 8 * hh;
    if (row >= S) continue;
    __nv_bfloat16* out = dq + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int col = 8 * g + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(out + col) =
          pack_bf16(acc[4 * g + 2 * hh], acc[4 * g + 2 * hh + 1]);
    }
  }
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int S, int H, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map(&tq, q, B, S, H, D, DQ_BQ);
  if (!err) err = make_bshd_map(&tdo, dout, B, S, H, D, DQ_BQ);
  if (!err) err = make_bshd_map(&tk, k, B, S, H, D, DQ_BK);
  if (!err) err = make_bshd_map(&tv, v, B, S, H, D, DQ_BK);
  if (err) return err;
  auto kernel = flash_dq_wgmma_kernel<D>;
  cudaError_t e = prepare(kernel, DqCfg<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (S + DQ_BQ - 1) / DQ_BQ);
  kernel<<<grid, DQ_THREADS, DqCfg<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), S,
      H);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_dq_wgmma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int S, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, B, S, H,
                                 stream);
    case 128:
      return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, B, S, H,
                                  stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace kfx
