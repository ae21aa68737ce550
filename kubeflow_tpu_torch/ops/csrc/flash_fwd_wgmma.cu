// Causal flash-attention forward for Hopper (sm_90a) on the tensor cores:
// bf16 at head dim 64 and 128.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (kubeflow_tpu/ops/flash_attention.py:64) for bf16 inputs at D in {64, 128},
// the trainer's dtype and the head dims of the small, base and large presets.
// Same function as flash_fwd.cu: per (batch, head), o = softmax(q k^T) v with
// q pre-scaled and the causal mask applied as NEG_INF on the diagonal tile,
// and lse = m + log(den) in [B, S, H, 1] f32.
//
// What bounds it on the H100: about 4 D FLOPs per (query, key) pair over the
// causal half of S^2, against q, k, v read once and o written once. At
// S = 2048, D = 64 that is ~500 FLOP per byte, above the card's ~295 FLOP/byte
// ridge in bf16: compute-bound, with a floor at the tensor cores' 989 TFLOP/s.
//
// What the design does about it: both products run on wgmma (bf16 operands,
// f32 accumulators), which is the only way to that floor. A product of two
// bf16 numbers is exact in f32, so q k^T matches the reference's f32 product
// up to summation order; the one new rounding is P to bf16 before P v, where
// FlashAttention-2/3 round too.
// - One 256-thread block per (128-row Q tile, head, batch): two warpgroups of
//   64 query rows each. Q is loaded once by TMA.
// - K and V stream through a ring of two shared-memory slots, filled by TMA
//   (thread 0 issues each load, one mbarrier per tile with its expected byte
//   count; an "empty" mbarrier per slot counts the eight warps done with it).
//   The load of tile j + 1 is in flight while tile j is computed.
// - K/V tiles are 128 rows at D = 64 and 64 rows at D = 128 (FwdCfg): the
//   widest tile whose S accumulator, beside O and P, keeps a thread within
//   128 registers, so that two blocks share an SM and one block's softmax
//   overlaps the other's products. At D = 128 a warpgroup stops at its own
//   diagonal tile, so warpgroup 0 skips the tile that would be all masked.
// - S = Q K^T is m64nBKk16 with both operands in shared memory (K-major).
//   The online softmax runs on the accumulator in registers (exp as one
//   FFMA and one ex2); a row's max and sum reduce over the thread's
//   registers and the 4 lanes that share the row. Only a warpgroup's
//   diagonal tile is masked.
//   P is packed to bf16 pairs in registers and is the register A operand of
//   O += P V (m64nDk16), V the MN-major B operand as stored. Nothing but the
//   TMA tiles goes through shared memory.
// - Blocks of the heaviest Q tiles (nearest the end of the sequence) launch
//   first. When S % 128 == 64 the last Q tile's second half lies past S: TMA
//   reads those rows as zeros, the causal mask hides the keys past S from
//   every real row, and the rows past S are not stored.
// Not done yet (later work): warp specialisation with setmaxnreg, overlapping
// the softmax with the next Q K^T, persistent blocks.
//
// f32 inputs (every D) and bf16 at D in {192, 256} keep the FMA design of
// flash_fwd.cu: f32 on wgmma would be TF32, which cannot hold the f32
// instantiations' 1e-4 bound, and no preset uses D > 128.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace kfx {
namespace {

using namespace hopper;

constexpr int FWD_THREADS = 256;
constexpr int FWD_BQ = 128;  // query rows per block

// Key rows per ring slot: 128 at D = 64, 64 at D = 128. Either way a
// warpgroup's S (BK / 2 f32) and O (D / 2 f32) accumulators and P fit in 128
// registers, and two ring slots in at most 96 KB of shared memory, so two
// blocks (16 warps) share an SM and one block's softmax runs while the
// other's products keep the tensor cores busy.
template <int D>
struct FwdCfg {
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = 2;  // blocks per SM
  static constexpr uint32_t Q_BYTES = FWD_BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;   // one K or V tile
  static constexpr uint32_t Q_BOX = FWD_BQ * 128;    // one 64-col box
  static constexpr uint32_t KV_BOX = BK * 128;
  // Q, then STAGES K slots, then STAGES V slots; 1024 bytes of slack to
  // align the start.
  static constexpr size_t SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

// Thread 0 fills ring slot t % STAGES with K and V tile t.
template <int D>
__device__ __forceinline__ void fwd_issue_kv(
    int t, const CUtensorMap* tk, const CUtensorMap* tv, uint32_t sK,
    uint32_t sV, uint64_t* full_k, uint64_t* full_v, int h, int b) {
  using C = FwdCfg<D>;
  constexpr int BK = C::BK;
  const int slot = t % C::STAGES;
  mbar_expect_tx(&full_k[slot], C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(sK + slot * C::KV_BYTES + c * C::KV_BOX, tk, &full_k[slot],
                c * 64, h, t * BK, b);
  mbar_expect_tx(&full_v[slot], C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(sV + slot * C::KV_BYTES + c * C::KV_BOX, tv, &full_v[slot],
                c * 64, h, t * BK, b);
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, FwdCfg<D>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int S, int H) {
  using C = FwdCfg<D>;
  constexpr int BK = C::BK;
  constexpr int STAGES = C::STAGES;
  constexpr int CH = D / 64;  // 64-column boxes in a row
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full_k[STAGES];
  __shared__ __align__(8) uint64_t full_v[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + STAGES * C::KV_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int q0 = qi * FWD_BQ;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // K tiles up to the diagonal: the block's (warpgroup 1's) and this
  // warpgroup's. With 64-key tiles warpgroup 0 stops one tile early; the
  // last tile's slot is never refilled, so its missing arrivals hold up
  // nothing.
  const int n_kv = (q0 + FWD_BQ) / BK;
  const int n_wg = (q0 + 64 * wg + 64 + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], FWD_THREADS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid == 0) {
    mbar_expect_tx(&bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load_4d(sQ + c * C::Q_BOX, &tq, &bar_q, c * 64, h, q0, b);
    for (int t = 0; t < STAGES - 1 && t < n_kv; ++t)
      fwd_issue_kv<D>(t, &tk, &tv, sK, sV, full_k, full_v, h, b);
  }

  float acc[D / 2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  // Running row max and this thread's part of the row sums.
  float m_row[2] = {NEG_INF, NEG_INF};
  float l_row[2] = {0.f, 0.f};
  // Query rows of this thread: q0 + r_lo and q0 + r_lo + 8.
  const int r_lo = 64 * wg + 16 * warp + lane / 4;
  const uint32_t sQ_wg = sQ + wg * 64 * 128;  // this warpgroup's 64 rows

  __syncwarp();
  mbar_wait(&bar_q, 0);

  for (int j = 0; j < n_wg; ++j) {
    if (tid == 0) {
      const int t = j + STAGES - 1;
      if (t < n_kv) {
        // The slot last held tile t - STAGES; wait until all warps are done.
        if (t >= STAGES) mbar_wait(&empty[t % STAGES], (t / STAGES - 1) & 1);
        fwd_issue_kv<D>(t, &tk, &tv, sK, sV, full_k, full_v, h, b);
      }
    }
    __syncwarp();  // warp 0 whole again before the .aligned wgmma ops
    const int slot = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const uint32_t k_tile = sK + slot * C::KV_BYTES;
    const uint32_t v_tile = sV + slot * C::KV_BYTES;

    // S = Q K^T
    mbar_wait(&full_k[slot], parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<BK>::ss(s, desc_k(sQ_wg, k, C::Q_BOX),
                    desc_k(k_tile, k, C::KV_BOX), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // The causal mask (key > query) on this warpgroup's diagonal tile.
    if (j == n_wg - 1) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = j * BK + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = q0 + r_lo + 8 * ((i / 2) % 2);
        if (key > row) s[i] = NEG_INF;
      }
    }

    // Online softmax on the accumulator: hh = 0 is row r_lo, 1 is r_lo + 8.
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2], m_log2[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = ex2((m_row[hh] - mx[hh]) * LOG2E);
      m_row[hh] = mx[hh];
      m_log2[hh] = mx[hh] * LOG2E;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(fmaf(s[i], LOG2E, -m_log2[(i / 2) % 2]));
      rs[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_row[hh] = l_row[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // P as bf16 A fragments, one per 16 keys.
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[k][r] = pack_bf16(s[8 * k + 2 * r], s[8 * k + 2 * r + 1]);

    // O += P V
    mbar_wait(&full_v[slot], parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      Wgmma<D>::rs(acc, p[k], desc_mn(v_tile, k, C::KV_BOX));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // Epilogue: o = acc / den in bf16, lse = m + log(den); rows past S are
  // not stored.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l_row[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = q0 + r_lo + 8 * hh;
    if (row >= S) continue;
    const float inv = 1.f / den;
    const size_t at = ((size_t)b * S + row) * H + h;
    __nv_bfloat16* out = o + at * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int col = 8 * g + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(out + col) =
          pack_bf16(acc[4 * g + 2 * hh] * inv, acc[4 * g + 2 * hh + 1] * inv);
    }
    if (lane % 4 == 0) lse[at] = m_row[hh] + logf(den);
  }
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int S, int H, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap tq, tk, tv;
  int err = make_bshd_map(&tq, q, B, S, H, D, FWD_BQ);
  if (!err) err = make_bshd_map(&tk, k, B, S, H, D, C::BK);
  if (!err) err = make_bshd_map(&tv, v, B, S, H, D, C::BK);
  if (err) return err;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t e = prepare(kernel, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (S + FWD_BQ - 1) / FWD_BQ);
  kernel<<<grid, FWD_THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      S, H);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int S, int H, int D,
                    cudaStream_t stream) {
  switch (D) {
    case 64: return launch_fwd_wgmma<64>(q, k, v, o, lse, B, S, H, stream);
    case 128: return launch_fwd_wgmma<128>(q, k, v, o, lse, B, S, H, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace kfx
