// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_bwd_dkv_kernel
// (launched by _flash_bwd_folded). Same function: with p = exp(s - lse) and
// ds = p * (dO vᵀ - delta), dv = pᵀ dO and dk = d^-0.5 * dsᵀ q.
//
// Bound on an H100: compute. Four products per (k, q) tile pair (k qᵀ,
// v dOᵀ, pᵀ dO, dsᵀ q): ~2.1e11 FLOP at the flagship shape against
// ~0.25 GB moved.
//
// Design: one block of three warpgroups per (k tile of 128 keys,
// batch*head), the pairs folded into grid x (k tile fastest), so batch*heads
// has no grid-y limit. Warpgroup 2 is the producer and gives up its
// registers: one thread loads the K and V tiles once by TMA and then
// streams 64-row q and dO tiles through a two-stage ring of full/empty
// mbarriers; a second warp copies the tiles' 64 lse (times log2 e) and
// delta values beside them and arrives on the same full barrier.
// Warpgroups 0 and 1 are consumers with 240 registers, each owning 64 keys
// and their fp32 dk and dv accumulators.
// Per q tile, sᵀ = k qᵀ and dpᵀ = v dOᵀ are wgmma m64n64k16 with both
// operands in shared memory; pᵀ = exp2(sᵀ scale log2 e - lse log2 e) and
// dsᵀ = pᵀ (dpᵀ - delta) are formed in the accumulator layout (keys as rows,
// q rows as columns, so lse and delta are indexed by column) and re-packed
// in registers as the A operand of dv += pᵀ dO and dk += dsᵀ q, where dO and
// q are MN-major B operands (transpose bit). dk is scaled by d^-0.5 once at
// the end. The causal start (the first q tile that reaches this k tile) is
// the loop's lower bound, a consumer skips q tiles that lie wholly before
// its keys, and the mask is applied only on tiles that straddle the
// diagonal or the end of the sequence. q rows past seq_len are masked, keys
// past it are never written. No atomics: each block writes its own dk, dv
// rows once, so results are the same from run to run.
//
// At D = 256 a warpgroup cannot hold dk and dv of 64 keys over the whole
// head dim (2 x 128 fp32 registers a thread). There a block takes 64 keys,
// both consumer warpgroups own all 64, and warpgroup w accumulates dk and dv
// over head-dim columns 128 w .. 128 w + 127 only: each computes sᵀ and dpᵀ
// over the whole head dim itself (so the block does 1.5x the four products'
// FLOP), and its dv and dk products read the dO and q boxes of its half.
// Its registers are then those of D = 128 (64 + 64 accumulators), and its
// shared memory 192 KiB (K and V 32 KiB each, two stages of q and dO).
#include "sm90_common.cuh"

namespace flash {

template <int D>
struct DkvLayout {
  static constexpr bool SPLIT = D == 256;  // the warpgroups split D, not the keys
  static constexpr int BK = SPLIT ? 64 : 128, BQ = 64, STAGES = 2;
  static constexpr int DW = SPLIT ? D / 2 : D;  // dk, dv columns of one warpgroup
  static constexpr int KV_BOX = BK * 128;  // bytes of one [BK x 64] box
  static constexpr int KV_BYTES = KV_BOX * (D / 64);  // the K or the V tile
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int Q_BYTES = Q_BOX * (D / 64);  // one q or dO tile
  static constexpr int RING_OFF = 2 * KV_BYTES;  // stage s: q tile, then dO tile
  static constexpr int STATS_OFF = RING_OFF + STAGES * 2 * Q_BYTES;  // stage s: lse, delta
  static constexpr int BAR_OFF = STATS_OFF + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int S, int H, float scale,
               float scale_log2) {
  using L = DkvLayout<D>;
  constexpr int BK = L::BK, BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + L::RING_OFF;
  float* stats = reinterpret_cast<float*>(smem + L::STATS_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  // Block x = k tile + n_k_tiles * batch*head: the blocks in flight share
  // a few (batch, head)s, whose q and dO stay in L2; causal: the first k
  // tiles do the most work.
  const int n_kt = (S + BK - 1) / BK;
  const int k0 = (blockIdx.x % n_kt) * BK;
  const int bh = blockIdx.x / n_kt, b = bh / H, h = bh % H;
  const int qstart = CAUSAL ? k0 : 0;
  const int ntiles = (S - qstart + BQ - 1) / BQ;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the stats warp
      mbar_init(&empty[s], 256);    // every consumer thread releases the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer.
    reg_dealloc<24>();
    const int pwarp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    if (pwarp == 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int x = 0; x < D / 64; ++x) {
        tma_load_4d(smem + x * L::KV_BOX, &tk, kv_full, 64 * x, h, k0, b);
        tma_load_4d(smem + L::KV_BYTES + x * L::KV_BOX, &tv, kv_full, 64 * x, h, k0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::Q_BYTES);
        unsigned char* dst = ring + s * 2 * L::Q_BYTES;
        const int q0 = qstart + j * BQ;
        for (int x = 0; x < D / 64; ++x) {
          tma_load_4d(dst + x * L::Q_BOX, &tq, &full[s], 64 * x, h, q0, b);
          tma_load_4d(dst + L::Q_BYTES + x * L::Q_BOX, &tdo, &full[s], 64 * x, h, q0, b);
        }
      }
    } else if (pwarp == 1) {
      const float* lse_bh = lse + (long)bh * S;
      const float* delta_bh = delta + (long)bh * S;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const int q0 = qstart + j * BQ;
        float* st = stats + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const bool in = q0 + i < S;
          st[i] = in ? lse_bh[q0 + i] * kLog2e : 0.f;
          st[BQ + i] = in ? delta_bh[q0 + i] : 0.f;
        }
        mbar_arrive(&full[s]);  // release: the stores above are seen by the waiters
      }
    }
  } else {
    // Consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 (all D
    // columns), or at D = 256 keys k0 .. + 63 and columns 128 wg .. + 127.
    reg_alloc<240>();
    constexpr int DW = L::DW;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, t = lane & 3;
    const int key_off = L::SPLIT ? 0 : 64 * wg, col_off = L::SPLIT ? 128 * wg : 0;
    const uint32_t k_addr = smem_addr(smem) + key_off * 128;
    const uint32_t v_addr = k_addr + L::KV_BYTES;
    const uint32_t half = (col_off / 64) * L::Q_BOX;  // the q and dO boxes of its columns
    const int kbase = k0 + key_off;
    const int key_lo = kbase + 16 * warp + (lane >> 2), key_hi = key_lo + 8;

    float dk_acc[DW / 2], dv_acc[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES;
      const int q0 = qstart + j * BQ;
      mbar_wait(&full[s], (j / STAGES) & 1);
      if (CAUSAL && q0 + BQ - 1 < kbase) {  // every q row lies before every key
        mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t q_addr = smem_addr(ring) + s * 2 * L::Q_BYTES;
      const uint32_t do_addr = q_addr + L::Q_BYTES;
      const float* c_lse = stats + s * 2 * BQ;
      const float* c_delta = c_lse + BQ;

      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // bytes into the box's 128-byte rows
        wgmma_ss_n64<T>(st, smem_desc(k_addr + (kk >> 2) * L::KV_BOX + col, 16, 1024),
                     smem_desc(q_addr + (kk >> 2) * L::Q_BOX + col, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        wgmma_ss_n64<T>(dpt, smem_desc(v_addr + (kk >> 2) * L::KV_BOX + col, 16, 1024),
                     smem_desc(do_addr + (kk >> 2) * L::Q_BOX + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const bool edge = (q0 + BQ > S) || (CAUSAL && q0 < kbase + 63);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = 8 * i + 2 * t + (e & 1);  // q row within the tile
          float p = exp2_approx(st[4 * i + e] * scale_log2 - c_lse[ci]);
          if (edge) {
            const int key = e < 2 ? key_lo : key_hi;
            if (q0 + ci >= S || (CAUSAL && q0 + ci < key)) p = 0.f;
          }
          st[4 * i + e] = p;                                  // pᵀ
          dpt[4 * i + e] = p * (dpt[4 * i + e] - c_delta[ci]);  // dsᵀ
        }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        c_to_a<T>(pa[kc], &st[8 * kc], &st[8 * kc + 4]);
        c_to_a<T>(da[kc], &dpt[8 * kc], &dpt[8 * kc + 4]);
      }

      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)  // 16 q rows = two 8-row groups
        wgmma_rs_mn<T, DW>(dv_acc, pa[kc],
                        smem_desc(do_addr + half + kc * 2048, L::Q_BOX, 1024));
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs_mn<T, DW>(dk_acc, da[kc], smem_desc(q_addr + half + kc * 2048, L::Q_BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[s]);
    }

    if (key_lo < S) {
      const long off = (((long)b * S + key_lo) * H + h) * D + col_off + 2 * t;
#pragma unroll
      for (int i = 0; i < DW / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
            pack2<T>(dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
            pack2<T>(dv_acc[4 * i], dv_acc[4 * i + 1]);
      }
    }
    if (key_hi < S) {
      const long off = (((long)b * S + key_hi) * H + h) * D + col_off + 2 * t;
#pragma unroll
      for (int i = 0; i < DW / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
            pack2<T>(dk_acc[4 * i + 2] * scale, dk_acc[4 * i + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
            pack2<T>(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
      }
    }
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                    int H, float scale, cudaStream_t stream) {
  using L = DkvLayout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, S, H, D, L::BQ);
  if (err == cudaSuccess) err = encode_bshd<T>(&tdo, dout, B, S, H, D, L::BQ);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, S, H, D, L::BK);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, S, H, D, L::BK);
  if (err != cudaSuccess) return err;
  const long blocks = (long)((S + L::BK - 1) / L::BK) * B * H;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  return launch(bwd_dkv_kernel<T, D, CAUSAL>, dim3((unsigned)blocks), dim3(384), L::SMEM, stream,
                tq, tk, tv, tdo,
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), S, H, scale,
                scale * kLog2e);
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int B, int S, int H, int D, int causal,
              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? run_dkv<T, 64, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : run_dkv<T, 64, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  if (D == 128)
    return causal ? run_dkv<T, 128, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : run_dkv<T, 128, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  if (D == 256)
    return causal ? run_dkv<T, 256, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : run_dkv<T, 256, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int S, int H, int D, int causal,
                                  float scale, void* stream) {
  return flash::dkv_entry<flash::bf16>(q, k, v, dout, lse, delta, dk, dv, B, S, H, D, causal,
                                       scale, stream);
}

extern "C" int flash_bwd_dkv_fp16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int S, int H, int D, int causal,
                                  float scale, void* stream) {
  return flash::dkv_entry<flash::f16>(q, k, v, dout, lse, delta, dk, dv, B, S, H, D, causal,
                                      scale, stream);
}
