// Flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_bwd_dq_kernel
// (launched by _flash_bwd_folded). Same function: with p = exp(s - lse) and
// ds = p * (dO vᵀ - delta), dq = d^-0.5 * ds k, where s is the masked,
// scaled score tile recomputed from q and k.
//
// Bound on an H100: compute. Three products per (q, k) tile pair (q kᵀ,
// dO vᵀ, ds k): ~1.5e11 FLOP at the flagship shape against ~0.25 GB moved.
//
// Design: the forward kernel's loop with dO and V beside q and K, and no
// online softmax (lse is given). Persistent blocks of three warpgroups, at
// most one per SM, work through 128-row q tiles dealt in causal-balanced
// pairs (PairSchedule). Warpgroup 2 is the producer: it gives up registers
// (setmaxnreg) and one of its threads issues TMA loads, each item's q and
// dO tiles (loaded once) and then its K and V tiles of BK keys (64; 32 at
// D = 256) into three-stage rings guarded by full/empty mbarriers.
// Warpgroups 0 and 1 are consumers with 240 registers, each owning 64 query
// rows, whose lse (times log2 e) and delta they keep in registers. Per key
// tile, s = q kᵀ and dp = dO vᵀ are wgmma m64nBKk16 with both operands in
// shared memory; p = exp2(s scale log2 e - lse log2 e) and
// ds = p (dp - delta) are formed in the fp32 accumulator layout and
// re-packed in registers as the A operand of dq += ds k, with K as an
// MN-major B operand (transpose bit).
// V's stage is released once dp is done; K's only after ds k has read it,
// one key tile later, which is why the rings have three stages: with two,
// the load of K tile j+2 waits for tile j's ds k and is not hidden.
// Within a warpgroup, tile j's two score products and tile j-1's ds k are
// in flight together while tile j's ds is formed; the two warpgroups take
// turns to issue (named barriers), so one's exp2 pass runs under the
// other's products. The causal limit is the loop bound; the mask is applied
// only on tiles that straddle the diagonal or the end of the sequence. The
// tensor maps fill rows past seq_len with zeros; keys past it are masked,
// and dq rows past it are not stored. dq is scaled by d^-0.5 once at the
// end. No atomics: each item's dq rows are written once by one block, so
// results are the same from run to run.
#include "sm90_common.cuh"

namespace flash {

// At D = 256 the key tiles are 32 rows: the q and dO tiles take 128 KiB,
// and three stages of 64-row K and V tiles would add 192 KiB more (96 KiB
// at 32 rows, 230,512 bytes in all of the 232,448 a block may have).
template <int D>
struct DqLayout {
  static constexpr int BQ = 128, BK = D == 256 ? 32 : 64, STAGES = 3;
  static constexpr int Q_BOX = BQ * 128;  // bytes of one [BQ x 64] box
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = Q_BOX * (D / 64);  // the q or the dO tile
  static constexpr int KV_BYTES = KV_BOX * (D / 64);  // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;  // K ring, then V ring, STAGES tiles each
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;  // + alignment slack
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int BH, float scale, float scale_log2) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  const int nq = (S + BQ - 1) / BQ;
  const int wg = threadIdx.x >> 7;
  auto key_tiles = [&](int q0) { return ((CAUSAL ? min(S, q0 + BQ) : S) + BK - 1) / BK; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);  // every consumer thread releases the q and dO tiles
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 256);
      mbar_init(&v_empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: the rings run on across the block's q tiles, and the next q
    // and dO tiles load as soon as the consumers' last score products with
    // the current ones are done.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      PairSchedule sched(nq, BH);
      int bh, qt, it = 0;
      for (int n = 0; sched.next(bh, qt); ++n) {
        const int b = bh / H, h = bh % H, q0 = qt * BQ;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::Q_BYTES);
        for (int x = 0; x < D / 64; ++x) {
          tma_load_4d(smem + x * L::Q_BOX, &tq, q_full, 64 * x, h, q0, b);
          tma_load_4d(smem + L::DO_OFF + x * L::Q_BOX, &tdo, q_full, 64 * x, h, q0, b);
        }
        const int ntiles = key_tiles(q0);
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int s = it % STAGES, parity = ((it / STAGES) & 1) ^ 1;
          unsigned char* dk = smem + L::K_OFF + s * L::KV_BYTES;
          unsigned char* dv = smem + L::V_OFF + s * L::KV_BYTES;
          mbar_wait(&k_empty[s], parity);
          mbar_expect_tx(&k_full[s], L::KV_BYTES);
          for (int x = 0; x < D / 64; ++x)
            tma_load_4d(dk + x * L::KV_BOX, &tk, &k_full[s], 64 * x, h, j * BK, b);
          mbar_wait(&v_empty[s], parity);
          mbar_expect_tx(&v_full[s], L::KV_BYTES);
          for (int x = 0; x < D / 64; ++x)
            tma_load_4d(dv + x * L::KV_BOX, &tv, &v_full[s], 64 * x, h, j * BK, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of each q tile.
    reg_alloc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, t = lane & 3;
    const uint32_t q_addr = smem_addr(smem) + wg * 64 * 128;
    const uint32_t do_addr = q_addr + L::DO_OFF;
    const uint32_t k_ring = smem_addr(smem + L::K_OFF);
    const uint32_t v_ring = smem_addr(smem + L::V_OFF);

    float acc[D / 2];
    float sc[BK / 2], dp[BK / 2];
    uint32_t da[BK / 16][4];  // ds of the previous tile, the A operand of ds k
    // d = a bᵀ over the head dim, both from shared memory (q kᵀ, dO vᵀ),
    // one commit group with its own fences.
    auto score_product = [&](float (&d)[BK / 2], uint32_t a_addr, uint32_t b_addr) {
      // At D = 256 the q and dO descriptors of the 2 x 16 k steps do not
      // change over the key loop, and hoisted out of it they hold 64
      // registers, enough to make ptxas spill: hiding the address makes
      // them be formed again per tile.
      if constexpr (D == 256) asm volatile("" : "+r"(a_addr));
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // bytes into the box's 128-byte rows
        wgmma_ss<T, BK>(d, smem_desc(a_addr + (kk >> 2) * L::Q_BOX + col, 16, 1024),
                     smem_desc(b_addr + (kk >> 2) * L::KV_BOX + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      fence_regs(d);
    };
    auto scores = [&](int it) {  // issues s = q kᵀ and dp = dO vᵀ, ring slot it
      score_product(sc, q_addr, k_ring + (it % STAGES) * L::KV_BYTES);
      score_product(dp, do_addr, v_ring + (it % STAGES) * L::KV_BYTES);
    };
    auto ds_k = [&](int it) {  // issues dq += ds k, ring slot it
      const uint32_t k_addr = k_ring + (it % STAGES) * L::KV_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)  // 16 keys = two 8-row groups of K
        wgmma_rs_mn<T, D>(acc, da[kc], smem_desc(k_addr + kc * 2048, L::KV_BOX, 1024));
      wgmma_commit();
      fence_regs(acc);
    };
    auto wait_kv = [&](int it) {
      mbar_wait(&k_full[it % STAGES], (it / STAGES) & 1);
      mbar_wait(&v_full[it % STAGES], (it / STAGES) & 1);
    };
    // Turns, as in the forward kernel: warpgroup 0 issues first; each
    // warpgroup hands the turn over after issuing a key tile's products,
    // warpgroup 1 not after the block's last, so every wait on a barrier
    // meets exactly one hand-over.
    const int own_turn = 1 + wg, other_turn = 2 - wg;
    auto take_turn = [&]() { named_bar_sync(own_turn, 256); };
    auto pass_turn = [&](bool block_last) {
      if (wg == 0 || !block_last) named_bar_arrive(other_turn, 256);
    };
    if (wg == 1) named_bar_arrive(1, 256);

    PairSchedule sched(nq, BH);
    int bh, qt, it = 0;
    for (int n = 0; sched.next(bh, qt); ++n) {
      const bool last_q = sched.done();
      const int b = bh / H, h = bh % H, q0 = qt * BQ;
      const int ntiles = key_tiles(q0);
      const int rbase = q0 + 64 * wg;
      const int row_lo = rbase + 16 * warp + (lane >> 2), row_hi = row_lo + 8;
      const float* lse_bh = lse + (long)bh * S;
      const float* delta_bh = delta + (long)bh * S;
      const float lse_lo = row_lo < S ? __ldg(lse_bh + row_lo) * kLog2e : 0.f;
      const float lse_hi = row_hi < S ? __ldg(lse_bh + row_hi) * kLog2e : 0.f;
      const float dl_lo = row_lo < S ? __ldg(delta_bh + row_lo) : 0.f;
      const float dl_hi = row_hi < S ? __ldg(delta_bh + row_hi) : 0.f;
      // sc <- ds of key tile j, from its scores in sc and dp.
      auto grad_scores = [&](int j) {
        const int k0 = j * BK;
        const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > rbase);
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool lo = e < 2;
            float p = exp2_approx(fmaf(sc[4 * i + e], scale_log2, lo ? -lse_lo : -lse_hi));
            if (edge) {
              const int col = k0 + 8 * i + 2 * t + (e & 1);
              if (col >= S || (CAUSAL && col > (lo ? row_lo : row_hi))) p = 0.f;
            }
            sc[4 * i + e] = p * (dp[4 * i + e] - (lo ? dl_lo : dl_hi));
          }
        }
      };
      auto pack_ds = [&]() {
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) c_to_a<T>(da[kc], &sc[8 * kc], &sc[8 * kc + 4]);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      mbar_wait(q_full, n & 1);
      wait_kv(it);
      take_turn();
      scores(it);
      pass_turn(last_q && ntiles == 1);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&v_empty[it % STAGES]);
      if (ntiles == 1) mbar_arrive(q_empty);
      grad_scores(0);
      pack_ds();
      for (int j = 1; j < ntiles; ++j) {
        const int cur = it + j;
        wait_kv(cur);
        take_turn();
        scores(cur);
        ds_k(cur - 1);
        pass_turn(last_q && j + 1 == ntiles);
        wgmma_wait<1>();  // the scores; ds k may still run
        fence_regs(sc);
        fence_regs(dp);
        mbar_arrive(&v_empty[cur % STAGES]);
        if (j + 1 == ntiles) mbar_arrive(q_empty);  // the producer may load the next q, dO
        grad_scores(j);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(da);
        mbar_arrive(&k_empty[(cur - 1) % STAGES]);
        pack_ds();
      }
      it += ntiles;
      ds_k(it - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(da);
      mbar_arrive(&k_empty[(it - 1) % STAGES]);

      if (row_lo < S) {
        T* out = dq + (((long)b * S + row_lo) * H + h) * D + 2 * t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(out + 8 * i) =
              pack2<T>(acc[4 * i] * scale, acc[4 * i + 1] * scale);
      }
      if (row_hi < S) {
        T* out = dq + (((long)b * S + row_hi) * H + h) * D + 2 * t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(out + 8 * i) =
              pack2<T>(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
      }
    }
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int S,
                   int H, float scale, cudaStream_t stream) {
  using L = DqLayout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_bshd<T>(&tq, q, B, S, H, D, L::BQ);
  if (err == cudaSuccess) err = encode_bshd<T>(&tdo, dout, B, S, H, D, L::BQ);
  if (err == cudaSuccess) err = encode_bshd<T>(&tk, k, B, S, H, D, L::BK);
  if (err == cudaSuccess) err = encode_bshd<T>(&tv, v, B, S, H, D, L::BK);
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = persistent_grid((S + L::BQ - 1) / L::BQ, B * H, &grid);
  if (err != cudaSuccess) return err;
  return launch(bwd_dq_kernel<T, D, CAUSAL>, grid, dim3(384), L::SMEM, stream, tq, tk, tv, tdo,
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dq), S, H, B * H, scale, scale * kLog2e);
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int B, int S, int H, int D, int causal,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? run_dq<T, 64, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : run_dq<T, 64, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  if (D == 128)
    return causal ? run_dq<T, 128, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : run_dq<T, 128, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  if (D == 256)
    return causal ? run_dq<T, 256, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : run_dq<T, 256, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int S, int H, int D, int causal,
                                 float scale, void* stream) {
  return flash::dq_entry<flash::bf16>(q, k, v, dout, lse, delta, dq, B, S, H, D, causal,
                                      scale, stream);
}

extern "C" int flash_bwd_dq_fp16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int S, int H, int D, int causal,
                                 float scale, void* stream) {
  return flash::dq_entry<flash::f16>(q, k, v, dout, lse, delta, dq, B, S, H, D, causal,
                                     scale, stream);
}
