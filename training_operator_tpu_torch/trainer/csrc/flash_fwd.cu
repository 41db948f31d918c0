// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_fwd_kernel
// (launched by _flash_fwd_folded). Same function: out = softmax(q kᵀ * d^-0.5
// [causal, keys < seq_len]) v, and lse = m + log(l) per row.
//
// Bound on an H100: compute. At the flagship shape ([8, 2048, 12, 128],
// causal) the two products are ~1.0e11 FLOP against ~0.2 GB of inputs and
// outputs, ~500 FLOP per byte, above the card's ~295 FLOP/byte ridge, so the
// design is about keeping the tensor cores fed through wgmma.
//
// Design: persistent blocks of three warpgroups, at most one per SM, each
// working through (q tile of 128 rows, batch*head) items. Warpgroup 2 is the
// producer: it gives up registers (setmaxnreg) and one of its threads
// issues TMA loads, each item's q tile and then its K and V tiles of BK
// keys (128; 64 at D = 256) into two-stage rings guarded by full/empty
// mbarriers (K and V apart, so K is released when its scores are done).
// Warpgroups 0 and 1 are consumers with 240 registers, each owning 64 query
// rows: s = q kᵀ is wgmma m64nBKk16 with both operands in shared memory (a
// row-major K tile is the K-major B operand), the online softmax runs on
// the fp32 accumulator in registers (exp2 with log2 e folded into the
// scale), the probabilities are re-packed in registers as the A operand,
// and o += p v is wgmma with V as an MN-major B operand (transpose bit), so
// no transposed copy exists.
// Within a warpgroup the next tile's scores and the current p v are issued
// together and the softmax runs under them; the two warpgroups take turns
// to issue (named barriers), so one's softmax runs under the other's
// products. Items are dealt to blocks in pairs (q tiles nq-1-p and p of one
// batch*head, PairSchedule), which under the causal mask all hold the same
// work; the next item's q tile loads while the current one finishes. The
// causal limit is the loop bound; the mask is applied only on tiles that
// straddle the diagonal or the end of the sequence. The tensor maps fill rows past
// seq_len with zeros; keys past it are masked and output rows past it are
// not stored.
#include "sm90_common.cuh"

namespace flash {

// At D = 256 the key tiles are 64 rows: with 128 the Q tile and the two
// rings would take 320 KiB of shared memory (192 KiB at 64), and a
// consumer's o accumulator alone holds 128 registers.
template <int D>
struct FwdLayout {
  static constexpr int BQ = 128, BK = D == 256 ? 64 : 128, STAGES = 2;
  static constexpr int Q_BOX = BQ * 128;  // bytes of one [BQ x 64] box
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = Q_BOX * (D / 64);
  static constexpr int KV_BYTES = KV_BOX * (D / 64);  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;  // K ring, then V ring, STAGES tiles each
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;  // + alignment slack
};

// Online softmax of one score tile in the accumulator layout. The running
// max m is kept in the log2 domain (scores times scale * log2 e); masked
// entries (only on edge tiles) become -inf, so they add nothing to the max
// and exp2 gives 0 for them. Leaves p = exp2(s * scale_log2 - m) in `sc`,
// updates the per-lane partial sums and returns the correction factors of
// the rows' earlier terms (exactly 1 where the max did not move).
template <int BK, bool CAUSAL>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], bool edge, int k0, int S,
                                               int row_lo, int row_hi, int t,
                                               float scale_log2, float& m_lo, float& m_hi,
                                               float& l_lo, float& l_hi, float& corr_lo,
                                               float& corr_hi) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * i + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        if (col >= S || (CAUSAL && col > row))
          sc[4 * i + e] = __int_as_float(0xff800000);  // -inf
      }
  }
  float mx_lo = sc[0], mx_hi = sc[2];
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  mx_lo = fmaxf(m_lo, quad_max(mx_lo) * scale_log2);
  mx_hi = fmaxf(m_hi, quad_max(mx_hi) * scale_log2);
  corr_lo = exp2_approx(m_lo - mx_lo);
  corr_hi = exp2_approx(m_hi - mx_hi);
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    sc[4 * i] = exp2_approx(fmaf(sc[4 * i], scale_log2, -mx_lo));
    sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], scale_log2, -mx_lo));
    sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], scale_log2, -mx_hi));
    sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], scale_log2, -mx_hi));
    sum_lo += sc[4 * i] + sc[4 * i + 1];
    sum_hi += sc[4 * i + 2] + sc[4 * i + 3];
  }
  // Each lane keeps a partial row sum; the quad's partials are added once at
  // the end (the correction is the same on all four lanes).
  l_lo = l_lo * corr_lo + sum_lo;
  l_hi = l_hi * corr_hi + sum_hi;
  m_lo = mx_lo;
  m_hi = mx_hi;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, int S, int H, int BH, float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;
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
    mbar_init(q_empty, 256);  // every consumer thread releases the q tile
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
    // Producer: K and V have rings of their own, so a K tile is released as
    // soon as its scores are done while the V tile waits for p v. The rings
    // run on across the block's q tiles, and the next q tile is loaded as
    // soon as the consumers' last product with the current one is done.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      PairSchedule sched(nq, BH);
      int bh, qt, it = 0;
      for (int n = 0; sched.next(bh, qt); ++n) {
        const int b = bh / H, h = bh % H, q0 = qt * BQ;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int x = 0; x < D / 64; ++x)
          tma_load_4d(sQ + x * L::Q_BOX, &tq, q_full, 64 * x, h, q0, b);
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
    // After a q tile's first key tile, iteration j issues s_j = q k_jᵀ and
    // o += p_{j-1} v_{j-1} back to back, and the softmax of s_j runs while
    // the second product is still on the tensor cores. The two warpgroups
    // take turns to issue their products (named barriers 1 and 2), so one's
    // softmax runs under the other's products (the schedule of
    // FlashAttention-3).
    reg_alloc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, t = lane & 3;
    const uint32_t q_addr = smem_addr(sQ) + wg * 64 * 128;
    const uint32_t k_ring = smem_addr(smem + L::K_OFF);
    const uint32_t v_ring = smem_addr(smem + L::V_OFF);

    float acc[D / 2];
    uint32_t pa[BK / 16][4];  // p of the previous tile, the A operand of p v
    float m_lo, m_hi, l_lo, l_hi, corr_lo, corr_hi;
    auto scores = [&](float (&sc)[BK / 2], int it) {  // issues s = q kᵀ, ring slot it
      const uint32_t k_addr = k_ring + (it % STAGES) * L::KV_BYTES;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // bytes into the box's 128-byte rows
        wgmma_ss<BK>(sc, smem_desc(q_addr + (kk >> 2) * L::Q_BOX + col, 16, 1024),
                     smem_desc(k_addr + (kk >> 2) * L::KV_BOX + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      fence_regs(sc);
    };
    auto pv = [&](int it) {  // issues o += p v, ring slot it
      const uint32_t v_addr = v_ring + (it % STAGES) * L::KV_BYTES;
      mbar_wait(&v_full[it % STAGES], (it / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)  // 16 keys = two 8-row groups of V
        wgmma_rs_mn<D>(acc, pa[kc], smem_desc(v_addr + kc * 2048, L::KV_BOX, 1024));
      wgmma_commit();
      fence_regs(acc);
    };
    auto rescale = [&]() {  // skipped by a warp whose rows kept their max
      if (__any_sync(0xffffffffu, corr_lo != 1.f || corr_hi != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[4 * i] *= corr_lo;
          acc[4 * i + 1] *= corr_lo;
          acc[4 * i + 2] *= corr_hi;
          acc[4 * i + 3] *= corr_hi;
        }
      }
    };
    // Turns: warpgroup 0 issues first; each warpgroup hands the turn over
    // after issuing a key tile's products, warpgroup 1 not after the
    // block's last, so every wait on a barrier meets exactly one hand-over.
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
      auto softmax = [&](float (&sc)[BK / 2], int j) {
        const int k0 = j * BK;
        const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > rbase);
        online_softmax<BK, CAUSAL>(sc, edge, k0, S, row_lo, row_hi, t, scale_log2, m_lo,
                                   m_hi, l_lo, l_hi, corr_lo, corr_hi);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m_lo = m_hi = kMask;
      l_lo = l_hi = 0.f;
      mbar_wait(q_full, n & 1);
      {
        float sc[BK / 2];
        mbar_wait(&k_full[it % STAGES], (it / STAGES) & 1);
        take_turn();
        scores(sc, it);
        pass_turn(last_q && ntiles == 1);
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(&k_empty[it % STAGES]);
        if (ntiles == 1) mbar_arrive(q_empty);
        softmax(sc, 0);
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) c_to_a(pa[kc], &sc[8 * kc], &sc[8 * kc + 4]);
      }
      for (int j = 1; j < ntiles; ++j) {
        const int cur = it + j;
        float sc[BK / 2];
        mbar_wait(&k_full[cur % STAGES], (cur / STAGES) & 1);
        take_turn();
        scores(sc, cur);
        rescale();  // by the previous tile's correction, before its p v lands in o
        pv(cur - 1);
        pass_turn(last_q && j + 1 == ntiles);
        wgmma_wait<1>();  // the scores; p v may still run
        fence_regs(sc);
        mbar_arrive(&k_empty[cur % STAGES]);
        if (j + 1 == ntiles) mbar_arrive(q_empty);  // the producer may load the next q tile
        softmax(sc, j);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(pa);
        mbar_arrive(&v_empty[(cur - 1) % STAGES]);
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) c_to_a(pa[kc], &sc[8 * kc], &sc[8 * kc + 4]);
      }
      it += ntiles;
      rescale();
      pv(it - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pa);
      mbar_arrive(&v_empty[(it - 1) % STAGES]);

      const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
      const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
      const float inv_lo = 1.f / den_lo, inv_hi = 1.f / den_hi;
      constexpr float kLn2 = 0.6931471805599453f;
      if (row_lo < S) {
        bf16* out = o + (((long)b * S + row_lo) * H + h) * D + 2 * t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(out + 8 * i) =
              pack_bf16(acc[4 * i] * inv_lo, acc[4 * i + 1] * inv_lo);
        if (t == 0) lse[(long)bh * S + row_lo] = (m_lo + __log2f(den_lo)) * kLn2;
      }
      if (row_hi < S) {
        bf16* out = o + (((long)b * S + row_hi) * H + h) * D + 2 * t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(out + 8 * i) =
              pack_bf16(acc[4 * i + 2] * inv_hi, acc[4 * i + 3] * inv_hi);
        if (t == 0) lse[(long)bh * S + row_hi] = (m_hi + __log2f(den_hi)) * kLn2;
      }
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                    int S, int H, float scale, cudaStream_t stream) {
  using L = FwdLayout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_bshd(&tq, q, B, S, H, D, L::BQ);
  if (err == cudaSuccess) err = encode_bshd(&tk, k, B, S, H, D, L::BK);
  if (err == cudaSuccess) err = encode_bshd(&tv, v, B, S, H, D, L::BK);
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = persistent_grid((S + L::BQ - 1) / L::BQ, B * H, &grid);
  if (err != cudaSuccess) return err;
  return launch(fwd_kernel<D, CAUSAL>, grid, dim3(384), L::SMEM, stream, tq, tk, tv,
                static_cast<bf16*>(o), static_cast<float*>(lse), S, H, B * H, scale * kLog2e);
}

}  // namespace flash

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int H, int D,
                              int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? flash::run_fwd<64, true>(q, k, v, o, lse, B, S, H, scale, st)
                  : flash::run_fwd<64, false>(q, k, v, o, lse, B, S, H, scale, st);
  if (D == 128)
    return causal ? flash::run_fwd<128, true>(q, k, v, o, lse, B, S, H, scale, st)
                  : flash::run_fwd<128, false>(q, k, v, o, lse, B, S, H, scale, st);
  if (D == 256)
    return causal ? flash::run_fwd<256, true>(q, k, v, o, lse, B, S, H, scale, st)
                  : flash::run_fwd<256, false>(q, k, v, o, lse, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
