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
// Design: one block of four warps per (k tile of 64 keys, batch*head), each
// warp owning 16 keys, looping over 32-row q tiles (q, dO, lse, delta) in
// shared memory, double-buffered with cp.async. The block computes the
// transposed tiles sᵀ = k qᵀ and dpᵀ = v dOᵀ, so pᵀ and dsᵀ come out in the
// C layout with keys as rows and are re-packed in registers as the A
// operand of pᵀ dO and dsᵀ q. The q tile is 32 rows (not 64) to keep the two fp32 accumulators (dk and dv, 16 x D
// each per warp) and the transposed tiles within the register file. The
// causal start (the first q tile that reaches this k tile) is the loop's
// lower bound; q rows past seq_len are masked. Keys past seq_len are never
// written.
#include "flash_common.cuh"

namespace flash {

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
               float scale) {
  constexpr int BK = 64, BQ = 32, LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LD;
  bf16* sQdO = sV + BK * LD;  // two buffers, each a q tile then a dO tile
  float* sStats = reinterpret_cast<float*>(sQdO + 4 * BQ * LD);  // two (lse, delta)

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long off = ((long)b * S * H + h) * D;
  const float* lse_bh = lse + (long)bh * S;
  const float* delta_bh = delta + (long)bh * S;
  const int k0 = blockIdx.x * BK;  // causal: the first k tiles do the most work
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = warp * 16;
  const int key_lo = k0 + r0 + (lane >> 2), key_hi = key_lo + 8;

  const int qstart = CAUSAL ? (k0 / BQ) * BQ : 0;
  const int ntiles = (S - qstart + BQ - 1) / BQ;
  load_rows<BK, D>(sK, k + off, k0, S, rs);
  load_rows<BK, D>(sV, v + off, k0, S, rs);
  load_rows<BQ, D>(sQdO, q + off, qstart, S, rs);
  load_rows<BQ, D>(sQdO + BQ * LD, dout + off, qstart, S, rs);
  load_stats(sStats, lse_bh, BQ, qstart, S);
  load_stats(sStats + BQ, delta_bh, BQ, qstart, S);
  cp_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BQ;
    const bf16* cQ = sQdO + (it & 1) * 2 * BQ * LD;
    const bf16* cdO = cQ + BQ * LD;
    const float* cL = sStats + (it & 1) * 2 * BQ;
    const float* cD = cL + BQ;
    if (it + 1 < ntiles) {  // the next tile's copy runs under this tile's math
      const int nb = (it + 1) & 1;
      bf16* nQ = sQdO + nb * 2 * BQ * LD;
      load_rows<BQ, D>(nQ, q + off, q0 + BQ, S, rs);
      load_rows<BQ, D>(nQ + BQ * LD, dout + off, q0 + BQ, S, rs);
      load_stats(sStats + nb * 2 * BQ, lse_bh, BQ, q0 + BQ, S);
      load_stats(sStats + nb * 2 * BQ + BQ, delta_bh, BQ, q0 + BQ, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_a(ak, sK, LD, r0, kk * 16, lane);
      ldsm_a(av, sV, LD, r0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BQ / 8; n += 2) {
        uint32_t bb[2][2];
        ldsm_b_nk(bb, cQ, LD, n * 8, kk * 16, lane);
        mma_bf16(st[n], ak, bb[0]);
        mma_bf16(st[n + 1], ak, bb[1]);
        ldsm_b_nk(bb, cdO, LD, n * 8, kk * 16, lane);
        mma_bf16(dpt[n], av, bb[0]);
        mma_bf16(dpt[n + 1], av, bb[1]);
      }
    }

    const bool edge = (q0 + BQ > S) || (CAUSAL && q0 < k0 + BK - 1);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = n * 8 + 2 * t + (e & 1);  // q row within the tile
        float p = __expf(st[n][e] * scale - cL[ci]);
        if (edge) {
          const int col = q0 + ci;
          const int key = e < 2 ? key_lo : key_hi;
          if (col >= S || (CAUSAL && col < key)) p = 0.f;
        }
        st[n][e] = p;                            // pᵀ
        dpt[n][e] = p * (dpt[n][e] - cD[ci]);    // dsᵀ
      }
    }
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, st[2 * kc], st[2 * kc + 1]);
      c_to_a(ads, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bb[2][2];
        ldsm_b_kn(bb, cdO, LD, kc * 16, j * 8, lane);
        mma_bf16(dv_acc[j], ap, bb[0]);
        mma_bf16(dv_acc[j + 1], ap, bb[1]);
        ldsm_b_kn(bb, cQ, LD, kc * 16, j * 8, lane);
        mma_bf16(dk_acc[j], ads, bb[0]);
        mma_bf16(dk_acc[j + 1], ads, bb[1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  if (key_lo < S) {
    bf16* pk = dk + off + (long)key_lo * rs + 2 * t;
    bf16* pv = dv + off + (long)key_lo * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(pk + j * 8) = pack_bf16(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
      *reinterpret_cast<uint32_t*>(pv + j * 8) = pack_bf16(dv_acc[j][0], dv_acc[j][1]);
    }
  }
  if (key_hi < S) {
    bf16* pk = dk + off + (long)key_hi * rs + 2 * t;
    bf16* pv = dv + off + (long)key_hi * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(pk + j * 8) = pack_bf16(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
      *reinterpret_cast<uint32_t*>(pv + j * 8) = pack_bf16(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int H, float scale,
                    cudaStream_t stream) {
  constexpr int BK = 64, BQ = 32, LD = Tile<D>::LD;
  const int smem = (2 * BK + 4 * BQ) * LD * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);
  dim3 grid((S + BK - 1) / BK, B * H);
  return launch(bwd_dkv_kernel<D, CAUSAL>, grid, dim3(128), smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, scale);
}

}  // namespace flash

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int S, int H, int D, int causal, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? flash::run_dkv<64, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : flash::run_dkv<64, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  if (D == 128)
    return causal ? flash::run_dkv<128, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : flash::run_dkv<128, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
