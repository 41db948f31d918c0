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
// Design: one block of four warps per (q tile of 64 rows, batch*head), each
// warp owning 16 rows, looping over 64-key tiles of K and V in shared memory.
// q and dO stay in shared memory for the whole loop; K/V tiles are
// double-buffered with cp.async; lse and delta for the warp's rows live in
// registers. s, dp, p and ds never leave registers: ds is
// re-packed from the C layout into the A operand of ds k. The causal limit is
// the loop bound. The fp32 dq accumulator is written once, scaled, at the
// end; rows past seq_len are not written. Causal grids run the longest q
// tiles first.
#include "flash_common.cuh"

namespace flash {

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int H, float scale) {
  constexpr int BQ = 64, BK = 64, LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BQ * LD;
  bf16* sKV = sdO + BQ * LD;  // two buffers, each a K tile then a V tile

  const int nq = (S + BQ - 1) / BQ;
  const int qt = CAUSAL ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long off = ((long)b * S * H + h) * D;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = warp * 16;
  const int row_lo = q0 + r0 + (lane >> 2), row_hi = row_lo + 8;

  const int kend = CAUSAL ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  load_rows<BQ, D>(sQ, q + off, q0, S, rs);
  load_rows<BQ, D>(sdO, dout + off, q0, S, rs);
  load_rows<BK, D>(sKV, k + off, 0, S, rs);
  load_rows<BK, D>(sKV + BK * LD, v + off, 0, S, rs);
  cp_commit();
  const float lse_lo = row_lo < S ? lse[(long)bh * S + row_lo] : 0.f;
  const float lse_hi = row_hi < S ? lse[(long)bh * S + row_hi] : 0.f;
  const float dl_lo = row_lo < S ? delta[(long)bh * S + row_lo] : 0.f;
  const float dl_hi = row_hi < S ? delta[(long)bh * S + row_hi] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    const bf16* cK = sKV + (it & 1) * 2 * BK * LD;
    const bf16* cV = cK + BK * LD;
    if (it + 1 < ntiles) {  // the next tile's copy runs under this tile's math
      bf16* nK = sKV + ((it + 1) & 1) * 2 * BK * LD;
      load_rows<BK, D>(nK, k + off, k0 + BK, S, rs);
      load_rows<BK, D>(nK + BK * LD, v + off, k0 + BK, S, rs);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_a(aq, sQ, LD, r0, kk * 16, lane);
      ldsm_a(ado, sdO, LD, r0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t bb[2][2];
        ldsm_b_nk(bb, cK, LD, n * 8, kk * 16, lane);
        mma_bf16(s[n], aq, bb[0]);
        mma_bf16(s[n + 1], aq, bb[1]);
        ldsm_b_nk(bb, cV, LD, n * 8, kk * 16, lane);
        mma_bf16(dp[n], ado, bb[0]);
        mma_bf16(dp[n + 1], ado, bb[1]);
      }
    }

    const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = __expf(s[n][e] * scale - (lo ? lse_lo : lse_hi));
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = lo ? row_lo : row_hi;
          if (col >= S || (CAUSAL && col > row)) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - (lo ? dl_lo : dl_hi));  // ds
      }
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      c_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bb[2][2];
        ldsm_b_kn(bb, cK, LD, kc * 16, j * 8, lane);
        mma_bf16(acc[j], a, bb[0]);
        mma_bf16(acc[j + 1], a, bb[1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  if (row_lo < S) {
    bf16* out = dq + off + (long)row_lo * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) = pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
  }
  if (row_hi < S) {
    bf16* out = dq + off + (long)row_hi * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) = pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D, bool CAUSAL>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int S,
                   int H, float scale, cudaStream_t stream) {
  constexpr int BQ = 64, BK = 64, LD = Tile<D>::LD;
  const int smem = (2 * BQ + 4 * BK) * LD * (int)sizeof(bf16);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  return launch(bwd_dq_kernel<D, CAUSAL>, grid, dim3(128), smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<bf16*>(dq), S, H, scale);
}

}  // namespace flash

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int S,
                                 int H, int D, int causal, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? flash::run_dq<64, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : flash::run_dq<64, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  if (D == 128)
    return causal ? flash::run_dq<128, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : flash::run_dq<128, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
