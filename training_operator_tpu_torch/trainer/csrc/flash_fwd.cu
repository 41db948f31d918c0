// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_fwd_kernel
// (launched by _flash_fwd_folded). Same function: out = softmax(q kᵀ * d^-0.5
// [causal, keys < seq_len]) v, and lse = m + log(l) per row.
//
// Bound on an H100: compute. At the flagship shape ([8, 2048, 12, 128],
// causal) the two products are ~1.0e11 FLOP against ~0.2 GB of inputs and
// outputs, ~500 FLOP per byte, above the card's ~295 FLOP/byte ridge.
//
// Design: one block of four warps per (q tile of 64 rows, batch*head); each
// warp owns 16 query rows. The block loops over 64-key tiles of K and V
// staged in shared memory (the TPU's sequential innermost grid axis becomes
// this loop). Scores, the running max/sum and the output accumulator stay in
// registers in the mma C layout; the probabilities are re-packed in
// registers as the A operand of p v. K/V tiles are double-buffered: the
// next tile's cp.async copy runs under the current tile's products. The
// causal limit is the loop bound, and the mask is applied only on tiles that
// straddle the diagonal or the end of the sequence. Causal grids start with
// the longest q tiles so the tail of the launch is short. No padding is
// written to memory: K/V rows past seq_len read as zeros and are masked, and
// output rows past it are skipped. Not yet: TMA, wgmma, warp specialisation.
#include "flash_common.cuh"

namespace flash {

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int S, int H, float scale) {
  constexpr int BQ = 64, BK = 64, LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + BQ * LD;  // two buffers, each a K tile then a V tile

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
  load_rows<BK, D>(sKV, k + off, 0, S, rs);
  load_rows<BK, D>(sKV + BK * LD, v + off, 0, S, rs);
  cp_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = kMask, m_hi = kMask, l_lo = 0.f, l_hi = 0.f;

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

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_a(a, sQ, LD, r0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t bb[2][2];
        ldsm_b_nk(bb, cK, LD, n * 8, kk * 16, lane);
        mma_bf16(s[n], a, bb[0]);
        mma_bf16(s[n + 1], a, bb[1]);
      }
    }

    const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > q0);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= S || (CAUSAL && col > row)) x = kMask;
        }
        s[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float corr_lo = __expf(m_lo - mx_lo), corr_hi = __expf(m_hi - mx_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = __expf(s[n][0] - mx_lo);
      s[n][1] = __expf(s[n][1] - mx_lo);
      s[n][2] = __expf(s[n][2] - mx_hi);
      s[n][3] = __expf(s[n][3] - mx_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
    // Each lane keeps a partial row sum; the quad's partials are added once
    // at the end (the correction factor is the same on all four lanes).
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
    m_lo = mx_lo;
    m_hi = mx_hi;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr_lo;
      acc[j][1] *= corr_lo;
      acc[j][2] *= corr_hi;
      acc[j][3] *= corr_hi;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      c_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bb[2][2];
        ldsm_b_kn(bb, cV, LD, kc * 16, j * 8, lane);
        mma_bf16(acc[j], a, bb[0]);
        mma_bf16(acc[j + 1], a, bb[1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  const float inv_lo = 1.f / den_lo, inv_hi = 1.f / den_hi;
  if (row_lo < S) {
    bf16* out = o + off + (long)row_lo * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) = pack_bf16(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (t == 0) lse[(long)bh * S + row_lo] = m_lo + logf(den_lo);
  }
  if (row_hi < S) {
    bf16* out = o + off + (long)row_hi * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) = pack_bf16(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
    if (t == 0) lse[(long)bh * S + row_hi] = m_hi + logf(den_hi);
  }
}

template <int D, bool CAUSAL>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int S, int H, float scale,
                    cudaStream_t stream) {
  constexpr int BQ = 64, BK = 64, LD = Tile<D>::LD;
  const int smem = (BQ + 4 * BK) * LD * (int)sizeof(bf16);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  return launch(fwd_kernel<D, CAUSAL>, grid, dim3(128), smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o),
                static_cast<float*>(lse), S, H, scale);
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
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
