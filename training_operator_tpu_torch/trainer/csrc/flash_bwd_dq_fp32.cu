// Flash-attention backward, dq, for Hopper (sm_90a), fp32.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_bwd_dq_kernel
// (launched by _flash_bwd_folded) on fp32 inputs. Same function: with
// p = exp(s - lse) and ds = p * (dO vᵀ - delta), dq = d^-0.5 * ds k, where s
// is the masked, scaled score tile recomputed from q and k; the products in
// fp32-class precision (3xTF32, flash_fp32.cuh).
//
// Bound on an H100: compute. Three products per (q, k) tile pair (q kᵀ,
// dO vᵀ, ds k): ~1.5e11 FLOP at the flagship shape, ~0.94 ms at 3xTF32's
// 165 TFLOP/s, against ~0.5 GB of fp32 traffic (~0.15 ms).
//
// Design: the forward kernel's loop with dO and V beside q and K, and no
// online softmax (lse is given). One block of WARPS warps per (q tile of
// 16 * WARPS rows, batch*head), each warp owning 16 rows whose lse (times
// log2 e) and delta it keeps in registers; q and dO stay in shared memory
// for the whole loop, K and V tiles are double-buffered by cp.async. s,
// dp, p and ds never leave registers: ds feeds ds k from the lane's own
// registers (the permuted k axis of flash_fp32.cuh). A warp skips a key
// tile that lies wholly past its rows under the causal mask; the causal
// limit is the loop bound. The fp32 accumulator is written once, scaled, at
// the end; rows past seq_len are not written. No atomics: each block
// writes its own rows once, so results are the same from run to run.
// Blocks are folded into grid x (longest causal tiles first). Tiles: D = 64
// takes 8 warps and 64-key tiles (136 KiB of shared memory), D = 128 8
// warps and 32-key tiles (198 KiB), D = 256 4 warps and 16-key tiles (195
// KiB; the q and dO tiles alone are 130 KiB).
#include "flash_fp32.cuh"

namespace flash {

template <int D>
struct DqF32Layout {
  static constexpr int WARPS = D == 256 ? 4 : 8;
  static constexpr int BQ = 16 * WARPS, LD = F32Tile<D>::LD;
  static constexpr int BK = D == 64 ? 64 : D == 128 ? 32 : 16;
  static constexpr int SMEM = (2 * BQ + 4 * BK) * LD * (int)sizeof(float);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(DqF32Layout<D>::WARPS * 32, 1)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int S, int H, int BH, float scale,
                  float scale_log2) {
  using L = DqF32Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + BQ * LD;
  float* sKV = sdO + BQ * LD;  // two buffers, each a K tile then a V tile

  const int nq = (S + BQ - 1) / BQ;
  const int rank = (int)(blockIdx.x / BH), bh = (int)(blockIdx.x % BH);
  const int qt = CAUSAL ? nq - 1 - rank : rank;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long off = ((long)b * S * H + h) * D;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = warp * 16;
  const int row_lo = q0 + r0 + (lane >> 2), row_hi = row_lo + 8;

  const int kend = CAUSAL ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  load_rows_f32<BQ, D>(sQ, q + off, q0, S, rs);
  load_rows_f32<BQ, D>(sdO, dout + off, q0, S, rs);
  load_rows_f32<BK, D>(sKV, k + off, 0, S, rs);
  load_rows_f32<BK, D>(sKV + BK * LD, v + off, 0, S, rs);
  cp_commit();
  const float lse_lo = row_lo < S ? lse[(long)bh * S + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < S ? lse[(long)bh * S + row_hi] * kLog2e : 0.f;
  const float dl_lo = row_lo < S ? delta[(long)bh * S + row_lo] : 0.f;
  const float dl_hi = row_hi < S ? delta[(long)bh * S + row_hi] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    const float* cK = sKV + (it & 1) * 2 * BK * LD;
    const float* cV = cK + BK * LD;
    if (it + 1 < ntiles) {  // the next tile's copy runs under this tile's math
      float* nK = sKV + ((it + 1) & 1) * 2 * BK * LD;
      load_rows_f32<BK, D>(nK, k + off, k0 + BK, S, rs);
      load_rows_f32<BK, D>(nK + BK * LD, v + off, k0 + BK, S, rs);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    if (!(CAUSAL && k0 > q0 + r0 + 15)) {  // some key of the tile is visible to the warp
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        Frag<4> aq, ado;
        load_a(aq, sQ, LD, r0, kk * 8, lane);
        load_a(ado, sdO, LD, r0, kk * 8, lane);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          Frag<2> bb;
          load_b_nk(bb, cK, LD, n * 8, kk * 8, lane);
          mma3(s[n], aq, bb);
          load_b_nk(bb, cV, LD, n * 8, kk * 8, lane);
          mma3(dp[n], ado, bb);
        }
      }

      const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > q0 + r0);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          float p = exp2f(fmaf(s[n][e], scale_log2, lo ? -lse_lo : -lse_hi));
          if (edge) {
            const int col = k0 + n * 8 + 2 * t + (e & 1);
            const int row = lo ? row_lo : row_hi;
            if (col >= S || (CAUSAL && col > row)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - (lo ? dl_lo : dl_hi));  // ds
        }
      }
      Frag<4> da[BK / 8];  // dq += ds k, the tile's summed on its own
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) c_to_a_tf32(da[kc], s[kc]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) mma3_add(acc[j], da, cK, LD, j * 8, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  if (row_lo < S) {
    float* out = dq + off + (long)row_lo * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][0] * scale, acc[j][1] * scale);
  }
  if (row_hi < S) {
    float* out = dq + off + (long)row_hi * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D, bool CAUSAL>
cudaError_t run_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int B, int S, int H,
                       float scale, cudaStream_t stream) {
  using L = DqF32Layout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  dim3 grid;
  const cudaError_t err = folded_grid((S + L::BQ - 1) / L::BQ, (long)B * H, &grid);
  if (err != cudaSuccess) return err;
  constexpr float kLog2e = 1.4426950408889634f;
  return launch(bwd_dq_f32_kernel<D, CAUSAL>, grid, dim3(L::WARPS * 32), L::SMEM, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<float*>(dq), S, H, B * H, scale, scale * kLog2e);
}

}  // namespace flash

extern "C" int flash_bwd_dq_fp32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int S, int H, int D, int causal,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? flash::run_dq_f32<64, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : flash::run_dq_f32<64, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  if (D == 128)
    return causal ? flash::run_dq_f32<128, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : flash::run_dq_f32<128, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  if (D == 256)
    return causal ? flash::run_dq_f32<256, true>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st)
                  : flash::run_dq_f32<256, false>(q, k, v, dout, lse, delta, dq, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
