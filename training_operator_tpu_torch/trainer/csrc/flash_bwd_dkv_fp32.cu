// Flash-attention backward, dk and dv, for Hopper (sm_90a), fp32.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_bwd_dkv_kernel
// (launched by _flash_bwd_folded) on fp32 inputs. Same function: with
// p = exp(s - lse) and ds = p * (dO vᵀ - delta), dv = pᵀ dO and
// dk = d^-0.5 * dsᵀ q; the products in fp32-class precision (3xTF32,
// flash_fp32.cuh).
//
// Bound on an H100: compute. Four products per (k, q) tile pair (k qᵀ,
// v dOᵀ, pᵀ dO, dsᵀ q): ~2.1e11 FLOP at the flagship shape, ~1.25 ms at
// 3xTF32's 165 TFLOP/s, against ~0.6 GB of fp32 traffic (~0.18 ms).
//
// Design: one block of four warps per (k tile, batch*head), folded into
// grid x (k tile fastest; causal: the first k tiles do the most work),
// looping over q tiles (q, dO, lse, delta; 32 rows at D = 64, 16 above,
// where a tile's pᵀ or dsᵀ fragments, held for its products, would leave
// ptxas short of registers) in shared memory,
// double-buffered by cp.async. The block computes the transposed tiles
// sᵀ = k qᵀ and dpᵀ = v dOᵀ, so pᵀ and dsᵀ come out in the C layout with
// keys as rows and feed pᵀ dO and dsᵀ q from the lane's own registers (the
// permuted k axis of flash_fp32.cuh). The causal start (the first q tile
// that reaches this k tile) is the loop's lower bound, a warp skips q tiles
// that lie wholly before its keys, and q rows past seq_len are masked. Keys
// past seq_len are never written. No atomics: each block writes its own
// dk, dv rows once.
//
// A warp's dk and dv of 16 keys over D columns are D fp32 registers a
// thread. At D = 64 and 128 each warp owns 16 keys and all D columns (a
// 64-key tile; 69 and 99 KiB of shared memory). At D = 256 that would be
// 256 registers, so a block takes 32 keys and warp w owns keys
// 16 (w / 2) .. + 15 and columns 128 (w % 2) .. + 127 of dk and dv: both
// warps of a key group compute sᵀ and dpᵀ over the whole head dim (1.5x
// the four products' FLOP), and each reads the q and dO columns of its half
// for its dk and dv products (130 KiB of shared memory).
#include "flash_fp32.cuh"

namespace flash {

template <int D>
struct DkvF32Layout {
  static constexpr bool SPLIT = D == 256;  // a key group's two warps split D
  static constexpr int WARPS = 4, BQ = D == 64 ? 32 : 16, LD = F32Tile<D>::LD;
  static constexpr int BK = SPLIT ? 32 : 64;
  static constexpr int DW = SPLIT ? D / 2 : D;  // dk, dv columns of one warp
  static constexpr int STATS_OFF = (2 * BK + 4 * BQ) * LD;  // floats
  static constexpr int SMEM = (STATS_OFF + 4 * BQ) * (int)sizeof(float);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128, 1)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int H, float scale,
                   float scale_log2) {
  using L = DkvF32Layout<D>;
  constexpr int BK = L::BK, BQ = L::BQ, LD = L::LD, DW = L::DW;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BK * LD;
  float* sQdO = sV + BK * LD;  // two buffers, each a q tile then a dO tile
  float* sStats = sK + L::STATS_OFF;  // two buffers, each lse (times log2 e) then delta

  const int n_kt = (S + BK - 1) / BK;
  const int k0 = (int)(blockIdx.x % n_kt) * BK;
  const int bh = (int)(blockIdx.x / n_kt), b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long off = ((long)b * S * H + h) * D;
  const float* lse_bh = lse + (long)bh * S;
  const float* delta_bh = delta + (long)bh * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = L::SPLIT ? 16 * (warp >> 1) : 16 * warp;  // the warp's keys in the tile
  const int col_off = L::SPLIT ? DW * (warp & 1) : 0;      // and its dk, dv columns
  const int kbase = k0 + r0;
  const int key_lo = kbase + (lane >> 2), key_hi = key_lo + 8;

  const int qstart = CAUSAL ? (k0 / BQ) * BQ : 0;
  const int ntiles = (S - qstart + BQ - 1) / BQ;
  auto load_q_tile = [&](int buf, int q0) {
    float* dst = sQdO + buf * 2 * BQ * LD;
    load_rows_f32<BQ, D>(dst, q + off, q0, S, rs);
    load_rows_f32<BQ, D>(dst + BQ * LD, dout + off, q0, S, rs);
    load_stats(sStats + buf * 2 * BQ, lse_bh, BQ, q0, S);
    load_stats(sStats + buf * 2 * BQ + BQ, delta_bh, BQ, q0, S);
  };
  load_rows_f32<BK, D>(sK, k + off, k0, S, rs);
  load_rows_f32<BK, D>(sV, v + off, k0, S, rs);
  load_q_tile(0, qstart);
  cp_commit();

  float dk_acc[DW / 8][4], dv_acc[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BQ;
    const float* cQ = sQdO + (it & 1) * 2 * BQ * LD;
    const float* cdO = cQ + BQ * LD;
    const float* cL = sStats + (it & 1) * 2 * BQ;
    const float* cD = cL + BQ;
    if (it + 1 < ntiles) {  // the next tile's copy runs under this tile's math
      load_q_tile((it + 1) & 1, q0 + BQ);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    if (!(CAUSAL && q0 + BQ - 1 < kbase)) {  // some q row reaches the warp's keys
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        Frag<4> ak, av;
        load_a(ak, sK, LD, r0, kk * 8, lane);
        load_a(av, sV, LD, r0, kk * 8, lane);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          Frag<2> bb;
          load_b_nk(bb, cQ, LD, n * 8, kk * 8, lane);
          mma3(st[n], ak, bb);
          load_b_nk(bb, cdO, LD, n * 8, kk * 8, lane);
          mma3(dpt[n], av, bb);
        }
      }

      // pᵀ and dsᵀ: keys as rows, q rows as columns, so lse and delta are
      // indexed by column.
      const bool edge = (q0 + BQ > S) || (CAUSAL && q0 < kbase + 15);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = n * 8 + 2 * t + (e & 1);  // q row within the tile
          float p = exp2f(fmaf(st[n][e], scale_log2, -cL[ci] * kLog2e));
          if (edge) {
            const int key = e < 2 ? key_lo : key_hi;
            if (q0 + ci >= S || (CAUSAL && q0 + ci < key)) p = 0.f;
          }
          st[n][e] = p;                                  // pᵀ
          dpt[n][e] = p * (dpt[n][e] - cD[ci]);          // dsᵀ
        }
      }
      // dv += pᵀ dO and dk += dsᵀ q, each tile's summed on its own.
      Frag<4> a[BQ / 8];
#pragma unroll
      for (int kc = 0; kc < BQ / 8; ++kc) c_to_a_tf32(a[kc], st[kc]);
#pragma unroll
      for (int j = 0; j < DW / 8; ++j)
        mma3_add(dv_acc[j], a, cdO, LD, col_off + j * 8, lane);
#pragma unroll
      for (int kc = 0; kc < BQ / 8; ++kc) c_to_a_tf32(a[kc], dpt[kc]);
#pragma unroll
      for (int j = 0; j < DW / 8; ++j)
        mma3_add(dk_acc[j], a, cQ, LD, col_off + j * 8, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  if (key_lo < S) {
    const long o = off + (long)key_lo * rs + col_off + 2 * t;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<float2*>(dk + o + j * 8) =
          make_float2(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
      *reinterpret_cast<float2*>(dv + o + j * 8) = make_float2(dv_acc[j][0], dv_acc[j][1]);
    }
  }
  if (key_hi < S) {
    const long o = off + (long)key_hi * rs + col_off + 2 * t;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<float2*>(dk + o + j * 8) =
          make_float2(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
      *reinterpret_cast<float2*>(dv + o + j * 8) = make_float2(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t run_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                        int H, float scale, cudaStream_t stream) {
  using L = DkvF32Layout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  dim3 grid;
  const cudaError_t err = folded_grid((S + L::BK - 1) / L::BK, (long)B * H, &grid);
  if (err != cudaSuccess) return err;
  constexpr float kLog2e = 1.4426950408889634f;
  return launch(bwd_dkv_f32_kernel<D, CAUSAL>, grid, dim3(L::WARPS * 32), L::SMEM, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<float*>(dk), static_cast<float*>(dv), S, H, scale,
                scale * kLog2e);
}

}  // namespace flash

extern "C" int flash_bwd_dkv_fp32(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int S, int H, int D, int causal,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? flash::run_dkv_f32<64, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : flash::run_dkv_f32<64, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  if (D == 128)
    return causal ? flash::run_dkv_f32<128, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : flash::run_dkv_f32<128, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  if (D == 256)
    return causal ? flash::run_dkv_f32<256, true>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st)
                  : flash::run_dkv_f32<256, false>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
