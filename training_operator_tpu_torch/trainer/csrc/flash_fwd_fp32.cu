// Flash-attention forward for Hopper (sm_90a), fp32 in and out.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_fwd_kernel
// (launched by _flash_fwd_folded) on fp32 inputs. Same function: out =
// softmax(q kᵀ * d^-0.5 [causal, keys < seq_len]) v, and lse = m + log(l)
// per row; the products in fp32-class precision (3xTF32, flash_fp32.cuh),
// the softmax in fp32.
//
// Bound on an H100: compute. At the flagship shape ([8, 2048, 12, 128],
// causal) the two products are ~1.0e11 FLOP against ~0.4 GB of fp32 inputs
// and outputs; at the fastest fp32-class rate, 3xTF32 at 495 / 3 = 165
// TFLOP/s, that is ~0.63 ms against ~0.12 ms of memory traffic.
//
// Design: the mma.sync design of the first bf16 kernels, on fp32 tiles.
// One block of 8 warps per (q tile, batch*head), each warp owning 16 query
// rows (at D = 256 a pair of warps, below); the block loops over key tiles of K
// and V in shared memory, double-buffered by cp.async so the next tile's
// copy runs under the current tile's products (the TPU's sequential
// innermost grid axis becomes this loop). Scores, the running max and sum
// and the output accumulator stay in registers in the mma C layout, and the
// probabilities feed p v from the lane's own registers (the permuted k axis
// of flash_fp32.cuh). A warp skips a key tile that lies wholly past its
// rows under the causal mask; the causal limit is the loop bound, and the
// mask is applied only on tiles that straddle the diagonal or the end of
// the sequence. Blocks are folded into grid x (q tile slow, batch*head
// fast, the causal grid's longest tiles first), so batch*heads has no
// grid-y limit. Rows past seq_len read as zeros and are never written.
// Tiles: D = 64 and 128 take 128 rows and 64-key tiles (102 and 198 KiB of
// shared memory). At D = 256 a warp's o accumulator over the whole head
// dim would be 128 registers a thread, beside the tile's p fragments held
// for its product (flash_fp32.cuh, Accumulation), and ptxas spills; so a
// block of 8 warps takes 64 rows and 32-key tiles (195 KiB), warps 2i and
// 2i+1 both own rows 16i .. 16i + 15, and each accumulates o over one half
// of D (as the dk/dv kernel splits D): both compute the rows' scores and
// softmax whole (1.5x the two products' FLOP), and only the first writes
// the lse.
#include "flash_fp32.cuh"

namespace flash {

template <int D>
struct FwdF32Layout {
  static constexpr bool SPLIT = D == 256;  // a row group's two warps split D
  static constexpr int WARPS = 8, BQ = SPLIT ? 64 : 128, BK = SPLIT ? 32 : 64;
  static constexpr int DW = SPLIT ? D / 2 : D;  // o columns of one warp
  static constexpr int LD = F32Tile<D>::LD;
  static constexpr int SMEM = (BQ + 4 * BK) * LD * (int)sizeof(float);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FwdF32Layout<D>::WARPS * 32, 1)
fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int S, int H, int BH, float scale_log2) {
  using L = FwdF32Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, DW = L::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sKV = sQ + BQ * LD;  // two buffers, each a K tile then a V tile

  const int nq = (S + BQ - 1) / BQ;
  const int rank = (int)(blockIdx.x / BH), bh = (int)(blockIdx.x % BH);
  const int qt = CAUSAL ? nq - 1 - rank : rank;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long off = ((long)b * S * H + h) * D;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = L::SPLIT ? 16 * (warp >> 1) : 16 * warp;  // the warp's rows in the tile
  const int col_off = L::SPLIT ? DW * (warp & 1) : 0;      // and its o columns
  const int row_lo = q0 + r0 + (lane >> 2), row_hi = row_lo + 8;

  const int kend = CAUSAL ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  load_rows_f32<BQ, D>(sQ, q + off, q0, S, rs);
  load_rows_f32<BK, D>(sKV, k + off, 0, S, rs);
  load_rows_f32<BK, D>(sKV + BK * LD, v + off, 0, S, rs);
  cp_commit();

  float acc[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Running max in the log2 domain (scores times scale * log2 e) and the
  // lane's partial row sums.
  float m_lo = kMask, m_hi = kMask, l_lo = 0.f, l_hi = 0.f;

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
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        Frag<4> a;
        load_a(a, sQ, LD, r0, kk * 8, lane);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          Frag<2> bb;
          load_b_nk(bb, cK, LD, n * 8, kk * 8, lane);
          mma3(s[n], a, bb);
        }
      }

      const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > q0 + r0);
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
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
      const float corr_lo = exp2f(m_lo - mx_lo), corr_hi = exp2f(m_hi - mx_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        s[n][0] = exp2f(s[n][0] - mx_lo);
        s[n][1] = exp2f(s[n][1] - mx_lo);
        s[n][2] = exp2f(s[n][2] - mx_hi);
        s[n][3] = exp2f(s[n][3] - mx_hi);
        sum_lo += s[n][0] + s[n][1];
        sum_hi += s[n][2] + s[n][3];
      }
      // Each lane keeps a partial row sum; the quad's partials are added
      // once at the end (the correction is the same on all four lanes).
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
      m_lo = mx_lo;
      m_hi = mx_hi;
      // o = o * corr + p v, the tile's p v summed on its own (flash_fp32.cuh).
      Frag<4> pa[BK / 8];
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) c_to_a_tf32(pa[kc], s[kc]);
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        float tile[4];
        mma3_tile(tile, pa, cV, LD, col_off + j * 8, lane);
        acc[j][0] = fmaf(acc[j][0], corr_lo, tile[0]);
        acc[j][1] = fmaf(acc[j][1], corr_lo, tile[1]);
        acc[j][2] = fmaf(acc[j][2], corr_hi, tile[2]);
        acc[j][3] = fmaf(acc[j][3], corr_hi, tile[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  const float inv_lo = 1.f / den_lo, inv_hi = 1.f / den_hi;
  constexpr float kLn2 = 0.6931471805599453f;
  const bool writes_lse = t == 0 && col_off == 0;
  if (row_lo < S) {
    float* out = o + off + (long)row_lo * rs + col_off + 2 * t;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (writes_lse) lse[(long)bh * S + row_lo] = m_lo * kLn2 + logf(den_lo);
  }
  if (row_hi < S) {
    float* out = o + off + (long)row_hi * rs + col_off + 2 * t;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
    if (writes_lse) lse[(long)bh * S + row_hi] = m_hi * kLn2 + logf(den_hi);
  }
}

template <int D, bool CAUSAL>
cudaError_t run_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int S, int H, float scale, cudaStream_t stream) {
  using L = FwdF32Layout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  dim3 grid;
  const cudaError_t err = folded_grid((S + L::BQ - 1) / L::BQ, (long)B * H, &grid);
  if (err != cudaSuccess) return err;
  constexpr float kLog2e = 1.4426950408889634f;
  return launch(fwd_f32_kernel<D, CAUSAL>, grid, dim3(L::WARPS * 32), L::SMEM, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                static_cast<float*>(lse), S, H, B * H, scale * kLog2e);
}

}  // namespace flash

extern "C" int flash_fwd_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int S, int H, int D, int causal, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? flash::run_fwd_f32<64, true>(q, k, v, o, lse, B, S, H, scale, st)
                  : flash::run_fwd_f32<64, false>(q, k, v, o, lse, B, S, H, scale, st);
  if (D == 128)
    return causal ? flash::run_fwd_f32<128, true>(q, k, v, o, lse, B, S, H, scale, st)
                  : flash::run_fwd_f32<128, false>(q, k, v, o, lse, B, S, H, scale, st);
  if (D == 256)
    return causal ? flash::run_fwd_f32<256, true>(q, k, v, o, lse, B, S, H, scale, st)
                  : flash::run_fwd_f32<256, false>(q, k, v, o, lse, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
