// Flash-attention forward for Hopper (sm_90a), fp32 in and out.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_fwd_kernel
// (launched by _flash_fwd_folded) on fp32 inputs. Same function: out =
// softmax(q kᵀ * d^-0.5 [causal, keys < seq_len]) v, and lse = m + log(l)
// per row; the products in fp32-class precision (3xTF32 on `mma.sync`,
// flash_fp32.cuh), the softmax in fp32, each key tile's p v summed from
// zero and added to o * corr in rounded fp32.
//
// Bound on an H100: compute. At the flagship shape ([8, 2048, 12, 128],
// causal) the two products are ~1.0e11 FLOP against ~0.4 GB of fp32 inputs
// and outputs; at the fastest fp32-class rate, 3xTF32 at 495 / 3 = 165
// TFLOP/s, that is ~0.63 ms against ~0.12 ms of memory traffic. Each
// product step is three `mma.sync` m16n8k8 on TF32, whose measured rate
// (0.619 a cycle per SM on an H100, probed alone) puts the 1.51e8 HMMA of that
// shape at ~1.05 ms: the floor of this design. What the warps issue beside
// the products and the shared memory they read set how far above it the
// kernel runs. Per HMMA at D = 128, against a scheduler's 6.46 issue slots
// and the SM's 1.62 shared-memory wavefronts in the time the tensor pipe
// takes for one HMMA at that rate:
//   the first design (16 q rows a warp, every operand split as loaded from
//   row-major tiles, two block barriers a tile): ~6.4 issue slots, 0.83
//   wavefronts;
//   this design (per warp and 16-key tile: 192 HMMA; q planes 32 16-byte
//   loads, K 32 4-byte loads and 32 splits, V 8 16-byte loads and 32
//   splits, p 16 splits, the softmax on 16 values, o's rescale, the
//   exchange): ~4.7 issue slots, ~1.3 wavefronts (0.67 of them the q
//   planes, re-read every tile).
// Neither count binds: at the flagship shape the kernel makes ~0.36 HMMA a
// cycle per SM (its HMMA over its time in chip_smoke.py phase 3). Clock64
// counters in instrumented builds put most of a consumer warp's time in
// the two products, where two warps a scheduler do not keep the tensor pipe
// busy; taking out the splits, the softmax's exp and shuffles or the
// exchange barrier, loading operands a step ahead, a second partial sum in
// q kᵀ and 32-key tiles each moved the time by a few percent at most
// (PERF.md, the fp32 forward's findings).
//
// The design:
//
// 1. A warp owns 32 q rows x 64 head-dim columns, at every D. A group of
//    G = D / 64 warps shares 32 rows; 8 consumer warps make BQ = 256 / G
//    rows a block. Each warp computes the partial s = q kᵀ over its 64
//    columns, as two m16 tiles that share every B fragment of K, writes it
//    to its exchange buffer, meets its group at a named barrier and adds
//    the G partials in group order: every warp of the group adds the same
//    values in the same order, so all hold the same scores bit for bit
//    (two buffers by tile parity, so a buffer is rewritten only after every
//    partner has passed the next barrier, that is, after its reads). Each
//    warp then runs the masked online softmax on the 32 x BK tile and
//    accumulates p v into its 64 columns of o (2 x 8 x 4 = 64 registers);
//    the group's first warp writes the lse. At D = 64 (G = 1) there is no
//    exchange. No product is computed twice: at D = 256 a launch makes two
//    thirds of the first design's HMMA, whose pairs of warps each computed
//    the whole q kᵀ of their 16 rows (per 16 rows and 32 keys 768 HMMA
//    against 1,152, from the loop bounds).
// 2. q loaded once per block. At the block's start each warp splits its 32
//    rows x 64 columns of q once into A planes (`stage_a_planes`, two calls
//    of 16 rows on the warp's column offset): one 16-byte load per plane
//    and fragment in the key loop, and no split.
// 3. K and V raw through an mbarrier ring. A producer warpgroup copies each
//    16-key tile of K and V by cp.async into a stage (rows past seq_len as
//    zeros) and each thread arrives on the stage's full mbarrier when its
//    copies land (`cp_async_arrive`); every consumer thread waits on full
//    and arrives on empty when its products are done; the producer waits on
//    empty before it refills. The tiles are row-major with a row stride of
//    D + 4 floats, so K's nk fragments (rows g, columns t and t + 4, as in
//    `load_b_nk`) and V's kn fragments fall on 32 distinct banks. A lane
//    reads V as one 16-byte load from each of rows 2t and 2t + 1 (the
//    permuted k axis of `c_to_a_tf32`) at columns 4g .. 4g + 3: the B
//    fragments of four n tiles at once, n tile i taking column 4g + i, so
//    o's columns come out permuted and a lane writes 8 neighbouring columns
//    of each 32 (two 16-byte stores). The block's only __syncthreads
//    follows the barriers' initialisation.
//
// One block per (q tile, batch*head), folded into grid x (q tile slow, the
// causal grid's longest tiles first), so batch*heads has no grid-y limit.
// The causal limit is the loop's bound; a group skips the key tiles wholly
// past its rows (a suffix of the loop; it still waits on and releases their
// stages), and the mask is applied only on tiles that straddle the diagonal
// or the end of the sequence. Keys past seq_len read as zeros and are
// masked; rows past it read as zeros and are never written. No atomics:
// each block writes its own rows once, so results are the same from run to
// run.
//
// Budget per head dim, 16-key tiles at every D (shared memory: 227 KiB a
// block; q planes split, 8 warps x 16 KiB = 128 KiB):
//   D =  64: 8 groups of one warp (256 q rows); ring 4 x 8.5 KiB: 162 KiB.
//   D = 128: 4 groups of two warps (128 rows); ring 3 x 16.5 KiB, exchange
//            8 warps x 2 x 2 KiB: 209.5 KiB.
//   D = 256: 2 groups of four warps (64 rows); ring 2 x 32.5 KiB, exchange
//            8 x 2 x 2 KiB: 225 KiB.
// 32-key tiles, as planned, spilled at D = 64 and 128 (with q planes raw at
// D = 128 to fit) and were no faster.
// Registers: the block is three warpgroups, 168 a thread at launch; the
// producer gives up all but PRODUCER_REGS and the consumers take
// CONSUMER_REGS (setmaxnreg). A consumer holds o (64), the partial then
// total scores (BK), the p fragments (2 BK), one 32-column pass's p v sums
// from zero (32) and the softmax statistics (8). Every instantiation
// compiles with no spill.
#include "flash_fp32.cuh"
#include "sm90_common.cuh"

namespace flash {

template <int D>
struct FwdF32Layout {
  static constexpr int G = D / 64;  // warps of a row group, 64 head-dim columns each
  static constexpr int CW = 8;      // consumer warps, then one producer warpgroup
  static constexpr int THREADS = (CW + 4) * 32;
  static constexpr int BQ = 32 * (CW / G), BK = 16;
  static constexpr int STAGES = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int LD = D + 4;  // floats per row of a K or V tile
  // Floats. A warp's q planes are two m16 tiles of 64 columns, hi then lo
  // per 8 columns; a stage is the K tile's rows, then the V tile's; a warp's
  // exchange buffers (two, by tile parity) hold its partial 32 x BK score
  // tile in C-fragment order.
  static constexpr int Q_M16 = 8 * 256;
  static constexpr int STAGE = 2 * BK * LD;
  static constexpr int XCH = G > 1 ? 32 * BK : 0;
  static constexpr int RING_OFF = CW * 2 * Q_M16;
  static constexpr int XCH_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BAR_OFF = XCH_OFF + CW * 2 * XCH;  // even: 8-byte aligned
  static constexpr int SMEM = BAR_OFF * 4 + 2 * STAGES * 8;
  // The producer's registers give the consumers theirs:
  // 128 x (168 - 40) = 256 x (232 - 168).
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FwdF32Layout<D>::THREADS, 1)
fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int S, int H, int BH, float scale_log2) {
  using L = FwdF32Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES, LD = L::LD, G = L::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* ring = smem + L::RING_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int nq = (S + BQ - 1) / BQ;
  const int rank = (int)(blockIdx.x / BH), bh = (int)(blockIdx.x % BH);
  const int qt = CAUSAL ? nq - 1 - rank : rank;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long off = ((long)b * S * H + h) * D;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kend = CAUSAL ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);          // every producer thread
      mbar_init(&empty[s], L::CW * 32);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= L::CW) {
    // Producer warpgroup: each thread copies its 16-byte chunks of a tile's
    // K rows, then V rows, into the stage and arrives on full when they land.
    reg_dealloc<L::PRODUCER_REGS>();
    constexpr int CPR = D / 4, RSTEP = 128 / CPR;  // chunks a row; rows a pass
    const int pt = threadIdx.x - 32 * L::CW;
    const int c = (pt % CPR) * 4, rr = pt / CPR;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES, row0 = j * BK;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      float* dst = ring + s * L::STAGE + rr * LD + c;
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // K rows, then V rows
        const float* src = (x ? v : k) + off + c;
#pragma unroll
        for (int m = 0; m < BK / RSTEP; ++m) {
          const int r = rr + m * RSTEP;
          const bool in = row0 + r < S;
          cp_async16(dst + (x * BK + m * RSTEP) * LD, src + (long)(in ? row0 + r : 0) * rs, in);
        }
      }
      cp_async_arrive(&full[s]);
    }
    // Its last tile's barrier completes once every copy of the block has
    // landed: no copy outlives the thread that issued it.
    mbar_wait(&full[(ntiles - 1) % STAGES], ((ntiles - 1) / STAGES) & 1);
    return;
  }

  // Consumers: group `grp` owns q rows q0 + 32 grp .. + 31, and warp `part`
  // of it the head-dim columns 64 part .. + 63 of q, K, V and o.
  reg_alloc<L::CONSUMER_REGS>();
  const int grp = warp / G, part = warp % G;
  const int r0 = 32 * grp, c0 = 64 * part;
  const int t = lane & 3;
  float* qa = smem + warp * 2 * L::Q_M16;
#pragma unroll
  for (int m = 0; m < 2; ++m)
    stage_a_planes<64, true>(qa + m * L::Q_M16, q + off + c0, q0 + r0 + 16 * m, S, rs, lane);
  __syncwarp();
  float* xch = smem + L::XCH_OFF + grp * G * 2 * L::XCH;  // [part][tile parity]

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // Running max in the log2 domain (scores times scale * log2 e) and the
  // lane's partial row sums, per m16 tile and row half (g, g + 8).
  float mrow[2][2] = {{kMask, kMask}, {kMask, kMask}}, lrow[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  // Under the causal mask the group computes the key tiles that start at or
  // before its last row; a group wholly past seq_len computes none.
  const int last = q0 + r0 >= S ? 0 : CAUSAL ? min(ntiles, (q0 + r0 + 31) / BK + 1) : ntiles;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (it < last) {
      const int k0 = it * BK;
      const float* sk = ring + s * L::STAGE + c0;
      const float* sv = sk + BK * LD;
      float sc[2][BK / 8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[m][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        Frag<4> a0, a1;
        load_a_plane<true>(a0, qa, kk, lane);
        load_a_plane<true>(a1, qa + L::Q_M16, kk, lane);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          Frag<2> bk;
          load_b_nk(bk, sk, LD, 8 * n, 8 * kk, lane);
          mma3(sc[0][n], a0, bk);
          mma3(sc[1][n], a1, bk);
        }
      }
      if constexpr (G > 1) {
        // The group's partials, added in group order.
        float* mine = xch + (2 * part + (it & 1)) * L::XCH + 4 * lane;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
            *reinterpret_cast<float4*>(mine + (m * (BK / 8) + n) * 128) =
                make_float4(sc[m][n][0], sc[m][n][1], sc[m][n][2], sc[m][n][3]);
        named_bar_sync(1 + grp, 32 * G);
        const float* all = xch + (it & 1) * L::XCH + 4 * lane;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const float* at = all + (m * (BK / 8) + n) * 128;
            float4 x = *reinterpret_cast<const float4*>(at);
#pragma unroll
            for (int p = 1; p < G; ++p) {
              const float4 y = *reinterpret_cast<const float4*>(at + p * 2 * L::XCH);
              x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
            }
            sc[m][n][0] = x.x; sc[m][n][1] = x.y; sc[m][n][2] = x.z; sc[m][n][3] = x.w;
          }
      }

      const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > q0 + r0);
      float corr[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int row_lo = q0 + r0 + 16 * m + (lane >> 2);
        float mx[2] = {mrow[m][0], mrow[m][1]};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[m][n][e] * scale_log2;
            if (edge) {
              const int col = k0 + 8 * n + 2 * t + (e & 1);
              if (col >= S || (CAUSAL && col > row_lo + 8 * (e >> 1))) x = kMask;
            }
            sc[m][n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) {
          mx[hl] = quad_max(mx[hl]);
          corr[m][hl] = exp2f(mrow[m][hl] - mx[hl]);
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[m][n][e] = exp2f(sc[m][n][e] - mx[e >> 1]);
            sum[e >> 1] += sc[m][n][e];
          }
        // Each lane keeps a partial row sum; the quad's partials are added
        // once at the end (the correction is the same on all four lanes).
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) {
          lrow[m][hl] = lrow[m][hl] * corr[m][hl] + sum[hl];
          mrow[m][hl] = mx[hl];
        }
      }

      // o = o * corr + p v over the warp's columns, 32 at a time: the B
      // fragments of four n tiles from one 16-byte load from each of rows
      // 2t and 2t + 1, each serving both m16 tiles; each tile's p v summed
      // from zero (flash_fp32.cuh).
      Frag<4> pa[2][BK / 8];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int kc = 0; kc < BK / 8; ++kc) c_to_a_tf32(pa[m][kc], sc[m][kc]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tile[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) tile[m][i][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < BK / 8; ++kc) {
          const float* vr = sv + (8 * kc + 2 * t) * LD + 32 * hh + 4 * (lane >> 2);
          const float4 x0 = *reinterpret_cast<const float4*>(vr);
          const float4 x1 = *reinterpret_cast<const float4*>(vr + LD);
          const float v0[4] = {x0.x, x0.y, x0.z, x0.w}, v1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            Frag<2> bv;
            split_tf32(v0[i], bv.hi[0], bv.lo[0]);
            split_tf32(v1[i], bv.hi[1], bv.lo[1]);
            mma3(tile[0][i], pa[0][kc], bv);
            mma3(tile[1][i], pa[1][kc], bv);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][4 * hh + i][e] = fmaf(acc[m][4 * hh + i][e], corr[m][e >> 1], tile[m][i][e]);
      }
    }
    mbar_arrive(&empty[s]);
  }

  // Of each 32 columns 32 hh .., lane (g, t) holds columns 8t + i (C column
  // 2t of n tile 4 hh + i) and 8t + 4 + i (C column 2t + 1), i = 0 .. 3.
  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      const float den = fmaxf(quad_sum(lrow[m][hl]), 1e-30f);
      const float inv = 1.f / den;
      const int row = q0 + r0 + 16 * m + 8 * hl + (lane >> 2);
      if (row < S) {
        float* out = o + off + (long)row * rs + c0 + 8 * t;
        const float(&a)[8][4] = acc[m];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int u = 0; u < 2; ++u)  // C column 2t, then 2t + 1
            *reinterpret_cast<float4*>(out + 32 * hh + 4 * u) =
                make_float4(a[4 * hh][2 * hl + u] * inv, a[4 * hh + 1][2 * hl + u] * inv,
                            a[4 * hh + 2][2 * hl + u] * inv, a[4 * hh + 3][2 * hl + u] * inv);
        if (part == 0 && t == 0) lse[(long)bh * S + row] = mrow[m][hl] * kLn2 + logf(den);
      }
    }
}

template <int D, bool CAUSAL>
cudaError_t run_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int S, int H, float scale, cudaStream_t stream) {
  using L = FwdF32Layout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  static_assert(L::THREADS == 384 && 128 * (168 - L::PRODUCER_REGS) >=
                                         256 * (L::CONSUMER_REGS - 168),
                "the consumers take more registers than the producer gives up");
  dim3 grid;
  const cudaError_t err = folded_grid((S + L::BQ - 1) / L::BQ, (long)B * H, &grid);
  if (err != cudaSuccess) return err;
  return launch(fwd_f32_kernel<D, CAUSAL>, grid, dim3(L::THREADS), L::SMEM, stream,
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
