// Flash-attention backward, dk and dv, for Hopper (sm_90a), fp32.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_bwd_dkv_kernel
// (launched by _flash_bwd_folded) on fp32 inputs. Same function: with
// p = exp(s - lse) and ds = p * (dO vᵀ - delta), dv = pᵀ dO and
// dk = d^-0.5 * dsᵀ q; the products in fp32-class precision (3xTF32 on
// `mma.sync`, flash_fp32.cuh), each q tile's product summed from zero and
// added to dk and dv in rounded fp32.
//
// Bound on an H100: compute. Four products per (k, q) tile pair (k qᵀ,
// v dOᵀ, pᵀ dO, dsᵀ q): ~2.1e11 FLOP at the flagship shape, ~1.25 ms at
// 3xTF32's 165 TFLOP/s, against ~0.6 GB of fp32 traffic (~0.18 ms). Each
// product step is three `mma.sync` m16n8k8 on TF32, so the tensor pipe's
// rate for `mma.sync` (below the card's TF32 peak) sets the floor, and
// what the warps issue beside the products (tf32 splits, shared loads)
// and the gaps between them set how far above it the kernel runs. The
// design:
//
// 1. Split once, in fragment order. A producer warpgroup reads each q and
//    dO tile from device memory (16-byte loads, two rows at a time),
//    splits every element once into tf32 hi and lo, and stores them into
//    the ring as a hi plane and a lo plane in B-fragment order (8x8
//    blocks, `store_b_planes` and `swz` in flash_fp32.cuh, shared with the
//    dq kernel): a lane's B fragment is four 4-byte loads for
//    k qᵀ and v dOᵀ, two 8-byte loads for pᵀ dO and dsᵀ q, straight into
//    the registers `mma.sync` reads, with no bank conflict. Each consumer
//    warp keeps the A fragments of its own 16 keys of K (or V) in shared
//    memory in A-fragment order (`stage_a_planes`): as split planes where
//    they fit beside the ring (D = 64), else raw (one 16-byte load and four
//    splits per fragment and q tile). The only other splits in the q loop
//    are those of the computed pᵀ and dsᵀ (`c_to_a_tf32`). No raw copy of a
//    q or dO tile lands in shared memory (a landing buffer would take 32
//    KiB a stage at D = 128, which the budget below does not have), so the
//    ring is filled by the producer's loads, not by TMA or cp.async.
// 2. dk and dv in partner warps (FlashAttention-3's split between
//    warpgroups). Each 16 keys have a dv warp and a dk warp. The dv warp
//    computes sᵀ = k qᵀ and pᵀ = exp2(sᵀ scale log2 e - lse log2 e), masked,
//    hands pᵀ to its partner through shared memory behind two named
//    barriers (full: the dv warp arrives, the dk warp waits; empty: the
//    other way round), and accumulates dv += pᵀ dO. The dk warp computes
//    dpᵀ = v dOᵀ, takes pᵀ, forms dsᵀ = pᵀ (dpᵀ - delta) and accumulates
//    dk += dsᵀ q. Each warp does two of the four products, each product is
//    computed once at every head dim, and a warp holds one D-wide
//    accumulator (D / 2 registers a thread). sᵀ and dpᵀ come out in the C
//    layout with keys as rows, so lse and delta are indexed by column, and
//    pᵀ and dsᵀ feed the second product from the lane's own registers (the
//    permuted k axis of flash_fp32.cuh).
// 3. A ring, not block barriers. q, dO, lse (times log2 e) and delta tiles
//    stream through a two-stage ring with a full and an empty mbarrier per
//    stage: the producer waits on empty, fills, and every producer thread
//    arrives on full; every consumer thread waits on full and arrives on
//    empty when its products are done. The block's only __syncthreads
//    follows the barriers' initialisation.
//
// One block per (k tile, batch*head), folded into grid x (k tile fastest;
// causal: the first k tiles do the most work). The causal start (the first
// q tile that reaches this k tile) is the loop's lower bound, a warp pair
// skips q tiles that lie wholly before its keys (it still waits on and
// releases their stages), and the mask is applied only on tiles that
// straddle the diagonal or the end of the sequence. q rows past seq_len are
// read as zeros and masked, keys past it are never written. No atomics:
// each block writes its own dk, dv rows once, so results are the same from
// run to run.
//
// Budget per head dim (shared memory: 227 KiB a block):
//   D =  64: 8 consumer warps (64 keys), 32-row q tiles; K and V as planes
//            64 KiB, ring 2 x 32.25 KiB, pᵀ hand-over 8 KiB: 136.5 KiB.
//   D = 128: 8 consumer warps (64 keys), 32-row q tiles; K and V raw
//            64 KiB (as planes 128 KiB, over the limit beside the ring's
//            128.5 KiB), ring 2 x 64.25 KiB, hand-over 8 KiB: 200.5 KiB.
//   D = 256: 4 consumer warps (32 keys; 64 would need 128 KiB of raw K and
//            V beside the ring), 16-row q tiles; K and V raw 64 KiB (as
//            planes 128 KiB), ring 2 x 64.1 KiB, hand-over 2 KiB: 194.3 KiB.
// Registers: at D <= 128 the block is three warpgroups, 168 a thread at
// launch; the producer gives up all but PRODUCER_REGS and the consumers
// take CONSUMER_REGS (setmaxnreg). At D = 256 two warpgroups may each hold
// 255, with no hand-over. A consumer holds its accumulator (D / 2 floats),
// sᵀ or dpᵀ (BQ / 2, in two partial sums over the head dim, for more
// independent `mma.sync` in flight) and the second product's A fragments
// (BQ). Every instantiation compiles with no spill.
#include "flash_fp32.cuh"
#include "sm90_common.cuh"

namespace flash {

template <int D>
struct DkvF32Layout {
  static constexpr int PAIRS = D == 256 ? 2 : 4;  // dv warp + dk warp per 16 keys
  static constexpr int CW = 2 * PAIRS;  // consumer warps, then one producer warpgroup
  static constexpr int THREADS = (CW + 4) * 32;
  static constexpr int BK = 16 * PAIRS, BQ = D == 256 ? 16 : 32;
  static constexpr int STAGES = 2;
  // Floats. A q or dO tile is its hi and lo planes (`swz`); a stage is the
  // q tile, the dO tile, then BQ lse (times log2 e) and BQ delta.
  static constexpr int PLANE = BQ * D * 2;
  static constexpr int STAGE = 2 * PLANE + 2 * BQ;
  static constexpr int HAND = 16 * BQ;  // one pair's pᵀ, in C-fragment order
  static constexpr int RING_AND_HAND = STAGES * STAGE + PAIRS * HAND;
  // K and V as split planes where they fit beside the ring, else raw.
  static constexpr bool KV_PLANES =
      (CW * 16 * D * 2 + RING_AND_HAND) * 4 + 2 * STAGES * 8 <= 232448;
  static constexpr int KV_CHUNK = KV_PLANES ? 256 : 128;  // one warp's A fragment of 8 columns
  static constexpr int KV_WARP = (D / 8) * KV_CHUNK;
  static constexpr int RING_OFF = CW * KV_WARP;
  static constexpr int HAND_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BAR_OFF = HAND_OFF + PAIRS * HAND;  // even: 8-byte aligned
  static constexpr int SMEM = BAR_OFF * 4 + 2 * STAGES * 8;
  // Three warpgroups (D <= 128) launch with 168 registers a thread; the
  // producer's give the consumers theirs: 128 x (168 - 40) = 256 x (232 - 168).
  static constexpr bool HAND_OVER = CW == 8;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(DkvF32Layout<D>::THREADS, 1)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int H, float scale,
                   float scale_log2) {
  using L = DkvF32Layout<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES, PLANE = L::PLANE, PAIRS = L::PAIRS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* ring = smem + L::RING_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int n_kt = (S + L::BK - 1) / L::BK;
  const int k0 = (int)(blockIdx.x % n_kt) * L::BK;
  const int bh = (int)(blockIdx.x / n_kt), b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long off = ((long)b * S * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qstart = CAUSAL ? (k0 / BQ) * BQ : 0;
  const int ntiles = (S - qstart + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);          // every producer thread
      mbar_init(&empty[s], L::CW * 32);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= L::CW) {
    // Producer warpgroup: q and dO split into the stage's planes
    // (`store_b_planes`), then the tile's lse (times log2 e) and delta.
    if constexpr (L::HAND_OVER) reg_dealloc<L::PRODUCER_REGS>();
    const int pw = warp - L::CW, pt = threadIdx.x - 32 * L::CW;
    const float* lse_bh = lse + (long)bh * S;
    const float* delta_bh = delta + (long)bh * S;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      float* stage = ring + s * L::STAGE;
      const int q0 = qstart + j * BQ;
      store_b_planes<BQ, D, true>(stage, q + off, dout + off, q0, S, rs, pw, lane);
      if (pt < BQ) {
        const bool in = q0 + pt < S;
        stage[2 * PLANE + pt] = in ? lse_bh[q0 + pt] * kLog2e : 0.f;
        stage[2 * PLANE + BQ + pt] = in ? delta_bh[q0 + pt] : 0.f;
      }
      mbar_arrive(&full[s]);  // release: this thread's stores are seen by the waiters
    }
    return;
  }

  // Consumers: pair `group` owns keys k0 + 16 group .. + 15; role 0 is the
  // dv warp (k qᵀ, pᵀ, pᵀ dO), role 1 the dk warp (v dOᵀ, dsᵀ, dsᵀ q).
  if constexpr (L::HAND_OVER) reg_alloc<L::CONSUMER_REGS>();
  const int group = warp >> 1, role = warp & 1;
  const int bar_full = 1 + group, bar_empty = 1 + PAIRS + group;
  const int t = lane & 3;
  const int kbase = k0 + 16 * group;
  const int key_lo = kbase + (lane >> 2), key_hi = key_lo + 8;
  float* kv = smem + warp * L::KV_WARP;
  float* hand = smem + L::HAND_OFF + group * L::HAND;
  stage_a_planes<D, L::KV_PLANES>(kv, (role ? v : k) + off, kbase, S, rs, lane);
  __syncwarp();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  bool handed = false;  // the dv warp has handed over a pᵀ before
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const int q0 = qstart + it * BQ;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (!(CAUSAL && q0 + BQ - 1 < kbase)) {  // some q row reaches the pair's keys
      const float* stage = ring + s * L::STAGE;
      const float* c_lse = stage + 2 * PLANE;
      const float* c_delta = c_lse + BQ;
      float c[BQ / 8][4];
      mma3_nk<D, BQ, true>(
          c, [&](int kk, Frag<4>& a) { load_a_plane<L::KV_PLANES>(a, kv, kk, lane); },
          stage + role * PLANE, lane);
      if (role == 0) {
        const bool edge = (q0 + BQ > S) || (CAUSAL && q0 < kbase + 15);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(c_lse + n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = n * 8 + 2 * t + (e & 1);  // q row within the tile
            float p = exp2f(fmaf(c[n][e], scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int key = e < 2 ? key_lo : key_hi;
              if (q0 + ci >= S || (CAUSAL && q0 + ci < key)) p = 0.f;
            }
            c[n][e] = p;  // pᵀ
          }
        }
        if (handed) named_bar_sync(bar_empty, 64);  // the dk warp took the last one
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
          *reinterpret_cast<float4*>(hand + n * 128 + 4 * lane) =
              make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
        named_bar_arrive(bar_full, 64);
        handed = true;
      } else {
        named_bar_sync(bar_full, 64);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float4 p = *reinterpret_cast<const float4*>(hand + n * 128 + 4 * lane);
          const float2 d2 = *reinterpret_cast<const float2*>(c_delta + n * 8 + 2 * t);
          c[n][0] = p.x * (c[n][0] - d2.x);  // dsᵀ
          c[n][1] = p.y * (c[n][1] - d2.y);
          c[n][2] = p.z * (c[n][2] - d2.x);
          c[n][3] = p.w * (c[n][3] - d2.y);
        }
        // The pair computes every later tile too (skipped tiles are a
        // prefix), so the dv warp waits for this release exactly when it
        // comes.
        if (it + 1 < ntiles) named_bar_arrive(bar_empty, 64);
      }
      Frag<4> a[BQ / 8];
#pragma unroll
      for (int kc = 0; kc < BQ / 8; ++kc) c_to_a_tf32(a[kc], c[kc]);
      mma3_kn<BQ, D, D / 8, true>(acc, a, stage + (1 - role) * PLANE, 0, lane);
    }
    mbar_arrive(&empty[s]);
  }

  float* dst = role ? dk : dv;
  const float mul = role ? scale : 1.f;
  const int col = 2 * t;
  if (key_lo < S) {
    const long o = off + (long)key_lo * rs + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + o + j * 8) = make_float2(acc[j][0] * mul, acc[j][1] * mul);
  }
  if (key_hi < S) {
    const long o = off + (long)key_hi * rs + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + o + j * 8) = make_float2(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int D, bool CAUSAL>
cudaError_t run_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                        int H, float scale, cudaStream_t stream) {
  using L = DkvF32Layout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  static_assert(!L::HAND_OVER || (L::THREADS == 384 && 128 * (168 - L::PRODUCER_REGS) >=
                                                            256 * (L::CONSUMER_REGS - 168)),
                "the consumers take more registers than the producer gives up");
  dim3 grid;
  const cudaError_t err = folded_grid((S + L::BK - 1) / L::BK, (long)B * H, &grid);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkv_f32_kernel<D, CAUSAL>, grid, dim3(L::THREADS), L::SMEM, stream,
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
