// Flash-attention backward, dq, for Hopper (sm_90a), fp32.
//
// Replaces: training_operator_tpu/trainer/flash.py, _flash_bwd_dq_kernel
// (launched by _flash_bwd_folded) on fp32 inputs. Same function: with
// p = exp(s - lse) and ds = p * (dO vᵀ - delta), dq = d^-0.5 * ds k, where s
// is the masked, scaled score tile recomputed from q and k; the products in
// fp32-class precision (3xTF32 on `mma.sync`, flash_fp32.cuh), each key
// tile's ds k summed from zero and added to dq in rounded fp32.
//
// Bound on an H100: compute. Three products per (q, k) tile pair (q kᵀ,
// dO vᵀ, ds k): ~1.5e11 FLOP at the flagship shape, ~0.94 ms at 3xTF32's
// 165 TFLOP/s, against ~0.5 GB of fp32 traffic (~0.15 ms). Each product
// step is three `mma.sync` m16n8k8 on TF32, whose measured rate
// (`bench --mma-rate`) puts the products alone at ~1.55 ms; what the warps
// do beside them (shared-memory traffic, splits, barriers) sets how far
// above that the kernel runs. The design, the dk/dv kernel's
// (flash_bwd_dkv_fp32.cu) turned around, q resident and K and V streamed:
//
// 1. q and dO split once per block. Each consumer warp splits its 16 rows
//    of q (the s warp) or dO (the dp warp) once, before the key loop, into
//    A fragments: held in registers at D <= 128 (`load_a_frags`), in its
//    own A planes at D = 256 (`stage_a_planes`, one 16-byte load per plane
//    and fragment). Registers, not planes, at D <= 128: the planes' loads
//    were ~1,000 of the ~2,700 shared-memory wavefronts of a block's key
//    tile, and the consumers ran 9% faster without them.
// 2. K and V split once per tile, through a ring. A producer warpgroup
//    splits every element of each K and V tile once into B planes
//    (`store_b_step`, `swz`; K and V unsplit at D = 256, split as they are
//    read) and fills a ring of STAGES stages with a full and an empty
//    mbarrier each: the producer waits on empty, fills, and every producer
//    thread arrives on full; every consumer thread waits on full and
//    arrives on empty when its products are done. One K plane serves both
//    of its orders: q kᵀ reads it nk, ds k kn. The only splits in the key
//    loop are those of the computed ds (`c_to_a_tf32`). At D <= 128 the
//    producer keeps LS tiles in flight ahead of the split: each thread
//    copies its 16-byte chunks of a tile's rows into a landing slot by
//    cp.async and arrives on the slot's mbarrier when they land
//    (`cp_async_arrive`); a named barrier of the producer warpgroup frees
//    the slot for the next copy. (Loading each tile into registers, or by
//    one bulk copy per row, left the producer slower than the consumers.)
//    The block's only __syncthreads follows the barriers' initialisation.
// 3. Partner warps. Each 16 q rows have an s warp, which computes s = q kᵀ
//    and p = exp2(s scale log2 e - lse log2 e), masked, and a dp warp, which
//    computes dp = dO vᵀ. They swap p and dp through shared memory behind
//    one named barrier per tile (two buffers each, by tile parity, so a
//    buffer is rewritten only after the partner has passed the next
//    barrier, that is, after its read); each forms ds = p (dp - delta)
//    itself and accumulates dq over its half of D. So each product is
//    computed once, a warp does 1.5 of the three, and it holds D / 4
//    accumulator registers.
//
// One block per (q tile, batch*head), folded into grid x (q tile slow, the
// causal grid's longest tiles first). The causal limit is the loop's bound,
// a pair skips the key tiles wholly past its rows (a suffix of the loop; it
// still waits on and releases their stages), and the mask is applied only
// on tiles that straddle the diagonal or the end of the sequence. Keys past
// seq_len read as zeros and are masked; rows past it are never written. No
// atomics: each block writes its own rows once, so results are the same
// from run to run.
//
// Budget per head dim (shared memory: 227 KiB a block):
//   D =  64: 4 pairs (64 q rows), 32-key tiles; ring 3 x 32 KiB (K and V
//            planes), hand-over 8 warps x 2 x 2 KiB = 32 KiB, landing
//            4 x 17 KiB: 196 KiB.
//   D = 128: 4 pairs (64 q rows), 16-key tiles; ring 4 x 32 KiB, hand-over
//            8 x 2 x 1 KiB = 16 KiB, landing 4 x 16.5 KiB: 210 KiB.
//   D = 256: 2 pairs (32 q rows), 16-key tiles; A planes 4 x 32 KiB =
//            128 KiB, K and V raw in the ring, 2 x 32 KiB (as planes 2 x
//            64 KiB, over the limit), hand-over 4 x 2 x 1 KiB: 200 KiB.
// Registers: at D <= 128 the block is three warpgroups, 168 a thread at
// launch; the producer gives up all but PRODUCER_REGS and the consumers
// take CONSUMER_REGS (setmaxnreg). At D = 256 two warpgroups may each hold
// 255. A consumer holds its A fragments (D at D <= 128), its accumulator
// (D / 4), the s or dp tile in two partial sums over the head dim (BK / 4
// each) and the tile's ds A fragments (BK). Every instantiation compiles
// with no spill.
#include "flash_fp32.cuh"
#include "sm90_common.cuh"

namespace flash {

template <int D>
struct DqF32Layout {
  static constexpr int PAIRS = D == 256 ? 2 : 4;  // s warp + dp warp per 16 q rows
  static constexpr int CW = 2 * PAIRS;  // consumer warps, then one producer warpgroup
  static constexpr int THREADS = (CW + 4) * 32;
  static constexpr int BQ = 16 * PAIRS, BK = D == 64 ? 32 : 16;
  // At D <= 128 a consumer holds its split q or dO fragments in registers
  // (D a thread) and the producer copies K and V rows into LS landing slots
  // (LDR floats a row) ahead of the split; at D = 256 the fragments sit in
  // A planes and the producer splits from device memory.
  static constexpr bool A_REGS = D <= 128;
  static constexpr int STAGES = D == 128 ? 4 : D == 64 ? 3 : 2;
  static constexpr int LS = A_REGS ? 4 : 0, LDR = D + 4;
  static constexpr bool KV_SPLIT = D != 256;  // K and V as split planes, else raw
  // Floats. A consumer warp's A planes (16 rows of q or dO, hi and lo); a
  // stage is the K tile's B planes, then the V tile's; a warp's hand-over
  // is two buffers of its s (p) or dp tile in C-fragment order; a landing
  // slot a K tile's rows, then a V tile's.
  static constexpr int A_WARP = A_REGS ? 0 : (D / 8) * 256;
  static constexpr int PLANE = BK * D * (KV_SPLIT ? 2 : 1);
  static constexpr int STAGE = 2 * PLANE;
  static constexpr int HAND = 16 * BK;
  static constexpr int LSLOT = 2 * BK * LDR;
  static constexpr int RING_OFF = CW * A_WARP;
  static constexpr int HAND_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int LAND_OFF = HAND_OFF + CW * 2 * HAND;
  static constexpr int BAR_OFF = LAND_OFF + LS * LSLOT;  // even: 8-byte aligned
  static constexpr int SMEM = BAR_OFF * 4 + (2 * STAGES + LS) * 8;
  // Three warpgroups (D <= 128) launch with 168 registers a thread; the
  // producer's give the consumers theirs: 128 x (168 - 40) = 256 x (232 - 168).
  static constexpr bool HAND_OVER = CW == 8;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int PRODUCER_BAR = 1 + PAIRS;  // named barrier of the producer warpgroup
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(DqF32Layout<D>::THREADS, 1)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int S, int H, int BH, float scale,
                  float scale_log2) {
  using L = DqF32Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES, PLANE = L::PLANE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* ring = smem + L::RING_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* landed = empty + STAGES;

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
    for (int s = 0; s < L::LS; ++s) mbar_init(&landed[s], 128);  // every producer thread
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= L::CW) {
    // Producer warpgroup: each K and V tile split into a stage's planes.
    if constexpr (L::HAND_OVER) reg_dealloc<L::PRODUCER_REGS>();
    constexpr int NB = B_STEPS<BK, D>;
    const int pw = warp - L::CW;
    if constexpr (L::LS > 0) {
      // It keeps LS tiles in flight: each thread copies its 16-byte chunks
      // of a tile's K rows and V rows into a landing slot by cp.async
      // (rows past seq_len as zeros) and arrives on the slot's barrier
      // when they have landed.
      const int pt = threadIdx.x - 32 * L::CW;
      float* land = smem + L::LAND_OFF;
      auto fetch = [&](int j) {
        float* dst = land + (j % L::LS) * L::LSLOT;
        const int row0 = j * BK;
#pragma unroll 1
        for (int m = 0; m < 2 * BK * (D / 4) / 128; ++m) {
          const int i = pt + 128 * m;
          const int x = i / (BK * D / 4), r = (i / (D / 4)) % BK, c = (i % (D / 4)) * 4;
          const bool in = row0 + r < S;
          cp_async16(dst + (x * BK + r) * L::LDR + c,
                     (x ? v : k) + off + (long)(in ? row0 + r : 0) * rs + c, in);
        }
        cp_async_arrive(&landed[j % L::LS]);
      };
      for (int j = 0; j < min(L::LS, ntiles); ++j) fetch(j);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES, slot = j % L::LS;
        mbar_wait(&landed[slot], (j / L::LS) & 1);
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const float* from = land + slot * L::LSLOT;
        float* stage = ring + s * L::STAGE;
#pragma unroll 1
        for (int i = 0; i < NB; ++i) {  // one step's registers at a time
          float4 x[2];
          load_b_step_smem<BK, D, L::LDR>(x, from, pw + 4 * i, lane);
          store_b_step<BK, D, L::KV_SPLIT>(stage, x, pw + 4 * i, lane);
        }
        mbar_arrive(&full[s]);  // release: this thread's stores are seen by the waiters
        named_bar_sync(L::PRODUCER_BAR, 128);  // the slot is read: refill it
        if (j + L::LS < ntiles) fetch(j + L::LS);
      }
    } else {
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        store_b_planes<BK, D, L::KV_SPLIT>(ring + s * L::STAGE, k + off, v + off, j * BK, S, rs,
                                           pw, lane);
        mbar_arrive(&full[s]);  // release: this thread's stores are seen by the waiters
      }
    }
    return;
  }

  // Consumers: pair `group` owns q rows q0 + 16 group .. + 15; role 0 is the
  // s warp (q kᵀ, p), role 1 the dp warp (dO vᵀ); each then ds and ds k
  // over half of D.
  if constexpr (L::HAND_OVER) reg_alloc<L::CONSUMER_REGS>();
  const int group = warp >> 1, role = warp & 1;
  const int t = lane & 3;
  const int r0 = 16 * group;
  const int row_lo = q0 + r0 + (lane >> 2), row_hi = row_lo + 8;
  float* own = smem + warp * L::A_WARP;
  Frag<4> fa[L::A_REGS ? D / 8 : 1];
  if constexpr (L::A_REGS) {
    load_a_frags<D>(fa, (role ? dout : q) + off, q0 + r0, S, rs, lane);
  } else {
    stage_a_planes<D, true>(own, (role ? dout : q) + off, q0 + r0, S, rs, lane);
  }
  auto a_of = [&](int kk, Frag<4>& a) {
    if constexpr (L::A_REGS) a = fa[kk];
    else load_a_plane<true>(a, own, kk, lane);
  };
  const float lse_lo = row_lo < S ? lse[(long)bh * S + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < S ? lse[(long)bh * S + row_hi] * kLog2e : 0.f;
  const float dl_lo = row_lo < S ? delta[(long)bh * S + row_lo] : 0.f;
  const float dl_hi = row_hi < S ? delta[(long)bh * S + row_hi] : 0.f;
  float* hand = smem + L::HAND_OFF + warp * 2 * L::HAND;
  const float* partner = smem + L::HAND_OFF + (warp ^ 1) * 2 * L::HAND;
  __syncwarp();

  float acc[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // Under the causal mask the pair computes the key tiles that start at or
  // before its last row.
  const int last = CAUSAL ? min(ntiles, (q0 + r0 + 15) / BK + 1) : ntiles;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (it < last) {
      const int k0 = it * BK;
      const float* stage = ring + s * L::STAGE;
      float c[BK / 8][4];
      mma3_nk<D, BK, L::KV_SPLIT>(c, a_of, stage + role * PLANE, lane);  // s or dp
      if (role == 0) {
        const bool edge = (k0 + BK > S) || (CAUSAL && k0 + BK - 1 > q0 + r0);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool lo = e < 2;
            float p = exp2f(fmaf(c[n][e], scale_log2, lo ? -lse_lo : -lse_hi));
            if (edge) {
              const int col = k0 + n * 8 + 2 * t + (e & 1);
              if (col >= S || (CAUSAL && col > (lo ? row_lo : row_hi))) p = 0.f;
            }
            c[n][e] = p;
          }
        }
      }
      float* mine = hand + (it & 1) * L::HAND;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        *reinterpret_cast<float4*>(mine + n * 128 + 4 * lane) =
            make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
      named_bar_sync(1 + group, 64);
      const float* theirs = partner + (it & 1) * L::HAND;
      Frag<4> a[BK / 8];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float4 o4 = *reinterpret_cast<const float4*>(theirs + n * 128 + 4 * lane);
        const float o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = role ? o[e] : c[n][e], dp = role ? c[n][e] : o[e];
          c[n][e] = p * (dp - (e < 2 ? dl_lo : dl_hi));  // ds
        }
        c_to_a_tf32(a[n], c[n]);
      }
      mma3_kn<BK, D, D / 16, L::KV_SPLIT>(acc, a, stage, role * (D / 16), lane);  // ds k
    }
    mbar_arrive(&empty[s]);
  }

  const int col = role * (D / 2) + 2 * t;
  if (row_lo < S) {
    float* out = dq + off + (long)row_lo * rs + col;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][0] * scale, acc[j][1] * scale);
  }
  if (row_hi < S) {
    float* out = dq + off + (long)row_hi * rs + col;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D, bool CAUSAL>
cudaError_t run_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int B, int S, int H,
                       float scale, cudaStream_t stream) {
  using L = DqF32Layout<D>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  static_assert(!L::HAND_OVER || (L::THREADS == 384 && 128 * (168 - L::PRODUCER_REGS) >=
                                                            256 * (L::CONSUMER_REGS - 168)),
                "the consumers take more registers than the producer gives up");
  dim3 grid;
  const cudaError_t err = folded_grid((S + L::BQ - 1) / L::BQ, (long)B * H, &grid);
  if (err != cudaSuccess) return err;
  return launch(bwd_dq_f32_kernel<D, CAUSAL>, grid, dim3(L::THREADS), L::SMEM, stream,
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
