// The model head's fp32 products for Hopper (sm_90a): 3xTF32 on wgmma.
//
// Replaces no TPU kernel: the JAX head is XLA's dot
// (training_operator_tpu/trainer/model.py, `x.astype(f32) @ lm_head`). It
// was added because cuBLAS runs an fp32 product on the CUDA cores (SGEMM,
// ~52 TFLOP/s of the H100's 67), and the head's four products a step
// (logits, their recompute, dX, dW) were a third to a half of a training
// step. Three products of x [T, D], W [D, V] and dL [T, V], all fp32:
//
//   logits = x W     (head_logits_fp32)
//   dX     = dL Wᵀ   (head_dx_fp32)
//   dW     = xᵀ dL   (head_dw_fp32)
//
// Bound on an H100: compute. Each is 2 T D V FLOP against (T D + D V + T V)
// 4-byte words, hundreds of FLOP a byte; the 3xTF32 split costs three TF32
// products per fp32 one, so the bound is 495 / 3 = 165 TFLOP/s.
//
// Precision: fp32-class, not TF32. Each fp32 operand x is split into
// hi + lo, both tf32, and a product is A_lo B_hi + A_hi B_lo + A_hi B_hi in
// fp32; what is dropped, lo lo and lo's rounding, is ~2^-21 of each term
// against plain TF32's 2^-11 (flash_fp32.cuh has the same split). The tensor
// cores add into fp32 with truncation, a drift toward zero of up to an ulp a
// step, and K reaches 92,544 here: each chunk of at most 256 k
// (head_gemm.plan) is summed from zero in registers of its own and added to
// the running sum with a rounded fp32 add.
//
// Design: every product is C [M x N] = A [M x K] B [K x N] with B read by
// wgmma from shared memory, which for tf32 must be K-major, and A from
// registers, which take any layout. So the operand that is K-major as
// stored is B, and the output is written transposed where that makes C the
// transpose of the product:
//   logits: C = logitsᵀ, M = V, N = T, K = D; A = Wᵀ (W's rows are k), B = x
//   dX:     C = dX,      M = T, N = D, K = V; A = dL,                 B = W
//   dW:     C = dWᵀ,     M = V, N = D, K = T; A = dLᵀ, B = x (k = T is
//           x's row axis: the split transposes B's tile)
// A block of three warpgroups owns one 128 x 128 tile of C (one per SM;
// tiles dealt in groups of `group` rows of tiles so the blocks in flight
// share their operands' panels in L2). Warpgroup 2 is the producer
// (setmaxnreg 56): one warp keeps TMA loads of raw fp32 [128 x 32] tiles of
// A and B in flight through a ring of STAGES mbarrier-guarded stages (plain
// loads where a row stride is not a multiple of 16 bytes, which TMA
// refuses); three warps split each stage's B tile into tf32 hi and lo
// planes in wgmma's K-major 128-byte-swizzled layout, once for the whole
// block. For a K-major B the raw tile is already that layout and serves as
// the hi plane, which wgmma reads as tf32 by dropping the 13 low bits
// (truncation): only lo = tf32(x - trunc(x)) is written. Warpgroups 0 and 1
// (setmaxnreg 224) own 64 rows each: per k step of 8 they load their A
// fragments from the raw tile, split them in registers, and issue three
// wgmma m64n128k8 (A_lo B_hi, A_hi B_lo, A_hi B_hi); a stage is 4 steps.
// The two consumers' products interleave on the tensor cores. A stage
// holds the raw tiles and the planes, and four stages fill shared memory
// (three for dW, whose planes need a buffer of their own): with three, the
// logits took 13% longer on an H100, and with the planes in a ring of
// their own two deep, behind a raw ring of six, dX took 15% longer.
// Nothing is written to device memory but C: no split or transposed copy of
// an operand exists outside shared memory. Rows and columns past M, N and K
// read as zeros (TMA's out-of-bounds fill, or the plain loads' mask) and C
// is stored under a mask.
#include <string.h>

#include "flash_fp32.cuh"
#include "sm90_common.cuh"

namespace flash {

enum HeadProduct { kLogits = 0, kDx = 1, kDw = 2 };

template <int P>
struct HeadLayout {
  // A is K-major in memory ([M][K] rows) only for dX; B is K-major
  // ([N][K] rows) for logits and dX; C is stored transposed for logits
  // and dW.
  static constexpr bool A_KMAJOR = P == kDx;
  static constexpr bool B_KMAJOR = P != kDw;
  static constexpr bool OUT_T = P != kDx;
  static constexpr int BM = 128, BN = 128, BK = 32;
  static constexpr int TILE = 128 * BK * 4;  // bytes of one raw or plane tile
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = TILE;                           // raw B (the hi plane if K-major)
  static constexpr int HI_OFF = B_KMAJOR ? B_OFF : 2 * TILE;   // hi plane
  static constexpr int LO_OFF = B_KMAJOR ? 2 * TILE : 3 * TILE;
  static constexpr int STAGE = B_KMAJOR ? 3 * TILE : 4 * TILE;
  static constexpr int STAGES = B_KMAJOR ? 4 : 3;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 8 * 3 * STAGES + 1024;  // + alignment slack
  static constexpr int THREADS = 384;
  static constexpr int SPLITTERS = 96;  // warps 1..3 of the producer warpgroup
};

// Byte offset of element (r, c) of a K-major [128 rows][32 k] fp32 tile
// with the 128-byte swizzle (TMA's and wgmma's layout): 16-byte chunk c / 4
// of row r sits at chunk (c / 4) ^ (r % 8).
__device__ __forceinline__ int kmajor_off(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + ((c & 3) << 2);
}

// Byte offset of element (k, r) of an MN-major [32 k][128 r] fp32 tile,
// stored as four swizzled [32 k][32 r] boxes side by side (TMA's 128-byte
// swizzle takes boxes of at most 128 bytes a row).
__device__ __forceinline__ int mnmajor_off(int k, int r) {
  return ((r >> 5) << 12) + k * 128 + (((((r & 31) >> 2) ^ (k & 7))) << 4) + ((r & 3) << 2);
}

// Loads one raw [128 x 32] tile of an operand: rows r0.. of a K-major
// [R][K] matrix, or k rows k0.. of an MN-major [K][R] one, with plain
// loads by the 32 lanes of a warp (zeros past the matrix).
template <bool KMAJOR>
__device__ __forceinline__ void load_tile_plain(unsigned char* dst, const float* src, int ld,
                                                int rows, int ks, int r0, int k0, int lane) {
  for (int idx = lane; idx < 128 * 32; idx += 32) {
    int r, k;
    if (KMAJOR) {
      r = idx >> 5;
      k = idx & 31;
    } else {
      k = idx >> 7;
      r = idx & 127;
    }
    const int gr = r0 + r, gk = k0 + k;
    float v = 0.f;
    if (gr < rows && gk < ks) v = KMAJOR ? src[(long)gr * ld + gk] : src[(long)gk * ld + gr];
    *reinterpret_cast<float*>(dst + (KMAJOR ? kmajor_off(r, k) : mnmajor_off(k, r))) = v;
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// The raw tile by TMA: a K-major tile is one [32 k x 128 rows] box, an
// MN-major one four [32 rows x 32 k] boxes.
template <bool KMAJOR>
__device__ __forceinline__ void load_tile_tma(unsigned char* dst, const CUtensorMap* map,
                                              uint64_t* bar, int r0, int k0) {
  if (KMAJOR) {
    tma_load_2d(dst, map, bar, k0, r0);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) tma_load_2d(dst + (j << 12), map, bar, r0 + 32 * j, k0);
  }
}

__device__ __forceinline__ uint32_t tf32_trunc(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// d (+)= A B, m64n128k8, tf32 operands, A from registers (the m16n8k8
// tf32 A layout of each warp's 16 rows), B K-major from shared memory;
// scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// B's tf32 lo plane from a K-major raw tile, which wgmma reads as the hi
// plane: float4 chunks c, c + SPLITTERS, .. of the tile, two at a time.
template <int TILE, int SPLITTERS>
__device__ __forceinline__ void split_kmajor(const unsigned char* raw, unsigned char* lo, int sid) {
  auto lo_of = [](float x) { return tf32_rn(x - __uint_as_float(tf32_trunc(x))); };
  for (int c = sid; c < TILE / 16; c += 2 * SPLITTERS) {
    const int c2 = c + SPLITTERS;
    const float4 v = reinterpret_cast<const float4*>(raw)[c];
    const float4 w = c2 < TILE / 16 ? reinterpret_cast<const float4*>(raw)[c2] : v;
    reinterpret_cast<uint4*>(lo)[c] = make_uint4(lo_of(v.x), lo_of(v.y), lo_of(v.z), lo_of(v.w));
    if (c2 < TILE / 16)
      reinterpret_cast<uint4*>(lo)[c2] = make_uint4(lo_of(w.x), lo_of(w.y), lo_of(w.z), lo_of(w.w));
  }
}

// B's hi and lo planes (K-major [128 n][32 k]) from an MN-major raw tile
// [32 k][128 n]: chunk c is column n = c % 128, k 4 (c / 128) .. + 3, one
// 16-byte row chunk of each plane. Two chunks at a time, their eight loads
// first.
template <int TILE, int SPLITTERS>
__device__ __forceinline__ void split_mnmajor(const unsigned char* raw, unsigned char* hi,
                                              unsigned char* lo, int sid) {
  for (int c = sid; c < TILE / 16; c += 2 * SPLITTERS) {
    float x[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int cu = min(c + u * SPLITTERS, TILE / 16 - 1), n = cu & 127, kc = cu >> 7;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[u][e] = *reinterpret_cast<const float*>(raw + mnmajor_off(4 * kc + e, n));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int cu = c + u * SPLITTERS, n = cu & 127, kc = cu >> 7;
      if (cu < TILE / 16) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(x[u][e], h[e], l[e]);
        const int off = n * 128 + ((kc ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(384, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int M, int N, int K, int lda, int ldb, int ldo,
                 int chunk, int group, int a_tma, int b_tma) {
  using L = HeadLayout<P>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  const int wg = threadIdx.x >> 7;
  const int nk = (K + L::BK - 1) / L::BK;

  // Tile of C: groups of `group` tile rows, column by column within a group.
  const int tiles_m = (M + L::BM - 1) / L::BM, tiles_n = (N + L::BN - 1) / L::BN;
  const int per_group = group * tiles_n;
  const int first_m = (blockIdx.x / per_group) * group;
  const int rows_here = min(tiles_m - first_m, group);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows_here) * L::BM;
  const int n0 = (in_group / rows_here) * L::BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);            // the loader warp's lanes (+ TMA bytes)
      mbar_init(&ready[s], L::SPLITTERS);  // every splitter thread
      mbar_init(&empty[s], 8);             // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<56>();
    const int tid = threadIdx.x - 256, warp = tid >> 5, lane = tid & 31;
    if (warp == 0) {
      // Loader: raw A and B tiles of each k block into the ring. TMA bytes
      // are announced by lane 0's arrival, after the lanes' plain loads of
      // an operand TMA cannot take (the other 31 lanes arrive plainly).
      const uint32_t tma_bytes = (a_tma ? L::TILE : 0) + (b_tma ? L::TILE : 0);
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES, k0 = i * L::BK;
        unsigned char* st = smem + s * L::STAGE;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        if (!a_tma) load_tile_plain<L::A_KMAJOR>(st + L::A_OFF, a, lda, M, K, m0, k0, lane);
        if (!b_tma) {
          load_tile_plain<L::B_KMAJOR>(st + L::B_OFF, b, ldb, N, K, n0, k0, lane);
          // A K-major raw B is wgmma's hi plane (the async proxy).
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        if (lane == 0 && tma_bytes) {
          mbar_expect_tx(&full[s], tma_bytes);
          if (a_tma) load_tile_tma<L::A_KMAJOR>(st + L::A_OFF, &ta, &full[s], m0, k0);
          if (b_tma) load_tile_tma<L::B_KMAJOR>(st + L::B_OFF, &tb, &full[s], n0, k0);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    } else {
      // Splitters: B's tf32 planes, once per stage for both consumers.
      const int sid = tid - 32;
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        unsigned char* st = smem + s * L::STAGE;
        mbar_wait(&full[s], (i / STAGES) & 1);
        if (L::B_KMAJOR)
          split_kmajor<L::TILE, L::SPLITTERS>(st + L::B_OFF, st + L::LO_OFF, sid);
        else
          split_mnmajor<L::TILE, L::SPLITTERS>(st + L::B_OFF, st + L::HI_OFF, st + L::LO_OFF, sid);
        // The planes are read by wgmma (the async proxy).
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&ready[s]);
      }
    }
  } else {
    reg_alloc<224>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r = 64 * wg + 16 * warp + g;  // the lane's first row in the tile; the other is r + 8
    float acc[64], tot[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = tot[j] = 0.f;
    uint32_t hi[4][4], lo[4][4];

    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES, parity = (i / STAGES) & 1;
      unsigned char* st = smem + s * L::STAGE;
      mbar_wait(&full[s], parity);
      mbar_wait(&ready[s], parity);
      // A fragments of the four k steps, split: a0 (r, t), a1 (r+8, t),
      // a2 (r, t+4), a3 (r+8, t+4) of each 8-wide step.
      const unsigned char* as = st + L::A_OFF;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r + ((e & 1) << 3), k = 8 * ks + t + ((e >> 1) << 2);
          const float x = *reinterpret_cast<const float*>(
              as + (L::A_KMAJOR ? kmajor_off(row, k) : mnmajor_off(k, row)));
          split_tf32(x, hi[ks][e], lo[ks][e]);
        }
      const uint32_t hi_addr = smem_addr(st + L::HI_OFF), lo_addr = smem_addr(st + L::LO_OFF);
      // The first product of a chunk ignores acc (scale_d 0); the chunk's
      // sum joins tot with a rounded fp32 add once its last block is done.
      const int keep = i % chunk != 0;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dhi = smem_desc(hi_addr + 32 * ks, 16, 1024);
        const uint64_t dlo = smem_desc(lo_addr + 32 * ks, 16, 1024);
        wgmma_tf32_n128(acc, lo[ks], dhi, ks > 0 || keep);
        wgmma_tf32_n128(acc, hi[ks], dlo, 1);
        wgmma_tf32_n128(acc, hi[ks], dhi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(hi);
      fence_frags(lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if ((i + 1) % chunk == 0 || i + 1 == nk) {
#pragma unroll
        for (int j = 0; j < 64; ++j) tot[j] += acc[j];
      }
    }

    // Store C: tot[4j + e] is row r (+8 for e >= 2), column 8j + 2t + (e & 1).
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + r + ((e >> 1) << 3), n = n0 + 8 * j + 2 * t + (e & 1);
        if (m < M && n < N) {
          if (L::OUT_T)
            out[(long)n * ldo + m] = tot[4 * j + e];
          else
            out[(long)m * ldo + n] = tot[4 * j + e];
        }
      }
  }
}

// Tensor map of a row-major fp32 matrix [rows][cols] (row stride ld floats)
// read in boxes of box_rows x 32 columns with the 128-byte swizzle; zeros
// past its edges.
inline cudaError_t encode_rows(CUtensorMap* map, const float* base, int rows, int cols, int ld,
                               int box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {4ull * ld};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether TMA can read a row-major matrix at `base` with row stride ld:
// a 16-byte aligned base and row stride.
inline bool tma_ok(const float* base, int ld) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && (4l * ld) % 16 == 0;
}

// C [M x N] (stored at out with stride ldo, transposed for logits and dW)
// from A and B as HeadLayout<P> reads them: a is [M][K] (dX) or [K][M] with
// row stride lda, b is [N][K] (logits, dX) or [K][N] with row stride ldb.
template <int P>
cudaError_t run_head(const float* a, const float* b, float* out, int M, int N, int K, int lda,
                     int ldb, int ldo, int chunk, int group, cudaStream_t stream) {
  using L = HeadLayout<P>;
  static_assert(L::SMEM <= 232448, "more shared memory than a block may have");
  if (M <= 0 || N <= 0 || K <= 0 || chunk <= 0 || group <= 0) return cudaErrorInvalidValue;
  const long tiles = (long)((M + L::BM - 1) / L::BM) * ((N + L::BN - 1) / L::BN);
  if (tiles > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  memset(&tb, 0, sizeof(tb));
  const int a_tma = tma_ok(a, lda), b_tma = tma_ok(b, ldb);
  cudaError_t err = cudaSuccess;
  if (a_tma)
    err = L::A_KMAJOR ? encode_rows(&ta, a, M, K, lda, 128) : encode_rows(&ta, a, K, M, lda, 32);
  if (err == cudaSuccess && b_tma)
    err = L::B_KMAJOR ? encode_rows(&tb, b, N, K, ldb, 128) : encode_rows(&tb, b, K, N, ldb, 32);
  if (err != cudaSuccess) return err;
  return launch(head_gemm_kernel<P>, dim3((unsigned)tiles), dim3(L::THREADS), L::SMEM, stream,
                ta, tb, a, b, out, M, N, K, lda, ldb, ldo, chunk, group, a_tma, b_tma);
}

}  // namespace flash

// x [T, D], w [D, V], dl [T, V], all contiguous fp32; `chunk` is the k
// blocks of 32 summed apart (head_gemm.plan), `group` the tile rows dealt
// together.
extern "C" int head_logits_fp32(const void* x, const void* w, void* logits, int T, int D, int V,
                                int chunk, int group, void* stream) {
  return flash::run_head<flash::kLogits>(static_cast<const float*>(w),
                                         static_cast<const float*>(x), static_cast<float*>(logits),
                                         V, T, D, V, D, V, chunk, group,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int head_dx_fp32(const void* dl, const void* w, void* dx, int T, int D, int V,
                            int chunk, int group, void* stream) {
  return flash::run_head<flash::kDx>(static_cast<const float*>(dl), static_cast<const float*>(w),
                                     static_cast<float*>(dx), T, D, V, V, V, D, chunk, group,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int head_dw_fp32(const void* x, const void* dl, void* dw, int T, int D, int V,
                            int chunk, int group, void* stream) {
  return flash::run_head<flash::kDw>(static_cast<const float*>(dl), static_cast<const float*>(x),
                                     static_cast<float*>(dw), V, D, T, V, D, V, chunk, group,
                                     static_cast<cudaStream_t>(stream));
}
