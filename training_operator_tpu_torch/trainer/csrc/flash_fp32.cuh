// Shared building blocks of the fp32 flash-attention kernels (sm_90a):
// the 3xTF32 product on `mma.sync` and the tf32 split, used by all three;
// and, for the forward and dq kernels, fragment loads that split each
// operand as they load it from a row-major shared tile, filled by
// `cp.async` copies. The dk/dv kernel (flash_bwd_dkv_fp32.cu) splits each
// q and dO element once into fragment-ordered planes and has its own loads.
//
// Layout contract with trainer/flash.py: q, k, v, out, dO, dq, dk, dv are
// contiguous fp32 [B, S, H, D] (row stride H*D elements); lse and delta are
// contiguous fp32 [B*H, S]. D is 64, 128 or 256.
//
// Precision: fp32-class, not TF32. wgmma reads fp32 only as TF32 (10
// mantissa bits), and only K-major, so these kernels use
// `mma.sync.m16n8k8.tf32`, whose operands pass through registers in any
// layout, in the 3xTF32 split: each fp32 operand x becomes hi = tf32(x)
// and lo = tf32(x - hi), both rounded to nearest, and a product is
// lo*hi + hi*lo + hi*hi summed in fp32. What is dropped, lo*lo and the
// rounding of lo, is ~2^-22 of each term, against plain TF32's 2^-11.
//
// Fragments of m16n8k8 with tf32 operands, g = lane / 4 and t = lane % 4:
//   A (16x8, row-major): a0 = (g, t)  a1 = (g+8, t)  a2 = (g, t+4)  a3 = (g+8, t+4)
//   B (8x8, k by n):     b0 = (k t, n g)   b1 = (k t+4, n g)
//   C (16x8, fp32):      c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..2t+1)
// A C tile does not hold an A fragment (a lane holds columns 2t, 2t+1 of C
// but needs t, t+4 of A). A product's k axis may be taken in any order as
// long as A's columns and B's rows follow the same one, so a product whose
// A is a C tile (p v, ds k, pᵀ dO, dsᵀ q) reads its k axis permuted: A
// column t is C column 2t and A column t+4 is C column 2t+1, so a lane's
// own c0..c3 are its A fragment, and B rows t and t+4 are read from rows 2t
// and 2t+1 of the shared tile (`load_b_kn`; the dk/dv kernel's planes
// store them side by side).
//
// Accumulation: mma adds into its fp32 accumulator with truncation, so a
// sum carried through every product of a long loop (o over the keys, dq
// over the keys, dk and dv over the queries: ~1,500 mma steps at S = 4096)
// drifts toward zero by up to an ulp a step. Each key or query tile's
// product is therefore summed from zero in registers of its own
// (`mma3_tile`, at most 24 steps; the dk/dv kernel's `rows_by_cols` the
// same) and added to the running sum with a rounded fp32 add
// (`mma3_add`). The tile's A fragments are all held for it, which sets the
// tile sizes where registers are short.
//
// The forward and dq kernels' shared tiles are row-major with a row stride
// of D + 4 floats: 4 banks apart, so the eight rows times four columns of
// an A or B fragment (`load_a`, `load_b_nk`) and the 2t / 2t+1 rows times
// eight columns of a permuted B fragment (`load_b_kn`) fall on 32 distinct
// banks.
#pragma once

#include "flash_common.cuh"

namespace flash {

template <int D>
struct F32Tile {
  static constexpr int LD = D + 4;  // floats per shared row
};

// Round to tf32 (10 mantissa bits), to nearest with ties away from zero:
// the bits below the 13 kept are added in and cut off. Integer operations,
// at twice the rate of cvt; inputs are finite.
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// c += a b on one 16x8x8 tile, tf32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment in the 3xTF32 split.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

// c += a b in 3xTF32: the small terms first, then the large one.
__device__ __forceinline__ void mma3(float c[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// A fragment of rows r0..r0+15, columns k0..k0+7 of a row-major tile.
__device__ __forceinline__ void load_a(Frag<4>& a, const float* s, int ld, int r0, int k0,
                                       int lane) {
  const float* p = s + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_tf32(p[0], a.hi[0], a.lo[0]);
  split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
  split_tf32(p[4], a.hi[2], a.lo[2]);
  split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
}

// B fragment of n n0..n0+7, k k0..k0+7 where B[k][n] = M[n][k]: M is
// row-major with the product's n axis as rows (K in q kᵀ).
__device__ __forceinline__ void load_b_nk(Frag<2>& b, const float* m, int ld, int n0, int k0,
                                          int lane) {
  const float* p = m + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[4], b.hi[1], b.lo[1]);
}

// B fragment where B[k][n] = M[k][n] (V in p v), k in the permuted order
// of `c_to_a_tf32`: B rows t and t+4 are M rows k0+2t and k0+2t+1.
__device__ __forceinline__ void load_b_kn(Frag<2>& b, const float* m, int ld, int k0, int n0,
                                          int lane) {
  const float* p = m + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[ld], b.hi[1], b.lo[1]);
}

// The A fragment of one 8-wide k chunk from the C tile of the same 8
// columns, k permuted (see the header comment): no data leaves the lane.
__device__ __forceinline__ void c_to_a_tf32(Frag<4>& a, const float c[4]) {
  split_tf32(c[0], a.hi[0], a.lo[0]);
  split_tf32(c[2], a.hi[1], a.lo[1]);
  split_tf32(c[1], a.hi[2], a.lo[2]);
  split_tf32(c[3], a.hi[3], a.lo[3]);
}

// The product of one tile over its K8 k chunks (A fragments from
// `c_to_a_tf32`, B from M's rows 0 .. 8 K8 - 1 at columns n0 .. n0 + 7,
// `load_b_kn`), summed from zero in registers of its own.
template <int K8>
__device__ __forceinline__ void mma3_tile(float tile[4], const Frag<4> (&a)[K8],
                                          const float* m, int ld, int n0, int lane) {
  tile[0] = tile[1] = tile[2] = tile[3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < K8; ++kc) {
    Frag<2> b;
    load_b_kn(b, m, ld, kc * 8, n0, lane);
    mma3(tile, a[kc], b);
  }
}

// acc += one tile's product (`mma3_tile`), in rounded fp32.
template <int K8>
__device__ __forceinline__ void mma3_add(float acc[4], const Frag<4> (&a)[K8], const float* m,
                                         int ld, int n0, int lane) {
  float tile[4];
  mma3_tile(tile, a, m, ld, n0, lane);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += tile[e];
}

// Asynchronous copies to shared memory; `valid` false writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N committed copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Starts copying rows row0..row0+R-1 of one (batch, head) of a [B, S, H, D]
// fp32 tensor into a padded shared tile, 16 bytes per thread and step; rows
// at or past seq_len become zeros.
template <int R, int D>
__device__ __forceinline__ void load_rows_f32(float* smem, const float* base, int row0,
                                              int seq_len, long row_stride) {
  constexpr int kChunks = D / 4;
  constexpr int LD = F32Tile<D>::LD;
  for (int i = threadIdx.x; i < R * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = row0 + r < seq_len;
    cp_async16(smem + r * LD + c, base + (long)(in ? row0 + r : 0) * row_stride + c, in);
  }
}

// Starts copying n fp32 row statistics (lse or delta) from `src` + row0;
// entries at or past seq_len become zeros.
__device__ __forceinline__ void load_stats(float* smem, const float* src, int n, int row0,
                                           int seq_len) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = row0 + i < seq_len;
    cp_async4(smem + i, src + (in ? row0 + i : 0), in);
  }
}

// Grid of `tiles` x `bh` blocks folded into x, refused past int's range.
inline cudaError_t folded_grid(long tiles, long bh, dim3* grid) {
  const long blocks = tiles * bh;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)blocks);
  return cudaSuccess;
}

}  // namespace flash
