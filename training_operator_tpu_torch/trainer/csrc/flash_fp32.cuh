// Shared building blocks of the fp32 flash-attention kernels (sm_90a):
// the 3xTF32 product on `mma.sync` and the tf32 split, used by all three;
// cp.async copies that complete on an mbarrier; a warp's resident rows in
// A-fragment order (A planes); and, for the dq and dk/dv kernels (the
// "ring" design), operands split once into hi and lo B planes in fragment
// order, and the products that read those planes. The forward (the
// "stream" design) reads K and V raw from padded row-major tiles and splits
// each B fragment as it loads it (`load_b_nk`, and 16-byte V loads in its
// source).
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
// and 2t+1 of the operand (the planes store them side by side,
// `load_b_plane_kn`).
//
// Accumulation: mma adds into its fp32 accumulator with truncation, so a
// sum carried through every product of a long loop (o over the keys, dq
// over the keys, dk and dv over the queries: ~1,500 mma steps at S = 4096)
// drifts toward zero by up to an ulp a step. Each key or query tile's
// product is therefore summed from zero in registers of its own (the
// forward's p v, `mma3_kn`: at most 24 steps) and added to the running sum
// with a rounded fp32 add. The tile's A fragments are all held for it,
// which sets the tile sizes where registers are short.
#pragma once

#include "flash_common.cuh"

namespace flash {

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

// B fragment of n n0..n0+7, k k0..k0+7 where B[k][n] = M[n][k]: M is
// row-major with the product's n axis as rows (K in q kᵀ).
__device__ __forceinline__ void load_b_nk(Frag<2>& b, const float* m, int ld, int n0, int k0,
                                          int lane) {
  const float* p = m + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[4], b.hi[1], b.lo[1]);
}

// The A fragment of one 8-wide k chunk from the C tile of the same 8
// columns, k permuted (see the header comment): no data leaves the lane.
__device__ __forceinline__ void c_to_a_tf32(Frag<4>& a, const float c[4]) {
  split_tf32(c[0], a.hi[0], a.lo[0]);
  split_tf32(c[2], a.hi[1], a.lo[1]);
  split_tf32(c[1], a.hi[2], a.lo[2]);
  split_tf32(c[3], a.hi[3], a.lo[3]);
}

// An asynchronous 16-byte copy to shared memory; `valid` false writes zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// Arrives on the mbarrier `bar` once this thread's earlier cp.async copies
// have landed (one of the barrier's expected arrivals; no commit or wait
// group).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}

// ---------------------------------------------------------------- split planes
//
// The ring design (dq and dk/dv) splits each operand element once, into
// planes in fragment order, so the products' loads land in the registers
// `mma.sync` reads. Two kinds:
//
// B planes (`store_b_planes`): an R x D tile of rows as a plane of tf32 hi
// values, then one of lo values (each R x D floats), cut into 8x8 blocks
// (block (kc, j): rows 8 kc.., columns 8 j..) of 64 floats, column-major
// with the columns permuted: element (r, c) of block (kc, j) at
// 8 swz(c, j) + r. The permutation spreads over all 32 banks both the
// loads and the producer's 8-byte stores (a half warp's lanes store 4 row
// pairs x the same column of 4 neighbouring column groups), with no
// rotation of data between lanes. One plane serves both B orders, hi and
// lo each in registers of their own:
// - n = the block's rows, k = its columns (dq's q kᵀ and dO vᵀ, dk/dv's
//   k qᵀ and v dOᵀ): (g, t) and (g, t + 4), four 4-byte loads
//   (`nk_offsets`, `load_b_plane_nk`);
// - k = rows 2t and 2t + 1 (the permuted k of `c_to_a_tf32`), n = column g
//   (dq's ds k, dk/dv's pᵀ dO and dsᵀ q): one 8-byte load from each plane
//   (`kn_offset`, `load_b_plane_kn`).
// Unsplit (SPLIT false, where split planes do not fit), the tile is one
// plane of raw fp32 values in the same order, split as it is read.
//
// A planes (`stage_a_planes`): one warp's 16 rows in A-fragment order, 8
// columns at a time: lane l's a0..a3 (rows g, g + 8 at columns t, t + 4) at
// floats 4 l .. 4 l + 3 of a 128-float chunk, the hi chunk then the lo chunk
// (or the raw chunk alone): one 16-byte load per plane (`load_a_plane`).
// Where registers allow, a warp holds its split A fragments in registers
// instead (`load_a_frags`).

__device__ __forceinline__ int swz(int c, int j) { return c ^ ((c >> 2) & 1) ^ ((j & 1) << 1); }

// Lane offsets of its nk B fragment in a block of column parity `odd`:
// columns t and t + 4 of row g.
__device__ __forceinline__ int2 nk_offsets(int lane, int odd) {
  const int g = lane >> 2, t = lane & 3;
  return make_int2(8 * swz(t, odd) + g, 8 * swz(t + 4, odd) + g);
}

// Lane offset of its kn B fragment: rows 2t and 2t + 1 of column g.
__device__ __forceinline__ int kn_offset(int lane, int odd) {
  return 8 * swz(lane >> 2, odd) + 2 * (lane & 3);
}

// B fragments from a block of a B plane whose lo plane lies LO floats on.
template <int LO, bool SPLIT>
__device__ __forceinline__ void load_b_plane_nk(Frag<2>& b, const float* blk, int2 o) {
  if constexpr (SPLIT) {
    const uint32_t* h = reinterpret_cast<const uint32_t*>(blk);
    b.hi[0] = h[o.x]; b.hi[1] = h[o.y];
    b.lo[0] = h[LO + o.x]; b.lo[1] = h[LO + o.y];
  } else {
    split_tf32(blk[o.x], b.hi[0], b.lo[0]);
    split_tf32(blk[o.y], b.hi[1], b.lo[1]);
  }
}

template <int LO, bool SPLIT>
__device__ __forceinline__ void load_b_plane_kn(Frag<2>& b, const float* hi) {
  if constexpr (SPLIT) {
    const uint2 h = *reinterpret_cast<const uint2*>(hi);
    const uint2 l = *reinterpret_cast<const uint2*>(hi + LO);
    b.hi[0] = h.x; b.hi[1] = h.y;
    b.lo[0] = l.x; b.lo[1] = l.y;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(hi);
    split_tf32(x.x, b.hi[0], b.lo[0]);
    split_tf32(x.y, b.hi[1], b.lo[1]);
  }
}

// A producer warpgroup's split-and-store: rows row0 .. row0 + R - 1 of two
// [B, S, H, D] tensors, `a` and `b` at one (batch, head), into `dst` as B
// planes, a's then b's (R x D floats each, twice that split). A warp step
// covers one tensor's 8 rows x 32 columns: lane (rp, cg) = (lane & 3,
// lane >> 2) loads rows 2 rp and 2 rp + 1 at columns 4 cg .. 4 cg + 3 (16
// bytes each, `load_b_step`) and stores each column's hi pair and lo pair
// where `swz` puts them (`store_b_step`); warp `pw` of the warpgroup takes
// steps pw, pw + 4, ... (B_STEPS of them). Rows at or past seq_len become
// zeros. The dq producer reads its steps from a landing tile in shared
// memory instead (`load_b_step_smem`).
template <int R, int D>
constexpr int B_STEPS = 2 * (R / 8) * (D / 32) / 4;

// Where step w puts a lane: tensor b (else a), block row kc, tile rows r
// and r + 1, columns c0 .. c0 + 3.
template <int R, int D>
struct BStep {
  static constexpr int GROUPS = (R / 8) * (D / 32);  // steps per tensor
  static_assert(R % 8 == 0 && D % 32 == 0 && GROUPS % 2 == 0, "whole steps for every warp");
  bool second;
  int kc, r, c0;
  __device__ __forceinline__ BStep(int w, int lane)
      : second(w >= GROUPS), kc((w % GROUPS) / (D / 32)), r(8 * kc + 2 * (lane & 3)),
        c0(32 * (w % (D / 32)) + 4 * (lane >> 2)) {}
};

template <int R, int D>
__device__ __forceinline__ void load_b_step(float4 (&x)[2], const float* a, const float* b,
                                            int row0, int S, long rs, int w, int lane) {
  const BStep<R, D> st(w, lane);
  const float* src = (st.second ? b : a) + st.c0 + (long)(row0 + st.r) * rs;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = row0 + st.r < S ? __ldg(reinterpret_cast<const float4*>(src)) : zero;
  x[1] = row0 + st.r + 1 < S ? __ldg(reinterpret_cast<const float4*>(src + rs)) : zero;
}

// The same step read from a landing tile in shared memory: a's R rows,
// then b's, each LDR floats apart.
template <int R, int D, int LDR>
__device__ __forceinline__ void load_b_step_smem(float4 (&x)[2], const float* land, int w,
                                                 int lane) {
  const BStep<R, D> st(w, lane);
  const float* src = land + (st.second ? R * LDR : 0) + st.r * LDR + st.c0;
  x[0] = *reinterpret_cast<const float4*>(src);
  x[1] = *reinterpret_cast<const float4*>(src + LDR);
}

template <int R, int D, bool SPLIT>
__device__ __forceinline__ void store_b_step(float* dst, const float4 (&x)[2], int w, int lane) {
  const BStep<R, D> st(w, lane);
  const float a0[4] = {x[0].x, x[0].y, x[0].z, x[0].w}, a1[4] = {x[1].x, x[1].y, x[1].z, x[1].w};
  // Rows r, r + 1 of block (kc, c0 / 8), hi plane.
  float* blk = dst + (st.second ? R * D * (SPLIT ? 2 : 1) : 0) +
               ((st.kc * (D / 8) + (st.c0 >> 3)) << 6) + (st.r & 7);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float* at = blk + 8 * swz((st.c0 & 7) + e, st.c0 >> 3);
    if constexpr (SPLIT) {
      uint32_t h0, l0, h1, l1;
      split_tf32(a0[e], h0, l0);
      split_tf32(a1[e], h1, l1);
      *reinterpret_cast<uint2*>(at) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(at + R * D) = make_uint2(l0, l1);
    } else {
      *reinterpret_cast<float2*>(at) = make_float2(a0[e], a1[e]);
    }
  }
}

template <int R, int D, bool SPLIT>
__device__ __forceinline__ void store_b_planes(float* dst, const float* a, const float* b,
                                               int row0, int S, long rs, int pw, int lane) {
#pragma unroll 2
  for (int i = 0; i < B_STEPS<R, D>; ++i) {
    float4 x[2];
    load_b_step<R, D>(x, a, b, row0, S, rs, pw + 4 * i, lane);
    store_b_step<R, D, SPLIT>(dst, x, pw + 4 * i, lane);
  }
}

// One warp copies rows row0 .. row0 + 15 of a [B, S, H, D] tensor (at one
// (batch, head)) into its A planes; rows at or past seq_len become zeros.
template <int D, bool SPLIT>
__device__ __forceinline__ void stage_a_planes(float* dst, const float* src, int row0, int S,
                                               long rs, int lane) {
  constexpr int C4 = D / 4;  // float4 columns of a row
  for (int u = lane; u < 16 * C4; u += 32) {
    const int rr = u / C4, c0 = (u % C4) * 4;
    const float4 x =
        row0 + rr < S ? __ldg(reinterpret_cast<const float4*>(src + (long)(row0 + rr) * rs + c0))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e, cc = c & 7;
      const int slot = 4 * (4 * (rr & 7) + (cc & 3)) + (rr >> 3) + 2 * (cc >> 2);
      if constexpr (SPLIT) {
        uint32_t hi, lo;
        split_tf32(xs[e], hi, lo);
        dst[(c >> 3) * 256 + slot] = __uint_as_float(hi);
        dst[(c >> 3) * 256 + 128 + slot] = __uint_as_float(lo);
      } else {
        dst[(c >> 3) * 128 + slot] = xs[e];
      }
    }
  }
}

// The lane's A fragment of columns 8 kk .. 8 kk + 7 from a warp's A planes.
template <bool SPLIT>
__device__ __forceinline__ void load_a_plane(Frag<4>& a, const float* planes, int kk, int lane) {
  if constexpr (SPLIT) {
    const uint4 hi = *reinterpret_cast<const uint4*>(planes + kk * 256 + 4 * lane);
    const uint4 lo = *reinterpret_cast<const uint4*>(planes + kk * 256 + 128 + 4 * lane);
    a.hi[0] = hi.x; a.hi[1] = hi.y; a.hi[2] = hi.z; a.hi[3] = hi.w;
    a.lo[0] = lo.x; a.lo[1] = lo.y; a.lo[2] = lo.z; a.lo[3] = lo.w;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(planes + kk * 128 + 4 * lane);
    split_tf32(x.x, a.hi[0], a.lo[0]);
    split_tf32(x.y, a.hi[1], a.lo[1]);
    split_tf32(x.z, a.hi[2], a.lo[2]);
    split_tf32(x.w, a.hi[3], a.lo[3]);
  }
}

// A warp's A fragments of rows row0 .. row0 + 15 of a [B, S, H, D] tensor
// (at one (batch, head)), every element split once, into registers; rows
// at or past seq_len become zeros.
template <int D>
__device__ __forceinline__ void load_a_frags(Frag<4> (&a)[D / 8], const float* src, int row0,
                                             int S, long rs, int lane) {
  const int lo = row0 + (lane >> 2), hi = lo + 8;
  const float* plo = src + (long)lo * rs + (lane & 3);
  const float* phi = src + (long)hi * rs + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const float x0 = lo < S ? __ldg(plo + 8 * kk) : 0.f;
    const float x1 = hi < S ? __ldg(phi + 8 * kk) : 0.f;
    const float x2 = lo < S ? __ldg(plo + 8 * kk + 4) : 0.f;
    const float x3 = hi < S ? __ldg(phi + 8 * kk + 4) : 0.f;
    split_tf32(x0, a[kk].hi[0], a[kk].lo[0]);
    split_tf32(x1, a[kk].hi[1], a[kk].lo[1]);
    split_tf32(x2, a[kk].hi[2], a[kk].lo[2]);
    split_tf32(x3, a[kk].hi[3], a[kk].lo[3]);
  }
}

// out = A Bᵀ over the head dim for a warp's 16 rows and the N rows of a B
// plane (dq: s = q kᵀ, dp = dO vᵀ; dk/dv: sᵀ = k qᵀ, dpᵀ = v dOᵀ): A from
// `a_of(kk, frag)`, the warp's fragment of columns 8 kk .. 8 kk + 7 (from
// its A planes or its registers), B in the nk order. Two partial sums over
// the head dim, for more independent `mma.sync` in flight.
template <int D, int N, bool B_SPLIT, typename AOf>
__device__ __forceinline__ void mma3_nk(float (&out)[N / 8][4], AOf&& a_of, const float* plane,
                                        int lane) {
  const int2 even = nk_offsets(lane, 0), odd = nk_offsets(lane, 1);
  float part[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = part[n][e] = 0.f;
  auto step = [&](int kk) {  // head-dim columns 8 kk .. 8 kk + 15
    Frag<4> a0, a1;
    a_of(kk, a0);
    a_of(kk + 1, a1);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float* blk = plane + ((n * (D / 8) + kk) << 6);
      Frag<2> b;
      load_b_plane_nk<N * D, B_SPLIT>(b, blk, even);
      mma3(out[n], a0, b);
      load_b_plane_nk<N * D, B_SPLIT>(b, blk + 64, odd);  // the next 8 columns' block
      mma3(part[n], a1, b);
    }
  };
#pragma unroll
  for (int kk = 0; kk < D / 8; kk += 2) step(kk);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] += part[n][e];
}

// acc += A M over the K rows of a B plane M, at M's columns 8 j0 ..
// 8 (j0 + NJ) - 1, j0 even (dq: ds k; dk/dv: pᵀ dO, dsᵀ q): A the K / 8
// fragments of a C tile (`c_to_a_tf32`), B in the kn order; each 8-column
// tile summed from zero and added in rounded fp32.
template <int K, int D, int NJ, bool B_SPLIT>
__device__ __forceinline__ void mma3_kn(float (&acc)[NJ][4], const Frag<4> (&a)[K / 8],
                                        const float* plane, int j0, int lane) {
  const float* lane_even = plane + (j0 << 6) + kn_offset(lane, 0);  // rows 2t, 2t + 1 of column g
  const float* lane_odd = plane + (j0 << 6) + kn_offset(lane, 1);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float tile[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < K / 8; ++kc) {
      Frag<2> b;
      const float* at = (j & 1 ? lane_odd : lane_even) + ((kc * (D / 8) + j) << 6);
      load_b_plane_kn<K * D, B_SPLIT>(b, at);
      mma3(tile, a[kc], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += tile[e];
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
