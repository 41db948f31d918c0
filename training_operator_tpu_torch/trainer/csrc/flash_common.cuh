// Shared building blocks of the flash-attention kernels (sm_90a): the
// layout contract, the `mma.sync` path of the dq kernel, and the fragment
// helpers (pack_bf16, c_to_a, quad_max, quad_sum) and launcher that the
// wgmma kernels reuse through sm90_common.cuh.
//
// Layout contract with trainer/flash.py: q, k, v, out, dO, dq, dk, dv are
// contiguous bf16 [B, S, H, D] (row stride H*D elements); lse and delta are
// contiguous fp32 [B*H, S]. D is 64 or 128. Keys at or past S are masked
// inside the kernels; rows at or past S are read as zeros and never written.
//
// Products run on the tensor cores through `mma.sync.m16n8k16` (bf16 in,
// fp32 accumulate). Fragment layout of that instruction, with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                         a2 = (g, 2t+8..+9)   a3 = (g+8, 2t+8..+9)
//   B (16x8, k by n):     b0 = (k 2t..2t+1, n g)   b1 = (k 2t+8..+9, n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1)    c2,c3 = (g+8, 2t..2t+1)
// Fragments come out of shared memory with `ldmatrix` (four 8x8 matrices per
// instruction; `.trans` for B operands stored k-major). Two neighbouring C
// tiles (n 8j..8j+15) hold exactly the A fragment of a 16-wide k chunk, so a
// softmax tile computed in registers feeds the next product without a trip
// through shared memory. Tiles are copied from device memory with
// `cp.async`, so the next tile's copy runs under the current tile's math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

// The mask value of the JAX reference (flash.py:_MASK): finite, so a row
// whose keys are all masked so far never produces inf - inf.
constexpr float kMask = -1e30f;

// Shared-memory rows are padded by 8 elements (16 bytes): a row of 64 or
// 128 bf16 then starts 4 banks after the previous one, so the eight 16-byte
// rows one ldmatrix matrix reads fall on distinct banks.
template <int D>
struct Tile {
  static constexpr int LD = D + 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b on one 16x8x16 tile.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Lane address shared by the A load and the transposed B load: lanes 0-15
// point at rows r0..r0+15 of column c0, lanes 16-31 at the same rows of
// column c0+8.
__device__ __forceinline__ const bf16* quad_rows(const bf16* s, int ld, int r0,
                                                 int c0, int lane) {
  return s + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}

// A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile.
__device__ __forceinline__ void ldsm_a(uint32_t a[4], const bf16* s, int ld,
                                       int r0, int k0, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(quad_rows(s, ld, r0, k0, lane))));
}

// B fragments of two n-tiles (n0..n0+7 and n0+8..n0+15, k0..k0+15) where
// B[k][n] = M[n][k]: M is row-major with the product's n axis as rows (K in
// q kᵀ). b[j] is the fragment of n-tile j.
__device__ __forceinline__ void ldsm_b_nk(uint32_t b[2][2], const bf16* m, int ld,
                                          int n0, int k0, int lane) {
  const bf16* p = m + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                  (((lane >> 3) & 1) << 3);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(smem_addr(p)));
}

// The same two B fragments where B[k][n] = M[k][n]: M's rows are the
// product's k axis (V in p v); `.trans` turns the k-major rows around.
__device__ __forceinline__ void ldsm_b_kn(uint32_t b[2][2], const bf16* m, int ld,
                                          int k0, int n0, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(smem_addr(quad_rows(m, ld, k0, n0, lane))));
}

// The A fragment of k chunk j (16 columns) taken from C tiles 2j and 2j+1.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Asynchronous copies to shared memory; `valid` false writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Starts copying rows row0..row0+R-1 of one (batch, head) of a [B, S, H, D]
// tensor into a padded shared tile, 16 bytes per thread and step; rows at or
// past seq_len become zeros.
template <int R, int D>
__device__ __forceinline__ void load_rows(bf16* smem, const bf16* base,
                                          int row0, int seq_len,
                                          long row_stride) {
  constexpr int kChunks = D / 8;
  constexpr int LD = Tile<D>::LD;
  for (int i = threadIdx.x; i < R * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < seq_len;
    cp_async16(smem + r * LD + c, base + (long)(in ? row0 + r : 0) * row_stride + c, in);
  }
}

// Max and sum across the four lanes that share one row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sets the dynamic shared-memory limit of `kernel` and launches it; returns
// the first CUDA error, so the Python wrapper can raise on a refused launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, dim3 block, int smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace flash
