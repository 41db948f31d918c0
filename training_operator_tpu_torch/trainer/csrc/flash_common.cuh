// Shared building blocks of the flash-attention kernels (sm_90a): the
// layout contract, the fragment helpers (pack_bf16, c_to_a, quad_max,
// quad_sum) and the launcher, which the kernels reach through
// sm90_common.cuh.
//
// Layout contract with trainer/flash.py: q, k, v, out, dO, dq, dk, dv are
// contiguous bf16 [B, S, H, D] (row stride H*D elements); lse and delta are
// contiguous fp32 [B*H, S]. D is 64, 128 or 256. Keys at or past S are masked
// inside the kernels; rows at or past S are read as zeros and never written.
//
// Fragment layout of the fp32 accumulator (per warp, per 8 columns, the
// `mma.sync.m16n8k16` C layout) and of the register A operand, with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                         a2 = (g, 2t+8..+9)   a3 = (g+8, 2t+8..+9)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1)    c2,c3 = (g+8, 2t..2t+1)
// Two neighbouring C tiles (n 8j..8j+15) hold exactly the A fragment of a
// 16-wide k chunk, so a probability or ds tile computed in registers feeds
// the next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

// The mask value of the JAX reference (flash.py:_MASK): finite, so a row
// whose keys are all masked so far never produces inf - inf.
constexpr float kMask = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k chunk j (16 columns) taken from C tiles 2j and 2j+1.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
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
