// Clip by the global norm and AdamW for Hopper (sm_90a): one multi-tensor
// pass for the norm, one for the update, over every parameter at once.
//
// Replaces no TPU kernel: the JAX optimizer is optax on XLA
// (training_operator_tpu/trainer/train.py, `optax.chain(clip_by_global_norm,
// adamw(warmup_cosine_decay_schedule))`), which XLA fuses into its step. The
// port ran it as one torch op per term (trainer/train.py's loop, kept for the
// CPU and for any tensor these kernels do not take), each reading and writing
// whole fp32 tensors: ~37 passes, ~148 bytes a parameter.
//
// Bound on an H100: device memory. The norm reads g once; the update reads
// p, g, mu and nu and writes p, mu and nu once: 32 bytes a parameter, 64 GB
// for 2.0B parameters, 19 ms at 3.35 TB/s. A few dozen flops an element.
//
// Design (multi-tensor-stream): trainer/adamw.py hands over a table with a
// row per tensor (Tensor: its pointers, its elements and its first chunk).
// Each tensor is cut into chunks of kChunk elements, one block a chunk, and
// the chunks of every tensor form one grid, so a launch covers every
// parameter whatever their number; a block finds its tensor by a binary
// search over the rows' first chunks. Offsets are 64-bit (a model holds
// billions of elements, a tensor more than 2^31). A block moves its chunk in
// float4 accesses (128-bit LDG/STG) where a tensor's p, g, mu and nu share
// their offset from a 16-byte boundary: a scalar head up to the first
// aligned element, float4 from there (the update loads kUnroll float4 of
// each before it stores any, so each thread keeps 16 loads in flight), a
// scalar tail; where they differ, scalar accesses throughout. The update's
// float4 accesses name the global space (`load4`, `store4`): read from the
// table, its pointers are generic to the compiler, which then emits generic
// LD/ST. Evict-first hints (ld.global.cs) ran its stream 1.6% slower on an
// H100, so the accesses keep the default caching.
//
// Norm: sumsq_kernel writes each chunk's sum of squares, summed in fp64 in a
// fixed order; sumsq_finish_kernel (one block) sums each tensor's chunks in
// order into its fp32 sum and the total into the norm's fp32 square root. No
// atomics: the same gradients give the same norm bit for bit.
//
// Update: the loop's arithmetic, op for op, in fp32 with IEEE division and
// square root (no fast math): clip decided on the device from the norm
// (g / norm * clip at or above clip_norm), then mu = mu b1 + (1 - b1) g,
// nu = nu b2 + (1 - b2) g g, u = (mu / bc1) / (sqrt(nu / bc2) + eps)
// + wd p, p = p - lr u, each term rounded where the loop's torch op rounds
// it (a division by a host scalar is a product with its reciprocal there).
// The hyperparameters arrive as host values, so the step reads nothing
// back from the card.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace adamw {

constexpr int kThreads = 256;
constexpr long long kChunk = 1 << 16;  // adamw.CHUNK
constexpr int kUnroll = 4;

// One row of the table (adamw.COLUMNS): p, mu and nu are null in a table
// for the norm alone.
struct Tensor {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  long long n;       // elements
  long long chunk0;  // the first of its chunks among every tensor's
};
static_assert(sizeof(Tensor) == 48, "the table's rows are six int64 columns");

struct Hyper {
  float clip, lr, b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd;
};

// The row holding `chunk`: the last whose first chunk is at or before it
// (an empty tensor shares its first chunk with the next and is never found).
__device__ __forceinline__ Tensor tensor_of(const Tensor* table, int rows, long long chunk) {
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].chunk0 <= chunk) lo = mid;
    else hi = mid - 1;
  }
  return table[lo];
}

// Elements [s, e) of chunk j of a tensor of n elements whose element `a`
// (0-3) is its first on a 16-byte boundary: chunk j starts at a + j kChunk
// (chunk 0 at 0). [vs, ve) is the float4 run; with `vec` false it is empty
// and [s, e) is all scalar.
struct Range {
  long long s, vs, ve, e;
};

__device__ __forceinline__ Range chunk_range(long long n, long long j, int a, bool vec) {
  Range r;
  r.e = min(n, a + (j + 1) * kChunk);
  r.s = min(r.e, j == 0 ? 0 : a + j * kChunk);
  r.vs = vec ? min(r.e, r.s + ((a - r.s) & 3)) : r.e;
  r.ve = r.vs + ((r.e - r.vs) & ~3ll);
  return r;
}

__device__ __forceinline__ int aligned_from(const void* ptr) {
  return (int)(((16 - (reinterpret_cast<uintptr_t>(ptr) & 15)) & 15) >> 2);
}

// The sum over the block, in thread 0, in a fixed order.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warps[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warps[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warps[] is free for the next call
  return v;
}

__device__ __forceinline__ float4 load4(const float4* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store4(float4* p, const float4& v) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ double square_add(float x, double acc) {
  return fma((double)x, (double)x, acc);
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const Tensor* __restrict__ table, int rows, double* __restrict__ partials) {
  const long long chunk = blockIdx.x;
  const Tensor t = tensor_of(table, rows, chunk);
  const Range r = chunk_range(t.n, chunk - t.chunk0, aligned_from(t.g), true);
  double acc = 0.0;
  for (long long i = r.s + threadIdx.x; i < r.vs; i += kThreads) acc = square_add(t.g[i], acc);
  const float4* g4 = reinterpret_cast<const float4*>(t.g + r.vs);
  const long long n4 = (r.ve - r.vs) >> 2;
#pragma unroll 4
  for (long long k = threadIdx.x; k < n4; k += kThreads) {
    const float4 x = __ldg(g4 + k);
    acc = square_add(x.w, square_add(x.z, square_add(x.y, square_add(x.x, acc))));
  }
  for (long long i = r.ve + threadIdx.x; i < r.e; i += kThreads) acc = square_add(t.g[i], acc);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[chunk] = acc;
}

__global__ void __launch_bounds__(kThreads)
sumsq_finish_kernel(const Tensor* __restrict__ table, int rows, long long chunks,
                    const double* __restrict__ partials, float* __restrict__ sums,
                    float* __restrict__ norm) {
  double total = 0.0;
  for (int t = 0; t < rows; ++t) {
    const long long end = t + 1 < rows ? table[t + 1].chunk0 : chunks;
    double acc = 0.0;
    for (long long c = table[t].chunk0 + threadIdx.x; c < end; c += kThreads) acc += partials[c];
    acc = block_sum(acc);
    if (threadIdx.x == 0) {
      sums[t] = (float)acc;
      total += acc;
    }
  }
  if (threadIdx.x == 0 && norm != nullptr) *norm = (float)sqrt(total);
}

// One element, as the loop's torch ops round it: a product by a host scalar
// (mul_), an add with alpha (add_, addcmul_: a fused multiply-add), a
// division by a host scalar (a product with its fp32 reciprocal).
__device__ __forceinline__ void step(float& p, float g, float& m, float& v, const Hyper& h,
                                     float norm, bool clip) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.clip);
  m = __fmaf_rn(h.one_minus_b1, g, __fmul_rn(m, h.b1));
  v = __fmaf_rn(__fmul_rn(h.one_minus_b2, g), g, __fmul_rn(v, h.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
  const float u = __fmaf_rn(h.wd, p, __fdiv_rn(__fmul_rn(m, h.inv_bc1), den));
  p = __fmaf_rn(-h.lr, u, p);
}

__device__ __forceinline__ void step4(float4& p, const float4& g, float4& m, float4& v,
                                      const Hyper& h, float norm, bool clip) {
  step(p.x, g.x, m.x, v.x, h, norm, clip);
  step(p.y, g.y, m.y, v.y, h, norm, clip);
  step(p.z, g.z, m.z, v.z, h, norm, clip);
  step(p.w, g.w, m.w, v.w, h, norm, clip);
}

__device__ __forceinline__ void step_at(const Tensor& t, long long i, const Hyper& h, float norm,
                                        bool clip) {
  float p = t.p[i], m = t.mu[i], v = t.nu[i];
  step(p, t.g[i], m, v, h, norm, clip);
  t.p[i] = p;
  t.mu[i] = m;
  t.nu[i] = v;
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const Tensor* __restrict__ table, int rows, const float* __restrict__ norm_at,
                    const Hyper h) {
  const long long chunk = blockIdx.x;
  const Tensor t = tensor_of(table, rows, chunk);
  const float norm = *norm_at;
  const bool clip = norm >= h.clip;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(t.p);
  const bool vec = ((pa ^ reinterpret_cast<uintptr_t>(t.g)) | (pa ^ reinterpret_cast<uintptr_t>(t.mu)) |
                    (pa ^ reinterpret_cast<uintptr_t>(t.nu))) % 16 == 0;
  const Range r = chunk_range(t.n, chunk - t.chunk0, aligned_from(t.p), vec);
  for (long long i = r.s + threadIdx.x; i < r.vs; i += kThreads) step_at(t, i, h, norm, clip);
  float4* p4 = reinterpret_cast<float4*>(t.p + r.vs);
  const float4* g4 = reinterpret_cast<const float4*>(t.g + r.vs);
  float4* m4 = reinterpret_cast<float4*>(t.mu + r.vs);
  float4* v4 = reinterpret_cast<float4*>(t.nu + r.vs);
  const long long n4 = (r.ve - r.vs) >> 2;
  for (long long k0 = threadIdx.x; k0 < n4; k0 += kUnroll * kThreads) {
    float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + u * kThreads;
      if (k < n4) {
        p[u] = load4(p4 + k);
        g[u] = load4(g4 + k);
        m[u] = load4(m4 + k);
        v[u] = load4(v4 + k);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + u * kThreads;
      if (k < n4) {
        step4(p[u], g[u], m[u], v[u], h, norm, clip);
        store4(p4 + k, p[u]);
        store4(m4 + k, m[u]);
        store4(v4 + k, v[u]);
      }
    }
  }
  for (long long i = r.ve + threadIdx.x; i < r.e; i += kThreads) step_at(t, i, h, norm, clip);
}

inline cudaError_t check_grid(int rows, long long chunks) {
  return rows <= 0 || chunks <= 0 || chunks > 0x7fffffffll ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace adamw

// table: `rows` rows of adamw.COLUMNS (int64) on the card, their chunks
// numbered 0 to chunks - 1; partials: `chunks` doubles of scratch; sums:
// `rows` floats, one a row; norm: one float, or null for none.
extern "C" int adamw_sumsq_fp32(const void* table, int rows, long long chunks, void* partials,
                                void* sums, void* norm, void* stream) {
  cudaError_t err = adamw::check_grid(rows, chunks);
  if (err != cudaSuccess) return (int)err;
  const auto* t = static_cast<const adamw::Tensor*>(table);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  adamw::sumsq_kernel<<<(unsigned)chunks, adamw::kThreads, 0, st>>>(
      t, rows, static_cast<double*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adamw::sumsq_finish_kernel<<<1, adamw::kThreads, 0, st>>>(
      t, rows, chunks, static_cast<const double*>(partials), static_cast<float*>(sums),
      static_cast<float*>(norm));
  return (int)cudaGetLastError();
}

// The update in place on every row's p, mu and nu, clipped by the norm at
// `norm` (one float on the card). The host values are rounded to fp32 here
// as the loop's torch ops round their scalars.
extern "C" int adamw_update_fp32(const void* table, int rows, long long chunks, const void* norm,
                                 double clip_norm, double lr, double b1, double b2, double bc1,
                                 double bc2, double eps, double weight_decay, void* stream) {
  cudaError_t err = adamw::check_grid(rows, chunks);
  if (err != cudaSuccess) return (int)err;
  adamw::Hyper h;
  h.clip = (float)clip_norm;
  h.lr = (float)lr;
  h.b1 = (float)b1;
  h.one_minus_b1 = (float)(1.0 - b1);
  h.b2 = (float)b2;
  h.one_minus_b2 = (float)(1.0 - b2);
  h.inv_bc1 = 1.0f / (float)bc1;
  h.inv_bc2 = 1.0f / (float)bc2;
  h.eps = (float)eps;
  h.wd = (float)weight_decay;
  adamw::adamw_update_kernel<<<(unsigned)chunks, adamw::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const adamw::Tensor*>(table), rows, static_cast<const float*>(norm), h);
  return (int)cudaGetLastError();
}
