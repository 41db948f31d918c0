// The dropless expert layer's token permutation for Hopper (sm_90a): the
// rows between token order and the grouped expert buffer, forward and
// backward, in two kernels.
//
// Replaces no TPU kernel: the JAX package has no dropless layer (its switch
// layer dispatches and combines by one-hot einsums that XLA fuses). The port
// ran the permutation as torch ops (trainer/moe.py's `plain_dispatch`,
// `plain_dispatch_backward` and `plain_combine`, kept for the CPU): a zero
// fill and an index_put, index_select, broadcast multiplies, k-sums and a
// zero-filled index_add, about 14 GB a layer and step at OLMoE's shape.
//
// Bound on an H100: device memory. With T tokens of D bf16, k choices each
// and M = T k + padding rows, R = M D 2 bytes:
//   scatter            write R, read T D 2 (the source, once a token);
//   scatter with gate  besides, read R (y, for the gate's gradient);
//   gather_sum         read T k D 2 (the named rows), write T D 2.
// At T 16384, k 8, D 2048 the four calls of a layer move ~4.2 GB, 1.25 ms
// at 3.35 TB/s. A few flops an element.
//
// Design (warp-row-permute): one warp owns a token and moves whole rows in
// 16-byte accesses (LDG.128, STG.128), a lane's chunks 512 bytes apart.
// Every output row has one writer and every sum a fixed order, so no
// atomics: the same inputs give the same bits.
//
//   scatter_kernel     out[dest[t, j]] = src[t] for each choice j: the
//                      source row read once, written k times.
//   scatter_gate_kernel  the combine's backward: the row written is
//                      bf16(src[t] * bf16(gate[t, j])), and the same pass
//                      reads y[dest[t, j]] for grad_gate[t, j] =
//                      sum_d src[t, d] y[dest[t, j], d] in fp32 (each lane's
//                      partial, a butterfly over the warp, lane j keeping
//                      choice j's sum). A lane holds kSeg chunks of the
//                      source row at once (a row of 2048 bf16 is one such
//                      segment) and loads a choice's kSeg chunks of y before
//                      it uses any.
//   Both scatters      zero, in the blocks past the tokens', the rows that
//                      no (t, j) names, found in a byte map that
//                      mark_kernel fills from dest after a memset of it: no
//                      pass fills the whole buffer.
//   gather_sum_kernel  out[t] = bf16(sum_j fp32(bf16(buf[dest[t, j]] *
//                      bf16(gate[t, j])))), the k terms in j order with fp32
//                      accumulation and one rounding (the combine); without
//                      a gate, bf16(sum_j fp32(buf[dest[t, j]])) (the
//                      dispatch's backward). A lane loads four rows' chunks
//                      before it adds any.
//
// Each product is rounded to bf16 as a bf16 multiply rounds it, and each
// gate is rounded to bf16 first, as `gate.to(bfloat16)` does. k, D, T and M
// come from the caller's shapes (trainer/permute.py): any top-k up to 32,
// any D that is a multiple of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe_permute {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // tokens a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 8;    // source chunks a lane holds at once (scatter_gate_kernel)
constexpr int kBatch = 4;  // rows whose chunks a lane loads before adding
constexpr int kMaxK = 32;  // choices a token (permute.MAX_K)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 load(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store(bf16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The rows of [r0, r0 + 32) (one a lane) that `named` does not mark, each
// zeroed by the whole warp.
__device__ __forceinline__ void zero_unnamed(bf16* __restrict__ out,
                                             const uint8_t* __restrict__ named, long long rows,
                                             int d, long long r0) {
  const int lane = threadIdx.x & 31;
  const long long r = r0 + lane;
  unsigned pad = __ballot_sync(kFull, r < rows && named[r] == 0);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  while (pad) {
    const int l = __ffs(pad) - 1;
    pad &= pad - 1;
    bf16* o = out + (r0 + l) * d;
    for (int c = lane; c < (d >> 3); c += 32) store(o + c * 8, zero);
  }
}

__global__ void mark_kernel(const long long* __restrict__ dest, long long pairs,
                            uint8_t* __restrict__ named) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < pairs) named[dest[i]] = 1;
}

// out[dest[t, j]] = src[t]: a lane's 16-byte chunk read once, stored k times.
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const bf16* __restrict__ src, const long long* __restrict__ dest,
               bf16* __restrict__ out, const uint8_t* __restrict__ named, long long tokens,
               int k, int d, long long rows, long long token_blocks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x >= token_blocks) {
    zero_unnamed(out, named, rows, d, ((blockIdx.x - token_blocks) * kWarps + warp) * 32);
    return;
  }
  const long long t = (long long)blockIdx.x * kWarps + warp;
  if (t >= tokens) return;
  const bf16* s = src + t * d;
  const long long* dt = dest + t * k;
  for (int c = lane; c < (d >> 3); c += 32) {
    const uint4 v = load(s + c * 8);
    for (int j = 0; j < k; ++j) store(out + __ldg(dt + j) * d + c * 8, v);
  }
}

// out[dest[t, j]] = bf16(src[t] bf16(gate[t, j])) and grad_gate[t, j] =
// src[t] . y[dest[t, j]]: a segment of kSeg chunks a lane held while each
// choice's y chunks are read, the dot's partials summed over the warp.
__global__ void __launch_bounds__(kThreads)
scatter_gate_kernel(const bf16* __restrict__ src, const long long* __restrict__ dest,
                    const float* __restrict__ gate, const bf16* __restrict__ y,
                    bf16* __restrict__ out, float* __restrict__ grad_gate,
                    const uint8_t* __restrict__ named, long long tokens, int k, int d,
                    long long rows, long long token_blocks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x >= token_blocks) {
    zero_unnamed(out, named, rows, d, ((blockIdx.x - token_blocks) * kWarps + warp) * 32);
    return;
  }
  const long long t = (long long)blockIdx.x * kWarps + warp;
  if (t >= tokens) return;
  const int chunks = d >> 3;
  const bf16* s = src + t * d;
  const long long* dt = dest + t * k;
  float mine = 0.f;  // lane j: grad_gate[t, j]
  for (int c0 = 0; c0 < chunks; c0 += 32 * kSeg) {
    uint4 v[kSeg];
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < chunks) v[u] = load(s + c * 8);
    }
    for (int j = 0; j < k; ++j) {
      const long long r = __ldg(dt + j);
      const float g = round_bf16(__ldg(gate + t * k + j));
      const bf16* yr = y + r * d;
      bf16* o = out + r * d;
      uint4 w[kSeg];
#pragma unroll
      for (int u = 0; u < kSeg; ++u) {
        const int c = c0 + lane + 32 * u;
        if (c < chunks) w[u] = load(yr + c * 8);
      }
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < kSeg; ++u) {
        const int c = c0 + lane + 32 * u;
        if (c < chunks) {
          float a[8], b[8];
          unpack(v[u], a);
          unpack(w[u], b);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            part = fmaf(a[i], b[i], part);
            a[i] = __fmul_rn(a[i], g);
          }
          store(o + c * 8, pack(a));
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(kFull, part, m);
      if (lane == j) mine += part;
    }
  }
  if (lane < k) grad_gate[t * k + lane] = mine;
}

template <bool kGate>
__device__ __forceinline__ void add_row(float (&acc)[8], const uint4& v, float g) {
  float f[8];
  unpack(v, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] += kGate ? round_bf16(__fmul_rn(f[i], g)) : f[i];
}

template <bool kGate>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const bf16* __restrict__ buf, const long long* __restrict__ dest,
                  const float* __restrict__ gate, bf16* __restrict__ out, long long tokens, int k,
                  int d) {
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tokens) return;
  const int lane = threadIdx.x & 31;
  const long long* dt = dest + t * k;
  const float* gt = kGate ? gate + t * k : nullptr;
  bf16* o = out + t * d;
  for (int c = lane; c < (d >> 3); c += 32) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int j = 0;
    for (; j + kBatch <= k; j += kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = load(buf + __ldg(dt + j + u) * d + c * 8);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        add_row<kGate>(acc, v[u], kGate ? round_bf16(__ldg(gt + j + u)) : 1.f);
    }
    for (; j < k; ++j)
      add_row<kGate>(acc, load(buf + __ldg(dt + j) * d + c * 8),
                     kGate ? round_bf16(__ldg(gt + j)) : 1.f);
    store(o + c * 8, pack(acc));
  }
}

inline bool bad_shape(long long tokens, int k, int d) {
  return tokens < 0 || k < 1 || k > kMaxK || d < 8 || d % 8 != 0;
}

inline unsigned blocks(long long n, long long per) { return (unsigned)((n + per - 1) / per); }

}  // namespace moe_permute

// src [tokens, d], dest [tokens, k] (int64 rows of out), out [rows, d]; gate
// [tokens, k] fp32, y [rows, d] and grad_gate [tokens, k] fp32 all given or
// all null; named: `rows` bytes of scratch. dest must name each row of out
// at most once; rows it does not name are zeroed.
extern "C" int moe_scatter_bf16(const void* src, const void* dest, const void* gate,
                                const void* y, void* out, void* grad_gate, void* named,
                                long long tokens, int k, int d, long long rows, void* stream) {
  using namespace moe_permute;
  if (bad_shape(tokens, k, d) || rows < 1 || (gate == nullptr) != (y == nullptr) ||
      (gate == nullptr) != (grad_gate == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(named, 0, (size_t)rows, st);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = tokens * k;
  uint8_t* map = static_cast<uint8_t*>(named);
  const auto* dst = static_cast<const long long*>(dest);
  if (pairs > 0) {
    mark_kernel<<<blocks(pairs, 256), 256, 0, st>>>(dst, pairs, map);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long token_blocks = blocks(tokens, kWarps);
  const unsigned grid = (unsigned)(token_blocks + blocks(rows, 32 * kWarps));
  const auto* s = static_cast<const bf16*>(src);
  auto* o = static_cast<bf16*>(out);
  if (gate != nullptr)
    scatter_gate_kernel<<<grid, kThreads, 0, st>>>(
        s, dst, static_cast<const float*>(gate), static_cast<const bf16*>(y), o,
        static_cast<float*>(grad_gate), map, tokens, k, d, rows, token_blocks);
  else
    scatter_kernel<<<grid, kThreads, 0, st>>>(s, dst, o, map, tokens, k, d, rows, token_blocks);
  return (int)cudaGetLastError();
}

// buf [*, d], dest [tokens, k] (int64 rows of buf, each in range), out
// [tokens, d]; gate [tokens, k] fp32, or null for unit weights.
extern "C" int moe_gather_sum_bf16(const void* buf, const void* dest, const void* gate, void* out,
                                   long long tokens, int k, int d, void* stream) {
  using namespace moe_permute;
  if (bad_shape(tokens, k, d)) return (int)cudaErrorInvalidValue;
  if (tokens == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const bf16*>(buf);
  const auto* dst = static_cast<const long long*>(dest);
  auto* o = static_cast<bf16*>(out);
  if (gate != nullptr)
    gather_sum_kernel<true><<<blocks(tokens, kWarps), kThreads, 0, st>>>(
        b, dst, static_cast<const float*>(gate), o, tokens, k, d);
  else
    gather_sum_kernel<false><<<blocks(tokens, kWarps), kThreads, 0, st>>>(b, dst, nullptr, o,
                                                                           tokens, k, d);
  return (int)cudaGetLastError();
}
