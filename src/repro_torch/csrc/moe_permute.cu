// Token permutation pair for Hopper, sm_90a: permute (K1) gathers tokens
// into the sorted capacity-slot order, unpermute (K2) inverts it with the
// gate-weight multiply fused in.  Built by repro_torch/kernels/backend.py
// with nvcc into a shared library with a plain C interface; called through
// ctypes from repro_torch/kernels/moe_permute/ops.py.
//
// Replaces: src/repro/kernels/moe_permute/kernel.py, permute_pallas and
// unpermute_pallas (Pallas TPU row movers driven by scalar-prefetched
// index vectors, one grid step per row).
//
// What they compute (sentinel convention of ref.py: an index equal to the
// source row count addresses an implicit zero row):
//   permute:   out[s] = x[slot_to_token[s]]        (zeros for the sentinel)
//   unpermute: out[t] = sum_k inv_w[t, k] * y[inv_idx[t, k]]   in float32
//
// What bounds them on this card: both move rows and do almost no
// arithmetic, so the memory rate (3.35 TB/s).  The designs:
//   * permute: one warp per slot row, each lane copying 16-byte vectors of
//     the row (any element type whose row is a multiple of 16 bytes); a
//     sentinel slot writes zeros without reading anything.  On the TPU the
//     index vector sits in SMEM ahead of the grid; here each warp loads its
//     own index.
//   * unpermute: one thread per 16-byte vector of a token row (a block of
//     128 threads covers one token row at d = 1024 bf16), looping over the
//     K picks and accumulating in float32 registers, then one float32 store.
//     Deterministic: each output element is written by one thread, so no
//     atomics.  A sentinel pick or a zero weight adds nothing and reads
//     nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int PERMUTE_THREADS = 256;    // 8 warps: 8 slot rows per block
constexpr int UNPERMUTE_THREADS = 128;

__global__ void __launch_bounds__(PERMUTE_THREADS)
permute_kernel(const uint4* __restrict__ x, int T, int row_vecs,
               const int* __restrict__ slot_to_token, int S,
               uint4* __restrict__ out) {
  const int row = blockIdx.x * (PERMUTE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= S) return;
  const int t = slot_to_token[row];
  uint4* dst = out + (size_t)row * row_vecs;
  if (t < 0 || t >= T) {                       // sentinel slot: zero row
    for (int v = lane; v < row_vecs; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = x + (size_t)t * row_vecs;
  for (int v = lane; v < row_vecs; v += 32) dst[v] = src[v];
}

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(UNPERMUTE_THREADS)
unpermute_kernel(const T* __restrict__ y, int S, int d,
                 const int* __restrict__ inv_idx,
                 const float* __restrict__ inv_w, int n_tok, int K,
                 float* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);            // elements per 16-byte vector
  const int vecs = d / V;
  const long long gid = (long long)blockIdx.x * UNPERMUTE_THREADS + threadIdx.x;
  if (gid >= (long long)n_tok * vecs) return;
  const int t = (int)(gid / vecs);
  const int c = (int)(gid % vecs) * V;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int s = inv_idx[(size_t)t * K + k];
    const float w = inv_w[(size_t)t * K + k];
    if (s < 0 || s >= S || w == 0.0f) continue;   // dropped pick
    const uint4 raw = *reinterpret_cast<const uint4*>(y + (size_t)s * d + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += w * to_float(e[i]);
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)t * d + c);
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

}  // namespace

extern "C" {

// x [T, row_bytes / esize] of any element type, row_bytes a multiple of 16;
// slot_to_token [S] i32 (T = sentinel); out [S, ...] like x.
int moe_permute(const void* x, int T, int row_bytes, const void* slot_to_token,
                int S, void* out, void* stream) {
  if (row_bytes % 16) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const int rows_per_block = PERMUTE_THREADS / 32;
  permute_kernel<<<(S + rows_per_block - 1) / rows_per_block, PERMUTE_THREADS,
                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), T, row_bytes / 16,
      static_cast<const int*>(slot_to_token), S, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// y [S, d] bf16 (y_bf16 = 1) or f32 (0); inv_idx [n_tok, K] i32 (S =
// sentinel); inv_w [n_tok, K] f32; out [n_tok, d] f32.  d must be a multiple
// of 8 (bf16) or 4 (f32).
int moe_unpermute(const void* y, int S, int d, int y_bf16, const void* inv_idx,
                  const void* inv_w, int n_tok, int K, void* out,
                  void* stream) {
  const int V = y_bf16 ? 8 : 4;
  if (d % V) return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return (int)cudaGetLastError();
  const long long work = (long long)n_tok * (d / V);
  const int blocks = (int)((work + UNPERMUTE_THREADS - 1) / UNPERMUTE_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(inv_idx);
  const float* w = static_cast<const float*>(inv_w);
  float* o = static_cast<float*>(out);
  if (y_bf16)
    unpermute_kernel<bf16><<<blocks, UNPERMUTE_THREADS, 0, s>>>(
        static_cast<const bf16*>(y), S, d, idx, w, n_tok, K, o);
  else
    unpermute_kernel<float><<<blocks, UNPERMUTE_THREADS, 0, s>>>(
        static_cast<const float*>(y), S, d, idx, w, n_tok, K, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
