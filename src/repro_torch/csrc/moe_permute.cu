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
// arithmetic, so the memory rate (3.35 TB/s); at the pipelined path's chunk
// shapes (a few hundred rows) the launch and one chain of dependent loads
// (index, then row).  The designs:
//   * permute: one warp a slot row, two rows a block (at the chunk shape,
//     304 blocks spread the rows over every multiprocessor).  The warp
//     loads the slot's index once, then copies the row in passes of four
//     16-byte vectors a lane, each pass's loads all issued before its
//     stores; a sentinel slot writes zeros without reading anything.  Any
//     element type whose row is a multiple of 16 bytes.  A bulk-copy
//     design (cp.async.bulk into a ring of shared-memory rows, each
//     completed on an mbarrier, out by bulk stores; zero rows from one
//     zeroed shared row) was measured against this one on an H100 and was
//     slower at both training shapes (4.6 against 4.0 us at 4864 slots, 2.1
//     against 1.5 us at 608): each row's load, barrier wait and store form
//     a longer chain than a warp's loads and stores.
//   * unpermute: one warp a token row.  Lanes 0..K-1 load the token's K
//     (index, weight) pairs once and the warp broadcasts them by shuffle;
//     every pick's 16-byte loads are issued before the FMAs (the kernel is
//     instantiated for K = 2, the configurations' top-k, and for any K);
//     a dropped pick (index S or weight 0) is skipped by a branch that is
//     uniform over the warp; the f32 row leaves as 16-byte stores.
//     Deterministic: each output element is written by one thread, so no
//     atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// permute (K1): one warp a slot row, a pass's loads before its stores
// ---------------------------------------------------------------------------

constexpr int PERMUTE_WARPS = 2;          // slot rows a block
constexpr int PERMUTE_U = 4;              // 16-byte vectors a lane a pass

__global__ void __launch_bounds__(PERMUTE_WARPS * 32)
permute_kernel(const uint4* __restrict__ x, int T, int row_vecs,
               const int* __restrict__ slot_to_token, int S,
               uint4* __restrict__ out) {
  const int row = blockIdx.x * PERMUTE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= S) return;
  const int t = slot_to_token[row];
  uint4* dst = out + (size_t)row * row_vecs;
  if (t < 0 || t >= T) {                       // sentinel slot: zero row
    for (int v = lane; v < row_vecs; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = x + (size_t)t * row_vecs;
  for (int v0 = 0; v0 < row_vecs; v0 += 32 * PERMUTE_U) {
    uint4 r[PERMUTE_U];
#pragma unroll
    for (int u = 0; u < PERMUTE_U; ++u) {
      const int v = v0 + lane + 32 * u;
      if (v < row_vecs) r[u] = src[v];
    }
#pragma unroll
    for (int u = 0; u < PERMUTE_U; ++u) {
      const int v = v0 + lane + 32 * u;
      if (v < row_vecs) dst[v] = r[u];
    }
  }
}

// ---------------------------------------------------------------------------
// unpermute (K2): one warp a token row
// ---------------------------------------------------------------------------

constexpr int UNPERMUTE_THREADS = 128;    // 4 tokens a block
constexpr int UNPERMUTE_U = 4;            // 16-byte vectors a lane a pass

__device__ __forceinline__ void add_row(float* acc, float w, uint4 raw,
                                        bf16) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = fmaf(w, __bfloat162float(e[i]), acc[i]);
}

__device__ __forceinline__ void add_row(float* acc, float w, uint4 raw,
                                        float) {
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = fmaf(w, e[i], acc[i]);
}

// KT > 0: K fixed at compile time (all picks' loads before the FMAs);
// KT == 0: any K, the picks taken 32 at a time, each pick's loads before
// its FMAs.
template <typename T, int KT>
__global__ void __launch_bounds__(UNPERMUTE_THREADS)
unpermute_kernel(const T* __restrict__ y, int S, int d,
                 const int* __restrict__ inv_idx,
                 const float* __restrict__ inv_w, int n_tok, int K,
                 float* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);            // elements a 16-byte vector
  constexpr unsigned FULL = 0xffffffffu;
  const int tok = (blockIdx.x * UNPERMUTE_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= n_tok) return;                    // whole warps leave together
  const int vecs = d / V;
  const int* idx_row = inv_idx + (size_t)tok * K;
  const float* w_row = inv_w + (size_t)tok * K;
  float* orow = out + (size_t)tok * d;

  if constexpr (KT > 0) {
    int my_s = S;
    float my_w = 0.0f;
    if (lane < KT) {
      my_s = idx_row[lane];
      my_w = w_row[lane];
    }
    int s[KT];
    float w[KT];
    bool live[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      s[k] = __shfl_sync(FULL, my_s, k);
      w[k] = __shfl_sync(FULL, my_w, k);
      live[k] = s[k] >= 0 && s[k] < S && w[k] != 0.0f;
    }
    for (int c0 = 0; c0 < vecs; c0 += 32 * UNPERMUTE_U) {
      uint4 raw[KT][UNPERMUTE_U];
#pragma unroll
      for (int k = 0; k < KT; ++k)
#pragma unroll
        for (int u = 0; u < UNPERMUTE_U; ++u) {
          const int v = c0 + lane + 32 * u;
          raw[k][u] = (live[k] && v < vecs)
                          ? *reinterpret_cast<const uint4*>(
                                y + (size_t)s[k] * d + (size_t)v * V)
                          : make_uint4(0, 0, 0, 0);
        }
      float acc[UNPERMUTE_U][V];
#pragma unroll
      for (int u = 0; u < UNPERMUTE_U; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[u][i] = 0.0f;
#pragma unroll
      for (int k = 0; k < KT; ++k)
        if (live[k])                            // uniform over the warp
#pragma unroll
          for (int u = 0; u < UNPERMUTE_U; ++u)
            add_row(acc[u], w[k], raw[k][u], T());
#pragma unroll
      for (int u = 0; u < UNPERMUTE_U; ++u) {
        const int v = c0 + lane + 32 * u;
        if (v < vecs) {
          float4* o = reinterpret_cast<float4*>(orow + (size_t)v * V);
#pragma unroll
          for (int i = 0; i < V / 4; ++i)
            o[i] = make_float4(acc[u][4 * i], acc[u][4 * i + 1],
                               acc[u][4 * i + 2], acc[u][4 * i + 3]);
        }
      }
    }
  } else {
    for (int c0 = 0; c0 < vecs; c0 += 32 * UNPERMUTE_U) {
      float acc[UNPERMUTE_U][V];
#pragma unroll
      for (int u = 0; u < UNPERMUTE_U; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[u][i] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int nk = min(32, K - k0);
        int my_s = S;
        float my_w = 0.0f;
        if (lane < nk) {
          my_s = idx_row[k0 + lane];
          my_w = w_row[k0 + lane];
        }
        for (int k = 0; k < nk; ++k) {
          const int s = __shfl_sync(FULL, my_s, k);
          const float w = __shfl_sync(FULL, my_w, k);
          if (s < 0 || s >= S || w == 0.0f) continue;   // uniform
          uint4 raw[UNPERMUTE_U];
#pragma unroll
          for (int u = 0; u < UNPERMUTE_U; ++u) {
            const int v = c0 + lane + 32 * u;
            raw[u] = v < vecs ? *reinterpret_cast<const uint4*>(
                                    y + (size_t)s * d + (size_t)v * V)
                              : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < UNPERMUTE_U; ++u)
            add_row(acc[u], w, raw[u], T());
        }
      }
#pragma unroll
      for (int u = 0; u < UNPERMUTE_U; ++u) {
        const int v = c0 + lane + 32 * u;
        if (v < vecs) {
          float4* o = reinterpret_cast<float4*>(orow + (size_t)v * V);
#pragma unroll
          for (int i = 0; i < V / 4; ++i)
            o[i] = make_float4(acc[u][4 * i], acc[u][4 * i + 1],
                               acc[u][4 * i + 2], acc[u][4 * i + 3]);
        }
      }
    }
  }
}

template <typename T>
void launch_unpermute(const T* y, int S, int d, const int* idx,
                      const float* w, int n_tok, int K, float* o,
                      cudaStream_t s) {
  const int warps = UNPERMUTE_THREADS / 32;
  const int blocks = (n_tok + warps - 1) / warps;
  if (K == 2)
    unpermute_kernel<T, 2><<<blocks, UNPERMUTE_THREADS, 0, s>>>(
        y, S, d, idx, w, n_tok, K, o);
  else
    unpermute_kernel<T, 0><<<blocks, UNPERMUTE_THREADS, 0, s>>>(
        y, S, d, idx, w, n_tok, K, o);
}

}  // namespace

extern "C" {

// x [T, row_bytes / esize] of any element type, row_bytes a multiple of 16;
// slot_to_token [S] i32 (T = sentinel); out [S, ...] like x; x and out
// 16-byte aligned.
int moe_permute(const void* x, int T, int row_bytes, const void* slot_to_token,
                int S, void* out, void* stream) {
  if (row_bytes % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  permute_kernel<<<(S + PERMUTE_WARPS - 1) / PERMUTE_WARPS,
                   PERMUTE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), T, row_bytes / 16,
      static_cast<const int*>(slot_to_token), S, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// y [S, d] bf16 (y_bf16 = 1) or f32 (0); inv_idx [n_tok, K] i32 (S =
// sentinel); inv_w [n_tok, K] f32; out [n_tok, d] f32.  d must be a multiple
// of 8 (bf16) or 4 (f32); y and out 16-byte aligned.
int moe_unpermute(const void* y, int S, int d, int y_bf16, const void* inv_idx,
                  const void* inv_w, int n_tok, int K, void* out,
                  void* stream) {
  if (d % (y_bf16 ? 8 : 4) || K < 0) return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(inv_idx);
  const float* w = static_cast<const float*>(inv_w);
  float* o = static_cast<float*>(out);
  if (y_bf16)
    launch_unpermute(static_cast<const bf16*>(y), S, d, idx, w, n_tok, K, o,
                     s);
  else
    launch_unpermute(static_cast<const float*>(y), S, d, idx, w, n_tok, K, o,
                     s);
  return (int)cudaGetLastError();
}

}  // extern "C"
