// Flash-decoding attention (one query token a request against a KV cache,
// GQA, sliding window) for Hopper, sm_90a: K8.  Built by
// repro_torch/kernels/backend.py with nvcc into a shared library with a
// plain C interface; called through ctypes from
// repro_torch/kernels/decode_attn/ops.py (decode_attention).
//
// Replaces: src/repro/kernels/decode_attn/kernel.py:65,
// decode_attention_pallas (the Pallas TPU kernel, grid (B, L / block_l)
// with the cache axis sequential, so the running max m, normaliser l and
// output of each request stay resident in its output blocks).
//
// What it computes: q [B, H, hd], k/v [B, L, K, hd] in bfloat16 with hd 64
// or 128, lengths [B] int32 ->
//   o[b, h] = softmax_j(q_h . k_j / sqrt(hd)) @ v_j over the KV head
//   h // (H / K) and the rows j in [lengths[b] - window, lengths[b]) (from
//   0 when window is 0), clipped to [0, L);
// float32 inside, output in bfloat16.  Rows outside that range are never
// loaded, so a cache may hold anything there, NaN included (the TPU kernel
// zeroes them after loading).  A request with no valid row (lengths[b] ==
// 0) gives exact zeros, as the TPU kernel does (l == 0 is read as 1); the
// plain version (kernels/decode_attn/ref.py) keeps the JAX reference's
// arithmetic there and returns the mean of the request's v rows, so the
// two are compared only on requests with lengths >= 1.
//
// Design: the TPU's sequential cache axis cannot carry state across blocks
// here, so the cache is split and combined (flash-decoding):
//   1. split launch: a block per (L split of 512 rows, KV head, request)
//      streams the valid rows of its split through shared memory, TL rows
//      at a time (16-byte loads, converted to f32), and for the G = H / K
//      query heads of its KV head keeps the online-softmax state (m, l and
//      the unnormalised hd-wide output, hd / 32 values a lane) in
//      registers, one warp per head (four heads a warp at most); it writes
//      the f32 partial (o, m, l).  A split with no valid row returns at
//      once and writes nothing.
//   2. combine launch: a block per (request, query head), a thread per
//      output dimension (hd threads), rescales the
//      partials of the splits that hold valid rows by exp(m_s - max m),
//      sums them, divides by the summed l and writes bfloat16.
// Both launches are templates on the head dim; the entry dispatches on hd
// and refuses any but 64 and 128.  The f32 tiles in shared memory (Q of 16
// heads, K with a pad column, V and the scores) are 40.3 KiB at hd 64 with
// TL = 64 rows; at hd 128 the same TL would need 76.3 KiB, over the 48 KiB
// a block gets without opting in, and would leave two blocks an SM.  So hd
// 128 stages TL = 32 rows (42.1 KiB, static; five blocks an SM as at hd
// 64), one score a lane in the softmax update instead of two.
// The split count is ceil(L / 512): fixed 512-row splits keep every
// block's work alike whatever a request's length (short requests simply
// have fewer live splits), and at the decode_32k shape (B = 32, L = 32768,
// K = 16) they give 32768 blocks, 64 per (request, KV head), enough to
// keep all 132 SMs streaming (16384 with 8 KV heads of 128).
//
// What bounds it on this card: bytes.  Each valid row's k and v (2 x 2hd
// bytes a KV head) is read once; the products are 2 x hd f32 FMAs a row
// and query head, far below the card's rate.  At B = 32, L = 32768, mean
// length about 16k, that is about 2.1 GB, 0.64 ms at 3.35 TB/s, with 16
// KV heads of 64 or 8 of 128 alike.  This first version does not pipeline
// its loads (a block waits for each TL-row tile before computing on it) and leaves three of four warps idle in the
// softmax update when G = 1; cp.async or TMA double buffering is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_geom.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int SPLIT_ROWS = 512;    // cache rows of one split block
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_G = 16;          // query heads a KV head may serve
constexpr int HPW = MAX_G / NWARPS;  // heads whose state a warp keeps
constexpr float NEG_INF = -1e30f;  // the reference's mask value

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the valid rows [lo, hi) of a request of length len
__device__ __forceinline__ void valid_range(int len, int window, int L,
                                            int* lo, int* hi) {
  *hi = min(max(len, 0), L);
  *lo = window > 0 ? max(len - window, 0) : 0;
}

// HD: head dim; TL: rows staged in shared memory at a time (a multiple of
// 32 dividing SPLIT_ROWS)
template <int HD, int TL>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ o_part, float* __restrict__ ml_part,
                    int L, int H, int K, int window, int n_split,
                    float scale) {
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  valid_range(lengths[b], window, L, &lo, &hi);
  const int r_begin = max(lo, s * SPLIT_ROWS);
  const int r_end = min(hi, (s + 1) * SPLIT_ROWS);
  if (r_begin >= r_end) return;              // the combine skips it too
  const int G = H / K;
  constexpr int RPL = TL / 32;               // scores a lane updates
  constexpr int DPL = HD / 32;               // output dims a lane keeps

  __shared__ float Qs[MAX_G][HD];            // pre-scaled queries
  __shared__ float Ks[TL][HD + 1];           // +1: lanes on 32 banks
  __shared__ float Vs[TL][HD];
  __shared__ float Ps[MAX_G][TL];            // scores, then weights

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int idx = tid; idx < G * HD; idx += THREADS) {
    int g = idx / HD, j = idx % HD;
    Qs[g][j] = __bfloat162float(q[((size_t)b * H + kh * G + g) * HD + j]) *
               scale;
  }
  float m[HPW], l[HPW], o[HPW][DPL];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[i][e] = 0.0f;
  }
  const size_t row_stride = (size_t)K * HD;
  const bf16* kb = k + ((size_t)b * L * K + kh) * HD;
  const bf16* vb = v + ((size_t)b * L * K + kh) * HD;

  for (int t0 = r_begin; t0 < r_end; t0 += TL) {
    const int nrows = min(TL, r_end - t0);
    __syncthreads();                         // Qs ready / last tile read
    for (int c = tid; c < nrows * (HD / 8); c += THREADS) {
      int r = c / (HD / 8), j = (c % (HD / 8)) * 8;
      size_t off = (size_t)(t0 + r) * row_stride + j;
      uint4 k4 = *reinterpret_cast<const uint4*>(kb + off);
      uint4 v4 = *reinterpret_cast<const uint4*>(vb + off);
      const bf16* kk = reinterpret_cast<const bf16*>(&k4);
      const bf16* vv = reinterpret_cast<const bf16*>(&v4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[r][j + e] = __bfloat162float(kk[e]);
        Vs[r][j + e] = __bfloat162float(vv[e]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * TL; idx += THREADS) {
      int g = idx / TL, r = idx % TL;
      float sc = NEG_INF;
      if (r < nrows) {
        float acc = 0.0f;
#pragma unroll 16
        for (int j = 0; j < HD; ++j) acc += Qs[g][j] * Ks[r][j];
        sc = acc;
      }
      Ps[g][r] = sc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int g = warp + NWARPS * i;
      if (g < G) {
        float sv[RPL], mx = NEG_INF, psum = 0.0f;
#pragma unroll
        for (int e = 0; e < RPL; ++e) {
          sv[e] = Ps[g][lane + 32 * e];
          mx = fmaxf(mx, sv[e]);
        }
        float m_new = fmaxf(m[i], warp_max(mx));
#pragma unroll
        for (int e = 0; e < RPL; ++e) {
          sv[e] = lane + 32 * e < nrows ? expf(sv[e] - m_new) : 0.0f;
          psum += sv[e];
        }
        float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + warp_sum(psum);
        m[i] = m_new;
        __syncwarp();
#pragma unroll
        for (int e = 0; e < RPL; ++e) Ps[g][lane + 32 * e] = sv[e];
        __syncwarp();
        float a[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) a[e] = o[i][e] * alpha;
        for (int r = 0; r < nrows; ++r) {
          float p = Ps[g][r];
#pragma unroll
          for (int e = 0; e < DPL; ++e) a[e] += p * Vs[r][lane + 32 * e];
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[i][e] = a[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + NWARPS * i;
    if (g < G) {
      size_t p = ((size_t)b * H + kh * G + g) * n_split + s;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o_part[p * HD + lane + 32 * e] = o[i][e];
      if (lane == 0) {
        ml_part[p * 2] = m[i];
        ml_part[p * 2 + 1] = l[i];
      }
    }
  }
}

// one block per (request, query head), one thread per output dimension
template <int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ o_part,
                      const float* __restrict__ ml_part,
                      const int* __restrict__ lengths, bf16* __restrict__ out,
                      int L, int H, int window, int n_split) {
  const int bh = blockIdx.x, b = bh / H, j = threadIdx.x;
  int lo, hi;
  valid_range(lengths[b], window, L, &lo, &hi);
  // the splits that hold valid rows, as decode_split_kernel decides
  const int s0 = lo / SPLIT_ROWS;
  const int s1 = hi > lo ? (hi - 1) / SPLIT_ROWS + 1 : s0;
  const size_t base = (size_t)bh * n_split;
  float mx = NEG_INF;
  for (int s = s0; s < s1; ++s) mx = fmaxf(mx, ml_part[(base + s) * 2]);
  float lsum = 0.0f, acc = 0.0f;
  for (int s = s0; s < s1; ++s) {
    float w = expf(ml_part[(base + s) * 2] - mx);
    lsum += ml_part[(base + s) * 2 + 1] * w;
    acc += o_part[(base + s) * HD + j] * w;
  }
  if (lsum == 0.0f) lsum = 1.0f;             // no valid row: zeros
  out[(size_t)bh * HD + j] = __float2bfloat16(acc / lsum);
}

// the split launch over (split, KV head, request) and the combine over
// (request, query head)
template <int HD, int TL>
void decode_geom(int B, int H, int K, int n_split, launch_geom::Launch* g) {
  g[0] = {dim3(n_split, K, B), THREADS, 0,
          (const void*)decode_split_kernel<HD, TL>};
  g[1] = {dim3(B * H), HD, 0, (const void*)decode_combine_kernel<HD>};
}

template <int HD, int TL>
int launch(const void* q, const void* k, const void* v, const int* len,
           void* o_part, void* ml_part, void* out, int B, int L, int H,
           int K, int window, int n_split, cudaStream_t s) {
  launch_geom::Launch g[2];
  decode_geom<HD, TL>(B, H, K, n_split, g);
  decode_split_kernel<HD, TL><<<g[0].grid, g[0].threads, g[0].smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), len, static_cast<float*>(o_part),
      static_cast<float*>(ml_part), L, H, K, window, n_split,
      1.0f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<HD><<<g[1].grid, g[1].threads, g[1].smem, s>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      len, static_cast<bf16*>(out), L, H, window, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attn_split_rows() { return SPLIT_ROWS; }

// All pointers are device pointers on the current device.  q [B, H, hd],
// k/v [B, L, K, hd] bf16, contiguous; lengths [B] int32; o_part [B, H,
// n_split, hd] and ml_part [B, H, n_split, 2] f32 scratch (no zeroing
// needed); out [B, H, hd] bf16.  hd must be 64 or 128, H a multiple of K
// with at most 16 query heads a KV head, n_split * 512 >= L.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o_part, void* ml_part,
                         void* out, int B, int L, int H, int K, int hd,
                         int window, int n_split, void* stream) {
  if ((hd != 64 && hd != 128) || K <= 0 || H % K || H / K > MAX_G ||
      window < 0 || n_split < 1 || (long long)n_split * SPLIT_ROWS < L)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (hd == 64)
    return launch<64, 64>(q, k, v, len, o_part, ml_part, out, B, L, H, K,
                          window, n_split, s);
  return launch<128, 32>(q, k, v, len, o_part, ml_part, out, B, L, H, K,
                         window, n_split, s);
}

// K8's launch geometry (launch_geom.cuh): the two launches
// decode_attention_fwd makes for B requests, H query heads over K KV heads
// of hd, and n_split splits.
int decode_attention_geometry(int B, int H, int K, int hd, int n_split,
                              int* out) {
  launch_geom::Launch g[2];
  if (hd == 64)
    decode_geom<64, 64>(B, H, K, n_split, g);
  else if (hd == 128)
    decode_geom<128, 32>(B, H, K, n_split, g);
  else
    return (int)cudaErrorInvalidValue;
  return launch_geom::report_all(g, 2, out);
}

}  // extern "C"
