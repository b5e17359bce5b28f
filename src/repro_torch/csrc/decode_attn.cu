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
// What bounds it on this card: bytes.  Each valid row's k and v (2 x 2 hd
// bytes a KV head) is read once; the products are 2 x hd f32 FMAs a row
// and query head, at most 16 query heads a KV head, so at most 16 FMAs a
// byte: far below what the SMs' f32 units do while the memory streams.
// So the design spends nothing on tensor cores (an m16n8k16 product would
// waste 15 of its 16 query rows at G = H / K = 1).  At B = 32, L = 32768
// and a mean length of about 16k that is about 2.1 GB, some 0.6 ms at 3.35
// TB/s, with 16 KV heads of 64 or 8 of 128.  Little's law at that rate
// asks for some 20-30 KB in flight an SM all the time.
//
// Design: the TPU's sequential cache axis cannot carry state across blocks
// here, so the cache is split and combined (flash-decoding):
//   1. split launch: a block per (KV head, split of 512 rows, request),
//      four warps.  Each warp owns every fourth step of 32 / (hd / 32)
//      rows of the split and streams them through its own ring of three
//      4 KB stages in shared memory: k and v in bfloat16 as stored, filled
//      by 16-byte cp.async copies (zero-filled and never read past the
//      split's valid rows), two steps in flight while one is computed.  A
//      warp waits only on its own copies (cp.async.wait_group, then
//      __syncwarp), never on the block.  In a step hd / 32 lanes score a
//      row, 32 dims each, against the G query heads (queries pre-scaled by
//      log2 e / sqrt(hd) in shared memory; k converted to f32 in
//      registers), the warp updates each head's running max (warp-
//      uniform) and its lanes' share of the normaliser, and every lane adds
//      p_j v_j for its hd / 32 output dims over the step's rows (p_j
//      broadcast by a shuffle).  So every warp works at any G, G = 1
//      included.  Chunks are swizzled (16-byte chunk c of row r at
//      c ^ (r & 7)), so the scores' reads of 8 rows at one chunk and p v's
//      reads of one row both hit 8 bank groups.  At the end of the split
//      the warps write (m, l, o) into their own rings and the block merges
//      them in warp order into the f32 partial (o, m, l).  A split with no
//      valid row returns at once and writes nothing.  Templated on hd and
//      on the query heads a warp keeps state for (4, or 16 when G > 4).
//   2. combine launch: a block per (request, query head), a thread per
//      output dimension (hd threads), rescales the partials of the splits
//      that hold valid rows by 2^(m_s - max m), sums them in split order,
//      divides by the summed l and writes bfloat16.
// Every sum runs in a fixed order, so repeated calls give equal bits.
// The warps are latency-bound on their arithmetic, not on their copies:
// the same launch with the arithmetic taken out is within 1-2% of it (87-
// 91% of the bytes' bound on two H100s), so what sets the rate is the
// warps an SM holds.  48 KB of dynamic shared memory a block (opted into
// once a device) leaves four blocks, 16 warps, an SM; 64 KB (three
// blocks) ran 3-11% slower at hd 64, 96 KB (two) 38-52% slower
// (chip_k8_tune.py).  The split count is ceil(L / 512): at decode_32k
// (B = 32, L = 32768) 32768 split blocks with 16 KV heads, 16384 with 8.

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
constexpr int STAGES = 3;          // a warp's ring depth
constexpr int MAX_G = 16;          // query heads a KV head may serve
constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

// dims of a cache row one lane scores (HD / SCORE_DIMS lanes a row), and
// the bytes of a ring stage: a step's 32 / (HD / SCORE_DIMS) rows of k
// and v in bf16
constexpr int SCORE_DIMS = 32;
constexpr int STAGE_BYTES = 32 * SCORE_DIMS * 2 * 2;
constexpr int SPLIT_SMEM = NWARPS * STAGES * STAGE_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// the valid rows [lo, hi) of a request of length len
__device__ __forceinline__ void valid_range(int len, int window, int L,
                                            int* lo, int* hi) {
  *hi = min(max(len, 0), L);
  *lo = window > 0 ? max(len - window, 0) : 0;
}

// element offset of 16-byte chunk c of row r in a swizzled [rows][HD]
// tile: the 8 lanes of a 16-byte shared memory phase read 8 rows at one
// chunk (the scores) or 8 chunks of one row (p v), 8 bank groups either way
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + ((c ^ (r & 7)) << 3);
}

// HD: head dim; GW: query heads a warp keeps state for (G <= GW)
template <int HD, int GW>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ o_part, float* __restrict__ ml_part,
                    int L, int H, int K, int window, int n_split,
                    float scale_log2) {
  constexpr int LPR = HD / SCORE_DIMS;   // lanes a row
  constexpr int RS = 32 / LPR;           // rows a step
  constexpr int CPL = SCORE_DIMS / 8;    // 16-byte chunks a lane scores
  constexpr int CPR = HD / 8;            // 16-byte chunks a row
  constexpr int DPL = HD / 32;           // output dims a lane
  constexpr int TILE = RS * HD;          // bf16 of k (or v) a stage
  static_assert(2 * TILE * 2 == STAGE_BYTES, "a stage is k and v of a step");
  static_assert((2 * GW + GW * HD) * 4 <= STAGES * STAGE_BYTES,
                "a warp's (m, l, o) fits its ring");
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ __align__(16) float Qs[GW][HD];  // queries, pre-scaled

  const int kh = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  valid_range(lengths[b], window, L, &lo, &hi);
  const int r0 = max(lo, s * SPLIT_ROWS);
  const int r1 = min(hi, (s + 1) * SPLIT_ROWS);
  if (r0 >= r1) return;                      // the combine skips it too
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < G * HD; i += THREADS)
    Qs[i / HD][i % HD] =
        __bfloat162float(q[((size_t)b * H + kh * G) * HD + i]) * scale_log2;
  __syncthreads();

  bf16* ring = reinterpret_cast<bf16*>(dsmem) + warp * STAGES * 2 * TILE;
  const size_t row_stride = (size_t)K * HD;
  const size_t head0 = ((size_t)b * L * K + kh) * HD;
  const int steps = (r1 - r0 + RS - 1) / RS;
  const int mine = steps > warp ? (steps - warp + NWARPS - 1) / NWARPS : 0;
  auto load = [&](int slot, int i) {         // the warp's step i into slot
    const int row0 = r0 + (warp + i * NWARPS) * RS;
    bf16* ks = ring + slot * 2 * TILE;
    bf16* vs = ks + TILE;
#pragma unroll
    for (int c = lane; c < RS * CPR; c += 32) {
      const int r = c / CPR, x = c % CPR;
      const bool ok = row0 + r < r1;
      const size_t off = head0 + (ok ? row0 + r : r0) * row_stride + x * 8;
      cp_async16(smem_u32(ks + swz<HD>(r, x)), k + off, ok ? 16 : 0);
      cp_async16(smem_u32(vs + swz<HD>(r, x)), v + off, ok ? 16 : 0);
    }
  };

  float m[GW], l[GW], o[GW][DPL];
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[g][e] = 0.0f;
  }
  // this lane's row of a step, and which SCORE_DIMS of it
  const int my_row = lane % RS, part = lane / RS;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 2>();             // step i has landed
    __syncwarp();                            // and step i - 1's slot is free
    if (i + STAGES - 1 < mine)
      load((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_async_commit();
    const bf16* ks = ring + (i % STAGES) * 2 * TILE;
    const bf16* vs = ks + TILE;
    const int nrows = min(RS, r1 - (r0 + (warp + i * NWARPS) * RS));
    const bool valid = my_row < nrows;

    // scores: this lane's part of its row against each query head
    float sc[GW];
#pragma unroll
    for (int g = 0; g < GW; ++g) sc[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int x = part * CPL + c;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(ks + swz<HD>(my_row, x));
      const float2 k01 = bf16x2_to_float2(raw.x);
      const float2 k23 = bf16x2_to_float2(raw.y);
      const float2 k45 = bf16x2_to_float2(raw.z);
      const float2 k67 = bf16x2_to_float2(raw.w);
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        if (g < G) {
          const float4 qa = *reinterpret_cast<const float4*>(&Qs[g][x * 8]);
          const float4 qb =
              *reinterpret_cast<const float4*>(&Qs[g][x * 8 + 4]);
          sc[g] += qa.x * k01.x + qa.y * k01.y + qa.z * k23.x + qa.w * k23.y +
                   qb.x * k45.x + qb.y * k45.y + qb.z * k67.x + qb.w * k67.y;
        }
      }
    }
    // online softmax (base 2): the max warp-uniform, l a lane's share
    float p[GW];
#pragma unroll
    for (int g = 0; g < GW; ++g) {
      if (g < G) {
#pragma unroll
        for (int off = RS; off < 32; off <<= 1)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
        const float sg = valid ? sc[g] : NEG_INF;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = exp2f(m[g] - m_new);
        p[g] = valid ? exp2f(sg - m_new) : 0.0f;
        l[g] = l[g] * alpha + (part == 0 ? p[g] : 0.0f);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[g][e] *= alpha;
      }
    }
    // o += p_j v_j over the step's rows, hd / 32 dims a lane
    const int x0 = lane * DPL / 8, sub = lane * DPL % 8;
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      if (j >= nrows) break;
      const bf16* vr = vs + swz<HD>(j, x0) + sub;
      float vf[DPL];
      if constexpr (DPL == 2) {
        const float2 t =
            bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(vr));
        vf[0] = t.x;
        vf[1] = t.y;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(vr);
        const float2 t0 = bf16x2_to_float2(u.x);
        const float2 t1 = bf16x2_to_float2(u.y);
        vf[0] = t0.x;
        vf[1] = t0.y;
        vf[2] = t1.x;
        vf[3] = t1.y;
      }
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
          for (int e = 0; e < DPL; ++e) o[g][e] += pj * vf[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  // each warp's (m, l, o) into its own ring, then merged in warp order
  float* st = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    if (g < G) {
      const float lt = warp_sum(l[g]);
      if (lane == 0) {
        st[g] = m[g];
        st[GW + g] = lt;
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        st[2 * GW + g * HD + lane * DPL + e] = o[g][e];
    }
  }
  __syncthreads();
  auto state = [&](int w) {
    return reinterpret_cast<const float*>(dsmem + w * STAGES * STAGE_BYTES);
  };
  const size_t p0 = ((size_t)b * H + kh * G) * n_split + s;
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, state(w)[g]);
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      acc += exp2f(state(w)[g] - mx) * state(w)[2 * GW + g * HD + d];
    o_part[(p0 + (size_t)g * n_split) * HD + d] = acc;
  }
  if (tid < G) {
    float mx = NEG_INF, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, state(w)[tid]);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      lsum += exp2f(state(w)[tid] - mx) * state(w)[GW + tid];
    ml_part[(p0 + (size_t)tid * n_split) * 2] = mx;
    ml_part[(p0 + (size_t)tid * n_split) * 2 + 1] = lsum;
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
    float w = exp2f(ml_part[(base + s) * 2] - mx);
    lsum += ml_part[(base + s) * 2 + 1] * w;
    acc += o_part[(base + s) * HD + j] * w;
  }
  if (lsum == 0.0f) lsum = 1.0f;             // no valid row: zeros
  out[(size_t)bh * HD + j] = __float2bfloat16(acc / lsum);
}

// the split launch over (KV head, split, request) and the combine over
// (request, query head), for the HD / GW instantiation; the split kernel's
// ring is opted into once a device
template <int HD, int GW>
int decode_geom(int B, int H, int K, int n_split, launch_geom::Launch* g) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(decode_split_kernel<HD, GW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SPLIT_SMEM);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  g[0] = {dim3(K, n_split, B), THREADS, SPLIT_SMEM,
          (const void*)decode_split_kernel<HD, GW>};
  g[1] = {dim3(B * H), HD, 0, (const void*)decode_combine_kernel<HD>};
  return 0;
}

// the launches of the HD / GW instantiation
template <int HD, int GW>
int launch(const void* q, const void* k, const void* v, const int* len,
           void* o_part, void* ml_part, void* out, int B, int L, int H,
           int K, int window, int n_split, cudaStream_t s) {
  launch_geom::Launch g[2];
  int err = decode_geom<HD, GW>(B, H, K, n_split, g);
  if (err != 0) return err;
  decode_split_kernel<HD, GW><<<g[0].grid, g[0].threads, g[0].smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), len, static_cast<float*>(o_part),
      static_cast<float*>(ml_part), L, H, K, window, n_split,
      LOG2E / sqrtf((float)HD));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  decode_combine_kernel<HD><<<g[1].grid, g[1].threads, g[1].smem, s>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      len, static_cast<bf16*>(out), L, H, window, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attn_split_rows() { return SPLIT_ROWS; }

// All pointers are device pointers on the current device.  q [B, H, hd],
// k/v [B, L, K, hd] bf16, contiguous and 16-byte aligned; lengths [B]
// int32; o_part [B, H, n_split, hd] and ml_part [B, H, n_split, 2] f32
// scratch (no zeroing needed); out [B, H, hd] bf16.  hd must be 64 or 128,
// H a multiple of K with at most 16 query heads a KV head, n_split *
// decode_attn_split_rows() >= L.
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
  // state for 4 query heads a warp, or for 16
  const bool narrow = H / K <= 4;
  if (hd == 64)
    return narrow ? launch<64, 4>(q, k, v, len, o_part, ml_part, out, B, L,
                                  H, K, window, n_split, s)
                  : launch<64, MAX_G>(q, k, v, len, o_part, ml_part, out, B,
                                      L, H, K, window, n_split, s);
  return narrow ? launch<128, 4>(q, k, v, len, o_part, ml_part, out, B, L, H,
                                 K, window, n_split, s)
                : launch<128, MAX_G>(q, k, v, len, o_part, ml_part, out, B,
                                     L, H, K, window, n_split, s);
}

// K8's launch geometry (launch_geom.cuh): the two launches
// decode_attention_fwd makes for B requests, H query heads over K KV heads
// of hd, and n_split splits.
int decode_attention_geometry(int B, int H, int K, int hd, int n_split,
                              int* out) {
  if ((hd != 64 && hd != 128) || K <= 0 || H % K || H / K > MAX_G)
    return (int)cudaErrorInvalidValue;
  launch_geom::Launch g[2];
  const bool narrow = H / K <= 4;
  const int err =
      hd == 64 ? (narrow ? decode_geom<64, 4>(B, H, K, n_split, g)
                         : decode_geom<64, MAX_G>(B, H, K, n_split, g))
               : (narrow ? decode_geom<128, 4>(B, H, K, n_split, g)
                         : decode_geom<128, MAX_G>(B, H, K, n_split, g));
  if (err != 0) return err;
  return launch_geom::report_all(g, 2, out);
}

}  // extern "C"
