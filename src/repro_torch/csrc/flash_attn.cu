// Flash attention forward (causal / sliding-window, GQA) for Hopper, sm_90a.
// Built by repro_torch/kernels/backend.py with nvcc into a shared library
// with a plain C interface; called through ctypes from
// repro_torch/kernels/flash_attn/ops.py (flash_attention).
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_pallas
// (the Pallas TPU kernel, grid (B, H, Sq/bq, Sk/bk) with the k axis
// sequential so m, l and the output stay resident in VMEM).
//
// What it computes: q [B, Sq, H, 64], k/v [B, Sk, K, 64] in bfloat16 ->
//   o[b, i, h] = softmax_j(mask(q_i . k_j / sqrt(hd))) @ v_j  over the kv head
//   h // (H / K), with the mask causal (i >= j), windowed (i - j < window)
//   and ragged (j < Sk); positions of q and k both start at 0.  float32
//   inside, output in bfloat16.  Only bf16 with hd = 64 (gpt3_medium_moe's
//   serving path) is built: other variants come with a configuration that
//   needs them and a card check that holds them.  NaN scores (garbage K rows) are scrubbed to
//   the mask value; fully-masked rows give 0.
//
// Design: one block per (q tile of 32 rows, head, batch).  The TPU's
// sequential fourth grid axis becomes a loop inside the block over 32-key
// tiles staged in shared memory as float32; k-tiles wholly above the causal
// diagonal or wholly outside the window are skipped.  Each warp owns 4 query
// rows; a lane scores one key of the tile (dot product over hd from shared
// memory, K rows padded by one float so the 32 lanes hit 32 banks), the warp
// reduces max and sum with shuffles, and each lane accumulates hd/32 output
// dimensions, so the running max m and normaliser l stay in registers.
//
// What bounds it on this card: at the prefill shapes it serves (Sq = Sk <=
// a few hundred, hd = 64) neither bytes (q, k, v, o once: a few MB) nor
// tensor-core operations; this first version runs the products on the
// float32 CUDA cores, so its time is bounded by float32 FMA issue and the
// launch, not by the card's bf16 roofline.  Tensor-core MMA tiles are later
// work, for when the prompt buckets grow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 32;             // query rows per block
constexpr int BKEYS = 32;          // keys per tile: one per lane
constexpr int NWARPS = 8;
constexpr int RPW = BQ / NWARPS;   // query rows per warp
constexpr int HD = 64;             // head dim (gpt3_medium_moe's)
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

__global__ void __launch_bounds__(NWARPS * 32)
flash_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                  int Sk, int H, int K, float scale, int causal, int window) {
  constexpr int DPL = HD / 32;     // output dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][HD], pre-scaled
  float* Ks = Qs + BQ * HD;                 // [BKEYS][HD + 1]
  float* Vs = Ks + BKEYS * (HD + 1);        // [BKEYS][HD]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int idx = tid; idx < BQ * HD; idx += NWARPS * 32) {
    int r = idx / HD, c = idx % HD;
    int qi = q0 + r;
    Qs[idx] = qi < Sq
        ? __bfloat162float(q[(((size_t)b * Sq + qi) * H + h) * HD + c]) * scale
        : 0.0f;
  }

  // key-tile range this query tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / BKEYS;
  const int t_end = (k_end + BKEYS - 1) / BKEYS;

  float m[RPW], l[RPW], acc[RPW][DPL];
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
    for (int j = 0; j < DPL; ++j) acc[rr][j] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int kbase = t * BKEYS;
    __syncthreads();                        // previous tile fully consumed
    for (int idx = tid; idx < BKEYS * HD; idx += NWARPS * 32) {
      int r = idx / HD, c = idx % HD;
      int kp = kbase + r;
      float kv = 0.0f, vv = 0.0f;
      if (kp < Sk) {                        // ragged end: never read past Sk
        size_t off = (((size_t)b * Sk + kp) * K + kh) * HD + c;
        kv = __bfloat162float(k[off]);
        vv = __bfloat162float(v[off]);
      }
      Ks[r * (HD + 1) + c] = kv;
      Vs[r * HD + c] = vv;
    }
    __syncthreads();

    const int kp = kbase + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int qi = q0 + r;
      if (qi >= Sq) continue;               // warp-uniform
      const float* qrow = Qs + r * HD;
      const float* krow = Ks + lane * (HD + 1);
      float s = 0.0f;
#pragma unroll 16
      for (int c = 0; c < HD; ++c) s = fmaf(qrow[c], krow[c], s);
      bool live = kp < Sk;
      if (causal) live = live && qi >= kp;
      if (window) live = live && (qi - kp) < window;
      if (!live || isnan(s)) s = NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = live ? expf(s - m_new) : 0.0f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = alpha * l[rr] + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[rr][j] *= alpha;
#pragma unroll 8
      for (int jj = 0; jj < BKEYS; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vrow = Vs + jj * HD;
        for (int j = 0; j < DPL; ++j)
          acc[rr][j] = fmaf(pj, vrow[lane + 32 * j], acc[rr][j]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qi = q0 + warp * RPW + rr;
    if (qi >= Sq) continue;
    const float inv = 1.0f / (l[rr] == 0.0f ? 1.0f : l[rr]);
    bf16* orow = o + (((size_t)b * Sq + qi) * H + h) * HD;
    for (int j = 0; j < DPL; ++j)
      orow[lane + 32 * j] = __float2bfloat16(acc[rr][j] * inv);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int K, int causal,
                   int window, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (BQ * HD + BKEYS * (HD + 1) + BKEYS * HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attn_kernel<<<grid, NWARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, K,
      1.0f / sqrtf((float)HD), causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k/v [B, Sk, K, hd], o [B, Sq, H, hd]; contiguous
// bfloat16 device tensors with hd = 64 (the only variant built until a
// configuration needs another); H a multiple of K.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int K, int hd,
                        int causal, int window, void* stream) {
  if (hd != HD || K <= 0 || H % K || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, o, B, Sq, Sk, H, K, causal, window,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
