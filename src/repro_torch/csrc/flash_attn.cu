// Flash attention forward (causal / sliding-window, GQA) for Hopper, sm_90a.
// Built by repro_torch/kernels/backend.py with nvcc into a shared library
// with a plain C interface; called through ctypes from
// repro_torch/kernels/flash_attn/ops.py (flash_attention).
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_pallas
// (the Pallas TPU kernel, grid (B, H, Sq/bq, Sk/bk) with the k axis
// sequential so m, l and the output stay resident in VMEM).
//
// What it computes: q [B, Sq, H, hd], k/v [B, Sk, K, hd] in bfloat16 ->
//   o[b, i, h] = softmax_j(mask(q_i . k_j / sqrt(hd))) @ v_j  over the kv head
//   h // (H / K), with the mask causal (i >= j), windowed (i - j < window)
//   and ragged (j < Sk); positions of q and k both start at 0.  Scores,
//   softmax and the output sum in float32; the probabilities are rounded
//   to bfloat16 for the tensor cores' P.V product; output in bfloat16.
//   bf16 only, with hd 64 (gpt3_medium_moe, granite_3_2b) or 128 (olmo_1b,
//   internlm2_1_8b, minitron_4b): the kernel is a template on HD and the
//   entry dispatches on hd, refusing any other; other variants come with a
//   configuration that needs them and a card check that holds them.  NaN
//   scores (garbage K rows) are scrubbed to the mask value; fully-masked
//   rows give 0.
//
// Design (a FlashAttention-2 forward on mma.sync): one block of four warps
// per (q tile of 64 rows, head, batch); each warp owns 16 query rows.  The
// TPU's sequential fourth grid axis becomes a loop inside the block over
// 64-key tiles; tiles wholly above the causal diagonal or wholly outside
// the window are skipped, for the block and, inside a computed tile, for
// each warp.
//   * Q is loaded once and kept in registers as bf16 A-fragments of
//     mma.m16n8k16 (ldmatrix from shared memory) for the whole loop.
//   * K and V tiles (64 x HD bf16, 8 KB each at HD 64, 16 KB at 128) arrive
//     through a two-stage cp.async ring (16 bytes a thread and copy): tile
//     t + 1 loads while tile t computes.  Rows are HD * 2 bytes, stored
//     with their HD / 8 16-byte chunks XOR-swizzled by the row (chunk c of
//     row r at c ^ (r & 7); at HD 128 the XOR leaves bit 3 of c, so a chunk
//     stays in its row's half).  Every ldmatrix phase reads one logical
//     chunk of eight consecutive rows, which the swizzle puts in eight
//     distinct bank groups, at either width; so does the 4-byte staging of
//     the output.  Keys past Sk are zero-filled by the copy and never read
//     from memory.
//   * S = Q.K^T and O += P.V run on the bf16 tensor cores with f32
//     accumulators (ldmatrix for K, ldmatrix.trans for V).  The online
//     softmax (running max m and sum l of each row, in the log2 domain)
//     stays in registers: a row lives in one quad of lanes, so its
//     reductions are two shuffles.
//     P is re-packed from the S accumulators into A-fragments in registers,
//     never through shared memory.
//   * The output is normalised in registers, staged through the warp's own
//     rows of the Q tile in shared memory and stored in 16-byte pieces.
// Shared memory (Q, two K and two V stages): 40 KB at HD 64, 80 KB at
// HD 128, over the 48 KB a block gets without asking.  It is dynamic, and
// the entry opts the HD 128 instantiation in
// (cudaFuncAttributeMaxDynamicSharedMemorySize) once per device: two blocks
// fit an SM's 227 KB.  Cutting the key tile to 32 rows would have fit in
// 48 KB exactly, but halves the work between the barriers of the ring.
// Registers at HD 128: the output accumulator o_acc[16][4] and the Q
// fragments qf[8][4] are 64 + 32 a thread beside the scores' 32; the
// ptxas lines of the build (chip_smoke.py's build phase) give the count
// and the spills of each instantiation under __launch_bounds__(128).
//
// What bounds it on this card: at the serve prefill shape [4, 128, 16, 64]
// the bound is q, k, v and o once (2 MB, 0.00125 ms), and a single wave of
// 128 blocks, each one or two key tiles deep, is bound by latency (the
// copy of its first tile, the dependent MMA and shuffle chain) and the
// launch; at [4, 512, 16, 64] 512 blocks of up to 8 tiles overlap copies
// with the products.  At HD 128 ([4, 128, 16, 128]: 8.4 MB, 0.0025 ms) the
// same holds, with twice the bytes and products a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_geom.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BKV = 64;            // keys per tile
constexpr int NWARPS = BQ / 16;    // 16 query rows per warp
constexpr int THREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

// element offset of 16-byte chunk c of row r in a swizzled [rows][HD] tile
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + ((c ^ (r & 7)) << 3);
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, nvalid) of a [64, HD] tile whose row 0 is at g (row stride ld
// elements) into the swizzled tile s; rows past nvalid are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, size_t ld,
                                          int nvalid, int tid) {
  constexpr int CHUNKS = HD / 8;
  for (int i = tid; i < 64 * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < nvalid;
    cp_async16(smem_u32(s + swz<HD>(r, c)),
               g + (size_t)(ok ? r : 0) * ld + c * 8, ok ? 16 : 0);
  }
}

// dynamic shared memory of one block: Q, then two K stages, two V stages
template <int HD>
constexpr int smem_bytes() {
  return (BQ + 4 * BKV) * HD * (int)sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                  int Sk, int H, int K, float scale_log2, int causal,
                  int window) {
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* const Ks = Qs + BQ * HD;             // stage st at st * BKV * HD
  bf16* const Vs = Ks + 2 * BKV * HD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t q_ld = (size_t)H * HD, kv_ld = (size_t)K * HD;
  const bf16* qg = q + ((size_t)b * Sq + q0) * q_ld + (size_t)h * HD;
  const bf16* kg = k + (size_t)b * Sk * kv_ld + (size_t)kh * HD;
  const bf16* vg = v + (size_t)b * Sk * kv_ld + (size_t)kh * HD;

  // key-tile range this query tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / BKV;
  const int t_end = (k_end + BKV - 1) / BKV;

  load_tile<HD>(Qs, qg, q_ld, Sq - q0, tid);
  cp_async_commit();
  if (t_begin < t_end) {
    const size_t off = (size_t)t_begin * BKV * kv_ld;
    load_tile<HD>(Ks, kg + off, kv_ld, Sk - t_begin * BKV, tid);
    load_tile<HD>(Vs, vg + off, kv_ld, Sk - t_begin * BKV, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();                       // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as A-fragments, one per 16-wide hd step
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qf[kk], smem_u32(Qs + swz<HD>(warp * 16 + (lane & 15),
                                          kk * 2 + (lane >> 4))));

  const int r_lo = q0 + warp * 16 + lane / 4;   // rows of c0,c1 (+8: c2,c3)
  const int w_first = q0 + warp * 16, w_last = w_first + 15;
  const bool warp_live = w_first < Sq;
  float o_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int st = it & 1;
    if (t + 1 < t_end) {                    // next tile into the other stage
      const size_t off = (size_t)(t + 1) * BKV * kv_ld;
      const int nvalid = Sk - (t + 1) * BKV;
      load_tile<HD>(Ks + (st ^ 1) * BKV * HD, kg + off, kv_ld, nvalid, tid);
      load_tile<HD>(Vs + (st ^ 1) * BKV * HD, vg + off, kv_ld, nvalid, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                     // tile t has landed
    __syncthreads();

    const int kbase = t * BKV;
    // the warp's rows see none of this tile: skip (warp-uniform)
    const bool skip = !warp_live || (causal && w_last < kbase) ||
                      (window && kbase + BKV - 1 <= w_first - window);
    if (!skip) {
      const bf16* Kt = Ks + st * BKV * HD;
      const bf16* Vt = Vs + st * BKV * HD;
      float s[BKV / 8][4];
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < BKV / 16; ++n2) {
          uint32_t bf[4];
          ldsm_x4(bf, smem_u32(Kt + swz<HD>(n2 * 16 + (lane & 7) +
                                                ((lane >> 4) << 3),
                                            kk * 2 + ((lane >> 3) & 1))));
          mma_bf16(s[2 * n2], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], bf[2], bf[3]);
        }
      }

      // mask, scrub, online softmax (rows r_lo and r_lo + 8); scores in
      // the log2 domain, scale * log2(e) folded into one multiply
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r_lo + hr * 8;
        float mx = m_r[hr];
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = kbase + n * 8 + 2 * (lane % 4) + e;
            bool live = j < Sk;
            if (causal) live = live && row >= j;
            if (window) live = live && row - j < window;
            float x = s[n][2 * hr + e] * scale_log2;
            if (isnan(x)) x = NEG_INF;
            // a masked key weighs exactly 0 (exp2(-inf)); a live NaN key
            // takes the mask value, as in the plain version
            x = live ? x : -INFINITY;
            s[n][2 * hr + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f(m_r[hr] - mx);
        m_r[hr] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[n][2 * hr + e] - mx);
            s[n][2 * hr + e] = p;
            sum += p;
          }
        }
        // the output's HD / 8 column tiles (not the scores' BKV / 8)
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o_acc[n][2 * hr] *= alpha;
          o_acc[n][2 * hr + 1] *= alpha;
        }
        l_r[hr] = l_r[hr] * alpha + sum;    // this lane's share of the row
      }

      // O += P.V, P re-packed from the S accumulators as bf16 A-fragments
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n2 = 0; n2 < HD / 16; ++n2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_u32(Vt + swz<HD>(kk * 16 + (lane & 7) +
                                                      (((lane >> 3) & 1) << 3),
                                                  n2 * 2 + (lane >> 4))));
          mma_bf16(o_acc[2 * n2], a, bf[0], bf[1]);
          mma_bf16(o_acc[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                        // stage st free for tile t + 2
  }
  cp_async_wait<0>();

  // normalise, stage through this warp's own rows of Qs, store 16 bytes
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hr] = 1.0f / (l == 0.0f ? 1.0f : l);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + lane / 4 + hr * 8;
      *reinterpret_cast<uint32_t*>(Qs + swz<HD>(r, n) + 2 * (lane % 4)) =
          pack_bf16(o_acc[n][2 * hr] * inv[hr],
                    o_acc[n][2 * hr + 1] * inv[hr]);
    }
  __syncwarp();
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = warp * 16 + i / CHUNKS, c = i % CHUNKS;
    const int qi = q0 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(o + ((size_t)b * Sq + qi) * q_ld +
                                (size_t)h * HD + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<HD>(r, c));
  }
}

// the launch of the HD instantiation over (query block, head, request); a
// block's shared memory over the 48 KB default is opted into once per
// device
template <int HD>
int flash_geom(int B, int Sq, int H, launch_geom::Launch* g) {
  constexpr int SMEM = smem_bytes<HD>();
  if (SMEM > 48 * 1024) {
    static bool opted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
      err = cudaFuncSetAttribute(flash_attn_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
      if (err != cudaSuccess) return (int)err;
      opted[dev] = true;
    }
  }
  *g = {dim3((Sq + BQ - 1) / BQ, H, B), THREADS, SMEM,
        (const void*)flash_attn_kernel<HD>};
  return 0;
}

// one launch of the HD instantiation
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int K, int causal, int window,
           void* stream) {
  launch_geom::Launch g;
  const int err = flash_geom<HD>(B, Sq, H, &g);
  if (err != 0) return err;
  flash_attn_kernel<HD><<<g.grid, g.threads, g.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, K,
      LOG2E / sqrtf((float)HD), causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k/v [B, Sk, K, hd], o [B, Sq, H, hd]; contiguous,
// 16-byte aligned bfloat16 device tensors with hd 64 or 128 (the variants
// built); H a multiple of K.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int K, int hd,
                        int causal, int window, void* stream) {
  if (K <= 0 || H % K || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (hd == 64) return launch<64>(q, k, v, o, B, Sq, Sk, H, K, causal,
                                  window, stream);
  if (hd == 128) return launch<128>(q, k, v, o, B, Sq, Sk, H, K, causal,
                                    window, stream);
  return (int)cudaErrorInvalidValue;
}

// K5's launch geometry (launch_geom.cuh): the launch flash_attention_fwd
// makes for B requests of Sq queries over H heads of hd.
int flash_attention_geometry(int B, int Sq, int H, int hd, int* out) {
  launch_geom::Launch g;
  const int err = hd == 64    ? flash_geom<64>(B, Sq, H, &g)
                  : hd == 128 ? flash_geom<128>(B, Sq, H, &g)
                              : (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return launch_geom::report_all(&g, 1, out);
}

}  // extern "C"
