// Shared pieces of the bf16 expert-FFN kernels for Hopper, sm_90a: the
// cp.async / ldmatrix / mma.sync helpers, the activations, and the tile
// product that K4's launches (csrc/moe_fused.cu) and K3's up launch
// (csrc/moe_gemm.cu) run.  Included by those sources only;
// repro_torch/kernels/backend.py hashes it into their library names.
//
// The tile product: a block of four warps computes a 64-row by 64-column
// tile of A @ B over a range of the reduction axis, A's rows gathered one
// by one (a token's row of x, or a tile's row of h) and B row-major (the
// bf16 w_in / w_gate [d, f] and w_out [f, d] as they are stored).  Each
// 64-deep slice of A and of every B arrives through a STAGES-deep
// cp.async ring into swizzled shared memory (rows of 128 bytes, 16-byte
// chunk c of row r at c ^ (r & 7), so every ldmatrix phase reads eight
// distinct bank groups), so the next slices are in flight while this one
// multiplies.  Warp w owns columns 16w .. 16w + 15 of every row: B
// reaches mma.m16n8k16 (bf16 in, f32 sums) by ldmatrix.trans straight
// from its row-major slice, A by ldmatrix.  Only the 16-row fragments up
// to the last row that holds work are loaded and multiplied (mf is the
// same for the whole block), so a tile with a few valid rows costs its
// weights' bytes and little else.  The sums stay in registers in mma's
// fixed element layout (sum element e of fragment (i, j): row 16i + lane
// / 4 + 8 (e / 2), column 16w + 8j + 2 (lane % 4) + e % 2), so epilogues
// read them there.
//
// Two options, for K6's dense tiles (every row holds work): a tile of MF
// 16-row fragments (a multiple of 4; 8 takes 128 rows over one weight
// stage, and each stage then holds MF / 4 A tiles), and the warps laid
// out WM = 2 by 2 instead of 1 by 4: warp w then owns row fragments
// (w / 2) MF / 2 .. + MF / 2 - 1 and columns 32 (w % 2) .. + 31, so each
// ldmatrix of A feeds four mma instead of two and shared memory is read
// a third less a product (warp_frag0 / warp_col0 give a warp's origin;
// fragment (i, j) is then row fragment warp_frag0 + i, columns warp_col0 +
// 8j).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe_mma {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;           // rows per tile
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // reduction depth per ring stage
constexpr int THREADS = 128;     // 4 warps
constexpr int MFRAGS = BM / 16;  // 16-row fragments of a tile
constexpr int TILE_ELEMS = 64 * 64;          // one swizzled stage tile
constexpr int TILE_BYTES = TILE_ELEMS * 2;   // 8 KB

// dynamic shared memory of a ring of `stages` stages, each a_tiles A and
// nb B tiles
constexpr int ring_bytes(int stages, int nb, int a_tiles = 1) {
  return stages * (a_tiles + nb) * TILE_BYTES;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True) form
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element offset of 16-byte chunk c of row r in a swizzled [64][64] tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}

// a warp's first row fragment and first column of a tile of MF fragments
// in warp layout WM (1: 1 x 4 warps, 2: 2 x 2)
template <int MF, int WM>
__device__ __forceinline__ int warp_frag0(int warp) {
  return WM == 1 ? 0 : (warp / 2) * (MF / 2);
}
template <int WM>
__device__ __forceinline__ int warp_col0(int warp) {
  return WM == 1 ? warp * 16 : (warp % 2) * 32;
}

// Opt `kernel` in to `bytes` of dynamic shared memory once a device (the
// attribute holds for the process's lifetime); `done` is the caller's
// per-kernel bit mask of devices.
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

// acc[b] += A[tile rows, k0:k1] @ B_b[k0:k1, 64 columns] for the NB B
// operands.  A's row r is a_base + a_row[r] * lda (a_row: 16 * MF ints in
// shared memory; -1 leaves row r unloaded, so its sums are garbage that
// the caller must not read); rows at or past 16 * mf are neither loaded
// nor multiplied.  b_base[b] points at B_b's first column of the tile
// (row stride ldb).  smem: ring_bytes(STAGES, NB, MF / MFRAGS) bytes,
// 128-byte aligned.  k1 - k0 must be a multiple of BK.  Every thread of
// the block calls it.  acc[b][i][j] is the warp's fragment (i, j) in
// layout WM (see the top of this file).
template <int NB, int STAGES, int MF = MFRAGS, int WM = 1>
__device__ __forceinline__ void tile_product(
    unsigned char* smem, const bf16* __restrict__ a_base, const int* a_row,
    int lda, const bf16* const (&b_base)[NB], int ldb, int k0, int k1,
    int mf, float (&acc)[NB][MF / WM][2 * WM][4]) {
  static_assert(MF % MFRAGS == 0, "whole 64-row A tiles");
  static_assert(WM == 1 || WM == 2, "1 x 4 or 2 x 2 warps");
  constexpr int AT = MF / MFRAGS;        // A tiles a stage
  constexpr int MW = MF / WM, NJ = 2 * WM;   // a warp's fragments
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f0 = warp_frag0<MF, WM>(warp), c0 = warp_col0<WM>(warp);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  auto a_tile = [&](int st) { return ring + st * (AT + NB) * TILE_ELEMS; };
  auto b_tile = [&](int st, int b) {
    return ring + (st * (AT + NB) + AT + b) * TILE_ELEMS;
  };
  const int a_chunks = mf * 16 * 8;
  auto load = [&](int st, int k) {
    bf16* a = a_tile(st);
    for (int c = tid; c < a_chunks; c += THREADS) {
      const int r = c >> 3, q = c & 7, src = a_row[r];
      if (src >= 0)
        cp_async16(a + swz(r, q), a_base + (size_t)src * lda + k + q * 8, 16);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      bf16* w = b_tile(st, b);
      for (int c = tid; c < BK * 8; c += THREADS) {
        const int r = c >> 3, q = c & 7;
        cp_async16(w + swz(r, q), b_base[b] + (size_t)(k + r) * ldb + q * 8,
                   16);
      }
    }
  };

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][i][j][e] = 0.0f;

  const int KT = (k1 - k0) / BK;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, k0 + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();          // slice kt has landed
    __syncthreads();                      // and slice kt - 1's slot is free
    if (kt + STAGES - 1 < KT)
      load((kt + STAGES - 1) % STAGES, k0 + (kt + STAGES - 1) * BK);
    cp_async_commit();
    const int st = kt % STAGES;
    const bf16* a = a_tile(st);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t bf[NB][WM][4];            // 16 columns each
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int p = 0; p < WM; ++p)
          ldsm_x4_trans(bf[b][p], b_tile(st, b) +
                                      swz(kk * 16 + (lane & 7) +
                                              (((lane >> 3) & 1) << 3),
                                          c0 / 8 + 2 * p + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        if (f0 + i < mf) {
          uint32_t af[4];
          ldsm_x4(af, a + swz((f0 + i) * 16 + (lane & 15),
                              kk * 2 + (lane >> 4)));
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int p = 0; p < WM; ++p) {
              mma_bf16(acc[b][i][2 * p], af, bf[b][p][0], bf[b][p][1]);
              mma_bf16(acc[b][i][2 * p + 1], af, bf[b][p][2], bf[b][p][3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The up-projection tile: act(A @ w_in[:, n0:n0+64]) (swiglu: silu(A @
// w_gate) * (A @ w_in)) over the whole reduction axis d, rounded to bf16
// into row r of h_tile (row stride f) for every row with a_row[r] >= 0,
// straight from the accumulators.  A as in tile_product, lda = d.
template <bool SWIGLU, int STAGES, int MF = MFRAGS, int WM = 1>
__device__ __forceinline__ void up_tile(unsigned char* smem,
                                        const bf16* __restrict__ a_base,
                                        const int* a_row, int mf, int d,
                                        int f, int n0,
                                        const bf16* __restrict__ w_in,
                                        const bf16* __restrict__ w_gate,
                                        bf16* __restrict__ h_tile) {
  constexpr int NB = SWIGLU ? 2 : 1;
  const bf16* wb[NB];
  wb[0] = w_in + n0;
  if (SWIGLU) wb[NB - 1] = w_gate + n0;
  float acc[NB][MF / WM][2 * WM][4];
  tile_product<NB, STAGES, MF, WM>(smem, a_base, a_row, d, wb, f, 0, d, mf,
                                   acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = warp_frag0<MF, WM>(warp);
  const int col = n0 + warp_col0<WM>(warp) + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < MF / WM; ++i) {
    if (f0 + i >= mf) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = (f0 + i) * 16 + lane / 4 + hr * 8;
      if (a_row[r] < 0) continue;
#pragma unroll
      for (int j = 0; j < 2 * WM; ++j) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hv = acc[0][i][j][2 * hr + e];
          v[e] = SWIGLU ? silu(acc[NB - 1][i][j][2 * hr + e]) * hv
                        : gelu_tanh(hv);
        }
        *reinterpret_cast<__nv_bfloat162*>(h_tile + (size_t)r * f + col +
                                           j * 8) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

}  // namespace moe_mma
