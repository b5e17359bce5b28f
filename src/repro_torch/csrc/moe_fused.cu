// Fused local MoE (dispatch gather -> expert FFN -> weighted combine) for
// Hopper, sm_90a.  Built by repro_torch/kernels/backend.py with nvcc into a
// shared library with a plain C interface; called through ctypes from
// repro_torch/kernels/moe_fused/ops.py (local_moe).
//
// Replaces: src/repro/kernels/moe_fused/kernel.py, local_moe_pallas (the
// Pallas TPU megakernel, grid (row-block, f-block)).
//
// What it computes:
//   out[t] = sum_{s : slot_to_token[s] == t, s valid} slot_w[s] * FFN_e(s)(x[t])
//   FFN_e(x) = act(x @ w_in[e]) @ w_out[e]      act = tanh-gelu, or
//              silu(x @ w_gate[e]) * (x @ w_in[e])   (swiglu)
// with the hidden activation rounded to bf16 before the down-projection and
// float32 accumulation everywhere.  Slot space is cut into static segments
// (one expert each); rows at or past a segment's runtime rows_valid count
// contribute nothing.
//
// What the TPU design relied on, and what this one does instead:
//   * The TPU kernel keeps the whole [T+1, d] token buffer and the [T, d] f32
//     output resident in VMEM, and its sequential grid makes the combine
//     scatter race-free.  Here blocks run in parallel, so the combine is an
//     f32 atomicAdd into a zeroed [T, d] output (order nondeterministic; the
//     tests compare at a tolerance).
//   * The TPU kernel holds a [bc, d] f32 accumulator across f-blocks (512 KiB
//     at bc=128, d=1024), more than a Hopper block's 227 KB of shared memory.
//     Here the FFN is two launches over the same tile list:
//       1. moe_up:   gather rows by slot_to_token, x @ w_in (and w_gate),
//                    activation, round to bf16, write h [tiles*64, f];
//       2. moe_down: h @ w_out with an f32 accumulator, then atomicAdd of
//                    slot_w-weighted rows into out.
//   * Fixed 64-row tiles with row masks replace plan_blocks' gcd rule (which
//     gives 8-row blocks at decode).  Each tile's valid-row count is computed
//     on the device from rows_valid (no host synchronisation); a tile with
//     none returns before any load.  That is the decode win: at 8 slots,
//     top-2 of 64 experts touches at most 16 experts per layer.
//
// What bounds it on this card: at decode (a few valid rows per touched
// expert) the expert weights' bytes, so the card's memory rate; at prefill
// (every row of every picked expert is computed, as in the reference) the
// bf16 tensor-core rate.  This first version uses warp-level tensor-core
// MMA (WMMA 16x16x16 bf16, f32 accumulate) on 64x64x32 tiles staged through
// shared memory with 16-byte loads, without a copy pipeline; wgmma, TMA and
// a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // slots (rows) per tile
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction depth per shared-memory stage
constexpr int THREADS = 128;  // 4 warps, each a 32x32 quarter of the tile
constexpr int A_LD = BK + 8;  // padded leading dims (WMMA wants multiples
constexpr int B_LD = BN + 8;  // of 8 bf16 / 4 f32 and 32-byte aligned rows
constexpr int C_LD = BN + 4;  // of 16; the pads also spread the banks)
constexpr int TILE_INTS = 5;  // per tile: first slot, expert, segment,
                              // offset into the segment, rows in the tile

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True) form
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

// valid rows of tile b: clamp(rows_valid[seg] - offset, 0, rows in tile)
__device__ __forceinline__ int tile_nvalid(const int* tiles,
                                           const int* rows_valid, int b) {
  const int* ti = tiles + b * TILE_INTS;
  int nv = rows_valid[ti[2]] - ti[3];
  return max(0, min(nv, ti[4]));
}

// Load a BK x BN bf16 tile of a row-major [rows, ld] matrix into smem.
__device__ __forceinline__ void load_b_tile(bf16 (*dst)[B_LD], const bf16* src,
                                            int ld, int k0, int n0, int tid) {
  for (int c = tid; c < BK * (BN / 8); c += THREADS) {
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(&dst[r][nc]) =
        *reinterpret_cast<const uint4*>(src + (size_t)(k0 + r) * ld + n0 + nc);
  }
}

template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
moe_up_kernel(const bf16* __restrict__ x, int T, int d, int f,
              const int* __restrict__ slot_to_token,
              const int* __restrict__ rows_valid,
              const int* __restrict__ tiles,
              const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
              bf16* __restrict__ h) {
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int nv = tile_nvalid(tiles, rows_valid, b);
  if (nv == 0) return;                       // slack tile: no loads, no math
  const int slot0 = tiles[b * TILE_INTS + 0];
  const int eid = tiles[b * TILE_INTS + 1];

  __shared__ __align__(128) bf16 As[BM][A_LD];
  __shared__ __align__(128) bf16 Bs[BK][B_LD];
  __shared__ __align__(128) bf16 Gs[SWIGLU ? BK : 1][B_LD];
  __shared__ __align__(128) float Cs[BM][C_LD];
  __shared__ int tok_s[BM];

  const int tid = threadIdx.x;
  if (tid < BM) {
    int t = tid < nv ? slot_to_token[slot0 + tid] : -1;
    tok_s[tid] = (t >= 0 && t < T) ? t : -1;  // sentinel / masked -> zeros
  }
  __syncthreads();

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2], gacc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if (SWIGLU) wmma::fill_fragment(gacc[i][j], 0.0f);
    }
  const bf16* wi = w_in + (size_t)eid * d * f;
  const bf16* wg = SWIGLU ? w_gate + (size_t)eid * d * f : nullptr;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // gather: the tile's rows straight from the token buffer
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      int t = tok_s[r];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0)
        v = *reinterpret_cast<const uint4*>(x + (size_t)t * d + k0 + kc);
      *reinterpret_cast<uint4*>(&As[r][kc]) = v;
    }
    load_b_tile(Bs, wi, f, k0, n0, tid);
    if (SWIGLU) load_b_tile(Gs, wg, f, k0, n0, tid);
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
      FragB bw[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + i * 16][kk], A_LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], &Bs[kk][wn + j * 16], B_LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
      if (SWIGLU) {
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bw[j], &Gs[kk][wn + j * 16], B_LD);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(gacc[i][j], a[i], bw[j], gacc[i][j]);
      }
    }
    __syncthreads();
  }

  // activation elementwise on the accumulators (same-type fragments share
  // their element mapping), staged through smem for the bf16 store
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      for (int e = 0; e < acc[i][j].num_elements; ++e) {
        float hv = acc[i][j].x[e];
        acc[i][j].x[e] = SWIGLU ? silu(gacc[i][j].x[e]) * hv : gelu_tanh(hv);
      }
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
    }
  __syncthreads();
  bf16* hb = h + (size_t)b * BM * f;
  for (int c = tid; c < BM * (BN / 8); c += THREADS) {
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    if (r >= nv) continue;
    __align__(16) bf16 v[8];
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(Cs[r][nc + e]);
    *reinterpret_cast<uint4*>(hb + (size_t)r * f + n0 + nc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

__global__ void __launch_bounds__(THREADS)
moe_down_kernel(int T, int d, int f,
                const int* __restrict__ slot_to_token,
                const float* __restrict__ slot_w,
                const int* __restrict__ rows_valid,
                const int* __restrict__ tiles,
                const bf16* __restrict__ h, const bf16* __restrict__ w_out,
                float* __restrict__ out) {
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int nv = tile_nvalid(tiles, rows_valid, b);
  if (nv == 0) return;
  const int slot0 = tiles[b * TILE_INTS + 0];
  const int eid = tiles[b * TILE_INTS + 1];

  __shared__ __align__(128) bf16 As[BM][A_LD];
  __shared__ __align__(128) bf16 Bs[BK][B_LD];
  __shared__ __align__(128) float Cs[BM][C_LD];
  __shared__ int tok_s[BM];
  __shared__ float w_s[BM];

  const int tid = threadIdx.x;
  if (tid < BM) {
    int t = tid < nv ? slot_to_token[slot0 + tid] : -1;
    float w = tid < nv ? slot_w[slot0 + tid] : 0.0f;
    bool live = t >= 0 && t < T;
    tok_s[tid] = live ? t : -1;
    w_s[tid] = live ? w : 0.0f;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const bf16* hb = h + (size_t)b * BM * f;
  const bf16* wo = w_out + (size_t)eid * f * d;

  for (int k0 = 0; k0 < f; k0 += BK) {
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nv)
        v = *reinterpret_cast<const uint4*>(hb + (size_t)r * f + k0 + kc);
      *reinterpret_cast<uint4*>(&As[r][kc]) = v;
    }
    load_b_tile(Bs, wo, d, k0, n0, tid);
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
      FragB bw[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + i * 16][kk], A_LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], &Bs[kk][wn + j * 16], B_LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  // combine: scatter-accumulate the weighted rows into token order.  A slot
  // whose combine weight is 0 (a token that did not pick this expert, in the
  // gather path's dense slot grid) adds nothing and is skipped.
  for (int c = tid; c < BM * BN; c += THREADS) {
    int r = c / BN, col = c % BN;
    float w = w_s[r];
    if (r >= nv || w == 0.0f) continue;
    atomicAdd(out + (size_t)tok_s[r] * d + n0 + col, w * Cs[r][col]);
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers on the current device.  x [T, d] bf16;
// slot_to_token [S] i32; slot_w [S] f32; rows_valid [n_seg] i32;
// tiles [n_tiles, 5] i32; w_in/w_gate [E, d, f] bf16 (w_gate unused unless
// swiglu); w_out [E, f, d] bf16; h scratch [n_tiles * 64, f] bf16;
// out [T, d] f32, zeroed by the caller.  d and f must be multiples of 64.
int moe_fused_tile_rows() { return BM; }

int local_moe_fused(const void* x, int T, int d, int f,
                    const void* slot_to_token, const void* slot_w,
                    const void* rows_valid, const void* tiles, int n_tiles,
                    const void* w_in, const void* w_gate, const void* w_out,
                    void* h, void* out, int swiglu, void* stream) {
  if (d % BN || f % BN || d % BK || f % BK) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_up(n_tiles, f / BN), grid_down(n_tiles, d / BN);
  const bf16* xb = static_cast<const bf16*>(x);
  const int* tok = static_cast<const int*>(slot_to_token);
  const int* rv = static_cast<const int*>(rows_valid);
  const int* ti = static_cast<const int*>(tiles);
  if (swiglu)
    moe_up_kernel<true><<<grid_up, THREADS, 0, s>>>(
        xb, T, d, f, tok, rv, ti, static_cast<const bf16*>(w_in),
        static_cast<const bf16*>(w_gate), static_cast<bf16*>(h));
  else
    moe_up_kernel<false><<<grid_up, THREADS, 0, s>>>(
        xb, T, d, f, tok, rv, ti, static_cast<const bf16*>(w_in), nullptr,
        static_cast<bf16*>(h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_down_kernel<<<grid_down, THREADS, 0, s>>>(
      T, d, f, tok, static_cast<const float*>(slot_w), rv, ti,
      static_cast<const bf16*>(h), static_cast<const bf16*>(w_out),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
