// Occupancy-aware ragged grouped expert FFN for Hopper, sm_90a: K3 (bf16)
// and K7 (int8 up-projections).  Built by repro_torch/kernels/backend.py
// with nvcc into a shared library with a plain C interface; called through
// ctypes from repro_torch/kernels/moe_gemm/ops.py (grouped_ffn_ragged and
// grouped_ffn_ragged_quant).
//
// Replaces: src/repro/kernels/moe_gemm/kernel.py, grouped_ffn_ragged_pallas
// (K3) and grouped_ffn_ragged_quant_pallas (K7): Pallas TPU kernels over a
// (row-block, f-block) grid with scalar-prefetched block_row / block_eid /
// block_nvalid vectors (and, for K7, per-block f32 dequant factors).
//
// What it computes, on a flat [R, d] buffer of static contiguous segments
// (segment s owns rows seg_offsets[s]:seg_offsets[s+1] and multiplies expert
// seg_experts[s]):
//   y[r] = FFN_e(x[r])   for the first rows_valid[s] rows of each segment
//   y[r] = 0             for the rows at or past rows_valid[s]
//   FFN_e(x) = act(x @ w_in[e]) @ w_out[e]      act = tanh-gelu, or
//              silu(x @ w_gate[e]) * (x @ w_in[e])   (swiglu)
// with the hidden activation rounded to bf16 before the down-projection,
// float32 accumulation, and y in bf16 (the reference's output dtype).
//
// What the TPU design relied on, and what this one does instead:
//   * The TPU kernel holds a [bc, d] f32 accumulator across its sequential
//     f-blocks (512 KiB at bc = 128, d = 1024), more than a Hopper block's
//     227 KB of shared memory.  Here the FFN is two launches over one tile
//     list, as in csrc/moe_fused.cu (K4) without its gather and scatter:
//       1. up:   x rows @ w_in (and w_gate), activation, round to bf16,
//                write h [tiles * 64, f];
//       2. down: h @ w_out with an f32 accumulator, bf16 store of the valid
//                rows, exact zeros for the rest.
//   * plan_blocks' gcd rule gives 8-row blocks for the 2x2 plan's segment
//     widths 120 and 16.  Fixed 64-row tiles with row masks replace it; no
//     tile straddles two segments.
//   * Each tile's valid-row count is computed on the device from rows_valid
//     (no host synchronisation).  A tile with none returns before any load;
//     the down launch writes its zero rows without reading anything.
//
// What bounds it on this card: at the shapes of the 2x2 training plan
// (16 experts a rank, about 2k valid rows of 4.9k) the expert weights'
// bytes, so the memory rate; at full occupancy and many rows an expert, the
// bf16 tensor-core rate.  This first version uses warp-level tensor-core
// MMA (WMMA 16x16x16 bf16, f32 accumulate) on 64x64x32 tiles staged through
// shared memory with 16-byte loads, without a copy pipeline; wgmma, TMA and
// a persistent schedule are later work.
//
// K7 (the int8 wire codec's expert compute) takes int8 activations xq [R, d]
// (one scale per segment) and int8 w_in / w_gate [E, d, f] (one scale per
// expert), quantized by the wrapper in plain torch as the reference does
// outside its kernel, and the bf16 w_out.  Its up launch runs int8 tensor
// cores (WMMA 16x16x16 signed char, int32 accumulate: exact) on 64x64x64
// tiles, multiplies each tile's accumulator by its f32 factor s1[tile] =
// scale_x[segment] * scale_w[expert] (sg for the gate), applies the
// activation in f32 and writes bf16 h; its down launch is K3's, unchanged.
// WMMA wants 256-bit aligned fragment pointers, and a 16-value int8 step is
// only 16 bytes, so the tiles are staged as 16-value chunks on a 32-byte
// row stride.  At the 2x2 pipelined plan's chunk (15- and 2-row segments,
// so at most 15 valid rows of each 64-row tile) it is bound by the experts'
// weight bytes, and far from that bound: the tile is mostly masked rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows per tile
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction depth per shared-memory stage
constexpr int THREADS = 128;  // 4 warps, each a 32x32 quarter of the tile
constexpr int A_LD = BK + 8;  // padded leading dims (WMMA wants multiples
constexpr int B_LD = BN + 8;  // of 8 bf16 / 4 f32 and 32-byte aligned rows
constexpr int C_LD = BN + 4;  // of 16; the pads also spread the banks)
constexpr int TILE_INTS = 5;  // per tile: first row, expert, segment,
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

// A BM x BK tile of rows [row0, row0 + nv) of a row-major [., ld] bf16
// matrix into smem; rows at or past nv load as zeros.
__device__ __forceinline__ void load_a_tile(bf16 (*dst)[A_LD], const bf16* src,
                                            int ld, int row0, int nv, int k0,
                                            int tid) {
  for (int c = tid; c < BM * (BK / 8); c += THREADS) {
    int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nv)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + k0 + kc);
    *reinterpret_cast<uint4*>(&dst[r][kc]) = v;
  }
}

template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
ragged_up_kernel(const bf16* __restrict__ x, int d, int f,
                 const int* __restrict__ rows_valid,
                 const int* __restrict__ tiles,
                 const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
                 bf16* __restrict__ h) {
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int nv = tile_nvalid(tiles, rows_valid, b);
  if (nv == 0) return;                       // slack tile: no loads, no math
  const int row0 = tiles[b * TILE_INTS + 0];
  const int eid = tiles[b * TILE_INTS + 1];

  __shared__ __align__(128) bf16 As[BM][A_LD];
  __shared__ __align__(128) bf16 Bs[BK][B_LD];
  __shared__ __align__(128) bf16 Gs[SWIGLU ? BK : 1][B_LD];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int tid = threadIdx.x;
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
    load_a_tile(As, x, d, row0, nv, k0, tid);
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
ragged_down_kernel(int d, int f, const int* __restrict__ rows_valid,
                   const int* __restrict__ tiles,
                   const bf16* __restrict__ h, const bf16* __restrict__ w_out,
                   bf16* __restrict__ y) {
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int nv = tile_nvalid(tiles, rows_valid, b);
  const int row0 = tiles[b * TILE_INTS + 0];
  const int rows = tiles[b * TILE_INTS + 4];
  const int tid = threadIdx.x;
  if (nv == 0) {                             // slack tile: zero rows only
    for (int c = tid; c < rows * (BN / 8); c += THREADS) {
      int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * d + n0 + nc) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int eid = tiles[b * TILE_INTS + 1];

  __shared__ __align__(128) bf16 As[BM][A_LD];
  __shared__ __align__(128) bf16 Bs[BK][B_LD];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const bf16* hb = h + (size_t)b * BM * f;
  const bf16* wo = w_out + (size_t)eid * f * d;

  for (int k0 = 0; k0 < f; k0 += BK) {
    load_a_tile(As, hb, f, 0, nv, k0, tid);
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
  // bf16 store of the tile's rows: the valid ones from the accumulator, the
  // ones past nv as exact zeros (the zero-slot convention)
  for (int c = tid; c < rows * (BN / 8); c += THREADS) {
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    __align__(16) bf16 v[8];
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16(r < nv ? Cs[r][nc + e] : 0.0f);
    *reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * d + n0 + nc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------------------
// K7: int8 up-projection
// ---------------------------------------------------------------------------

constexpr int QK = 64;     // int8 reduction depth per shared-memory stage
constexpr int QC = 16;     // int8 values per WMMA step (k) and column chunk
constexpr int QLD = 32;    // bytes per staged 16-value row (see above)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> QFragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> QFragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> QFragC;

// Rows [row0, row0 + nv) x columns [k0, k0 + QK) of a row-major [., d] int8
// matrix into smem as QK / QC chunks of [BM][QLD]; rows past nv are zeros.
__device__ __forceinline__ void load_qa_tile(signed char (*dst)[BM][QLD],
                                             const signed char* src, int d,
                                             int row0, int nv, int k0,
                                             int tid) {
  for (int c = tid; c < BM * (QK / QC); c += THREADS) {
    int r = c / (QK / QC), q = c % (QK / QC);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nv)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + k0 +
                                          q * QC);
    *reinterpret_cast<uint4*>(&dst[q][r][0]) = v;
  }
}

// Rows [k0, k0 + QK) x columns [n0, n0 + BN) of a row-major [d, f] int8
// matrix into smem as BN / QC column chunks of [QK][QLD].
__device__ __forceinline__ void load_qb_tile(signed char (*dst)[QK][QLD],
                                             const signed char* src, int f,
                                             int k0, int n0, int tid) {
  for (int c = tid; c < QK * (BN / QC); c += THREADS) {
    int r = c / (BN / QC), q = c % (BN / QC);
    *reinterpret_cast<uint4*>(&dst[q][r][0]) =
        *reinterpret_cast<const uint4*>(src + (size_t)(k0 + r) * f + n0 +
                                        q * QC);
  }
}

template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
ragged_quant_up_kernel(const signed char* __restrict__ xq, int d, int f,
                       const int* __restrict__ rows_valid,
                       const int* __restrict__ tiles,
                       const float* __restrict__ s1,
                       const float* __restrict__ sg,
                       const signed char* __restrict__ q_in,
                       const signed char* __restrict__ q_gate,
                       bf16* __restrict__ h) {
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int nv = tile_nvalid(tiles, rows_valid, b);
  if (nv == 0) return;                       // slack tile: no loads, no MMA
  const int row0 = tiles[b * TILE_INTS + 0];
  const int eid = tiles[b * TILE_INTS + 1];

  __shared__ __align__(128) signed char As[QK / QC][BM][QLD];
  __shared__ __align__(128) signed char Bs[BN / QC][QK][QLD];
  __shared__ __align__(128) signed char Gs[SWIGLU ? BN / QC : 1][QK][QLD];
  __shared__ __align__(128) int Cs[BM][C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  QFragC acc[2][2], gacc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0);
      if (SWIGLU) wmma::fill_fragment(gacc[i][j], 0);
    }
  const signed char* wi = q_in + (size_t)eid * d * f;
  const signed char* wg = SWIGLU ? q_gate + (size_t)eid * d * f : nullptr;

  for (int k0 = 0; k0 < d; k0 += QK) {
    load_qa_tile(As, xq, d, row0, nv, k0, tid);
    load_qb_tile(Bs, wi, f, k0, n0, tid);
    if (SWIGLU) load_qb_tile(Gs, wg, f, k0, n0, tid);
    __syncthreads();
    for (int kc = 0; kc < QK / QC; ++kc) {
      QFragA a[2];
      QFragB bw[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kc][wm + i * 16][0], QLD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], &Bs[wn / QC + j][kc * QC][0], QLD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
      if (SWIGLU) {
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bw[j], &Gs[wn / QC + j][kc * QC][0], QLD);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(gacc[i][j], a[i], bw[j], gacc[i][j]);
      }
    }
    __syncthreads();
  }

  // dequantize and activate elementwise on the accumulators (same-type
  // fragments share their element mapping); the f32 result travels through
  // the int fragment and smem as its bit pattern
  const float f1 = s1[b];
  const float fg = SWIGLU ? sg[b] : 0.0f;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      for (int e = 0; e < acc[i][j].num_elements; ++e) {
        float hv = (float)acc[i][j].x[e] * f1;
        float v = SWIGLU ? silu((float)gacc[i][j].x[e] * fg) * hv
                         : gelu_tanh(hv);
        acc[i][j].x[e] = __float_as_int(v);
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
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16(__int_as_float(Cs[r][nc + e]));
    *reinterpret_cast<uint4*>(hb + (size_t)r * f + n0 + nc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers on the current device.  x [R, d] bf16;
// rows_valid [n_seg] i32; tiles [n_tiles, 5] i32 covering every row of x
// once; w_in/w_gate [E, d, f] bf16 (w_gate unused unless swiglu); w_out
// [E, f, d] bf16; h scratch [n_tiles * 64, f] bf16; y [R, d] bf16, every
// row written.  d and f must be multiples of 64.
int moe_gemm_tile_rows() { return BM; }

int grouped_ffn_ragged(const void* x, int d, int f, const void* rows_valid,
                       const void* tiles, int n_tiles, const void* w_in,
                       const void* w_gate, const void* w_out, void* h,
                       void* y, int swiglu, void* stream) {
  if (d % BN || f % BN || d % BK || f % BK) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_up(n_tiles, f / BN), grid_down(n_tiles, d / BN);
  const bf16* xb = static_cast<const bf16*>(x);
  const int* rv = static_cast<const int*>(rows_valid);
  const int* ti = static_cast<const int*>(tiles);
  if (swiglu)
    ragged_up_kernel<true><<<grid_up, THREADS, 0, s>>>(
        xb, d, f, rv, ti, static_cast<const bf16*>(w_in),
        static_cast<const bf16*>(w_gate), static_cast<bf16*>(h));
  else
    ragged_up_kernel<false><<<grid_up, THREADS, 0, s>>>(
        xb, d, f, rv, ti, static_cast<const bf16*>(w_in), nullptr,
        static_cast<bf16*>(h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ragged_down_kernel<<<grid_down, THREADS, 0, s>>>(
      d, f, rv, ti, static_cast<const bf16*>(h),
      static_cast<const bf16*>(w_out), static_cast<bf16*>(y));
  return (int)cudaGetLastError();
}

// K7.  xq [R, d] int8; rows_valid and tiles as above; s1 / sg [n_tiles] f32
// dequant factors (sg unused unless swiglu); q_in / q_gate [E, d, f] int8;
// w_out [E, f, d] bf16; h scratch [n_tiles * 64, f] bf16; y [R, d] bf16,
// every row written.  d and f must be multiples of 64.
int grouped_ffn_ragged_quant(const void* xq, int d, int f,
                             const void* rows_valid, const void* tiles,
                             int n_tiles, const void* s1, const void* sg,
                             const void* q_in, const void* q_gate,
                             const void* w_out, void* h, void* y, int swiglu,
                             void* stream) {
  if (d % BN || f % BN || d % QK || f % BK) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_up(n_tiles, f / BN), grid_down(n_tiles, d / BN);
  const signed char* xb = static_cast<const signed char*>(xq);
  const int* rv = static_cast<const int*>(rows_valid);
  const int* ti = static_cast<const int*>(tiles);
  const float* f1 = static_cast<const float*>(s1);
  if (swiglu)
    ragged_quant_up_kernel<true><<<grid_up, THREADS, 0, s>>>(
        xb, d, f, rv, ti, f1, static_cast<const float*>(sg),
        static_cast<const signed char*>(q_in),
        static_cast<const signed char*>(q_gate), static_cast<bf16*>(h));
  else
    ragged_quant_up_kernel<false><<<grid_up, THREADS, 0, s>>>(
        xb, d, f, rv, ti, f1, nullptr, static_cast<const signed char*>(q_in),
        nullptr, static_cast<bf16*>(h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ragged_down_kernel<<<grid_down, THREADS, 0, s>>>(
      d, f, rv, ti, static_cast<const bf16*>(h),
      static_cast<const bf16*>(w_out), static_cast<bf16*>(y));
  return (int)cudaGetLastError();
}

}  // extern "C"
