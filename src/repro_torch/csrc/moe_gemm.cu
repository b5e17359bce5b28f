// Grouped expert FFNs for Hopper, sm_90a: the occupancy-aware ragged K3
// (bf16) and K7 (int8 up-projections), and the dense equal-capacity K6.
// Built by repro_torch/kernels/backend.py with nvcc into a shared library
// with a plain C interface; called through ctypes from
// repro_torch/kernels/moe_gemm/ops.py (grouped_ffn_ragged,
// grouped_ffn_ragged_quant and grouped_ffn).
//
// Replaces: src/repro/kernels/moe_gemm/kernel.py, grouped_ffn_ragged_pallas
// (K3) and grouped_ffn_ragged_quant_pallas (K7): Pallas TPU kernels over a
// (row-block, f-block) grid with scalar-prefetched block_row / block_eid /
// block_nvalid vectors (and, for K7, per-block f32 dequant factors); and
// grouped_ffn_pallas (K6, moe_gemm/kernel.py:185), an (E, C-block,
// f-block) grid over a dense [E, C, d] buffer.
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
//     227 KB of shared memory.  Here each FFN is two launches over one
//     tile list, as in csrc/moe_fused.cu (K4) without its gather and
//     scatter:
//       1. up:   x rows @ w_in (and w_gate), activation, round to bf16,
//                write h [tiles * 64, f];
//       2. down: h @ w_out with an f32 accumulator, bf16 store of the valid
//                rows, exact zeros for the rest.
//   * plan_blocks' gcd rule gives 8-row blocks for the 2x2 plan's segment
//     widths 120 and 16.  K3 and K7 instead cut each expert's span of
//     consecutive segments into 64-row tiles (moe_fused.ops.
//     plan_expert_tiles: at the 2x2 plan's rank-0 buffer, S = 4864, 5
//     tiles an expert and 80 in all, where tiling by segment gave 8 and
//     128), so each tile streams its expert's weights once for up to 64
//     rows.  A tile may cross segments but never experts: each row finds
//     its segment on the device (row_seg; no host synchronisation), is
//     computed when below its segment's count, and written as an exact
//     zero otherwise.  A tile with no such row does no loads.
//
// What bounds them on this card: at the shapes of the 2x2 training plan
// (16 experts a rank, about 2k valid rows of 4.9k) the expert weights'
// bytes, so the memory rate; at full occupancy and many rows an expert, the
// tensor-core rate.  Every launch of K3 and K7 streams its weights through
// a cp.async ring, so the next slices load while this one multiplies:
//   * K3's up launch is the bf16 tile product of csrc/moe_mma.cuh (also
//     K4's): mma.m16n8k16 fed by ldmatrix (x rows) and ldmatrix.trans (the
//     row-major w_in / w_gate, read as stored), the activation applied to
//     the accumulators in registers, and only the 16-row fragments up to
//     the tile's last valid row multiplied.
//   * K3's and K7's down launch (span_down_kernel) is bf16 WMMA with an
//     f32 accumulator on 64-deep ring stages, staged through shared memory
//     for the bf16 store.
//
// K7 (the int8 wire codec's expert compute) takes int8 activations xq [R, d]
// (one scale per segment, quantized by the wrapper in plain torch each
// call) and int8 w_in / w_gate [E, d, f] (one scale per expert, quantized
// once a layer forward by the dispatch engine and shared by every chunk),
// and the bf16 w_out.  The delivered buffer is ordered (expert, stage,
// destination, slot), so at the pipelined plan's chunk 0 each expert's 38
// rows lie in 6 segments (2 of 15 rows, 4 of 2): 16 span tiles, not 96
// segment tiles.  Its up launch runs int8 tensor cores (mma.m16n8k32 s8,
// exact int32 sums) on 64x64x64 stages of a 4-stage ring (3 for swiglu,
// which holds two weight tiles a stage), the weights read from their
// transposes so ldmatrix feeds the MMA, and dequantizes each row by its
// own segment's factor sx[s] * s_w[e] (f32, as the plain version) in the
// epilogue.  At chunk 0 the pair is bound by the weights' bytes: 16
// experts' int8 w_in (32 MB, which the 50 MB L2 holds) and bf16 w_out (64
// MB, which it does not).
//
// K6 (MoEConfig.use_kernel: the einsum dispatch's [E, C, d] buffer) is the
// same FFN on equal, fully-occupied segments: up_kernel and down_kernel
// over a grid of (E * ceil(C / 64), columns / 64) blocks read straight from
// blockIdx: no tile list, no rows_valid, no skip predicate; the rows of
// the last tile past C are masked, and h is [E, C, f].  At the einsum
// path's shape (64 experts, C = 128, d = 1024, f = 2048, tanh-gelu) it is
// bound by bytes: the 64 experts' w_in and w_out, about 537 MB, over the
// memory rate (0.17 ms), against 0.07 ms of bf16 tensor-core operations.
// Each expert's weights are read once per 64-row tile (twice at C = 128),
// through unpipelined WMMA (16x16x16 bf16, f32 accumulate) on 64x64x32
// tiles staged through shared memory with 16-byte loads; its redesign is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "moe_mma.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

using moe_mma::cp_async16;
using moe_mma::cp_async_commit;
using moe_mma::cp_async_wait;
using moe_mma::gelu_tanh;
using moe_mma::ldsm_x4;
using moe_mma::silu;
using moe_mma::smem_opt_in;

constexpr int BM = 64;        // rows per tile
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K6's reduction depth per shared-memory stage
constexpr int THREADS = 128;  // 4 warps, each a 32x32 quarter of the tile
constexpr int A_LD = BK + 8;  // padded leading dims (WMMA wants multiples
constexpr int B_LD = BN + 8;  // of 8 bf16 / 4 f32 and 32-byte aligned rows
constexpr int C_LD = BN + 4;  // of 16; the pads also spread the banks)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

// K6's tile b over an [E, C, .] buffer: ceil(C / 64) tiles an expert,
// every row valid, the last tile masked at C.
__device__ __forceinline__ void dense_tile(int C, int b, int* nv, int* row0,
                                           int* eid) {
  const int tpe = (C + BM - 1) / BM, r0 = (b % tpe) * BM;
  *eid = b / tpe;
  *row0 = *eid * C + r0;
  *nv = min(BM, C - r0);
}

// K6's up launch over 64-row tiles: rows [row0, row0 + nv) of x times
// columns [n0, n0 + 64) of expert eid's w_in (and w_gate), the activation
// in f32, rounded to bf16 into h; the tile from blockIdx (dense_tile).
template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
up_kernel(const bf16* __restrict__ x, int C, int d, int f,
          const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
          bf16* __restrict__ h) {
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  int nv, row0, eid;
  dense_tile(C, b, &nv, &row0, &eid);

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
  bf16* hb = h + (size_t)row0 * f;
  for (int c = tid; c < BM * (BN / 8); c += THREADS) {
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    if (r >= nv) continue;
    __align__(16) bf16 v[8];
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(Cs[r][nc + e]);
    *reinterpret_cast<uint4*>(hb + (size_t)r * f + n0 + nc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// K6's down launch: h's rows of the tile times columns [n0, n0 + 64) of
// w_out[eid] with an f32 accumulator, the tile's rows of y written in bf16.
__global__ void __launch_bounds__(THREADS)
down_kernel(int C, int d, int f, const bf16* __restrict__ h,
            const bf16* __restrict__ w_out, bf16* __restrict__ y) {
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  int nv, row0, eid;
  dense_tile(C, b, &nv, &row0, &eid);

  __shared__ __align__(128) bf16 As[BM][A_LD];
  __shared__ __align__(128) bf16 Bs[BK][B_LD];
  __shared__ __align__(128) float Cs[BM][C_LD];

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const bf16* hb = h + (size_t)row0 * f;
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
  for (int c = tid; c < nv * (BN / 8); c += THREADS) {
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    __align__(16) bf16 v[8];
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(Cs[r][nc + e]);
    *reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * d + n0 + nc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------------------
// K3 and K7: the ragged FFNs over expert-span tiles
// ---------------------------------------------------------------------------
//
// Tiles are 64-row pieces of each expert's span (its consecutive segments),
// so a tile may cross segment boundaries but never experts.  A tile's rows
// take their segment from row_seg: row r is delivered when it lies below
// its segment's count (r - seg_start[s] < rows_valid[s]); K7's up launch
// dequantizes it by its own segment's factor sx[s] * s_w[e], the product
// taken in f32 as the plain version takes it.  Every launch keeps the next
// weight tiles in flight during the MMA through a cp.async ring.

constexpr int SPAN_INTS = 3;  // per span tile: first row, expert, rows
constexpr int QK = 64;        // int8 reduction depth (bytes) per ring stage
constexpr int QTILE = BM * QK;  // bytes of one int8 [64][64] stage tile
constexpr int DBK = 64;       // bf16 reduction depth per down stage
constexpr int DSTAGES = 4;    // ring depth of the bf16 down launch
constexpr int DA_LD = DBK + 8;  // padded leading dims of the down stages
constexpr int D_A_BYTES = BM * DA_LD * 2, D_B_BYTES = DBK * B_LD * 2;
constexpr int DOWN_SMEM = DSTAGES * (D_A_BYTES + D_B_BYTES);  // 73,728 B
// K3's up launch: moe_mma.cuh's tile product on a 2-stage ring (32 KB for
// gelu: seven blocks an SM), which measured faster on an H100 at the 2x2
// buffer than 3 or 4 stages
constexpr int UP_STAGES = 2;
constexpr int UP_SMEM = moe_mma::ring_bytes(UP_STAGES, 1);          // 32 KB
constexpr int UP_SMEM_SWIGLU = moe_mma::ring_bytes(UP_STAGES, 2);   // 48 KB

// c += a (16x32 s8, row) . b (32x8 s8, col), exact s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in an int8 [64][64] stage tile:
// rows are 64 bytes, and the chunk is XOR-swizzled by r / 2 so that the
// eight rows an ldmatrix phase reads fall in eight distinct bank groups.
__device__ __forceinline__ int qswz(int r, int c) {
  return r * QK + ((c ^ ((r >> 1) & 3)) << 4);
}

// K3's span tile header in shared memory: a_row[r] = row0 + r for the
// tile's delivered rows, -1 for the rest; returns the number of 16-row
// fragments up to the last delivered row (0: none), the same in every
// thread.
__device__ __forceinline__ int span_rows(int row0, int rows,
                                         const int* __restrict__ row_seg,
                                         const int* __restrict__ seg_start,
                                         const int* __restrict__ rows_valid,
                                         int* a_row, unsigned* masks,
                                         int tid) {
  bool ok = false;
  if (tid < BM) {
    if (tid < rows) {
      const int r = row0 + tid, s = row_seg[r];
      ok = r - seg_start[s] < rows_valid[s];
    }
    a_row[tid] = ok ? row0 + tid : -1;
  }
  const unsigned m = __ballot_sync(0xffffffffu, ok);
  if (tid < BM && tid % 32 == 0) masks[tid / 32] = m;
  __syncthreads();
  const unsigned long long all =
      masks[0] | (unsigned long long)masks[1] << 32;
  return all ? (64 - __clzll(all) + 15) / 16 : 0;
}

// K3's up launch: the tile's delivered rows of x times columns [n0, n0 +
// 64) of expert eid's w_in (and w_gate), activated and rounded to bf16 into
// h (moe_mma.cuh's up_tile; dynamic shared memory: its ring).
template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
span_up_kernel(const bf16* __restrict__ x, int d, int f,
               const int* __restrict__ row_seg,
               const int* __restrict__ seg_start,
               const int* __restrict__ rows_valid,
               const int* __restrict__ tiles,
               const bf16* __restrict__ w_in,
               const bf16* __restrict__ w_gate, bf16* __restrict__ h) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int a_row[BM];
  __shared__ unsigned masks[2];
  const int b = blockIdx.x, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const int row0 = tiles[b * SPAN_INTS + 0];
  const int eid = tiles[b * SPAN_INTS + 1];
  const int mf = span_rows(row0, tiles[b * SPAN_INTS + 2], row_seg,
                           seg_start, rows_valid, a_row, masks, tid);
  if (mf == 0) return;                       // no delivered row: no work
  const size_t wofs = (size_t)eid * d * f;
  moe_mma::up_tile<SWIGLU, UP_STAGES>(dsmem, x, a_row, mf, d, f, n0,
                                      w_in + wofs,
                                      SWIGLU ? w_gate + wofs : nullptr,
                                      h + (size_t)b * BM * f);
}

// The span tile's row header in shared memory: valid[r] (row r of the tile
// lies in the tile and below its segment's count) and, with FACTORS, the
// row's f32 dequant factors f1[r] = sx[s] * s_in[e] (fg[r] for the gate).
// Returns whether any row is valid (the same in every thread).
template <bool FACTORS, bool SWIGLU>
__device__ __forceinline__ bool span_header(
    int row0, int rows, int eid, const int* __restrict__ row_seg,
    const int* __restrict__ seg_start, const int* __restrict__ rows_valid,
    const float* __restrict__ sx, const float* __restrict__ s_in,
    const float* __restrict__ s_g, int* valid, float* f1, float* fg,
    int tid) {
  int ok = 0;
  if (tid < BM) {
    if (tid < rows) {
      const int r = row0 + tid;
      const int s = row_seg[r];
      ok = r - seg_start[s] < rows_valid[s];
      if (FACTORS) {
        f1[tid] = sx[s] * s_in[eid];
        if (SWIGLU) fg[tid] = sx[s] * s_g[eid];
      }
    }
    valid[tid] = ok;
  }
  return __syncthreads_or(ok) != 0;
}

// K7's up launch: the tile's valid rows of int8 xq times columns [n0, n0 +
// 64) of expert eid's int8 w_in (and w_gate), read from their transposes
// q_in [E, f, d] (the reduction axis innermost, as the wrapper quantizes
// them), on mma.m16n8k32 s8 tensor cores with exact int32 sums fed by
// ldmatrix; each warp owns a 32 x 32 quarter of the tile.  Each row is
// dequantized by its own factor, activated in f32 and rounded to bf16
// into h, straight from the accumulators (their element layout is fixed).
template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
quant_span_up_kernel(const signed char* __restrict__ xq, int d, int f,
                     const int* __restrict__ row_seg,
                     const int* __restrict__ seg_start,
                     const int* __restrict__ rows_valid,
                     const int* __restrict__ tiles,
                     const float* __restrict__ sx,
                     const float* __restrict__ s_in,
                     const float* __restrict__ s_g,
                     const signed char* __restrict__ q_in,
                     const signed char* __restrict__ q_gate,
                     bf16* __restrict__ h) {
  constexpr int STAGES = SWIGLU ? 3 : 4;
  constexpr int NW = SWIGLU ? 2 : 1;        // weight tiles a stage
  __shared__ __align__(128) signed char ring[STAGES][1 + NW][QTILE];
  __shared__ int valid[BM];
  __shared__ float f1[BM], fg[SWIGLU ? BM : 1];

  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int row0 = tiles[b * SPAN_INTS + 0];
  const int eid = tiles[b * SPAN_INTS + 1];
  const int rows = tiles[b * SPAN_INTS + 2];
  if (!span_header<true, SWIGLU>(row0, rows, eid, row_seg, seg_start,
                                 rows_valid, sx, s_in, s_g, valid, f1, fg,
                                 tid))
    return;                                  // no delivered row: no work

  const signed char* wsrc[2] = {
      q_in + ((size_t)eid * f + n0) * d,
      SWIGLU ? q_gate + ((size_t)eid * f + n0) * d : nullptr};
  auto load_stage = [&](int st, int k0) {
    for (int c = tid; c < BM * (QK / 16); c += THREADS) {
      const int r = c / (QK / 16), q = c % (QK / 16);
      const bool ok = valid[r];
      cp_async16(&ring[st][0][qswz(r, q)],
                 xq + (size_t)(row0 + (ok ? r : 0)) * d + k0 + q * 16,
                 ok ? 16 : 0);
      for (int w = 0; w < NW; ++w)           // weight row r = column n0 + r
        cp_async16(&ring[st][1 + w][qswz(r, q)],
                   wsrc[w] + (size_t)r * d + k0 + q * 16, 16);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  int acc[2][4][4], gacc[2][4][4];      // gacc: swiglu only
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j)
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if (SWIGLU) gacc[i][j][e] = 0;
      }

  const int KT = d / QK;
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage(st, st * QK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();             // stage kt has landed
    __syncthreads();                         // and kt - 1's slot is free
    if (kt + STAGES - 1 < KT)
      load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * QK);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < QK / 32; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], &ring[st][0][qswz(wm + i * 16 + (lane & 15),
                                        kk * 2 + (lane >> 4))]);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {        // columns wn + 16p .. + 15
          uint32_t bf[4];
          ldsm_x4(bf, &ring[st][1 + w][qswz(
                          wn + p * 16 + (lane & 7) + ((lane >> 4) << 3),
                          kk * 2 + ((lane >> 3) & 1))]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (w == 0) {
              mma_s8(acc[i][2 * p], a[i], bf[0], bf[1]);
              mma_s8(acc[i][2 * p + 1], a[i], bf[2], bf[3]);
            } else {
              mma_s8(gacc[i][2 * p], a[i], bf[0], bf[1]);
              mma_s8(gacc[i][2 * p + 1], a[i], bf[2], bf[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator element e of (i, j): row wm + 16i + lane/4 + 8(e/2),
  // column wn + 8j + 2(lane%4) + e%2
  bf16* hb = h + (size_t)b * BM * f + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm + i * 16 + lane / 4 + hr * 8;
      if (!valid[r]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[2];
        for (int e = 0; e < 2; ++e) {
          const float hv = (float)acc[i][j][2 * hr + e] * f1[r];
          v[e] = SWIGLU ? silu((float)gacc[i][j][2 * hr + e] * fg[r]) * hv
                        : gelu_tanh(hv);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            hb + (size_t)r * f + wn + j * 8 + 2 * (lane % 4)) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

// K3's and K7's down launch over the span tiles: the tile's valid rows of h
// times columns [n0, n0 + 64) of w_out[eid] with an f32 accumulator (bf16
// WMMA), the next DSTAGES - 1 slices of 64 rows of h and w_out in flight
// during the MMA (dynamic shared memory: DOWN_SMEM); the tile's rows of y
// are written, those not delivered as exact zeros.
__global__ void __launch_bounds__(THREADS)
span_down_kernel(int d, int f, const int* __restrict__ row_seg,
                       const int* __restrict__ seg_start,
                       const int* __restrict__ rows_valid,
                       const int* __restrict__ tiles,
                       const bf16* __restrict__ h,
                       const bf16* __restrict__ w_out,
                       bf16* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int valid[BM];

  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int row0 = tiles[b * SPAN_INTS + 0];
  const int eid = tiles[b * SPAN_INTS + 1];
  const int rows = tiles[b * SPAN_INTS + 2];
  if (!span_header<false, false>(row0, rows, eid, row_seg, seg_start,
                                 rows_valid, nullptr, nullptr, nullptr,
                                 valid, nullptr, nullptr, tid)) {
    for (int c = tid; c < rows * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * d + n0 + nc) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  auto a_tile = [&](int st) {
    return reinterpret_cast<bf16 (*)[DA_LD]>(dsmem + st * D_A_BYTES);
  };
  auto b_tile = [&](int st) {
    return reinterpret_cast<bf16 (*)[B_LD]>(dsmem + DSTAGES * D_A_BYTES +
                                            st * D_B_BYTES);
  };
  const bf16* hb = h + (size_t)b * BM * f;
  const bf16* wo = w_out + (size_t)eid * f * d;
  auto load_stage = [&](int st, int k0) {
    bf16 (*A)[DA_LD] = a_tile(st);
    for (int c = tid; c < BM * (DBK / 8); c += THREADS) {
      const int r = c / (DBK / 8), kc = (c % (DBK / 8)) * 8;
      const bool ok = valid[r];
      cp_async16(&A[r][kc], hb + (size_t)(ok ? r : 0) * f + k0 + kc,
                 ok ? 16 : 0);
    }
    bf16 (*B)[B_LD] = b_tile(st);
    for (int c = tid; c < DBK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      cp_async16(&B[r][nc], wo + (size_t)(k0 + r) * d + n0 + nc, 16);
    }
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = f / DBK;
  for (int st = 0; st < DSTAGES - 1; ++st) {
    if (st < KT) load_stage(st, st * DBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();
    if (kt + DSTAGES - 1 < KT)
      load_stage((kt + DSTAGES - 1) % DSTAGES, (kt + DSTAGES - 1) * DBK);
    cp_async_commit();
    bf16 (*A)[DA_LD] = a_tile(kt % DSTAGES);
    bf16 (*B)[B_LD] = b_tile(kt % DSTAGES);
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 16) {
      FragA a[2];
      FragB bw[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &A[wm + i * 16][kk], DA_LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], &B[kk][wn + j * 16], B_LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring becomes the sums

  float (*Cs)[C_LD] = reinterpret_cast<float (*)[C_LD]>(dsmem);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < rows * (BN / 8); c += THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    __align__(16) bf16 v[8];
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16(valid[r] ? Cs[r][nc + e] : 0.0f);
    *reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * d + n0 + nc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

unsigned long long down_opt_in, up_opt_in[2];   // per-device bit masks

// The span down launch (K3 and K7) over n_tiles span tiles.
cudaError_t span_down(int n_tiles, int d, int f, const int* row_seg,
                      const int* seg_start, const int* rows_valid,
                      const int* tiles, const void* h, const void* w_out,
                      void* y, cudaStream_t s) {
  cudaError_t err = smem_opt_in(span_down_kernel, DOWN_SMEM, down_opt_in);
  if (err != cudaSuccess) return err;
  span_down_kernel<<<dim3(n_tiles, d / BN), THREADS, DOWN_SMEM, s>>>(
      d, f, row_seg, seg_start, rows_valid, tiles,
      static_cast<const bf16*>(h), static_cast<const bf16*>(w_out),
      static_cast<bf16*>(y));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int moe_gemm_tile_rows() { return BM; }

// K3.  All pointers are device pointers on the current device.  x [R, d]
// bf16; row_seg [R] i32 (each row's segment); seg_start [S] i32 (each
// segment's first row); rows_valid [S] i32; tiles [n_tiles, 3] i32
// expert-span tiles (first row, expert, rows) covering every row of x
// once; w_in/w_gate [E, d, f] bf16 (w_gate unused unless swiglu); w_out
// [E, f, d] bf16; h scratch [n_tiles * 64, f] bf16; y [R, d] bf16, every
// row written.  d and f must be multiples of 64.
int grouped_ffn_ragged(const void* x, int d, int f, const void* row_seg,
                       const void* seg_start, const void* rows_valid,
                       const void* tiles, int n_tiles, const void* w_in,
                       const void* w_gate, const void* w_out, void* h,
                       void* y, int swiglu, void* stream) {
  if (d % moe_mma::BK || f % BN || f % DBK) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_up(n_tiles, f / BN);
  const bf16* xb = static_cast<const bf16*>(x);
  const int* rs = static_cast<const int*>(row_seg);
  const int* ss = static_cast<const int*>(seg_start);
  const int* rv = static_cast<const int*>(rows_valid);
  const int* ti = static_cast<const int*>(tiles);
  const bf16* wi = static_cast<const bf16*>(w_in);
  bf16* hb = static_cast<bf16*>(h);
  cudaError_t err;
  if (swiglu) {
    err = smem_opt_in(span_up_kernel<true>, UP_SMEM_SWIGLU, up_opt_in[1]);
    if (err != cudaSuccess) return (int)err;
    span_up_kernel<true><<<grid_up, THREADS, UP_SMEM_SWIGLU, s>>>(
        xb, d, f, rs, ss, rv, ti, wi, static_cast<const bf16*>(w_gate), hb);
  } else {
    err = smem_opt_in(span_up_kernel<false>, UP_SMEM, up_opt_in[0]);
    if (err != cudaSuccess) return (int)err;
    span_up_kernel<false><<<grid_up, THREADS, UP_SMEM, s>>>(
        xb, d, f, rs, ss, rv, ti, wi, nullptr, hb);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)span_down(n_tiles, d, f, rs, ss, rv, ti, h, w_out, y, s);
}

// K6.  x [E, C, d] bf16; w_in/w_gate [E, d, f] bf16 (w_gate unused unless
// swiglu); w_out [E, f, d] bf16; h scratch [E, C, f] bf16; y [E, C, d]
// bf16, every row written.  d and f must be multiples of 64.
int grouped_ffn_dense(const void* x, int E, int C, int d, int f,
                      const void* w_in, const void* w_gate, const void* w_out,
                      void* h, void* y, int swiglu, void* stream) {
  if (d % BN || f % BN || d % BK || f % BK) return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = E * ((C + BM - 1) / BM);
  dim3 grid_up(tiles, f / BN), grid_down(tiles, d / BN);
  const bf16* xb = static_cast<const bf16*>(x);
  if (swiglu)
    up_kernel<true><<<grid_up, THREADS, 0, s>>>(
        xb, C, d, f, static_cast<const bf16*>(w_in),
        static_cast<const bf16*>(w_gate), static_cast<bf16*>(h));
  else
    up_kernel<false><<<grid_up, THREADS, 0, s>>>(
        xb, C, d, f, static_cast<const bf16*>(w_in), nullptr,
        static_cast<bf16*>(h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_kernel<<<grid_down, THREADS, 0, s>>>(
      C, d, f, static_cast<const bf16*>(h), static_cast<const bf16*>(w_out),
      static_cast<bf16*>(y));
  return (int)cudaGetLastError();
}

// K7.  xq [R, d] int8; row_seg [R] i32 (each row's segment); seg_start [S]
// i32 (each segment's first row); rows_valid [S] i32; tiles [n_tiles, 3]
// i32 expert-span tiles (first row, expert, rows) covering every row of xq
// once; sx [S] f32 segment scales; s_in / s_g [E] f32 expert scales (s_g
// unused unless swiglu); q_in / q_gate [E, f, d] int8, each expert's
// quantized w_in / w_gate transposed (q_gate unused unless swiglu); w_out
// [E, f, d] bf16; h scratch [n_tiles * 64, f] bf16; y [R, d] bf16, every row
// written.  d and f must be multiples of 64.
int grouped_ffn_ragged_quant(const void* xq, int d, int f,
                             const void* row_seg, const void* seg_start,
                             const void* rows_valid, const void* tiles,
                             int n_tiles, const void* sx, const void* s_in,
                             const void* s_g, const void* q_in,
                             const void* q_gate, const void* w_out, void* h,
                             void* y, int swiglu, void* stream) {
  if (d % BN || f % BN || d % QK || f % DBK)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_up(n_tiles, f / BN);
  const signed char* xb = static_cast<const signed char*>(xq);
  const int* rs = static_cast<const int*>(row_seg);
  const int* ss = static_cast<const int*>(seg_start);
  const int* rv = static_cast<const int*>(rows_valid);
  const int* ti = static_cast<const int*>(tiles);
  const float* fx = static_cast<const float*>(sx);
  const float* fi = static_cast<const float*>(s_in);
  if (swiglu)
    quant_span_up_kernel<true><<<grid_up, THREADS, 0, s>>>(
        xb, d, f, rs, ss, rv, ti, fx, fi, static_cast<const float*>(s_g),
        static_cast<const signed char*>(q_in),
        static_cast<const signed char*>(q_gate), static_cast<bf16*>(h));
  else
    quant_span_up_kernel<false><<<grid_up, THREADS, 0, s>>>(
        xb, d, f, rs, ss, rv, ti, fx, fi, nullptr,
        static_cast<const signed char*>(q_in), nullptr,
        static_cast<bf16*>(h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)span_down(n_tiles, d, f, rs, ss, rv, ti, h, w_out, y, s);
}

}  // extern "C"
