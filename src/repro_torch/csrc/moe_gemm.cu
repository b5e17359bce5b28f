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
// same FFN on equal, fully-occupied segments, on the same tile product as
// K3's up launch and K4: no tile list, no rows_valid, no skip predicate.
// Its two launches (dense_up_kernel, dense_down_kernel) read each block's
// expert, rows and columns from a 1-D grid (dense_block), and the rows
// past C are neither loaded nor written; h is [E, C, f].  The up launch
// is moe_mma.cuh's up_tile; the down launch its tile product over h's
// rows and w_out[e]'s 64 columns, with y stored in bf16 straight from the
// accumulators (no staging through shared memory).  Both stream 64-deep
// slices of the rows and of the weights through a cp.async ring into
// swizzled shared memory, B by ldmatrix.trans from the row-major weights
// as stored, onto mma.m16n8k16.  Unlike K3 and K4 (whose tiles are mostly
// empty rows), a K6 block takes an expert's 128 rows (C = 128) for 64
// columns, so each weight slice leaves DRAM once, with its four warps 2 x
// 2 (64 rows by 32 columns each: a third less shared-memory reading than
// 1 x 4) and a 2-stage ring (48 KB, four blocks an SM); the grid walks a
// tile's columns first, so the blocks that read one tile's rows of x or
// h run together.  chip_k6_tune.py reads 24 geometries on an H100
// (PERF.md): this one 0.320 ms at the einsum path's shape (64
// experts, C = 128, d = 1024, f = 2048, tanh-gelu; up 0.170, down 0.150),
// one 64-row tile a block with 1 x 4 warps and 3 stages 0.403, deeper
// rings slower at every geometry (fewer blocks an SM).  The bound is the
// bytes: the 64 experts' w_in and w_out, about 537 MB, over the memory
// rate (0.170 ms), against 0.07 ms of bf16 tensor-core operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "launch_geom.cuh"
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
constexpr int THREADS = 128;  // 4 warps
constexpr int B_LD = BN + 8;  // padded leading dims of the WMMA down
constexpr int C_LD = BN + 4;  // launch's tiles (multiples of 8 bf16 / 4 f32)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// ---------------------------------------------------------------------------
// K6: the dense grouped FFN over an [E, C, d] buffer
// ---------------------------------------------------------------------------

// K6's launch geometry, the fastest of those chip_k6_tune.py reads on an
// H100 (it rebuilds this file with other values of these three constants
// and with every tile of a column first in dense_block).
constexpr int K6_STAGES = 2;  // cp.async ring depth of both launches
constexpr int K6_ROWS = 128;  // rows a block: an expert's two tiles at C = 128
constexpr int K6_WM = 2;      // warps 2 x 2 over the block's tile
static_assert(K6_ROWS % BM == 0, "K6_ROWS is a whole number of tiles");
constexpr int K6_MF = K6_ROWS / 16;          // 16-row fragments a block
constexpr int K6_AT = K6_ROWS / BM;          // A tiles a ring stage
constexpr int K6_UP_SMEM = moe_mma::ring_bytes(K6_STAGES, 1, K6_AT);
constexpr int K6_UP_SMEM_SWIGLU = moe_mma::ring_bytes(K6_STAGES, 2, K6_AT);
constexpr int K6_DOWN_SMEM = moe_mma::ring_bytes(K6_STAGES, 1, K6_AT);

// K6's block of a 1-D grid of tiles x ncols blocks: output columns [n0, n0
// + 64) of rows [r0, r0 + K6_ROWS) of expert e's C rows; a_row[r] (shared)
// = e * C + r0 + r, the row of the [E * C, .] buffer, for the rows below
// C and -1 past it.  Returns the 16-row fragments that hold rows.  The grid
// walks a tile's columns first, so the blocks that share the tile's rows
// of x or h run together.
__device__ __forceinline__ int dense_block(int C, int ncols, int* n0, int* e,
                                           int* r0, int* a_row) {
  const int tpe = (C + K6_ROWS - 1) / K6_ROWS;
  const int b = blockIdx.x / ncols, col = blockIdx.x % ncols;
  *n0 = col * BN;
  *e = b / tpe;
  *r0 = (b % tpe) * K6_ROWS;
  for (int r = threadIdx.x; r < K6_ROWS; r += THREADS)
    a_row[r] = *r0 + r < C ? *e * C + *r0 + r : -1;
  __syncthreads();
  return (min(K6_ROWS, C - *r0) + 15) / 16;
}

// K6's up launch: the block's rows of x times columns [n0, n0 + 64) of
// expert e's w_in (and w_gate), activated and rounded to bf16 into h [E *
// C, f] (moe_mma.cuh's up_tile; dynamic shared memory: its ring).
template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
dense_up_kernel(const bf16* __restrict__ x, int C, int d, int f,
                const bf16* __restrict__ w_in,
                const bf16* __restrict__ w_gate, bf16* __restrict__ h) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int a_row[K6_ROWS];
  int n0, e, r0;
  const int mf = dense_block(C, f / BN, &n0, &e, &r0, a_row);
  const size_t wofs = (size_t)e * d * f;
  moe_mma::up_tile<SWIGLU, K6_STAGES, K6_MF, K6_WM>(
      dsmem, x, a_row, mf, d, f, n0, w_in + wofs,
      SWIGLU ? w_gate + wofs : nullptr, h + ((size_t)e * C + r0) * f);
}

// K6's down launch: the block's rows of h times columns [n0, n0 + 64) of
// w_out[e] (moe_mma.cuh's tile product, f32 sums), written to y in bf16
// straight from the accumulators: element e of the warp's fragment (i, j)
// is row 16 (f0 + i) + lane / 4 + 8 (e / 2), column c0 + 8j + 2 (lane %
// 4) + e % 2 (f0, c0: the warp's origin), so each thread stores bf16
// pairs; only rows below C are written.
__global__ void __launch_bounds__(THREADS)
dense_down_kernel(int C, int d, int f, const bf16* __restrict__ h,
                  const bf16* __restrict__ w_out, bf16* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int a_row[K6_ROWS];
  int n0, e, r0;
  const int mf = dense_block(C, d / BN, &n0, &e, &r0, a_row);
  const bf16* wb[1] = {w_out + (size_t)e * f * d + n0};
  float acc[1][K6_MF / K6_WM][2 * K6_WM][4];
  moe_mma::tile_product<1, K6_STAGES, K6_MF, K6_WM>(dsmem, h, a_row, f, wb,
                                                    d, 0, f, mf, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = moe_mma::warp_frag0<K6_MF, K6_WM>(warp);
  const int col = n0 + moe_mma::warp_col0<K6_WM>(warp) + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < K6_MF / K6_WM; ++i) {
    if (f0 + i >= mf) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = (f0 + i) * 16 + lane / 4 + hr * 8;
      if (a_row[r] < 0) continue;
      bf16* dst = y + (size_t)a_row[r] * d + col;
#pragma unroll
      for (int j = 0; j < 2 * K6_WM; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(acc[0][i][j][2 * hr],
                                  acc[0][i][j][2 * hr + 1]);
    }
  }
}

unsigned long long dense_up_opt_in[2], dense_down_opt_in;  // device masks

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

// The span down launch (K3 and K7) over n_tiles span tiles, opted in to
// its dynamic shared memory.
cudaError_t span_down_geom(int n_tiles, int d, launch_geom::Launch* g) {
  const cudaError_t err = smem_opt_in(span_down_kernel, DOWN_SMEM,
                                      down_opt_in);
  *g = {dim3(n_tiles, d / BN), THREADS, DOWN_SMEM,
        (const void*)span_down_kernel};
  return err;
}

// K3's span up launch over (tile, f / 64), opted in.
cudaError_t span_up_geom(int n_tiles, int f, int swiglu,
                         launch_geom::Launch* g) {
  const cudaError_t err =
      swiglu ? smem_opt_in(span_up_kernel<true>, UP_SMEM_SWIGLU, up_opt_in[1])
             : smem_opt_in(span_up_kernel<false>, UP_SMEM, up_opt_in[0]);
  *g = {dim3(n_tiles, f / BN), THREADS, swiglu ? UP_SMEM_SWIGLU : UP_SMEM,
        swiglu ? (const void*)span_up_kernel<true>
               : (const void*)span_up_kernel<false>};
  return err;
}

// K7's int8 up launch over (tile, f / 64): its ring is static.
launch_geom::Launch quant_up_geom(int n_tiles, int f, int swiglu) {
  return {dim3(n_tiles, f / BN), THREADS, 0,
          swiglu ? (const void*)quant_span_up_kernel<true>
                 : (const void*)quant_span_up_kernel<false>};
}

// K6's two 1-D launches over E * ceil(C / 128) tiles x 64-column blocks,
// opted in.
cudaError_t dense_geom(int E, int C, int d, int f, int swiglu,
                       launch_geom::Launch* g) {
  cudaError_t err =
      swiglu ? smem_opt_in(dense_up_kernel<true>, K6_UP_SMEM_SWIGLU,
                           dense_up_opt_in[1])
             : smem_opt_in(dense_up_kernel<false>, K6_UP_SMEM,
                           dense_up_opt_in[0]);
  if (err == cudaSuccess)
    err = smem_opt_in(dense_down_kernel, K6_DOWN_SMEM, dense_down_opt_in);
  const long long tiles = (long long)E * ((C + K6_ROWS - 1) / K6_ROWS);
  g[0] = {dim3((unsigned)(tiles * (f / BN))), THREADS,
          swiglu ? K6_UP_SMEM_SWIGLU : K6_UP_SMEM,
          swiglu ? (const void*)dense_up_kernel<true>
                 : (const void*)dense_up_kernel<false>};
  g[1] = {dim3((unsigned)(tiles * (d / BN))), THREADS, K6_DOWN_SMEM,
          (const void*)dense_down_kernel};
  return err;
}

// The span down launch (K3 and K7) over n_tiles span tiles.
cudaError_t span_down(int n_tiles, int d, int f, const int* row_seg,
                      const int* seg_start, const int* rows_valid,
                      const int* tiles, const void* h, const void* w_out,
                      void* y, cudaStream_t s) {
  launch_geom::Launch g;
  const cudaError_t err = span_down_geom(n_tiles, d, &g);
  if (err != cudaSuccess) return err;
  span_down_kernel<<<g.grid, g.threads, g.smem, s>>>(
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
  launch_geom::Launch g;
  cudaError_t err = span_up_geom(n_tiles, f, swiglu, &g);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const int* rs = static_cast<const int*>(row_seg);
  const int* ss = static_cast<const int*>(seg_start);
  const int* rv = static_cast<const int*>(rows_valid);
  const int* ti = static_cast<const int*>(tiles);
  const bf16* wi = static_cast<const bf16*>(w_in);
  bf16* hb = static_cast<bf16*>(h);
  if (swiglu)
    span_up_kernel<true><<<g.grid, g.threads, g.smem, s>>>(
        xb, d, f, rs, ss, rv, ti, wi, static_cast<const bf16*>(w_gate), hb);
  else
    span_up_kernel<false><<<g.grid, g.threads, g.smem, s>>>(
        xb, d, f, rs, ss, rv, ti, wi, nullptr, hb);
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
  if (d % BN || f % BN) return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0) return (int)cudaGetLastError();
  const long long tiles = (long long)E * ((C + K6_ROWS - 1) / K6_ROWS);
  if (tiles * ((d > f ? d : f) / BN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;                 // one 1-D grid each
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_geom::Launch g[2];
  cudaError_t err = dense_geom(E, C, d, f, swiglu, g);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wi = static_cast<const bf16*>(w_in);
  bf16* hb = static_cast<bf16*>(h);
  if (swiglu)
    dense_up_kernel<true><<<g[0].grid, g[0].threads, g[0].smem, s>>>(
        xb, C, d, f, wi, static_cast<const bf16*>(w_gate), hb);
  else
    dense_up_kernel<false><<<g[0].grid, g[0].threads, g[0].smem, s>>>(
        xb, C, d, f, wi, nullptr, hb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_down_kernel<<<g[1].grid, g[1].threads, g[1].smem, s>>>(
      C, d, f, hb, static_cast<const bf16*>(w_out), static_cast<bf16*>(y));
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
  const launch_geom::Launch g = quant_up_geom(n_tiles, f, swiglu);
  const signed char* xb = static_cast<const signed char*>(xq);
  const int* rs = static_cast<const int*>(row_seg);
  const int* ss = static_cast<const int*>(seg_start);
  const int* rv = static_cast<const int*>(rows_valid);
  const int* ti = static_cast<const int*>(tiles);
  const float* fx = static_cast<const float*>(sx);
  const float* fi = static_cast<const float*>(s_in);
  if (swiglu)
    quant_span_up_kernel<true><<<g.grid, g.threads, g.smem, s>>>(
        xb, d, f, rs, ss, rv, ti, fx, fi, static_cast<const float*>(s_g),
        static_cast<const signed char*>(q_in),
        static_cast<const signed char*>(q_gate), static_cast<bf16*>(h));
  else
    quant_span_up_kernel<false><<<g.grid, g.threads, g.smem, s>>>(
        xb, d, f, rs, ss, rv, ti, fx, fi, nullptr,
        static_cast<const signed char*>(q_in), nullptr,
        static_cast<bf16*>(h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)span_down(n_tiles, d, f, rs, ss, rv, ti, h, w_out, y, s);
}

// K3's, K7's and K6's launch geometry (launch_geom.cuh): the launches
// grouped_ffn_ragged and grouped_ffn_ragged_quant make over n_tiles span
// tiles, and those grouped_ffn_dense makes for an [E, C, d] buffer.
int grouped_ffn_ragged_geometry(int d, int f, int n_tiles, int swiglu,
                                int* out) {
  launch_geom::Launch g[2];
  cudaError_t err = span_up_geom(n_tiles, f, swiglu, &g[0]);
  if (err == cudaSuccess) err = span_down_geom(n_tiles, d, &g[1]);
  if (err != cudaSuccess) return (int)err;
  return launch_geom::report_all(g, 2, out);
}

int grouped_ffn_ragged_quant_geometry(int d, int f, int n_tiles, int swiglu,
                                      int* out) {
  launch_geom::Launch g[2];
  g[0] = quant_up_geom(n_tiles, f, swiglu);
  const cudaError_t err = span_down_geom(n_tiles, d, &g[1]);
  if (err != cudaSuccess) return (int)err;
  return launch_geom::report_all(g, 2, out);
}

int grouped_ffn_dense_geometry(int E, int C, int d, int f, int swiglu,
                               int* out) {
  launch_geom::Launch g[2];
  const cudaError_t err = dense_geom(E, C, d, f, swiglu, g);
  if (err != cudaSuccess) return (int)err;
  return launch_geom::report_all(g, 2, out);
}

}  // extern "C"
