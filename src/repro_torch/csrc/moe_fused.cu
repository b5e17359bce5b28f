// Fused local MoE (dispatch gather -> expert FFN -> weighted combine) for
// Hopper, sm_90a.  Built by repro_torch/kernels/backend.py with nvcc into a
// shared library with a plain C interface; called through ctypes from
// repro_torch/kernels/moe_fused/ops.py (local_moe, compact_slots,
// token_rows).
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
//     output resident in VMEM, and its sequential grid adds each slot's
//     finished row into the output in slot order, race-free.  Here blocks
//     run in parallel, so each slot's row is finished into a scratch first
//     and a last launch sums every token's rows in that same slot order:
//     no float atomics, and repeated calls on one input give equal bits.
//   * The TPU kernel holds a [bc, d] f32 accumulator across f-blocks (512 KiB
//     at bc=128, d=1024), more than a Hopper block's 227 KB of shared memory.
//     Here the FFN is two launches over one list of 64-row tiles (no tile
//     straddles two segments), between the launches that index the slots
//     and the one that combines them:
//       0. compact: per segment, the slots below rows_valid whose slot_w is
//                   nonzero and whose token is in [0, T), in their order,
//                   into live (-1 past the segment's count), each tile's
//                   number of them into tile_nv, and each token's number
//                   of them into a zeroed count (integer atomics: the
//                   counts do not depend on their order);
//       1. scan:    one block: the exclusive scan of the counts, row_ptr;
//       2. fill:    a block per tile: each live row's tile row (tile * 64 +
//                   its place in the tile) and slot_w into its token's
//                   list, rows [row_ptr[t], row_ptr[t + 1]), at a place
//                   claimed by an integer atomic: the token index, a CSR
//                   by token;
//       3. up:      gather the live slots' rows of x, x @ w_in (and
//                   w_gate), activation, round to bf16, write h;
//       4. down:    h @ w_out with f32 sums, each split's unweighted sums
//                   stored (not added) at the row's tile row of y;
//       5. combine: a block per token sorts its list ascending (tile rows
//                   ascend with slots, within and across segments, so that
//                   is slot order), then writes out[t] once: 0, then
//                   += slot_w * (y's splits summed in split order) over the
//                   list.  A token with no live slot gets an exact zero row.
//   * Only rows with a combine weight are computed.  The gather path's
//     dense slot grid maps every token through every expert a token picked
//     (a 4 x 128 prefill pack: 64 x 512 slots, of which about 1024 carry a
//     weight), and a slot whose weight is 0 adds nothing to out, so the
//     compaction (a block per segment, a warp-ballot prefix; no host
//     synchronisation) leaves the FFN launches those rows alone: about 64
//     of the 512 prefill tiles hold any, each about 16 rows.  A tile with
//     none returns after reading one int.
//
// What bounds it on this card: the touched experts' weights' bytes (decode:
// at most 16 experts a layer, 128 MB; prefill: the 64 experts, 512 MB; the
// one-rank training layout about the same), so the memory rate.  The
// launches keep the weights streaming: each tile product is the cp.async
// ring into mma.m16n8k16 of csrc/moe_mma.cuh (only the 16-row fragments
// that hold live rows are multiplied), the activation and the store of y
// read the sums straight from the accumulators, and when the segments are
// narrow (the decode layout: a few live rows in at most 16 tiles) the down
// launch splits its f reduction over `splits` blocks, which fills the
// card.  The ordered combine costs one f32 write and read of the live rows
// (16 MB at the one-rank layout's 4096 rows of d = 1024) and three small
// launches; the output needs no zeroing, and no sum makes a round trip
// through L2 as an atomic would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_geom.cuh"
#include "moe_mma.cuh"

namespace {

using namespace moe_mma;

constexpr int TILE_INTS = 5;  // per tile: first slot, expert, segment,
                              // offset into the segment, rows in the tile
constexpr int COMPACT_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int COMBINE_THREADS = 256;
// ring depths: 3 stages (48 KB for gelu's up and the down launch) leave
// room for four blocks an SM, which measured faster on an H100 than 2 or
// 4 stages at the decode and prefill layouts
constexpr int UP_STAGES = 3, DOWN_STAGES = 3;
constexpr int UP_SMEM = ring_bytes(UP_STAGES, 1);           // 48 KB
constexpr int UP_SMEM_SWIGLU = ring_bytes(UP_STAGES, 2);    // 72 KB
constexpr int DOWN_SMEM = ring_bytes(DOWN_STAGES, 1);       // 48 KB

// One block per segment s: the slots start + i, i < min(rows_valid[s],
// width), with slot_w != 0 and a token in [0, T), in order, into
// live[start ...] with -1 after them; count[s] their number; tile_nv[b]
// of the segment's tiles b = tile0[s] + j the live rows of rows
// [64 j, 64 j + 64); tok_count[t] (zeroed by the caller) += the live
// slots of token t.  tile0, tile_nv and tok_count may be null.
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const int* __restrict__ slot_to_token,
               const float* __restrict__ slot_w,
               const int* __restrict__ rows_valid,
               const int* __restrict__ seg_offsets,
               const int* __restrict__ tile0, int T, int* __restrict__ live,
               int* __restrict__ count, int* __restrict__ tile_nv,
               int* __restrict__ tok_count) {
  __shared__ int warp_n[COMPACT_THREADS / 32];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int start = seg_offsets[s], width = seg_offsets[s + 1] - start;
  const int n = max(0, min(rows_valid[s], width));
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += COMPACT_THREADS) {
    const int i = c0 + tid;
    bool keep = false;
    int t = 0;
    if (i < n) {
      t = slot_to_token[start + i];
      keep = slot_w[start + i] != 0.0f && t >= 0 && t < T;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < COMPACT_THREADS / 32; ++w) {
      before += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (keep) {
      live[start + base + before + __popc(m & ((1u << lane) - 1u))] =
          start + i;
      if (tok_count != nullptr) atomicAdd(tok_count + t, 1);
    }
    base += total;
    __syncthreads();                     // warp_n is rewritten next chunk
  }
  for (int i = base + tid; i < width; i += COMPACT_THREADS)
    live[start + i] = -1;
  if (tile_nv != nullptr)
    for (int j = tid; j * BM < width; j += COMPACT_THREADS)
      tile_nv[tile0[s] + j] = max(0, min(base - j * BM, BM));
  if (tid == 0) count[s] = base;
}

// One block: row_ptr[0 .. T] the exclusive scan of tok_count[0 .. T), which
// it zeroes behind it (the fill's cursors).
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int* __restrict__ tok_count, int* __restrict__ row_ptr, int T) {
  constexpr int NW = SCAN_THREADS / 32;
  __shared__ int warp_sum[NW];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int carry = 0;
  for (int c0 = 0; c0 < T; c0 += SCAN_THREADS) {
    const int t = c0 + tid;
    const int v = t < T ? tok_count[t] : 0;
    if (t < T) tok_count[t] = 0;
    int x = v;                               // inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {                         // inclusive scan of the warps
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < NW; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (t < T) row_ptr[t] = carry + (warp > 0 ? warp_sum[warp - 1] : 0) +
                            x - v;
    carry += warp_sum[NW - 1];
    __syncthreads();                     // warp_sum is rewritten next chunk
  }
  if (tid == 0) row_ptr[T] = carry;
}

// A block per tile b: its live rows' tile rows b * 64 + j and slot
// weights into their tokens' lists, each at a place claimed from
// cursor[t] (zero after the scan): the lists' order is the atomics', which
// the combine sorts.
__global__ void __launch_bounds__(BM)
fill_kernel(const int* __restrict__ slot_to_token,
            const float* __restrict__ slot_w, const int* __restrict__ live,
            const int* __restrict__ tile_nv, const int* __restrict__ tiles,
            const int* __restrict__ row_ptr, int* __restrict__ cursor,
            int* __restrict__ rows, float* __restrict__ wts) {
  const int b = blockIdx.x, j = threadIdx.x;
  if (j >= tile_nv[b]) return;
  const int slot = live[tiles[b * TILE_INTS] + j];
  const int t = slot_to_token[slot];
  const int at = row_ptr[t] + atomicAdd(cursor + t, 1);
  rows[at] = b * BM + j;
  wts[at] = slot_w[slot];
}

template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
fused_up_kernel(const bf16* __restrict__ x, int d, int f,
                const int* __restrict__ slot_to_token,
                const int* __restrict__ live,
                const int* __restrict__ tile_nv,
                const int* __restrict__ tiles,
                const bf16* __restrict__ w_in,
                const bf16* __restrict__ w_gate, bf16* __restrict__ h) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int a_row[BM];
  const int b = blockIdx.x, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const int nv = tile_nv[b];
  if (nv == 0) return;                       // no live row: no loads
  const int first = tiles[b * TILE_INTS + 0];
  const int eid = tiles[b * TILE_INTS + 1];
  if (tid < BM) a_row[tid] = tid < nv ? slot_to_token[live[first + tid]] : -1;
  __syncthreads();
  const size_t wofs = (size_t)eid * d * f;
  up_tile<SWIGLU, UP_STAGES>(dsmem, x, a_row, (nv + 15) / 16, d, f, n0,
                             w_in + wofs, SWIGLU ? w_gate + wofs : nullptr,
                             h + (size_t)b * BM * f);
}

// blockIdx.z takes reduction rows [z f / splits, (z + 1) f / splits) of
// h @ w_out[eid] and stores its f32 sums of every live row of tile b at
// rows b * 64 + r of y's split z ([splits, n_tiles * 64, d]); no two
// blocks store one element.
__global__ void __launch_bounds__(THREADS)
fused_down_kernel(int d, int f, const int* __restrict__ tile_nv,
                  const int* __restrict__ tiles,
                  const bf16* __restrict__ h,
                  const bf16* __restrict__ w_out, float* __restrict__ y,
                  size_t split_stride) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int a_row[BM];
  const int b = blockIdx.x, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const int nv = tile_nv[b];
  if (nv == 0) return;
  const int eid = tiles[b * TILE_INTS + 1];
  if (tid < BM) a_row[tid] = tid < nv ? tid : -1;
  __syncthreads();
  const int mf = (nv + 15) / 16, span = f / gridDim.z;
  const bf16* wb[1] = {w_out + (size_t)eid * f * d + n0};
  float acc[1][MFRAGS][2][4];
  tile_product<1, DOWN_STAGES>(dsmem, h + (size_t)b * BM * f, a_row, f, wb,
                               d, blockIdx.z * span, (blockIdx.z + 1) * span,
                               mf, acc);
  const int warp = tid / 32, lane = tid % 32;
  const int col = n0 + warp * 16 + 2 * (lane % 4);
  float* yb = y + blockIdx.z * split_stride + (size_t)b * BM * d + col;
#pragma unroll
  for (int i = 0; i < MFRAGS; ++i) {
    if (i >= mf) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = i * 16 + lane / 4 + hr * 8;
      if (r >= nv) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(yb + (size_t)r * d + j * 8) =
            make_float2(acc[0][i][j][2 * hr], acc[0][i][j][2 * hr + 1]);
    }
  }
}

// A block per token t: sorts its list (rows[row_ptr[t] ..) and their
// weights) by row, ascending, in place (one thread; a token has a few
// rows), then, unless y is null (the index alone), writes out[t] = sum
// over the list in that order of its weight * (y's splits summed in split
// order), from 0.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const int* __restrict__ row_ptr, int* rows, float* wts,
               const float* __restrict__ y, size_t split_stride, int splits,
               int d, float* __restrict__ out) {
  const int t = blockIdx.x, tid = threadIdx.x;
  const int r0 = row_ptr[t], n = row_ptr[t + 1] - r0;
  int* list = rows + r0;
  float* wl = wts + r0;
  if (tid == 0)
    for (int i = 1; i < n; ++i) {
      const int v = list[i];
      const float wv = wl[i];
      int j = i - 1;
      for (; j >= 0 && list[j] > v; --j) {
        list[j + 1] = list[j];
        wl[j + 1] = wl[j];
      }
      list[j + 1] = v;
      wl[j + 1] = wv;
    }
  __syncthreads();                           // the sorted list is visible
  if (y == nullptr) return;
  for (int c = 4 * tid; c < d; c += 4 * COMBINE_THREADS) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < n; ++i) {
      const int r = list[i];
      const float w = wl[i];
      const float* yr = y + (size_t)r * d + c;
      float4 v = *reinterpret_cast<const float4*>(yr);
      for (int z = 1; z < splits; ++z) {
        const float4 u =
            *reinterpret_cast<const float4*>(yr + z * split_stride);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    *reinterpret_cast<float4*>(out + (size_t)t * d + c) = acc;
  }
}

unsigned long long up_opt_in[2], down_opt_in;   // per-device bit masks

// The compaction's launch over n_seg segments.
launch_geom::Launch compact_geom(int n_seg) {
  return {dim3(n_seg), COMPACT_THREADS, 0, (const void*)compact_kernel};
}

// The token index's launches after the compaction: the scan, the fill
// over n_tiles tiles, and the combine over T tokens.
void index_geom(int n_tiles, int T, launch_geom::Launch* g) {
  g[0] = {dim3(1), SCAN_THREADS, 0, (const void*)scan_kernel};
  g[1] = {dim3(n_tiles), BM, 0, (const void*)fill_kernel};
  g[2] = {dim3(T), COMBINE_THREADS, 0, (const void*)combine_kernel};
}

// K4's six launches for one call, in their order: the compaction, the
// scan, the fill, up over (tile, f / 64), down over (tile, d / 64,
// splits) and the combine; after opting the up and down kernels in to
// their dynamic shared memory.
cudaError_t fused_geom(int n_seg, int n_tiles, int T, int d, int f,
                       int swiglu, int splits, launch_geom::Launch* g) {
  cudaError_t err =
      swiglu ? smem_opt_in(fused_up_kernel<true>, UP_SMEM_SWIGLU, up_opt_in[1])
             : smem_opt_in(fused_up_kernel<false>, UP_SMEM, up_opt_in[0]);
  if (err != cudaSuccess) return err;
  err = smem_opt_in(fused_down_kernel, DOWN_SMEM, down_opt_in);
  if (err != cudaSuccess) return err;
  launch_geom::Launch ix[3];
  index_geom(n_tiles, T, ix);
  g[0] = compact_geom(n_seg);
  g[1] = ix[0];
  g[2] = ix[1];
  g[3] = {dim3(n_tiles, f / BN), THREADS, swiglu ? UP_SMEM_SWIGLU : UP_SMEM,
          swiglu ? (const void*)fused_up_kernel<true>
                 : (const void*)fused_up_kernel<false>};
  g[4] = {dim3(n_tiles, d / BN, splits), THREADS, DOWN_SMEM,
          (const void*)fused_down_kernel};
  g[5] = ix[2];
  return cudaSuccess;
}

// The index scratch, 4-byte words [2 T + 1 + 2 R], R = n_tiles * 64 (at
// least the live rows): the per-token counts (then the fill's cursors),
// row_ptr [T + 1], the lists' tile rows [R] and their weights [R] (f32).
struct Index {
  int* tok_count;
  int* row_ptr;
  int* rows;
  float* wts;
};

Index index_at(void* index, int T, int n_tiles) {
  int* p = static_cast<int*>(index);
  return {p, p + T, p + 2 * T + 1,
          reinterpret_cast<float*>(p + 2 * T + 1 + n_tiles * BM)};
}

// The compaction, the scan and the fill, on stream s.
cudaError_t launch_index(const launch_geom::Launch* g, const int* tok,
                         const float* sw, const int* rows_valid,
                         const int* seg_offsets, const int* tiles,
                         const int* tile0, int T, int* live, int* count,
                         int* tile_nv, const Index& ix, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(ix.tok_count, 0, sizeof(int) * T, s);
  if (err != cudaSuccess) return err;
  compact_kernel<<<g[0].grid, g[0].threads, g[0].smem, s>>>(
      tok, sw, rows_valid, seg_offsets, tile0, T, live, count, tile_nv,
      ix.tok_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<g[1].grid, g[1].threads, g[1].smem, s>>>(ix.tok_count,
                                                         ix.row_ptr, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fill_kernel<<<g[2].grid, g[2].threads, g[2].smem, s>>>(
      tok, sw, live, tile_nv, tiles, ix.row_ptr, ix.tok_count, ix.rows,
      ix.wts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int moe_fused_tile_rows() { return BM; }

// The compaction alone.  slot_to_token [S] i32; slot_w [S] f32;
// rows_valid [n_seg] i32; seg_offsets [n_seg + 1] i32 (seg_offsets[0] = 0,
// seg_offsets[n_seg] = S); live [S] i32 and count [n_seg] i32 written.
int compact_slots(const void* slot_to_token, const void* slot_w,
                  const void* rows_valid, const void* seg_offsets, int n_seg,
                  int T, void* live, void* count, void* stream) {
  if (n_seg == 0) return (int)cudaGetLastError();
  const launch_geom::Launch g = compact_geom(n_seg);
  compact_kernel<<<g.grid, g.threads, g.smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot_to_token),
      static_cast<const float*>(slot_w), static_cast<const int*>(rows_valid),
      static_cast<const int*>(seg_offsets), nullptr, T,
      static_cast<int*>(live), static_cast<int*>(count), nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The token index alone: the compaction, the scan, the fill and the
// combine's sort, as local_moe_fused runs them.  Arguments as
// local_moe_fused's; index ([2 T + 1 + 2 n_tiles * 64] words) ends holding
// the counts, row_ptr [T + 1] and each token's tile rows, ascending, at
// rows [row_ptr[t], row_ptr[t + 1]), their weights after them.  T and
// n_tiles must be at least 1.
int token_rows(const void* slot_to_token, const void* slot_w,
               const void* rows_valid, const void* seg_offsets, int n_seg,
               const void* tiles, const void* tile0, int n_tiles, int T,
               void* live, void* count, void* tile_nv, void* index,
               void* stream) {
  if (n_seg < 1 || n_tiles < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_geom::Launch g[4];
  g[0] = compact_geom(n_seg);
  index_geom(n_tiles, T, g + 1);
  const Index ix = index_at(index, T, n_tiles);
  cudaError_t err = launch_index(
      g, static_cast<const int*>(slot_to_token),
      static_cast<const float*>(slot_w), static_cast<const int*>(rows_valid),
      static_cast<const int*>(seg_offsets), static_cast<const int*>(tiles),
      static_cast<const int*>(tile0), T, static_cast<int*>(live),
      static_cast<int*>(count), static_cast<int*>(tile_nv), ix, s);
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<g[3].grid, g[3].threads, g[3].smem, s>>>(
      ix.row_ptr, ix.rows, ix.wts, nullptr, 0, 1, 0, nullptr);
  return (int)cudaGetLastError();
}

// All pointers are device pointers on the current device.  x [T, d] bf16;
// slot_to_token [S] i32; slot_w [S] f32; rows_valid [n_seg] i32;
// seg_offsets [n_seg + 1] i32; tiles [n_tiles, 5] i32, segment by segment,
// a segment's tiles in order; tile0 [n_seg] i32, each segment's first tile;
// w_in/w_gate [E, d, f] bf16 (w_gate unused unless swiglu); w_out [E, f, d]
// bf16; scratch: live [S], count [n_seg], tile_nv [n_tiles] i32, h
// [n_tiles * 64, f] bf16, y [splits, n_tiles * 64, d] f32 (16-byte
// aligned) and index [2 T + 1 + 2 n_tiles * 64] 4-byte words; out [T, d]
// f32, every row written.
// d must be a multiple of 64, f of 64 * splits.
int local_moe_fused(const void* x, int T, int d, int f,
                    const void* slot_to_token, const void* slot_w,
                    const void* rows_valid, const void* seg_offsets,
                    int n_seg, const void* tiles, const void* tile0,
                    int n_tiles, const void* w_in, const void* w_gate,
                    const void* w_out, void* live, void* count,
                    void* tile_nv, void* h, void* y, void* index, void* out,
                    int swiglu, int splits, void* stream) {
  if (d % BK || f % BN || splits < 1 || f % (BK * splits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaGetLastError();
  if (n_tiles == 0)                          // no slot: every row is zero
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * T * d, s);
  launch_geom::Launch g[6];
  cudaError_t err = fused_geom(n_seg, n_tiles, T, d, f, swiglu, splits, g);
  if (err != cudaSuccess) return (int)err;
  const int* tok = static_cast<const int*>(slot_to_token);
  const float* sw = static_cast<const float*>(slot_w);
  const int* ti = static_cast<const int*>(tiles);
  int* lv = static_cast<int*>(live);
  int* nv = static_cast<int*>(tile_nv);
  const Index ix = index_at(index, T, n_tiles);
  err = launch_index(g, tok, sw, static_cast<const int*>(rows_valid),
                     static_cast<const int*>(seg_offsets), ti,
                     static_cast<const int*>(tile0), T, lv,
                     static_cast<int*>(count), nv, ix, s);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wi = static_cast<const bf16*>(w_in);
  bf16* hb = static_cast<bf16*>(h);
  if (swiglu)
    fused_up_kernel<true><<<g[3].grid, g[3].threads, g[3].smem, s>>>(
        xb, d, f, tok, lv, nv, ti, wi, static_cast<const bf16*>(w_gate), hb);
  else
    fused_up_kernel<false><<<g[3].grid, g[3].threads, g[3].smem, s>>>(
        xb, d, f, tok, lv, nv, ti, wi, nullptr, hb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* yf = static_cast<float*>(y);
  const size_t split_stride = (size_t)n_tiles * BM * d;
  fused_down_kernel<<<g[4].grid, g[4].threads, g[4].smem, s>>>(
      d, f, nv, ti, hb, static_cast<const bf16*>(w_out), yf, split_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<g[5].grid, g[5].threads, g[5].smem, s>>>(
      ix.row_ptr, ix.rows, ix.wts, yf, split_stride, splits, d,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// K4's launch geometry (launch_geom.cuh): the six launches
// local_moe_fused makes for n_seg segments, n_tiles tiles and T tokens.
int local_moe_fused_geometry(int n_seg, int n_tiles, int T, int d, int f,
                             int swiglu, int splits, int* out) {
  launch_geom::Launch g[6];
  const cudaError_t err = fused_geom(n_seg, n_tiles, T, d, f, swiglu,
                                     splits, g);
  if (err != cudaSuccess) return (int)err;
  return launch_geom::report_all(g, 6, out);
}

}  // extern "C"
