// Fused local MoE (dispatch gather -> expert FFN -> weighted combine) for
// Hopper, sm_90a.  Built by repro_torch/kernels/backend.py with nvcc into a
// shared library with a plain C interface; called through ctypes from
// repro_torch/kernels/moe_fused/ops.py (local_moe, compact_slots).
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
//     Here the FFN is two launches over one list of 64-row tiles (no tile
//     straddles two segments), after a compaction launch:
//       0. compact: per segment, the slots below rows_valid whose slot_w is
//                   nonzero and whose token is in [0, T), in their order,
//                   into live (-1 past the segment's count), and each
//                   tile's number of them into tile_nv;
//       1. up:      gather the live slots' rows of x, x @ w_in (and
//                   w_gate), activation, round to bf16, write h;
//       2. down:    h @ w_out with f32 sums, then atomicAdd of the
//                   slot_w-weighted rows into out.
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
// that hold live rows are multiplied), the activation and the weighted
// atomic combine read the sums straight from the accumulators, and when
// the segments are narrow (the decode layout: a few live rows in at most
// 16 tiles) the down launch splits its f reduction over `splits` blocks
// that each add their share to out, which fills the card.

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
// [64 j, 64 j + 64).
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const int* __restrict__ slot_to_token,
               const float* __restrict__ slot_w,
               const int* __restrict__ rows_valid,
               const int* __restrict__ seg_offsets,
               const int* __restrict__ tile0, int T, int* __restrict__ live,
               int* __restrict__ count, int* __restrict__ tile_nv) {
  __shared__ int warp_n[COMPACT_THREADS / 32];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int start = seg_offsets[s], width = seg_offsets[s + 1] - start;
  const int n = max(0, min(rows_valid[s], width));
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += COMPACT_THREADS) {
    const int i = c0 + tid;
    bool keep = false;
    if (i < n) {
      const int t = slot_to_token[start + i];
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
    if (keep)
      live[start + base + before + __popc(m & ((1u << lane) - 1u))] =
          start + i;
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
// h @ w_out[eid] and adds its weighted share of every live row into out.
__global__ void __launch_bounds__(THREADS)
fused_down_kernel(int d, int f, const int* __restrict__ slot_to_token,
                  const float* __restrict__ slot_w,
                  const int* __restrict__ live,
                  const int* __restrict__ tile_nv,
                  const int* __restrict__ tiles,
                  const bf16* __restrict__ h,
                  const bf16* __restrict__ w_out, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int a_row[BM], tok_s[BM];
  __shared__ float w_s[BM];
  const int b = blockIdx.x, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const int nv = tile_nv[b];
  if (nv == 0) return;
  const int first = tiles[b * TILE_INTS + 0];
  const int eid = tiles[b * TILE_INTS + 1];
  if (tid < BM) {
    a_row[tid] = tid < nv ? tid : -1;
    if (tid < nv) {
      const int slot = live[first + tid];
      tok_s[tid] = slot_to_token[slot];
      w_s[tid] = slot_w[slot];
    }
  }
  __syncthreads();
  const int mf = (nv + 15) / 16, span = f / gridDim.z;
  const bf16* wb[1] = {w_out + (size_t)eid * f * d + n0};
  float acc[1][MFRAGS][2][4];
  tile_product<1, DOWN_STAGES>(dsmem, h + (size_t)b * BM * f, a_row, f, wb,
                               d, blockIdx.z * span, (blockIdx.z + 1) * span,
                               mf, acc);
  // combine: scatter-accumulate the weighted rows into token order
  const int warp = tid / 32, lane = tid % 32;
  const int col = n0 + warp * 16 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < MFRAGS; ++i) {
    if (i >= mf) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = i * 16 + lane / 4 + hr * 8;
      if (r >= nv) continue;
      float* o = out + (size_t)tok_s[r] * d + col;
      const float w = w_s[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        atomicAdd(o + j * 8, w * acc[0][i][j][2 * hr]);
        atomicAdd(o + j * 8 + 1, w * acc[0][i][j][2 * hr + 1]);
      }
    }
  }
}

unsigned long long up_opt_in[2], down_opt_in;   // per-device bit masks

// The compaction's launch over n_seg segments.
launch_geom::Launch compact_geom(int n_seg) {
  return {dim3(n_seg), COMPACT_THREADS, 0, (const void*)compact_kernel};
}

// K4's three launches for one call (the compaction, up over (tile, f /
// 64), down over (tile, d / 64, splits)), after opting the up and down
// kernels in to their dynamic shared memory.
cudaError_t fused_geom(int n_seg, int n_tiles, int d, int f, int swiglu,
                       int splits, launch_geom::Launch* g) {
  cudaError_t err =
      swiglu ? smem_opt_in(fused_up_kernel<true>, UP_SMEM_SWIGLU, up_opt_in[1])
             : smem_opt_in(fused_up_kernel<false>, UP_SMEM, up_opt_in[0]);
  if (err != cudaSuccess) return err;
  err = smem_opt_in(fused_down_kernel, DOWN_SMEM, down_opt_in);
  if (err != cudaSuccess) return err;
  g[0] = compact_geom(n_seg);
  g[1] = {dim3(n_tiles, f / BN), THREADS, swiglu ? UP_SMEM_SWIGLU : UP_SMEM,
          swiglu ? (const void*)fused_up_kernel<true>
                 : (const void*)fused_up_kernel<false>};
  g[2] = {dim3(n_tiles, d / BN, splits), THREADS, DOWN_SMEM,
          (const void*)fused_down_kernel};
  return cudaSuccess;
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
      static_cast<int*>(live), static_cast<int*>(count), nullptr);
  return (int)cudaGetLastError();
}

// All pointers are device pointers on the current device.  x [T, d] bf16;
// slot_to_token [S] i32; slot_w [S] f32; rows_valid [n_seg] i32;
// seg_offsets [n_seg + 1] i32; tiles [n_tiles, 5] i32, segment by segment,
// a segment's tiles in order; tile0 [n_seg] i32, each segment's first tile;
// w_in/w_gate [E, d, f] bf16 (w_gate unused unless swiglu); w_out [E, f, d]
// bf16; scratch: live [S], count [n_seg], tile_nv [n_tiles] i32 and h
// [n_tiles * 64, f] bf16; out [T, d] f32, zeroed by the caller.  d must be
// a multiple of 64, f of 64 * splits.
int local_moe_fused(const void* x, int T, int d, int f,
                    const void* slot_to_token, const void* slot_w,
                    const void* rows_valid, const void* seg_offsets,
                    int n_seg, const void* tiles, const void* tile0,
                    int n_tiles, const void* w_in, const void* w_gate,
                    const void* w_out, void* live, void* count,
                    void* tile_nv, void* h, void* out, int swiglu, int splits,
                    void* stream) {
  if (d % BK || f % BN || splits < 1 || f % (BK * splits))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  launch_geom::Launch g[3];
  cudaError_t err = fused_geom(n_seg, n_tiles, d, f, swiglu, splits, g);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tok = static_cast<const int*>(slot_to_token);
  const float* sw = static_cast<const float*>(slot_w);
  const int* ti = static_cast<const int*>(tiles);
  int* lv = static_cast<int*>(live);
  int* nv = static_cast<int*>(tile_nv);
  compact_kernel<<<g[0].grid, g[0].threads, g[0].smem, s>>>(
      tok, sw, static_cast<const int*>(rows_valid),
      static_cast<const int*>(seg_offsets), static_cast<const int*>(tile0),
      T, lv, static_cast<int*>(count), nv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wi = static_cast<const bf16*>(w_in);
  bf16* hb = static_cast<bf16*>(h);
  if (swiglu)
    fused_up_kernel<true><<<g[1].grid, g[1].threads, g[1].smem, s>>>(
        xb, d, f, tok, lv, nv, ti, wi, static_cast<const bf16*>(w_gate), hb);
  else
    fused_up_kernel<false><<<g[1].grid, g[1].threads, g[1].smem, s>>>(
        xb, d, f, tok, lv, nv, ti, wi, nullptr, hb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_down_kernel<<<g[2].grid, g[2].threads, g[2].smem, s>>>(
      d, f, tok, sw, lv, nv, ti, hb, static_cast<const bf16*>(w_out),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// K4's launch geometry (launch_geom.cuh): the three launches
// local_moe_fused makes for n_seg segments and n_tiles tiles.
int local_moe_fused_geometry(int n_seg, int n_tiles, int d, int f,
                             int swiglu, int splits, int* out) {
  launch_geom::Launch g[3];
  const cudaError_t err = fused_geom(n_seg, n_tiles, d, f, swiglu, splits,
                                     g);
  if (err != cudaSuccess) return (int)err;
  return launch_geom::report_all(g, 3, out);
}

}  // extern "C"
