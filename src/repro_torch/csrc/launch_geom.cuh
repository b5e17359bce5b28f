// Launch geometry of the host entries, for the launch check on the card.
// Included by every kernel source; repro_torch/kernels/backend.py hashes
// it into their library names.
//
// Each source describes each of its launches by a host function that
// returns a Launch (grid, threads a block, dynamic shared memory, the
// __global__ function) and that its launch entry itself uses, and exports
// a C geometry entry per kernel that reports those launches for given
// shapes.  report() writes, for one launch, INTS ints:
//   grid x, y, z; threads a block; dynamic shared memory bytes; and from
//   cudaFuncGetAttributes of the function: static shared memory bytes,
//   registers a thread, maxThreadsPerBlock (the __launch_bounds__ and the
//   registers allow), maxDynamicSharedSizeBytes (after the entry's
//   opt-in), local (spill) bytes a thread; then
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor at those threads and
//   dynamic shared memory.
// A geometry entry returns 0, or the first cudaError it met.

#pragma once

#include <cuda_runtime.h>

namespace launch_geom {

struct Launch {
  dim3 grid;
  int threads;
  int smem;        // dynamic shared memory bytes a block
  const void* fn;  // the __global__ function
};

constexpr int INTS = 11;

inline int report(const Launch& l, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, l.fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.fn,
                                                      l.threads, l.smem);
  if (err != cudaSuccess) return (int)err;
  const int v[INTS] = {(int)l.grid.x, (int)l.grid.y, (int)l.grid.z,
                       l.threads, l.smem, (int)a.sharedSizeBytes,
                       a.numRegs, a.maxThreadsPerBlock,
                       a.maxDynamicSharedSizeBytes, (int)a.localSizeBytes,
                       blocks};
  for (int i = 0; i < INTS; ++i) out[i] = v[i];
  return 0;
}

inline int report_all(const Launch* ls, int n, int* out) {
  for (int i = 0; i < n; ++i) {
    const int err = report(ls[i], out + INTS * i);
    if (err != 0) return err;
  }
  return 0;
}

// The current device's limits: max threads a block, max grid x, y, z, the
// opt-in shared memory a block, shared memory an SM, 32-bit registers an
// SM, max threads an SM, max registers a block.
inline int device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const cudaDeviceAttr attrs[9] = {
      cudaDevAttrMaxThreadsPerBlock, cudaDevAttrMaxGridDimX,
      cudaDevAttrMaxGridDimY, cudaDevAttrMaxGridDimZ,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxRegistersPerBlock};
  for (int i = 0; i < 9; ++i) {
    err = cudaDeviceGetAttribute(out + i, attrs[i], dev);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace launch_geom
