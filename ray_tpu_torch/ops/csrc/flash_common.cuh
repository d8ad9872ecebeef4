// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, out and their gradients are [B, T, H, D] row-major, so one
// head's rows are D contiguous elements H*D apart. A block reads them in place;
// nothing is transposed or copied into a [B*H, T, D] layout first.
//
// The kernels build on flash_sm90.cuh (bf16) and flash_tf32.cuh (f32); the
// masks and loop bounds here serve all of them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

// Is key `kpos` visible from query row `qpos` (both absolute positions, with
// the query already shifted by Tk - Tq so the causal mask is bottom-right
// aligned)? Keys at or past Tk are padding of the last tile.
__device__ __forceinline__ bool visible(int qpos, int kpos, int Tk, int causal, int window) {
  if (kpos >= Tk) return false;
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

// Key tiles [*begin, *end) that rows [q0, q_last] can see: the causal and
// sliding-window pruning of the TPU kernels' k loops, with `offset` = Tk - Tq.
__device__ __forceinline__ void key_tile_range(int q0, int q_last, int offset, int Tk, int bk, int causal,
                                               int window, int* begin, int* end) {
  const int n = (Tk + bk - 1) / bk;
  *begin = 0;
  *end = n;
  if (!causal) return;
  const int last_key = q_last + offset;
  *end = last_key < 0 ? 0 : min(n, last_key / bk + 1);
  if (window > 0) {
    const int first_key = q0 + offset - window + 1;
    *begin = first_key <= 0 ? 0 : min(first_key / bk, *end);
  }
}

// Let `kernel` use `bytes` of dynamic shared memory: above 48 KB a launch is
// refused without this.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// What `kernel` takes on the current device, launched with `threads` threads
// and `smem` bytes of dynamic shared memory: info = {registers per thread,
// shared memory per block, blocks that fit on one SM, threads per block,
// local memory per thread (spills)}. Returns a cudaError_t.
template <typename Kernel>
inline int kernel_info(Kernel kernel, size_t smem, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)(attr.sharedSizeBytes + smem);
  info[2] = blocks;
  info[3] = threads;
  info[4] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace rtt
