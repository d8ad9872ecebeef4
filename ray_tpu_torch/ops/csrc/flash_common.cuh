// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, out and their gradients are [B, T, H, D] row-major, so one
// head's rows are D contiguous elements H*D apart. A block reads them in place;
// nothing is transposed or copied into a [B*H, T, D] layout first.
//
// The f32 kernels (the first version, kept for f32 inputs: no tensor-core
// path on this card computes full f32) use the tile helpers below: a tile of
// 16*W rows is owned by a block of W warps, and warp w owns rows [16w, 16w+16)
// of it for every product and every row-wise step, so the only block-wide
// barriers are around loading a shared tile. warp_mm multiplies a warp's
// 16-row strip by a tile in shared memory into a float strip in shared
// memory with scalar FMA, so an f32 run keeps full f32 precision (no TF32).
// The bf16 kernels build on flash_sm90.cuh instead; the masks and loop bounds
// at the end of this file serve both.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

constexpr int kStrip = 16;  // rows per warp
// Rows of an f32 tile: 32 keep the largest kernel (dK/dV at D = 128) inside
// one SM's 227 KB of shared memory.
constexpr int kF32Tile = 32;

// Copy rows [row0, row0 + rows) of one head into a dense [rows, D] tile,
// 16 bytes per thread per step; rows at or past `len` are zero-filled.
// `src` points at row 0 of the head; `stride` is H * D elements.
template <int D>
__device__ void load_tile(float* dst, const float* src, int row0, int rows, int len, int stride) {
  constexpr int kChunks = D * (int)sizeof(float) / 16;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len) val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride)[c];
    reinterpret_cast<uint4*>(dst + r * D)[c] = val;
  }
}

// Rows [row0, row0 + rows) of a per-row f32 vector ([B*H, T], one head at
// `src`), zero past `len`.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows, int len) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) dst[i] = row0 + i < len ? src[row0 + i] : 0.f;
}

// Write a warp's [16, D] f32 strip to rows [row0, row0 + 16) of one head,
// skipping rows at or past `len`.
template <int D>
__device__ void store_strip(float* dst, const float* strip, int row0, int len, int stride) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < kStrip * D; i += 32) {
    const int r = i / D, d = i % D;
    if (row0 + r < len) dst[(size_t)(row0 + r) * stride + d] = strip[i];
  }
}

// C[16, N] = (accumulate ? C : 0) + A[16, K] * B[K, N], for one warp.
// A is row-major with leading dimension lda. B is row-major [K, N] with
// leading dimension ldb, or, when B_T, the transpose of a row-major [N, K]
// tile (element (k, n) at B[n * ldb + k]). C is row-major with ldc. All of
// A, B, C live in shared memory; C is complete for every lane on return.
// N is a multiple of 32, so a warp's 32 outputs of one step share the row m;
// each lane starts the k-loop at its own offset so the 32 lanes read 32
// different banks of A and B.
template <bool B_T, int N, int K>
__device__ void warp_mm(const float* A, int lda, const float* B, int ldb, float* C, int ldc, bool accumulate) {
  static_assert(N % 32 == 0 && K % 32 == 0, "tile widths are multiples of 32");
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < kStrip * N; i += 32) {
    const int m = i / N, n = i % N;
    float s = accumulate ? C[m * ldc + n] : 0.f;
    const float* a = A + m * lda;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      int kk = k + lane;
      if (kk >= K) kk -= K;
      const float b = B_T ? B[n * ldb + kk] : B[kk * ldb + n];
      s = fmaf(a[kk], b, s);
    }
    C[m * ldc + n] = s;
  }
  __syncwarp();
}

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
