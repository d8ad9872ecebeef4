// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, out and their gradients are [B, T, H, D] row-major, so one
// head's rows are D contiguous elements H*D apart. A block reads them in place;
// nothing is transposed or copied into a [B*H, T, D] layout first.
//
// Work split: a tile of 16*W rows is owned by a block of W warps, and warp w
// owns rows [16w, 16w+16) of it for every product and every row-wise step. So
// the only block-wide barriers are around loading a shared tile; everything a
// warp computes for its own rows needs just __syncwarp().
//
// Products: warp_mm below multiplies a 16-row strip by a tile in shared
// memory into a float strip in shared memory. bf16 inputs go through the
// tensor cores with WMMA (16x16x16, f32 accumulation); f32 inputs through
// scalar FMA, so an f32 run keeps full f32 precision (no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace rtt {

constexpr int kStrip = 16;  // rows per warp: the height of one WMMA tile

template <typename E>
__device__ __forceinline__ E from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Tile edge for element type E: 64 rows for bf16, 32 for f32, which keeps the
// largest kernel (dK/dV at D = 128) inside one SM's 227 KB of shared memory.
template <typename E>
__host__ __device__ constexpr int tile_rows() { return std::is_same<E, float>::value ? 32 : 64; }

// Copy rows [row0, row0 + rows) of one head into a dense [rows, D] tile,
// 16 bytes per thread per step; rows at or past `len` are zero-filled.
// `src` points at row 0 of the head; `stride` is H * D elements.
template <typename E, int D>
__device__ void load_tile(E* dst, const E* src, int row0, int rows, int len, int stride) {
  constexpr int kChunks = D * (int)sizeof(E) / 16;
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
// as E, skipping rows at or past `len`.
template <typename E, int D>
__device__ void store_strip(E* dst, const float* strip, int row0, int len, int stride) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < kStrip * D; i += 32) {
    const int r = i / D, d = i % D;
    if (row0 + r < len) dst[(size_t)(row0 + r) * stride + d] = from_float<E>(strip[i]);
  }
}

// C[16, N] = (accumulate ? C : 0) + A[16, K] * B[K, N], for one warp.
// A is row-major with leading dimension lda. B is row-major [K, N] with
// leading dimension ldb, or, when B_T, the transpose of a row-major [N, K]
// tile (element (k, n) at B[n * ldb + k]). C is row-major f32 with ldc.
// All of A, B, C live in shared memory; C is complete for every lane on return.
template <typename E, bool B_T, int N, int K>
__device__ void warp_mm(const E* A, int lda, const E* B, int ldb, float* C, int ldc, bool accumulate) {
  static_assert(N % 32 == 0 && K % 32 == 0, "tile widths are multiples of 32");
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    using namespace nvcuda;
#pragma unroll 1
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate) {
        wmma::load_matrix_sync(c, C + n0, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + k0, lda);
        if constexpr (B_T) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, B + n0 * ldb + k0, ldb);
          wmma::mma_sync(c, a, b, c);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, B + k0 * ldb + n0, ldb);
          wmma::mma_sync(c, a, b, c);
        }
      }
      wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    // Scalar f32. N is a multiple of 32, so a warp's 32 outputs of one step
    // share the row m; each lane starts the k-loop at its own offset so
    // the 32 lanes read 32 different banks of A and B.
    const int lane = threadIdx.x & 31;
    for (int i = lane; i < kStrip * N; i += 32) {
      const int m = i / N, n = i % N;
      float s = accumulate ? C[m * ldc + n] : 0.f;
      const E* a = A + m * lda;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        int kk = k + lane;
        if (kk >= K) kk -= K;
        const float b = B_T ? B[n * ldb + kk] : B[kk * ldb + n];
        s = fmaf(a[kk], b, s);
      }
      C[m * ldc + n] = s;
    }
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

}  // namespace rtt
