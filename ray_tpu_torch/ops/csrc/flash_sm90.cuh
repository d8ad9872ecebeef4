// Register-resident building blocks of the bf16 flash-attention kernels
// (the forward in flash_fwd.cu, dK/dV and dQ in flash_bwd.cu).
//
// Products are mma.sync.m16n8k16 (bf16 in, f32 accumulate) on fragments in
// registers, with operands read from shared memory by ldmatrix. Tiles reach
// shared memory by cp.async (16 bytes a thread, no register staging) into a
// two-stage ring: a kernel waits for tile j, passes one barrier, issues tile
// j+1 into the stage tile j-1 left and computes on tile j. Tiles are stored
// with an XOR swizzle of their 16-byte chunks, so the 8 row addresses of one
// ldmatrix phase (and of one cp.async store phase) fall in 8 distinct bank
// groups.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"),
// with lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9)
//   B (16 x 8):             b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// So the C fragments of two neighbouring n-tiles, rounded to bf16 pairs, are
// exactly the A fragment of one k-chunk (pack_a): P, P^T, dS and dS^T go
// from one product into the next without leaving registers. Each row of a C
// fragment lives in the 4 lanes of one quad, so a row max or sum is two
// __shfl_xor_sync steps (quad_max, quad_sum).
#pragma once

#include <cuda_bf16.h>

#include "flash_common.cuh"
#include "ptx_sm90.cuh"

namespace rtt {
namespace sm90 {

using bf16 = __nv_bfloat16;

enum TileMode { kSkip = 0, kFull = 1, kMasked = 2 };

// Element offset of (row, col) in a [rows, D] bf16 tile whose 16-byte chunks
// are XOR-swizzled: within each group of rows that spans 8 chunks (one
// 128-byte line for D 64 and 128, two rows for D 32), chunk c of row r is
// stored at c ^ (line index of r & mask).
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int C = D / 8;                     // 16-byte chunks per row
  constexpr int R = C >= 8 ? 1 : 8 / C;        // rows per 128-byte line
  constexpr int M = (C >= 8 ? 8 : C) - 1;      // chunk bits flipped
  return row * D + ((((col >> 3) ^ ((row / R) & M))) << 3) + (col & 7);
}

// Rows [row0, row0 + ROWS) of one head (`src` at its row 0, rows `stride`
// elements apart) into a swizzled [ROWS, D] tile; rows at or past `len` are
// zero-filled. All THREADS threads of the block take part.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0, int len, int stride) {
  constexpr int C = D / 8;
  static_assert(ROWS * C % THREADS == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * C / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / C, c = i % C;
    const bool ok = row0 + r < len;
    cp_async16(smem_u32(dst + swz<D>(r, c * 8)), src + (size_t)(ok ? row0 + r : 0) * stride + c * 8, ok);
  }
}

// Entries [row0, row0 + ROWS) of a per-row f32 vector (one head's [T] row at
// `src`), zero past `len`.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int row0, int len) {
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    const bool ok = row0 + i < len;
    cp_async4(smem_u32(dst + i), src + (ok ? row0 + i : 0), ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-chunk j from C fragments of n-tiles 2j and 2j+1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Addressing in the products below: a lane's ldmatrix row address for
// column chunk c + 2j (c = 0 or 1) is its address for chunk c XOR 32 j bytes,
// and 16 rows further on it is 32 D bytes further on (swz keeps the XOR below
// the row and repeats every 8 rows). So each lane computes one swizzled base
// address per operand, and every step adds or XORs a constant.

// acc[n][.] = A[16, D] * B[N, D]^T for one warp: A is rows [a_row, a_row + 16)
// of a swizzled [*, D] tile, B rows [b_row, b_row + N) of another (a_row and
// b_row multiples of 16). The k dimension is D. (S = Q K^T in the forward;
// S^T = K Q^T and dP^T = V dO^T in dK/dV; S = Q K^T and dP = dO V^T in dQ.)
template <int D, int N>
__device__ __forceinline__ void mm_abt(float (&acc)[N / 8][4], const bf16* A, int a_row, const bf16* B, int b_row) {
  const int lane = threadIdx.x & 31;
  const uint32_t a_base = smem_u32(A + swz<D>(a_row + (lane & 15), (lane >> 4) * 8));
  const uint32_t b_base = smem_u32(B + swz<D>(b_row + (lane & 7) + ((lane >> 4) << 3), ((lane >> 3) & 1) * 8));
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_base ^ (kk * 32), a);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4];  // b0, b1 of n-tile 2nn, then of n-tile 2nn+1
      ldsm_x4((b_base ^ (kk * 32)) + nn * 32 * D, b);
      mma(acc[2 * nn], a, b[0], b[1]);
      mma(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// acc[16, D] += P[16, K] * B[K, D] for one warp: P is given as the C
// fragments of K/8 n-tiles (rounded to bf16 here), B is rows
// [b_row, b_row + K) of a swizzled [*, D] tile (b_row a multiple of 16), read
// transposed by ldmatrix. (O += P V in the forward; dV += P^T dO and
// dK += dS^T Q in dK/dV; dQ += dS K in dQ.)
template <int D, int K>
__device__ __forceinline__ void mm_pb(float (&acc)[D / 8][4], const float (&p)[K / 8][4], const bf16* B, int b_row) {
  const int lane = threadIdx.x & 31;
  const uint32_t b_base = smem_u32(B + swz<D>(b_row + (lane & 15), (lane >> 4) * 8));
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    pack_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];  // b0, b1 of n-tile 2nn, then of n-tile 2nn+1
      ldsm_x4_t((b_base ^ (nn * 32)) + kk * 32 * D, b);
      mma(acc[2 * nn], a, b[0], b[1]);
      mma(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// Round a warp's [16, D] f32 accumulator to bf16 and write it to rows
// [row0, row0 + 16) of one head (`dst` at its row 0), skipping rows at or
// past `len`. It goes through `stage`, the warp's own 16 rows of a swizzled
// [*, D] shared tile that no other warp reads, so the global stores are
// 16 bytes a lane.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 8][4], float scale0, float scale1,
                                          bf16* stage, int row0, int len, int stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + swz<D>(g, n * 8 + 2 * t)) = pack_bf16(acc[n][0] * scale0, acc[n][1] * scale0);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(g + 8, n * 8 + 2 * t)) =
        pack_bf16(acc[n][2] * scale1, acc[n][3] * scale1);
  }
  __syncwarp();
  constexpr int C = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = i % C;
    if (row0 + r < len)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(r, c * 8));
  }
}

// How one warp treats a tile of query positions [qp_lo, qp_hi] (already
// shifted by Tk - Tq) against keys [k_lo, k_hi]: kSkip when no pair is
// visible, kFull when every pair is (no mask is evaluated: the diagonal split
// of the TPU kernel), kMasked otherwise, and always when the tile holds
// padding (`ragged`: keys past Tk in the forward and dQ, queries past Tq in
// dK/dV).
__device__ __forceinline__ int tile_mode(int qp_lo, int qp_hi, int k_lo, int k_hi, bool ragged, int causal,
                                         int window) {
  if (!causal) return ragged ? kMasked : kFull;
  if (k_lo > qp_hi || (window > 0 && qp_lo - k_hi >= window)) return kSkip;
  const bool all_visible = k_hi <= qp_lo && (window <= 0 || qp_hi - k_lo < window);
  return all_visible && !ragged ? kFull : kMasked;
}

}  // namespace sm90
}  // namespace rtt
