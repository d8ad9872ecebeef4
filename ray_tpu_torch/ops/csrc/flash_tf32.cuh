// Register-resident building blocks of the f32 flash-attention kernels (the
// forward in flash_fwd.cu, dK/dV and dQ in flash_bwd.cu): the bf16 kernels' structure
// (flash_sm90.cuh) on f32 tiles, with every product on the tensor cores in
// the 3xTF32 form.
//
// 3xTF32: each operand x is split into x_hi = tf32(x) and x_lo =
// tf32(x - x_hi) (cvt.rna.tf32.f32: 10 mantissa bits, to nearest), and
// a * b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation,
// the two small products first. The dropped a_lo b_lo and the rounding of the
// lo parts leave ~2^-21 of each product, against ~2^-11 for one TF32 product:
// attention's outputs read 15-40x inside the f32 bar (ops/attention.py
// MATCH_TOL) with the first, 35-55x outside it with the second
// (tests/test_torch_tf32_split.py). Every operand is split, P and dS
// included: nothing is rounded to a narrower type.
//
// Fragment layouts of m16n8k8 with tf32 operands (PTX ISA, "Matrix fragments
// for mma.m16n8k8"), lane = 4 * g + t:
//   A (16 x 8, row-major): a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4)
//   B (8 x 8):             b0 = (k t, n g), b1 = (k t+4, n g)
//   C (16 x 8, f32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// C is m16n8k16's, so the masks, the quad reductions (quad_max, quad_sum)
// and tile_mode serve as in bf16. Unlike there, a C fragment is not the next
// product's A fragment: A holds columns t and t+4 of a k-chunk, C columns 2t
// and 2t+1. mm_pb_tf32 permutes the contraction index instead of exchanging
// values within the quad: k-slot t takes key 2t and slot t+4 key 2t+1, so
// c0, c2, c1, c3 are a0..a3 as they stand, and B's fragment is read at the
// same rows, 2t and 2t+1.
//
// Operands come from XOR-swizzled f32 tiles (swz_f32): Q K^T's A and B
// fragments by ldmatrix, which moves 32-bit elements unchanged when it is not
// transposed (lane (g, t) of an 8 x 8 b16 matrix gets float t of row g);
// P V's, dS K's, P^T dO's and dS^T Q's B fragments by scalar loads, since ldmatrix.trans moves
// 16-bit elements. The swizzle keeps both free of bank conflicts.
#pragma once

#include "flash_sm90.cuh"

namespace rtt {
namespace sm90 {

// Element offset of (row, col) in a [rows, D] f32 tile whose 16-byte chunks
// (4 floats) are XOR-swizzled: chunk c of row r is stored at c ^ (r & 7).
// A row spans at least 8 chunks (D >= 32), so the 8 rows of one ldmatrix
// phase read 8 distinct bank groups, and so do the 8 lanes of a cp.async
// store phase. The scalar loads of mm_pb_tf32 (rows 2t and 2t+1, columns
// 8n + g) fall in 32 distinct banks.
template <int D>
__device__ __forceinline__ int swz_f32(int row, int col) {
  static_assert(D % 32 == 0, "rows of at least 8 chunks");
  return row * D + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// Rows [row0, row0 + ROWS) of one head (`src` at its row 0, rows `stride`
// elements apart) into a swizzled [ROWS, D] f32 tile; rows at or past `len`
// are zero-filled. All THREADS threads of the block take part.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_f32_async(float* dst, const float* src, int row0, int len, int stride) {
  constexpr int C = D / 4;
  static_assert(ROWS * C % THREADS == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * C / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / C, c = i % C;
    const bool ok = row0 + r < len;
    cp_async16(smem_u32(dst + swz_f32<D>(r, c * 4)), src + (size_t)(ok ? row0 + r : 0) * stride + c * 4, ok);
  }
}

// x = hi + lo, both tf32, hi the nearest tf32 to x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt_tf32(x);
  lo = cvt_tf32(x - __uint_as_float(hi));
}

// c += a * b from the split operands, in the tensor cores' accumulator: the
// two correction products, then the main one. That accumulator rounds its
// sums toward zero. Over the few k-chunks of one score (D / 8 <= 16) the
// forward's output stays well inside the f32 bar; dQ's and dK's do not (dS
// = P (dP - Delta) cancels), nor does a sum over the hundreds of keys of a
// long row or queries of a long column: mma3_tf32_fresh serves those sums.
__device__ __forceinline__ void mma3_tf32(float (&c)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                          uint32_t b0_hi, uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// c += a * b as mma3_tf32, the products summed in a fresh fragment that is
// added to c by f32 adds, which round to nearest.
__device__ __forceinline__ void mma3_tf32_fresh(float (&c)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                                uint32_t b0_hi, uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma3_tf32(d, a_hi, a_lo, b0_hi, b1_hi, b0_lo, b1_lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// acc[n][.] = A[16, D] * B[N, D]^T for one warp: A is rows [a_row, a_row + 16)
// of a swizzled [*, D] f32 tile, B rows [b_row, b_row + N) of another (b_row a
// multiple of 8). The k dimension is D, in chunks of 8. (S = Q K^T in the
// forward; S = Q K^T and dP = dO V^T in dQ; S^T = K Q^T and dP^T = V dO^T
// in dK/dV.) FRESH: each k-chunk's sum in
// a fresh fragment (mma3_tf32_fresh), else all in the accumulator.
template <int D, int N, bool FRESH>
__device__ __forceinline__ void mm_abt_tf32(float (&acc)[N / 8][4], const float* A, int a_row, const float* B,
                                            int b_row) {
  static_assert(N % 16 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31;
  // ldmatrix row addresses: A's matrices are rows 0-7 and 8-15 of chunk 2kk,
  // then of chunk 2kk + 1 (a0..a3); B's are rows 0-7 of chunks 2kk, 2kk + 1
  // (b0, b1 of n-tile 2nn), then rows 8-15 (n-tile 2nn + 1). A lane's byte
  // offset for chunk c + 2kk is its offset for chunk c XOR 32 kk (kk < D/8).
  const int ar = a_row + (lane & 15), br = b_row + (lane & 7) + ((lane >> 4) << 3);
  const uint32_t a_base = smem_u32(A + ar * D), b_base = smem_u32(B + br * D);
  const int a_x = ((lane >> 4) ^ (ar & 7)) << 4, b_x = (((lane >> 3) & 1) ^ (br & 7)) << 4;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a[4], a_hi[4], a_lo[4];
    ldsm_x4(a_base + ((kk * 32) ^ a_x), a);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), a_hi[i], a_lo[i]);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4], b_hi[4], b_lo[4];  // b0, b1 of n-tile 2nn, then of n-tile 2nn+1
      ldsm_x4(b_base + nn * 16 * D * 4 + ((kk * 32) ^ b_x), b);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), b_hi[i], b_lo[i]);
      if constexpr (FRESH) {
        mma3_tf32_fresh(acc[2 * nn], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        mma3_tf32_fresh(acc[2 * nn + 1], a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
      } else {
        mma3_tf32(acc[2 * nn], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        mma3_tf32(acc[2 * nn + 1], a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
      }
    }
  }
}

// acc[16, D] += P[16, K] * B[K, D] for one warp: P is given as the C
// fragments of K/8 n-tiles, B is rows [0, K) of a swizzled [*, D] f32 tile.
// (O += P V in the forward; dQ += dS K in dQ; dV += P^T dO and dK += dS^T Q
// in dK/dV, the contraction over queries.) k-chunk j holds keys
// 8j..8j+7 in the permuted order of the header: a lane's A fragment is its
// C fragment p[j] reordered, its B fragment B[8j + 2t][8nn + g] and
// B[8j + 2t + 1][8nn + g]. Each k-chunk's products are summed apart
// (mma3_tf32_fresh): a row of keys (a column of queries) is long.
template <int D, int K>
__device__ __forceinline__ void mm_pb_tf32(float (&acc)[D / 8][4], const float (&p)[K / 8][4], const float* B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // Row 2t (+1) holds column 8nn + g in chunk (2nn + g/4) ^ 2t (^ 1): at
  // element (8nn ^ x) + g % 4, with x the lane's swizzle of chunk g/4.
  const float* b0 = B + 2 * t * D + (g & 3);
  const float* b1 = b0 + D;
  const int x0 = ((g >> 2) ^ (2 * t)) << 2, x1 = ((g >> 2) ^ (2 * t + 1)) << 2;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(p[j][0], a_hi[0], a_lo[0]);  // (g, key 2t): slot t
    split_tf32(p[j][2], a_hi[1], a_lo[1]);  // (g + 8, key 2t)
    split_tf32(p[j][1], a_hi[2], a_lo[2]);  // (g, key 2t + 1): slot t + 4
    split_tf32(p[j][3], a_hi[3], a_lo[3]);  // (g + 8, key 2t + 1)
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      uint32_t v0_hi, v0_lo, v1_hi, v1_lo;
      split_tf32(b0[j * 8 * D + ((8 * nn) ^ x0)], v0_hi, v0_lo);
      split_tf32(b1[j * 8 * D + ((8 * nn) ^ x1)], v1_hi, v1_lo);
      mma3_tf32_fresh(acc[nn], a_hi, a_lo, v0_hi, v1_hi, v0_lo, v1_lo);
    }
  }
}

// Write a warp's [16, D] f32 accumulator, row g scaled by scale0 and row
// g + 8 by scale1, to rows [row0, row0 + 16) of one head (`dst` at its row
// 0), skipping rows at or past `len`. Each quad writes a row's 8 n-tile
// columns as 32 contiguous bytes.
template <int D>
__device__ __forceinline__ void store_acc_f32(float* dst, const float (&acc)[D / 8][4], float scale0, float scale1,
                                              int row0, int len, int stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= len) continue;
    const float scale = r ? scale1 : scale0;
    float* out = dst + (size_t)row * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8) = make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

}  // namespace sm90
}  // namespace rtt
