// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_kernel (launched by
// _pallas_flash_with_lse): O = softmax(Q K^T * scale, masked) V with an online
// softmax, and optionally the per-row log-sum-exp LSE = m + log(l) that the
// backward kernels rebuild P from.
//
// What bounds it on this card: at the training shapes (T 1024, D 128, causal,
// bf16) the work is ~256 FLOP per byte of q/k/v/o, just under the H100's
// ~295 FLOP/byte balance point, so a kernel at the roofline is bound by
// memory, with the tensor cores nearly as busy. In practice a tile kernel is
// held by how fast its warps feed the tensor cores: shared-memory operand
// reads, the softmax's exp and shuffles, and the barriers around each tile.
//
// bf16 (flash_fwd_bf16_kernel; the main path), the FA2 design on mma.sync:
// - One block of 4 warps per (64-row query tile, batch*head). Warp w owns
//   query rows [16w, 16w+16) end to end: S = Q K^T, the online softmax, the
//   rescale, O += P V and the epilogue's 1/l and LSE.
// - S, P and the output accumulator O live in registers as m16n8k16
//   fragments (flash_sm90.cuh). The softmax rescales its own rows in
//   registers; a row's max and sum take two shuffles within a quad. P goes
//   from S's C fragments into the A fragments of P V without touching shared
//   memory. (wgmma would reach a higher tensor-core rate, reading each K/V
//   tile once per 64-row warpgroup where mma.sync reads it once per 16-row
//   warp, but needs descriptors matched to a TMA or hand swizzle and, to pay,
//   a producer warp; mma.sync keeps fragments whose layout the code can
//   check, and it lifts the bound that held the first version: every
//   accumulator and score staged through shared memory.)
// - K/V tiles of 64 rows stream through a two-stage ring by cp.async: tile
//   j+1 is in flight while tile j is used, behind one barrier per tile.
//   Tiles are XOR-swizzled, so ldmatrix and the cp.async stores meet no bank
//   conflict.
// - The diagonal split: a warp classifies each K/V tile against its own 16
//   rows (sm90::tile_mode). Tiles wholly below the diagonal, inside the
//   window and inside Tk take no mask; only tiles that cross the diagonal,
//   the window's left edge or the ragged tail evaluate visible(); a tile
//   with no visible key is skipped by that warp.
// - Longest first: blockIdx.y counts query tiles from the last, so the
//   causal tiles with the most key tiles start first and the short ones
//   fill the tail.
// - Occupancy at D 128: ~200 registers a thread (O 64, S 32, the rest
//   addresses and fragments in flight) and 80 KB of shared memory, so two
//   blocks (8 warps) fit on an SM, without spills. 128-row tiles of 8 warps
//   fit once per SM, or twice with registers capped at 128 and some spilled:
//   both read slower on the card (ops/tune_kernels.py; PERF.md).
// The causal and window pruning of the k loop is the TPU kernel's
// (key_tile_range); the ragged tail of any length is masked in the kernel.
// P is rounded to bf16 before P V, as on the TPU; m, l and O stay f32. A row
// with no visible key gives 0 and LSE = -inf, never NaN (safe_m). The output
// does not depend on whether LSE is written.
//
// f32 (flash_fwd_kernel): the same design on f32 tiles, with every product
// in the 3xTF32 form on mma.sync.m16n8k8 (flash_tf32.cuh): each operand is
// split into two TF32 parts and three tensor-core products stand for one f32
// product, to ~2^-21 of it, well inside the f32 bar that one TF32 product
// would break. S's products over D sum in the tensor cores' accumulator,
// which rounds toward zero: O reads 1.0e-6 rel_l2 at the main shape against
// 4.6e-7 with each k-chunk in a fresh fragment added by f32 adds, in 3-4%
// less time at D 128 and 6-9% less at DT's shape (ops/tune_kernels.py
// --f32). O's products over the keys take fresh fragments: summed in the
// accumulator over 1024 keys O drifts to 2.7e-6. S, P and O stay in
// registers as f32 fragments, P is split like any operand (never rounded to
// a narrower type), and K/V tiles stream through the two-stage cp.async
// ring into XOR-swizzled f32 tiles. What held the first f32 version
// (scalar-FMA products through shared memory, 2-warp blocks, two barriers
// and a blocking load per tile) is gone.
// - K/V stages of 64 keys at D 32 and 64, 32 at D 128. Registers, shared
//   memory and blocks per SM (rtt_flash_fwd_info): D 32 134, 40 KB, 3
//   blocks; D 64 192, 80 KB, 2; D 128 255 with 56 B spilled, 96 KB, 2.
//   16-key stages at D 128 spill nothing (188 registers) and read slower
//   (ops/tune_kernels.py --f32; PERF.md).
// - At the Decision Transformer's shape (B 64, T 60, H 2, D 32: one key tile
//   a block) the kernel runs for a few microseconds, less than its Python
//   wrapper takes on the host.
#include "flash_tf32.cuh"

namespace rtt {
namespace sm90 {

constexpr int kFwdBQ = 64;  // query rows per block: 4 warps of 16
constexpr int kFwdBK = 64;  // key rows per ring stage
constexpr int kFwdThreads = kFwdBQ / 16 * 32;

template <int D>
constexpr size_t fwd_bf16_smem_bytes() {
  return sizeof(bf16) * (kFwdBQ * D + 2 * 2 * kFwdBK * D);  // Q, and a two-stage ring of K and V
}

// The bound of two blocks per SM caps nothing at 128 threads (255 registers
// fit twice), but ptxas schedules differently under it: ~200 registers, and
// faster on the card than the ~180 it picks without (ops/tune_kernels.py).
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          bf16* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, float scale,
                          int causal, int window) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ, D]
  bf16* Ks = Qs + BQ * D;                    // [2][BK, D]
  bf16* Vs = Ks + 2 * BK * D;                // [2][BK, D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the last (longest causal) query tiles first
  const int q0 = qt * BQ;
  const int stride = H * D;
  const int offset = Tk - Tq;  // bottom-right causal alignment
  const bf16* qh = q + ((size_t)b * Tq * H + h) * D;
  const bf16* kh = k + ((size_t)b * Tk * H + h) * D;
  const bf16* vh = v + ((size_t)b * Tk * H + h) * D;

  int kt_begin, kt_end;
  key_tile_range(q0, min(q0 + BQ, Tq) - 1, offset, Tk, BK, causal, window, &kt_begin, &kt_end);

  load_tile_async<BQ, D, kFwdThreads>(Qs, qh, q0, Tq, stride);
  if (kt_begin < kt_end) {
    load_tile_async<BK, D, kFwdThreads>(Ks, kh, kt_begin * BK, Tk, stride);
    load_tile_async<BK, D, kFwdThreads>(Vs, vh, kt_begin * BK, Tk, stride);
  }
  cp_async_commit();

  const int row_lo = q0 + warp * 16;  // this warp's first query row
  const int qp_lo = row_lo + offset;  // its position against the keys
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp(x) = exp2(x log2 e)
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Running max (log2 units) and this lane's share of the running sum, for
  // rows g (index 0) and g + 8 (index 1) of the warp's strip.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll 1
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait<0>();  // this thread's copies of tile kt (and Q) have landed ...
    __syncthreads();     // ... every thread's have, and every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {  // so tile kt + 1 can fill tile kt - 1's stage while tile kt is used
      load_tile_async<BK, D, kFwdThreads>(Ks + (stage ^ 1) * BK * D, kh, (kt + 1) * BK, Tk, stride);
      load_tile_async<BK, D, kFwdThreads>(Vs + (stage ^ 1) * BK * D, vh, (kt + 1) * BK, Tk, stride);
    }
    cp_async_commit();

    const int k0 = kt * BK;
    int mode = tile_mode(qp_lo, qp_lo + 15, k0, k0 + BK - 1, k0 + BK > Tk, causal, window);
    if (mode == kSkip) continue;  // no key of this tile is visible to the warp's rows

    float s[BK / 8][4];
    mm_abt<D, BK>(s, Qs, warp * 16, Ks + stage * BK * D, 0);  // S = Q K^T
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
    }
    if (mode == kMasked) {  // only tiles across the diagonal, the window's left edge or Tk
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!visible(qp_lo + g + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1), Tk, causal, window))
            s[n][e] = -INFINITY;
        }
      }
    }

    // Online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // A row with no visible key so far has m_new = -inf; exp(-inf - -inf)
      // would be NaN, so subtract 0 instead and every p stays exp(-inf) = 0.
      const float safe_m = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2(m[r] - safe_m);
      m[r] = m_new;
      mx[r] = safe_m;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(s[n][e] - mx[e >> 1]);  // P, in place of S
        sum[e >> 1] += s[n][e];
      }
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    }
    mm_pb<D, BK>(o, s, Vs + stage * BK * D, 0);  // O += P V
  }
  cp_async_wait<0>();
  __syncthreads();  // Q's rows are free to stage the output

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_acc<D>(out + ((size_t)b * Tq * H + h) * D, o, l[0] > 0.f ? 1.f / l[0] : 0.f,
               l[1] > 0.f ? 1.f / l[1] : 0.f, Qs + warp * 16 * D, row_lo, Tq, stride);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + g + 8 * r;
      // (max + log2 l) in log2 units, back to natural log; -inf when l == 0.
      if (row < Tq) lse[(size_t)bh * Tq + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

template <int D>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int Tq,
                            int Tk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = fwd_bf16_smem_bytes<D>();
  auto kernel = flash_fwd_bf16_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kFwdBQ - 1) / kFwdBQ);
  kernel<<<grid, kFwdThreads, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                              static_cast<const bf16*>(v), static_cast<bf16*>(out),
                                              static_cast<float*>(lse), H, Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd_bf16(int D, const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
                              int Tq, int Tk, float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd_bf16<32>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 64: return launch_fwd_bf16<64>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 128: return launch_fwd_bf16<128>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Keys per ring stage of the f32 forward: at D 128, 32 keep Q and the ring
// at 96 KB (two blocks per SM).
template <int D>
constexpr int kFwdF32BK = D == 128 ? 32 : 64;

template <int D>
constexpr size_t fwd_f32_smem_bytes() {
  return sizeof(float) * (kFwdBQ * D + 2 * 2 * kFwdF32BK<D> * D);  // Q, and a two-stage ring of K and V
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, float scale, int causal,
                     int window) {
  constexpr int BQ = kFwdBQ, BK = kFwdF32BK<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ, D]
  float* Ks = Qs + BQ * D;                     // [2][BK, D]
  float* Vs = Ks + 2 * BK * D;                 // [2][BK, D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the last (longest causal) query tiles first
  const int stride = H * D;
  const int offset = Tk - Tq;  // bottom-right causal alignment
  const float* qh = q + ((size_t)b * Tq * H + h) * D;
  const float* kh = k + ((size_t)b * Tk * H + h) * D;
  const float* vh = v + ((size_t)b * Tk * H + h) * D;

  int kt_begin, kt_end;
  key_tile_range(q0, min(q0 + BQ, Tq) - 1, offset, Tk, BK, causal, window, &kt_begin, &kt_end);

  load_tile_f32_async<BQ, D, kFwdThreads>(Qs, qh, q0, Tq, stride);
  if (kt_begin < kt_end) {
    load_tile_f32_async<BK, D, kFwdThreads>(Ks, kh, kt_begin * BK, Tk, stride);
    load_tile_f32_async<BK, D, kFwdThreads>(Vs, vh, kt_begin * BK, Tk, stride);
  }
  cp_async_commit();

  const int row_lo = q0 + warp * 16;  // this warp's first query row
  const int qp_lo = row_lo + offset;  // its position against the keys
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp(x) = exp2(x log2 e)
  float acc[D / 8][4];  // the unnormalised output
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // Running max (log2 units) and this lane's share of the running sum, for
  // rows g (index 0) and g + 8 (index 1) of the warp's strip.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll 1
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait<0>();  // this thread's copies of tile kt (and Q) have landed ...
    __syncthreads();     // ... every thread's have, and every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {  // so tile kt + 1 can fill tile kt - 1's stage while tile kt is used
      load_tile_f32_async<BK, D, kFwdThreads>(Ks + (stage ^ 1) * BK * D, kh, (kt + 1) * BK, Tk, stride);
      load_tile_f32_async<BK, D, kFwdThreads>(Vs + (stage ^ 1) * BK * D, vh, (kt + 1) * BK, Tk, stride);
    }
    cp_async_commit();

    const int k0 = kt * BK, k_last = k0 + BK - 1;
    const int tile = tile_mode(qp_lo, qp_lo + 15, k0, k_last, k_last >= Tk, causal, window);
    if (tile == kSkip) continue;  // no key of this tile is visible to the warp's rows

    float s[BK / 8][4];
    mm_abt_tf32<D, BK, false>(s, Qs, warp * 16, Ks + stage * BK * D, 0);  // S = Q K^T, unscaled
    if (tile == kMasked) {  // only tiles across the diagonal, the window's left edge or Tk
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!visible(qp_lo + g + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1), Tk, causal, window))
            s[n][e] = -INFINITY;
        }
      }
    }

    // Online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3). The scale is
    // positive, so the max is taken on the unscaled scores and each p is
    // exp2(s * sl2 - max) with one rounding (fmaf).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * sl2);
      // A row with no visible key so far has m_new = -inf; exp(-inf - -inf)
      // would be NaN, so subtract 0 instead and every p stays exp(-inf) = 0.
      const float safe_m = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2(m[r] - safe_m);
      m[r] = m_new;
      mx[r] = safe_m;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], sl2, -mx[e >> 1]));  // P, in place of S
        sum[e >> 1] += s[n][e];
      }
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
    mm_pb_tf32<D, BK>(acc, s, Vs + stage * BK * D);  // O += P V
  }
  cp_async_wait<0>();  // no copy outlives the block (Q's, when no key tile is visible)

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_acc_f32<D>(out + ((size_t)b * Tq * H + h) * D, acc, l[0] > 0.f ? 1.f / l[0] : 0.f,
                   l[1] > 0.f ? 1.f / l[1] : 0.f, row_lo, Tq, stride);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + g + 8 * r;
      // (max + log2 l) in log2 units, back to natural log; -inf when l == 0.
      if (row < Tq) lse[(size_t)bh * Tq + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

template <int D>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int Tq,
                           int Tk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = fwd_f32_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kFwdBQ - 1) / kFwdBQ);
  kernel<<<grid, kFwdThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                              static_cast<const float*>(v), static_cast<float*>(out),
                                              static_cast<float*>(lse), H, Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd_f32(int D, const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
                             int Tq, int Tk, float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd_f32<32>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 64: return launch_fwd_f32<64>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 128: return launch_fwd_f32<128>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace rtt

// q, k, v, out: [B, T, H, D] contiguous, 16-byte aligned; lse: [B, H, Tq] f32
// or null. is_bf16: 1 for bfloat16, 0 for float32. Returns a cudaError_t.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int is_bf16, int B,
                             int H, int Tq, int Tk, int D, float scale, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? rtt::sm90::dispatch_fwd_bf16(D, q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, s)
                 : rtt::sm90::dispatch_fwd_f32(D, q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, s);
}

// The forward kernel's resources for one type (is_bf16: 1 bfloat16, 0
// float32) at head width D, on the current device: info = {registers per
// thread, shared memory per block (bytes), blocks that fit on one SM, threads
// per block, local memory per thread (bytes; spills)}.
extern "C" int rtt_flash_fwd_info(int is_bf16, int D, int* info) {
  using namespace rtt::sm90;
  switch (is_bf16 * 1000 + D) {
    case 32: return rtt::kernel_info(flash_fwd_kernel<32>, fwd_f32_smem_bytes<32>(), kFwdThreads, info);
    case 64: return rtt::kernel_info(flash_fwd_kernel<64>, fwd_f32_smem_bytes<64>(), kFwdThreads, info);
    case 128: return rtt::kernel_info(flash_fwd_kernel<128>, fwd_f32_smem_bytes<128>(), kFwdThreads, info);
    case 1032: return rtt::kernel_info(flash_fwd_bf16_kernel<32>, fwd_bf16_smem_bytes<32>(), kFwdThreads, info);
    case 1064: return rtt::kernel_info(flash_fwd_bf16_kernel<64>, fwd_bf16_smem_bytes<64>(), kFwdThreads, info);
    case 1128: return rtt::kernel_info(flash_fwd_bf16_kernel<128>, fwd_bf16_smem_bytes<128>(), kFwdThreads, info);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rtt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
