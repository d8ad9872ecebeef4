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
// f32 (flash_fwd_kernel): the first version, kept for f32 inputs only. No
// tensor-core path on this card computes full f32 (TF32 would break the f32
// bar), so its products are scalar FMA on tiles in shared memory.
#include "flash_sm90.cuh"

namespace rtt {

template <int D>
constexpr size_t fwd_smem_bytes() {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  return sizeof(float) * (2 * BQ * D + 2 * BK * D + 2 * BQ * BK);
}

template <int D>
__global__ void __launch_bounds__(kF32Tile / kStrip * 32)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, float scale, int causal,
                     int window) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ, D]
  float* Ks = Qs + BQ * D;                     // [BK, D]
  float* Vs = Ks + BK * D;                     // [BK, D]
  float* Ps = Vs + BK * D;                     // [BQ, BK]  P
  float* Ss = Ps + BQ * BK;                    // [BQ, BK]  scores
  float* Acc = Ss + BQ * BK;                   // [BQ, D]   unnormalised output

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int stride = H * D;
  const int offset = Tk - Tq;  // bottom-right causal alignment
  const float* qh = q + ((size_t)b * Tq * H + h) * D;
  const float* kh = k + ((size_t)b * Tk * H + h) * D;
  const float* vh = v + ((size_t)b * Tk * H + h) * D;

  load_tile<D>(Qs, qh, q0, BQ, Tq, stride);
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) Acc[i] = 0.f;
  __syncthreads();

  int kt_begin, kt_end;
  key_tile_range(q0, min(q0 + BQ, Tq) - 1, offset, Tk, BK, causal, window, &kt_begin, &kt_end);

  // Row statistics: lanes 2r and 2r+1 of a warp both hold row r of its strip
  // and each handles half of the row's columns.
  const int r = lane >> 1, half = lane & 1;
  const int qpos = q0 + warp * kStrip + r + offset;
  const float* Qw = Qs + warp * kStrip * D;
  float* Pw = Ps + warp * kStrip * BK;
  float* Sw = Ss + warp * kStrip * BK;
  float* Aw = Acc + warp * kStrip * D;
  float m = -INFINITY, l = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kh, k0, BK, Tk, stride);
    load_tile<D>(Vs, vh, k0, BK, Tk, stride);
    __syncthreads();

    warp_mm<true, BK, D>(Qw, D, Ks, D, Sw, BK, false);  // S = Q K^T

    // Online softmax over this tile. Column j + lane (mod BK/2) spreads the
    // 32 lanes over 32 banks.
    float s[BK / 2];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half * (BK / 2) + (j + lane) % (BK / 2);
      s[j] = visible(qpos, k0 + c, Tk, causal, window) ? Sw[r * BK + c] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    // A row with no visible key so far has m_new = -inf; exp(-inf - -inf)
    // would be NaN, so subtract 0 instead and every p stays exp(-inf) = 0.
    const float safe_m = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m - safe_m);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half * (BK / 2) + (j + lane) % (BK / 2);
      const float p = expf(s[j] - safe_m);
      p_sum += p;
      Pw[r * BK + c] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l = l * corr + p_sum;
    m = m_new;
    for (int j = 0; j < D / 2; ++j) Aw[r * D + half * (D / 2) + (j + lane) % (D / 2)] *= corr;
    __syncwarp();

    warp_mm<false, D, BK>(Pw, BK, Vs, D, Aw, D, true);  // Acc += P V
  }

  const int row = q0 + warp * kStrip + r;
  if (row < Tq) {
    float* orow = out + ((size_t)(b * Tq + row) * H + h) * D;
    for (int j = 0; j < D / 2; ++j) {
      const int d = half * (D / 2) + j;
      orow[d] = l > 0.f ? Aw[r * D + d] / l : 0.f;
    }
    if (lse != nullptr && half == 0) lse[(size_t)bh * Tq + row] = m + logf(l);  // -inf when l == 0
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int Tq,
                       int Tk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int BQ = kF32Tile;
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, BQ / kStrip * 32, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                   static_cast<const float*>(v), static_cast<float*>(out),
                                                   static_cast<float*>(lse), H, Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(int D, const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
                         int Tq, int Tk, float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd<32>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 64: return launch_fwd<64>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 128: return launch_fwd<128>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

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

}  // namespace sm90
}  // namespace rtt

// q, k, v, out: [B, T, H, D] contiguous, 16-byte aligned; lse: [B, H, Tq] f32
// or null. is_bf16: 1 for bfloat16, 0 for float32. Returns a cudaError_t.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int is_bf16, int B,
                             int H, int Tq, int Tk, int D, float scale, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? rtt::sm90::dispatch_fwd_bf16(D, q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, s)
                 : rtt::dispatch_fwd(D, q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, s);
}

// The bf16 forward kernel's resources at head width D, on the current device:
// info = {registers per thread, shared memory per block (bytes), blocks that
// fit on one SM, threads per block, local memory per thread (bytes; spills)}.
extern "C" int rtt_flash_fwd_info(int D, int* info) {
  switch (D) {
    case 32: return rtt::kernel_info(rtt::sm90::flash_fwd_bf16_kernel<32>, rtt::sm90::fwd_bf16_smem_bytes<32>(),
                                     rtt::sm90::kFwdThreads, info);
    case 64: return rtt::kernel_info(rtt::sm90::flash_fwd_bf16_kernel<64>, rtt::sm90::fwd_bf16_smem_bytes<64>(),
                                     rtt::sm90::kFwdThreads, info);
    case 128: return rtt::kernel_info(rtt::sm90::flash_fwd_bf16_kernel<128>, rtt::sm90::fwd_bf16_smem_bytes<128>(),
                                      rtt::sm90::kFwdThreads, info);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rtt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
