// Flash-attention backward for Hopper (sm_90a): two kernels, as on the TPU.
//
// Replaces ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel and
// _flash_bwd_dq_kernel (both launched by _pallas_bwd_impl). With P rebuilt
// from the forward's LSE and Delta = rowsum(dO * O) computed in torch before
// the launch:
//   P = exp(S - lse),  dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta) * scale,
//   dK = dS^T Q,       dQ = dS K.
// The dK/dV kernel owns a K tile and loops over the query tiles that can see
// it; the dQ kernel owns a query tile and loops over the key tiles it sees.
// Each output element is written by exactly one block with no atomics, so
// the results are deterministic. The loop bounds are the TPU kernels'
// causal/sliding-window bounds; ragged tails are masked in the kernel. P and
// dS are rounded to the input type before their products, as on the TPU; all
// sums are f32.
//
// What bounds them on this card: at the training shapes (T 1024, D 128,
// causal, bf16) dK/dV does ~340 FLOP and dQ ~307 FLOP per byte it must move,
// above the H100's ~295 FLOP/byte balance point, so at the roofline both are
// bound by the tensor cores; a tile kernel is held first by how fast its
// warps feed them (shared-memory operand reads, exp, barriers per tile).
//
// In bf16 (the main path) both run on mma.sync with their accumulators in
// registers (m16n8 f32 fragments, flash_sm90.cuh), in blocks of 4 warps.
//
// dK/dV (flash_bwd_dkv_bf16_kernel):
// - One block per (64-key tile, batch*head). Its K and V tiles stay in shared
//   memory; warp w owns keys [16w, 16w+16) and holds their dK and dV
//   accumulators.
// - Query tiles of 64 rows, with their dO rows, lse and Delta, stream
//   through a two-stage cp.async ring: tile j+1 is in flight while tile j is
//   used, behind one barrier per tile.
// - Per query tile: S^T = K Q^T and dP^T = V dO^T into registers; P^T and
//   dS^T computed there; then dV += P^T dO and dK += dS^T Q with P^T and
//   dS^T as register A operands (C fragments rounded to bf16) and dO, Q read
//   transposed from shared memory by ldmatrix.trans.
// - The diagonal split: each warp classifies a query tile against its own
//   16 keys (sm90::tile_mode): no mask below the diagonal, inside the window
//   and inside Tq; visible() only on tiles that cross the diagonal, the
//   window's edge or the ragged tail; no work on tiles that see none of its
//   keys.
// - Longest first: blockIdx.y is the key tile, so key tile 0, which every
//   causal query tile sees, starts first.
// - Occupancy at D 128: the two f32 accumulators (64 registers each) and
//   S^T, dP^T (32 each) fill the 255-register cap, with a few words spilled;
//   at 128 threads and ~97 KB of shared memory two blocks (8 warps) fit on
//   an SM. A block of 8 warps over 128 keys fits once per SM and reads
//   slower on the card (ops/tune_kernels.py; PERF.md).
//
// dQ (flash_bwd_dq_bf16_kernel): the forward's loop with one more product
// and no online softmax.
// - One block per (64-row query tile, batch*head); warp w owns query rows
//   [16w, 16w+16) end to end. The block's Q and dO tiles are loaded once;
//   each lane keeps lse and Delta of its two rows (g and g+8) in registers.
// - K/V tiles of 64 keys stream through the forward's two-stage cp.async
//   ring, one barrier per tile.
// - Per key tile: S = Q K^T and dP = dO V^T into registers; P and dS
//   computed there; then dQ += dS K with dS as the register A operand and K
//   read transposed by ldmatrix.trans. One swizzled K tile is the B operand
//   of both products: as stored for S, transposed for dQ.
// - The forward's diagonal split (tile_mode against the warp's 16 rows; the
//   mask also on tiles holding keys past Tk, which cp.async zero-fills and
//   which would otherwise give exp(-lse) != 0) and its order (the last,
//   longest causal query tiles first).
// - Occupancy at D 128: ~245 registers a thread (dQ 64, S and dP 32 each,
//   the rest addresses and fragments in flight), no spills, and 96 KB of
//   shared memory (Q, dO, two stages of K and V), so two blocks (8 warps)
//   fit on an SM. 128-row tiles of 8 warps, which read each K/V tile for
//   twice the rows, fit once per SM and read slower on the card
//   (ops/tune_kernels.py; PERF.md).
//
// f32 (flash_bwd_dkv_kernel, flash_bwd_dq_kernel): the first version, kept
// for f32 inputs only, with scalar FMA products on tiles, scores and
// accumulators all in shared memory (flash_common.cuh). No tensor-core path
// on this card computes full f32.
#include "flash_sm90.cuh"

namespace rtt {

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  // K, V, Q, dO; P^T, dS^T, S^T, dP^T; dK, dV; lse, Delta.
  return sizeof(float) * (2 * BK * D + 2 * BQ * D + 4 * BK * BQ + 2 * BK * D + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  // Q, dO, K, V; dS, S, dP; dQ; lse, Delta.
  return sizeof(float) * (2 * BQ * D + 2 * BK * D + 3 * BQ * BK + BQ * D + 2 * BQ);
}

// One block per (key tile, batch*head); warp w owns key rows [16w, 16w+16).
// Scores are taken transposed, S^T = K Q^T, so that each warp's strip of P^T
// and dS^T is the A operand of its dV and dK products.
template <int D>
__global__ void __launch_bounds__(kF32Tile / kStrip * 32)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk, float scale, int causal,
                         int window) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [BK, D]
  float* Vs = Ks + BK * D;                     // [BK, D]
  float* Qs = Vs + BK * D;                     // [BQ, D]
  float* dOs = Qs + BQ * D;                    // [BQ, D]
  float* PT = dOs + BQ * D;                    // [BK, BQ]  P^T
  float* dST = PT + BK * BQ;                   // [BK, BQ]  dS^T
  float* ST = dST + BK * BQ;                   // [BK, BQ]
  float* dPT = ST + BK * BQ;                   // [BK, BQ]
  float* dKacc = dPT + BK * BQ;                // [BK, D]
  float* dVacc = dKacc + BK * D;               // [BK, D]
  float* lse_s = dVacc + BK * D;               // [BQ]
  float* delta_s = lse_s + BQ;                 // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int stride = H * D;
  const int offset = Tk - Tq;
  const size_t q_head = ((size_t)b * Tq * H + h) * D, k_head = ((size_t)b * Tk * H + h) * D;

  load_tile<D>(Ks, k + k_head, k0, BK, Tk, stride);
  load_tile<D>(Vs, v + k_head, k0, BK, Tk, stride);
  for (int i = threadIdx.x; i < 2 * BK * D; i += blockDim.x) dKacc[i] = 0.f;  // dKacc and dVacc
  __syncthreads();  // a warp may store its strip without entering the loop

  // Query tiles that can see this key tile: from the first row whose causal
  // horizon reaches k0 to the last row whose window still holds the tile's
  // last key.
  const int nqt = (Tq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = nqt;
  if (causal) {
    const int first_row = k0 - offset;
    qt_begin = first_row <= 0 ? 0 : min(first_row / BQ, nqt);
    if (window > 0) {
      const int last_row = min(k0 + BK, Tk) - 1 + window - 1 - offset;
      qt_end = last_row < 0 ? 0 : min(nqt, last_row / BQ + 1);
      qt_end = max(qt_end, qt_begin);
    }
  }

  const int kw = warp * kStrip;  // this warp's first key row in the tile
  float* STw = ST + kw * BQ;
  float* dPTw = dPT + kw * BQ;
  float* PTw = PT + kw * BQ;
  float* dSTw = dST + kw * BQ;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D>(Qs, q + q_head, q0, BQ, Tq, stride);
    load_tile<D>(dOs, dout + q_head, q0, BQ, Tq, stride);
    load_rows(lse_s, lse + (size_t)bh * Tq, q0, BQ, Tq);
    load_rows(delta_s, delta + (size_t)bh * Tq, q0, BQ, Tq);
    __syncthreads();

    warp_mm<true, BQ, D>(Ks + kw * D, D, Qs, D, STw, BQ, false);    // S^T = K Q^T
    warp_mm<true, BQ, D>(Vs + kw * D, D, dOs, D, dPTw, BQ, false);  // dP^T = V dO^T
    for (int i = lane; i < kStrip * BQ; i += 32) {
      const int kr = i / BQ, c = i % BQ;
      const bool vis = q0 + c < Tq && visible(q0 + c + offset, k0 + kw + kr, Tk, causal, window);
      const float p = vis ? expf(STw[i] * scale - lse_s[c]) : 0.f;
      PTw[i] = p;
      dSTw[i] = p * (dPTw[i] - delta_s[c]) * scale;
    }
    __syncwarp();
    warp_mm<false, D, BQ>(PTw, BQ, dOs, D, dVacc + kw * D, D, true);  // dV += P^T dO
    warp_mm<false, D, BQ>(dSTw, BQ, Qs, D, dKacc + kw * D, D, true);  // dK += dS^T Q
  }

  store_strip<D>(dk + k_head, dKacc + kw * D, k0 + kw, Tk, stride);
  store_strip<D>(dv + k_head, dVacc + kw * D, k0 + kw, Tk, stride);
}

// One block per (query tile, batch*head); warp w owns query rows [16w, 16w+16).
template <int D>
__global__ void __launch_bounds__(kF32Tile / kStrip * 32)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Tq, int Tk, float scale, int causal, int window) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ, D]
  float* dOs = Qs + BQ * D;                    // [BQ, D]
  float* Ks = dOs + BQ * D;                    // [BK, D]
  float* Vs = Ks + BK * D;                     // [BK, D]
  float* dS = Vs + BK * D;                     // [BQ, BK]
  float* S = dS + BQ * BK;                     // [BQ, BK]
  float* dP = S + BQ * BK;                     // [BQ, BK]
  float* dQacc = dP + BQ * BK;                 // [BQ, D]
  float* lse_s = dQacc + BQ * D;               // [BQ]
  float* delta_s = lse_s + BQ;                 // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int stride = H * D;
  const int offset = Tk - Tq;
  const size_t q_head = ((size_t)b * Tq * H + h) * D, k_head = ((size_t)b * Tk * H + h) * D;

  load_tile<D>(Qs, q + q_head, q0, BQ, Tq, stride);
  load_tile<D>(dOs, dout + q_head, q0, BQ, Tq, stride);
  load_rows(lse_s, lse + (size_t)bh * Tq, q0, BQ, Tq);
  load_rows(delta_s, delta + (size_t)bh * Tq, q0, BQ, Tq);
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) dQacc[i] = 0.f;
  __syncthreads();  // a warp may store its strip without entering the loop

  int kt_begin, kt_end;
  key_tile_range(q0, min(q0 + BQ, Tq) - 1, offset, Tk, BK, causal, window, &kt_begin, &kt_end);

  const int qw = warp * kStrip;  // this warp's first query row in the tile
  float* Sw = S + qw * BK;
  float* dPw = dP + qw * BK;
  float* dSw = dS + qw * BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, k + k_head, k0, BK, Tk, stride);
    load_tile<D>(Vs, v + k_head, k0, BK, Tk, stride);
    __syncthreads();

    warp_mm<true, BK, D>(Qs + qw * D, D, Ks, D, Sw, BK, false);    // S = Q K^T
    warp_mm<true, BK, D>(dOs + qw * D, D, Vs, D, dPw, BK, false);  // dP = dO V^T
    for (int i = lane; i < kStrip * BK; i += 32) {
      const int qr = i / BK, c = i % BK;
      const int row = q0 + qw + qr;
      const bool vis = row < Tq && visible(row + offset, k0 + c, Tk, causal, window);
      const float p = vis ? expf(Sw[i] * scale - lse_s[qw + qr]) : 0.f;
      dSw[i] = p * (dPw[i] - delta_s[qw + qr]) * scale;
    }
    __syncwarp();
    warp_mm<false, D, BK>(dSw, BK, Ks, D, dQacc + qw * D, D, true);  // dQ += dS K
  }

  store_strip<D>(dq + q_head, dQacc + qw * D, q0 + qw, Tq, stride);
}

// The f32 kernels: dK/dV when DKV, else dQ.
template <int D, bool DKV>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
                       int causal, int window, cudaStream_t stream) {
  constexpr int TILE = kF32Tile;
  constexpr int threads = TILE / kStrip * 32;
  const float *qe = static_cast<const float*>(q), *ke = static_cast<const float*>(k), *ve = static_cast<const float*>(v);
  const float* de = static_cast<const float*>(dout);
  if constexpr (DKV) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    auto kernel = flash_bwd_dkv_kernel<D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Tk + TILE - 1) / TILE, B * H), threads, smem, stream>>>(
        qe, ke, ve, de, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, scale, causal, window);
  } else {
    constexpr size_t smem = dq_smem_bytes<D>();
    auto kernel = flash_bwd_dq_kernel<D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Tq + TILE - 1) / TILE, B * H), threads, smem, stream>>>(
        qe, ke, ve, de, lse, delta, static_cast<float*>(dq), H, Tq, Tk, scale, causal, window);
  }
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
                         int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_bwd<32, DKV>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    case 64:
      return launch_bwd<64, DKV>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    case 128:
      return launch_bwd<128, DKV>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

namespace sm90 {

constexpr int kDkvBK = 64;  // keys per block: 4 warps of 16
constexpr int kDkvBQ = 64;  // query rows per ring stage
constexpr int kDkvThreads = kDkvBK / 16 * 32;

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  // K, V; a two-stage ring of Q, dO, lse and Delta.
  return sizeof(bf16) * (2 * kDkvBK * D + 2 * 2 * kDkvBQ * D) + sizeof(float) * 2 * 2 * kDkvBQ;
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                              const bf16* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                              int Tq, int Tk, float scale, int causal, int window) {
  constexpr int BQ = kDkvBQ, BK = kDkvBK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BK, D]
  bf16* Vs = Ks + BK * D;                    // [BK, D]
  bf16* Qs = Vs + BK * D;                    // [2][BQ, D]
  bf16* dOs = Qs + 2 * BQ * D;               // [2][BQ, D]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * D);  // [2][BQ] lse
  float* Ds = Ls + 2 * BQ;                                 // [2][BQ] Delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;  // key tile 0 (the longest causal work) first
  const int stride = H * D;
  const int offset = Tk - Tq;
  const bf16* qh = q + ((size_t)b * Tq * H + h) * D;
  const bf16* doh = dout + ((size_t)b * Tq * H + h) * D;
  const float* lseh = lse + (size_t)bh * Tq;
  const float* deltah = delta + (size_t)bh * Tq;
  const size_t k_head = ((size_t)b * Tk * H + h) * D;

  // Query tiles that can see this key tile: from the first row whose causal
  // horizon reaches k0 to the last row whose window still holds the tile's
  // last key.
  const int nqt = (Tq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = nqt;
  if (causal) {
    const int first_row = k0 - offset;
    qt_begin = first_row <= 0 ? 0 : min(first_row / BQ, nqt);
    if (window > 0) {
      const int last_row = min(k0 + BK, Tk) - 1 + window - 1 - offset;
      qt_end = last_row < 0 ? 0 : min(nqt, last_row / BQ + 1);
      qt_end = max(qt_end, qt_begin);
    }
  }

  auto load_stage = [&](int qt, int stage) {
    load_tile_async<BQ, D, kDkvThreads>(Qs + stage * BQ * D, qh, qt * BQ, Tq, stride);
    load_tile_async<BQ, D, kDkvThreads>(dOs + stage * BQ * D, doh, qt * BQ, Tq, stride);
    load_rows_async<BQ>(Ls + stage * BQ, lseh, qt * BQ, Tq);
    load_rows_async<BQ>(Ds + stage * BQ, deltah, qt * BQ, Tq);
  };
  load_tile_async<BK, D, kDkvThreads>(Ks, k + k_head, k0, Tk, stride);
  load_tile_async<BK, D, kDkvThreads>(Vs, v + k_head, k0, Tk, stride);
  if (qt_begin < qt_end) load_stage(qt_begin, 0);
  cp_async_commit();

  const int kr0 = k0 + warp * 16;  // this warp's first key ...
  const int kr_last = min(kr0 + 15, Tk - 1);  // ... and its last real one
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

#pragma unroll 1
  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int stage = (qt - qt_begin) & 1;
    cp_async_wait<0>();  // this thread's copies of query tile qt (and K, V) have landed ...
    __syncthreads();     // ... every thread's have, and every warp is done with tile qt - 1
    if (qt + 1 < qt_end) load_stage(qt + 1, stage ^ 1);  // so qt + 1 fills qt - 1's stage while qt is used
    cp_async_commit();

    const int q0 = qt * BQ;
    const bool ragged = q0 + BQ > Tq;  // padding rows past Tq are masked
    int mode = kr0 >= Tk ? kSkip : tile_mode(q0 + offset, q0 + BQ - 1 + offset, kr0, kr_last, ragged, causal, window);
    if (mode == kSkip) continue;  // no query of this tile sees the warp's keys

    const bf16* Qt = Qs + stage * BQ * D;
    const bf16* dOt = dOs + stage * BQ * D;
    float s[BQ / 8][4], dp[BQ / 8][4];
    mm_abt<D, BQ>(s, Ks, warp * 16, Qt, 0);    // S^T = K Q^T
    mm_abt<D, BQ>(dp, Vs, warp * 16, dOt, 0);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const int col = n * 8 + 2 * t;  // query (in the tile) of elements e = 0 and 2; e = 1, 3: col + 1
      const float2 lse2 = *reinterpret_cast<const float2*>(Ls + stage * BQ + col);
      const float2 del2 = *reinterpret_cast<const float2*>(Ds + stage * BQ + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[n][e] * sl2 - (e & 1 ? lse2.y : lse2.x) * 1.4426950408889634f);
        if (mode == kMasked) {  // only tiles across the diagonal, the window's edge or Tq
          const int qrow = q0 + col + (e & 1);
          if (!(qrow < Tq && visible(qrow + offset, kr0 + g + (e >> 1) * 8, Tk, causal, window))) p = 0.f;
        }
        s[n][e] = p;                                                     // P^T
        dp[n][e] = p * (dp[n][e] - (e & 1 ? del2.y : del2.x)) * scale;  // dS^T
      }
    }
    mm_pb<D, BQ>(dv_acc, s, dOt, 0);  // dV += P^T dO
    mm_pb<D, BQ>(dk_acc, dp, Qt, 0);  // dK += dS^T Q
  }
  cp_async_wait<0>();
  __syncthreads();  // K's and V's rows are free to stage the outputs

  // Warp w read only its own 16 rows of K and V: they stage its dK and dV.
  store_acc<D>(dk + k_head, dk_acc, 1.f, 1.f, Ks + warp * 16 * D, kr0, Tk, stride);
  store_acc<D>(dv + k_head, dv_acc, 1.f, 1.f, Vs + warp * 16 * D, kr0, Tk, stride);
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
                            int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = dkv_bf16_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_bf16_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, (Tk + kDkvBK - 1) / kDkvBK), kDkvThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, Tk, scale,
      causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_dkv_bf16(int D, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
                              int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch_dkv_bf16<32>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    case 64: return launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    case 128: return launch_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kDqBQ = 64;  // query rows per block: 4 warps of 16
constexpr int kDqBK = 64;  // key rows per ring stage
constexpr int kDqThreads = kDqBQ / 16 * 32;

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return sizeof(bf16) * (2 * kDqBQ * D + 2 * 2 * kDqBK * D);  // Q, dO, and a two-stage ring of K and V
}

// As in the forward, the bound of two blocks per SM caps nothing at 128
// threads; here ptxas allocates as many registers with it as without (243,
// 244), and the two builds time within 2% of each other on the card
// (ops/tune_kernels.py).
template <int D>
__global__ void __launch_bounds__(kDqThreads, 2)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Tq, int Tk,
                             float scale, int causal, int window) {
  constexpr int BQ = kDqBQ, BK = kDqBK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ, D]
  bf16* dOs = Qs + BQ * D;                   // [BQ, D]
  bf16* Ks = dOs + BQ * D;                   // [2][BK, D]
  bf16* Vs = Ks + 2 * BK * D;                // [2][BK, D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the last (longest causal) query tiles first
  const int q0 = qt * BQ;
  const int stride = H * D;
  const int offset = Tk - Tq;  // bottom-right causal alignment
  const size_t q_head = ((size_t)b * Tq * H + h) * D;
  const bf16* kh = k + ((size_t)b * Tk * H + h) * D;
  const bf16* vh = v + ((size_t)b * Tk * H + h) * D;

  int kt_begin, kt_end;
  key_tile_range(q0, min(q0 + BQ, Tq) - 1, offset, Tk, BK, causal, window, &kt_begin, &kt_end);

  load_tile_async<BQ, D, kDqThreads>(Qs, q + q_head, q0, Tq, stride);
  load_tile_async<BQ, D, kDqThreads>(dOs, dout + q_head, q0, Tq, stride);
  if (kt_begin < kt_end) {
    load_tile_async<BK, D, kDqThreads>(Ks, kh, kt_begin * BK, Tk, stride);
    load_tile_async<BK, D, kDqThreads>(Vs, vh, kt_begin * BK, Tk, stride);
  }
  cp_async_commit();

  const int row_lo = q0 + warp * 16;  // this warp's first query row
  const int qp_lo = row_lo + offset;  // its position against the keys
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  // lse (log2 units) and Delta of rows g (index 0) and g + 8 (index 1) of the
  // warp's strip. Rows past Tq read 0: their Q and dO rows are zero-filled,
  // so they compute finite values that are never stored.
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + g + 8 * r;
    lse2[r] = row < Tq ? lse[(size_t)bh * Tq + row] * 1.4426950408889634f : 0.f;
    del[r] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

#pragma unroll 1
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait<0>();  // this thread's copies of tile kt (and Q, dO) have landed ...
    __syncthreads();     // ... every thread's have, and every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {  // so tile kt + 1 can fill tile kt - 1's stage while tile kt is used
      load_tile_async<BK, D, kDqThreads>(Ks + (stage ^ 1) * BK * D, kh, (kt + 1) * BK, Tk, stride);
      load_tile_async<BK, D, kDqThreads>(Vs + (stage ^ 1) * BK * D, vh, (kt + 1) * BK, Tk, stride);
    }
    cp_async_commit();

    const int k0 = kt * BK;
    // A row with no visible key has lse = -inf, and exp(S - lse) = inf: only
    // the masked loop below, which selects 0 for it, may see such a row.
    int mode = row_lo >= Tq ? kSkip : tile_mode(qp_lo, qp_lo + 15, k0, k0 + BK - 1, k0 + BK > Tk, causal, window);
    if (mode == kSkip) continue;  // no key of this tile is visible to the warp's rows

    const bf16* Kt = Ks + stage * BK * D;
    float s[BK / 8][4], dp[BK / 8][4];
    mm_abt<D, BK>(s, Qs, warp * 16, Kt, 0);                      // S = Q K^T
    mm_abt<D, BK>(dp, dOs, warp * 16, Vs + stage * BK * D, 0);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[n][e] * sl2 - lse2[e >> 1]);
        if (mode == kMasked) {  // only tiles across the diagonal, the window's left edge or Tk
          if (!visible(qp_lo + g + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1), Tk, causal, window)) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - del[e >> 1]) * scale;  // dS
      }
    }
    mm_pb<D, BK>(dq_acc, dp, Kt, 0);  // dQ += dS K
  }
  cp_async_wait<0>();
  __syncthreads();  // Q's rows are free to stage the output

  // dS carries the scale already: dQ is stored as it is.
  store_acc<D>(dq + q_head, dq_acc, 1.f, 1.f, Qs + warp * 16 * D, row_lo, Tq, stride);
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                           const float* delta, void* dq, int B, int H, int Tq, int Tk, float scale, int causal,
                           int window, cudaStream_t stream) {
  constexpr size_t smem = dq_bf16_smem_bytes<D>();
  auto kernel = flash_bwd_dq_bf16_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, (Tq + kDqBQ - 1) / kDqBQ), kDqThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_dq_bf16(int D, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                             const float* delta, void* dq, int B, int H, int Tq, int Tk, float scale, int causal,
                             int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch_dq_bf16<32>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, scale, causal, window, s);
    case 64: return launch_dq_bf16<64>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, scale, causal, window, s);
    case 128: return launch_dq_bf16<128>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace rtt

// q, dout: [B, Tq, H, D]; k, v: [B, Tk, H, D]; all contiguous, 16-byte aligned,
// one type (is_bf16: 1 bfloat16, 0 float32). lse, delta: [B, H, Tq] f32.
// Writes dk, dv ([B, Tk, H, D], same type). Returns a cudaError_t.
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int is_bf16, int B, int H, int Tq, int Tk,
                                 int D, float scale, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *l = static_cast<const float*>(lse), *d = static_cast<const float*>(delta);
  return is_bf16 ? rtt::sm90::dispatch_dkv_bf16(D, q, k, v, dout, l, d, dk, dv, B, H, Tq, Tk, scale, causal, window, s)
                 : rtt::dispatch_bwd<true>(D, q, k, v, dout, l, d, nullptr, dk, dv, B, H, Tq, Tk, scale, causal,
                                           window, s);
}

// As rtt_flash_bwd_dkv, writing dq ([B, Tq, H, D]).
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, int is_bf16, int B, int H, int Tq, int Tk, int D,
                                float scale, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *l = static_cast<const float*>(lse), *d = static_cast<const float*>(delta);
  return is_bf16 ? rtt::sm90::dispatch_dq_bf16(D, q, k, v, dout, l, d, dq, B, H, Tq, Tk, scale, causal, window, s)
                 : rtt::dispatch_bwd<false>(D, q, k, v, dout, l, d, dq, nullptr, nullptr, B, H, Tq, Tk, scale, causal,
                                            window, s);
}

// A bf16 backward kernel's resources at head width D (kernel 0: dK/dV,
// 1: dQ), on the current device; info as for rtt_flash_fwd_info.
extern "C" int rtt_flash_bwd_info(int kernel, int D, int* info) {
  using namespace rtt::sm90;
  switch (kernel * 1000 + D) {
    case 32: return rtt::kernel_info(flash_bwd_dkv_bf16_kernel<32>, dkv_bf16_smem_bytes<32>(), kDkvThreads, info);
    case 64: return rtt::kernel_info(flash_bwd_dkv_bf16_kernel<64>, dkv_bf16_smem_bytes<64>(), kDkvThreads, info);
    case 128: return rtt::kernel_info(flash_bwd_dkv_bf16_kernel<128>, dkv_bf16_smem_bytes<128>(), kDkvThreads, info);
    case 1032: return rtt::kernel_info(flash_bwd_dq_bf16_kernel<32>, dq_bf16_smem_bytes<32>(), kDqThreads, info);
    case 1064: return rtt::kernel_info(flash_bwd_dq_bf16_kernel<64>, dq_bf16_smem_bytes<64>(), kDqThreads, info);
    case 1128: return rtt::kernel_info(flash_bwd_dq_bf16_kernel<128>, dq_bf16_smem_bytes<128>(), kDqThreads, info);
    default: return cudaErrorInvalidValue;
  }
}
