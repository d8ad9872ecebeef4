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
// causal/sliding-window bounds; ragged tails are masked in the kernel.
//
// What bounds them on this card: at the training shapes (T 1024, D 128,
// causal, bf16) dK/dV does ~340 FLOP and dQ ~307 FLOP per byte it must move,
// above the H100's ~295 FLOP/byte balance point, so at the roofline both are
// bound by the tensor cores. This first version reaches neither roof: its
// WMMA products go through shared memory (scores, P, dS and the f32
// accumulators all live there), and the dK/dV block's ~180 KB of shared
// memory leaves one block of four warps per SM. P and dS are rounded to the
// input type before their products, as on the TPU; all sums are f32.
#include "flash_common.cuh"

namespace rtt {

template <typename E, int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = tile_rows<E>(), BK = tile_rows<E>();
  return sizeof(E) * (2 * BK * D + 2 * BQ * D + 2 * BK * BQ) + sizeof(float) * (2 * BK * BQ + 2 * BK * D + 2 * BQ);
}

template <typename E, int D>
constexpr size_t dq_smem_bytes() {
  constexpr int BQ = tile_rows<E>(), BK = tile_rows<E>();
  return sizeof(E) * (2 * BQ * D + 2 * BK * D + BQ * BK) + sizeof(float) * (2 * BQ * BK + BQ * D + 2 * BQ);
}

// One block per (key tile, batch*head); warp w owns key rows [16w, 16w+16).
// Scores are taken transposed, S^T = K Q^T, so that each warp's strip of P^T
// and dS^T is the A operand of its dV and dK products.
template <typename E, int D>
__global__ void __launch_bounds__(tile_rows<E>() / kStrip * 32)
    flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                         const E* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                         E* __restrict__ dk, E* __restrict__ dv, int H, int Tq, int Tk, float scale, int causal,
                         int window) {
  constexpr int BQ = tile_rows<E>(), BK = tile_rows<E>();
  extern __shared__ __align__(128) unsigned char smem[];
  E* Ks = reinterpret_cast<E*>(smem);  // [BK, D]
  E* Vs = Ks + BK * D;                 // [BK, D]
  E* Qs = Vs + BK * D;                 // [BQ, D]
  E* dOs = Qs + BQ * D;                // [BQ, D]
  E* PT = dOs + BQ * D;                // [BK, BQ]  P^T in the input type
  E* dST = PT + BK * BQ;               // [BK, BQ]  dS^T in the input type
  float* ST = reinterpret_cast<float*>(dST + BK * BQ);  // [BK, BQ]
  float* dPT = ST + BK * BQ;           // [BK, BQ]
  float* dKacc = dPT + BK * BQ;        // [BK, D]
  float* dVacc = dKacc + BK * D;       // [BK, D]
  float* lse_s = dVacc + BK * D;       // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int stride = H * D;
  const int offset = Tk - Tq;
  const size_t q_head = ((size_t)b * Tq * H + h) * D, k_head = ((size_t)b * Tk * H + h) * D;

  load_tile<E, D>(Ks, k + k_head, k0, BK, Tk, stride);
  load_tile<E, D>(Vs, v + k_head, k0, BK, Tk, stride);
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
  E* PTw = PT + kw * BQ;
  E* dSTw = dST + kw * BQ;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<E, D>(Qs, q + q_head, q0, BQ, Tq, stride);
    load_tile<E, D>(dOs, dout + q_head, q0, BQ, Tq, stride);
    load_rows(lse_s, lse + (size_t)bh * Tq, q0, BQ, Tq);
    load_rows(delta_s, delta + (size_t)bh * Tq, q0, BQ, Tq);
    __syncthreads();

    warp_mm<E, true, BQ, D>(Ks + kw * D, D, Qs, D, STw, BQ, false);    // S^T = K Q^T
    warp_mm<E, true, BQ, D>(Vs + kw * D, D, dOs, D, dPTw, BQ, false);  // dP^T = V dO^T
    for (int i = lane; i < kStrip * BQ; i += 32) {
      const int kr = i / BQ, c = i % BQ;
      const bool vis = q0 + c < Tq && visible(q0 + c + offset, k0 + kw + kr, Tk, causal, window);
      const float p = vis ? expf(STw[i] * scale - lse_s[c]) : 0.f;
      PTw[i] = from_float<E>(p);
      dSTw[i] = from_float<E>(p * (dPTw[i] - delta_s[c]) * scale);
    }
    __syncwarp();
    warp_mm<E, false, D, BQ>(PTw, BQ, dOs, D, dVacc + kw * D, D, true);  // dV += P^T dO
    warp_mm<E, false, D, BQ>(dSTw, BQ, Qs, D, dKacc + kw * D, D, true);  // dK += dS^T Q
  }

  store_strip<E, D>(dk + k_head, dKacc + kw * D, k0 + kw, Tk, stride);
  store_strip<E, D>(dv + k_head, dVacc + kw * D, k0 + kw, Tk, stride);
}

// One block per (query tile, batch*head); warp w owns query rows [16w, 16w+16).
template <typename E, int D>
__global__ void __launch_bounds__(tile_rows<E>() / kStrip * 32)
    flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                        const E* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                        E* __restrict__ dq, int H, int Tq, int Tk, float scale, int causal, int window) {
  constexpr int BQ = tile_rows<E>(), BK = tile_rows<E>();
  extern __shared__ __align__(128) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem);  // [BQ, D]
  E* dOs = Qs + BQ * D;                // [BQ, D]
  E* Ks = dOs + BQ * D;                // [BK, D]
  E* Vs = Ks + BK * D;                 // [BK, D]
  E* dS = Vs + BK * D;                 // [BQ, BK]  in the input type
  float* S = reinterpret_cast<float*>(dS + BQ * BK);  // [BQ, BK]
  float* dP = S + BQ * BK;             // [BQ, BK]
  float* dQacc = dP + BQ * BK;         // [BQ, D]
  float* lse_s = dQacc + BQ * D;       // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int stride = H * D;
  const int offset = Tk - Tq;
  const size_t q_head = ((size_t)b * Tq * H + h) * D, k_head = ((size_t)b * Tk * H + h) * D;

  load_tile<E, D>(Qs, q + q_head, q0, BQ, Tq, stride);
  load_tile<E, D>(dOs, dout + q_head, q0, BQ, Tq, stride);
  load_rows(lse_s, lse + (size_t)bh * Tq, q0, BQ, Tq);
  load_rows(delta_s, delta + (size_t)bh * Tq, q0, BQ, Tq);
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) dQacc[i] = 0.f;
  __syncthreads();  // a warp may store its strip without entering the loop

  int kt_begin, kt_end;
  key_tile_range(q0, min(q0 + BQ, Tq) - 1, offset, Tk, BK, causal, window, &kt_begin, &kt_end);

  const int qw = warp * kStrip;  // this warp's first query row in the tile
  float* Sw = S + qw * BK;
  float* dPw = dP + qw * BK;
  E* dSw = dS + qw * BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<E, D>(Ks, k + k_head, k0, BK, Tk, stride);
    load_tile<E, D>(Vs, v + k_head, k0, BK, Tk, stride);
    __syncthreads();

    warp_mm<E, true, BK, D>(Qs + qw * D, D, Ks, D, Sw, BK, false);    // S = Q K^T
    warp_mm<E, true, BK, D>(dOs + qw * D, D, Vs, D, dPw, BK, false);  // dP = dO V^T
    for (int i = lane; i < kStrip * BK; i += 32) {
      const int qr = i / BK, c = i % BK;
      const int row = q0 + qw + qr;
      const bool vis = row < Tq && visible(row + offset, k0 + c, Tk, causal, window);
      const float p = vis ? expf(Sw[i] * scale - lse_s[qw + qr]) : 0.f;
      dSw[i] = from_float<E>(p * (dPw[i] - delta_s[qw + qr]) * scale);
    }
    __syncwarp();
    warp_mm<E, false, D, BK>(dSw, BK, Ks, D, dQacc + qw * D, D, true);  // dQ += dS K
  }

  store_strip<E, D>(dq + q_head, dQacc + qw * D, q0 + qw, Tq, stride);
}

template <typename E, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
                       int causal, int window, cudaStream_t stream) {
  constexpr int TILE = tile_rows<E>();
  constexpr int threads = TILE / kStrip * 32;
  const E *qe = static_cast<const E*>(q), *ke = static_cast<const E*>(k), *ve = static_cast<const E*>(v);
  const E* de = static_cast<const E*>(dout);
  if (dk != nullptr) {
    constexpr size_t smem = dkv_smem_bytes<E, D>();
    auto kernel = flash_bwd_dkv_kernel<E, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Tk + TILE - 1) / TILE, B * H), threads, smem, stream>>>(
        qe, ke, ve, de, lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), H, Tq, Tk, scale, causal, window);
  } else {
    constexpr size_t smem = dq_smem_bytes<E, D>();
    auto kernel = flash_bwd_dq_kernel<E, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Tq + TILE - 1) / TILE, B * H), threads, smem, stream>>>(
        qe, ke, ve, de, lse, delta, static_cast<E*>(dq), H, Tq, Tk, scale, causal, window);
  }
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
                         int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch_bwd<E, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    case 64: return launch_bwd<E, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    case 128: return launch_bwd<E, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rtt

// q, dout: [B, Tq, H, D]; k, v: [B, Tk, H, D]; all contiguous, 16-byte aligned,
// one type (is_bf16: 1 bfloat16, 0 float32). lse, delta: [B, H, Tq] f32.
// Writes dk, dv ([B, Tk, H, D], same type). Returns a cudaError_t.
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int is_bf16, int B, int H, int Tq, int Tk,
                                 int D, float scale, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *l = static_cast<const float*>(lse), *d = static_cast<const float*>(delta);
  return is_bf16 ? rtt::dispatch_bwd<__nv_bfloat16>(D, q, k, v, dout, l, d, nullptr, dk, dv, B, H, Tq, Tk, scale,
                                                    causal, window, s)
                 : rtt::dispatch_bwd<float>(D, q, k, v, dout, l, d, nullptr, dk, dv, B, H, Tq, Tk, scale, causal,
                                            window, s);
}

// As rtt_flash_bwd_dkv, writing dq ([B, Tq, H, D]).
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, int is_bf16, int B, int H, int Tq, int Tk, int D,
                                float scale, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *l = static_cast<const float*>(lse), *d = static_cast<const float*>(delta);
  return is_bf16 ? rtt::dispatch_bwd<__nv_bfloat16>(D, q, k, v, dout, l, d, dq, nullptr, nullptr, B, H, Tq, Tk,
                                                    scale, causal, window, s)
                 : rtt::dispatch_bwd<float>(D, q, k, v, dout, l, d, dq, nullptr, nullptr, B, H, Tq, Tk, scale,
                                            causal, window, s);
}
