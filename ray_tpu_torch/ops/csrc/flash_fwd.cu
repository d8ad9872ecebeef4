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
// memory, with the tensor cores nearly as busy. This first version is bound by
// neither: its products are WMMA tiles staged through shared memory, and the
// online-softmax state round-trips through shared memory on every key tile.
//
// Design: one block per (64-row query tile, batch*head); the sequential k loop
// of the TPU grid becomes a loop inside the block over 64-row K/V tiles, each
// loaded once into shared memory and used by all four warps. Causal and
// sliding-window pruning bound that loop as the TPU kernel's does, and the
// ragged tail of a sequence of any length is masked in the kernel. Running
// max, sum and accumulator stay in f32; P is rounded to the input type before
// P*V, as on the TPU. A fully masked row gives 0 and LSE = -inf, never NaN.
#include "flash_common.cuh"

namespace rtt {

template <typename E, int D>
constexpr size_t fwd_smem_bytes() {
  constexpr int BQ = tile_rows<E>(), BK = tile_rows<E>();
  return sizeof(E) * (BQ * D + 2 * BK * D + BQ * BK) + sizeof(float) * (BQ * BK + BQ * D);
}

template <typename E, int D>
__global__ void __launch_bounds__(tile_rows<E>() / kStrip * 32)
    flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v, E* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk, float scale, int causal, int window) {
  constexpr int BQ = tile_rows<E>(), BK = tile_rows<E>();
  extern __shared__ __align__(128) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem);                // [BQ, D]
  E* Ks = Qs + BQ * D;                               // [BK, D]
  E* Vs = Ks + BK * D;                               // [BK, D]
  E* Ps = Vs + BK * D;                               // [BQ, BK]  P in the input type
  float* Ss = reinterpret_cast<float*>(Ps + BQ * BK);  // [BQ, BK]  scores
  float* Acc = Ss + BQ * BK;                         // [BQ, D]   unnormalised output

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int stride = H * D;
  const int offset = Tk - Tq;  // bottom-right causal alignment
  const E* qh = q + ((size_t)b * Tq * H + h) * D;
  const E* kh = k + ((size_t)b * Tk * H + h) * D;
  const E* vh = v + ((size_t)b * Tk * H + h) * D;

  load_tile<E, D>(Qs, qh, q0, BQ, Tq, stride);
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) Acc[i] = 0.f;
  __syncthreads();

  int kt_begin, kt_end;
  key_tile_range(q0, min(q0 + BQ, Tq) - 1, offset, Tk, BK, causal, window, &kt_begin, &kt_end);

  // Row statistics: lanes 2r and 2r+1 of a warp both hold row r of its strip
  // and each handles half of the row's columns.
  const int r = lane >> 1, half = lane & 1;
  const int qpos = q0 + warp * kStrip + r + offset;
  const E* Qw = Qs + warp * kStrip * D;
  E* Pw = Ps + warp * kStrip * BK;
  float* Sw = Ss + warp * kStrip * BK;
  float* Aw = Acc + warp * kStrip * D;
  float m = -INFINITY, l = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<E, D>(Ks, kh, k0, BK, Tk, stride);
    load_tile<E, D>(Vs, vh, k0, BK, Tk, stride);
    __syncthreads();

    warp_mm<E, true, BK, D>(Qw, D, Ks, D, Sw, BK, false);  // S = Q K^T

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
      Pw[r * BK + c] = from_float<E>(p);
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l = l * corr + p_sum;
    m = m_new;
    for (int j = 0; j < D / 2; ++j) Aw[r * D + half * (D / 2) + (j + lane) % (D / 2)] *= corr;
    __syncwarp();

    warp_mm<E, false, D, BK>(Pw, BK, Vs, D, Aw, D, true);  // Acc += P V
  }

  const int row = q0 + warp * kStrip + r;
  if (row < Tq) {
    E* orow = out + ((size_t)(b * Tq + row) * H + h) * D;
    for (int j = 0; j < D / 2; ++j) {
      const int d = half * (D / 2) + j;
      orow[d] = from_float<E>(l > 0.f ? Aw[r * D + d] / l : 0.f);
    }
    if (lse != nullptr && half == 0) lse[(size_t)bh * Tq + row] = m + logf(l);  // -inf when l == 0
  }
}

template <typename E, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int Tq,
                       int Tk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int BQ = tile_rows<E>();
  constexpr size_t smem = fwd_smem_bytes<E, D>();
  auto kernel = flash_fwd_kernel<E, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, BQ / kStrip * 32, smem, stream>>>(static_cast<const E*>(q), static_cast<const E*>(k),
                                                   static_cast<const E*>(v), static_cast<E*>(out),
                                                   static_cast<float*>(lse), H, Tq, Tk, scale, causal, window);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_fwd(int D, const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
                         int Tq, int Tk, float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd<E, 32>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 64: return launch_fwd<E, 64>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    case 128: return launch_fwd<E, 128>(q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rtt

// q, k, v, out: [B, T, H, D] contiguous, 16-byte aligned; lse: [B, H, Tq] f32
// or null. is_bf16: 1 for bfloat16, 0 for float32. Returns a cudaError_t.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int is_bf16, int B,
                             int H, int Tq, int Tk, int D, float scale, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? rtt::dispatch_fwd<__nv_bfloat16>(D, q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, s)
                 : rtt::dispatch_fwd<float>(D, q, k, v, out, lse, B, H, Tq, Tk, scale, causal, window, s);
}

extern "C" const char* rtt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
