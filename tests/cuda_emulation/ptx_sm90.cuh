// Emulation of ops/csrc/ptx_sm90.cuh (see cuda_runtime.h here): the same
// functions, computing what the PTX instructions compute. Fragment layouts
// of ldmatrix and mma.m16n8k16 as in the PTX ISA, lane = 4 g + t:
// ldmatrix gives lane, for matrix i, row g's elements 2t and 2t+1 (.trans:
// rows 2t and 2t+1 of column g), from the row addresses of lanes 8i..8i+7.
#pragma once

namespace rtt {
namespace sm90 {

inline uint32_t smem_u32(const void* p) { return (uint32_t)((const unsigned char*)p - emu_smem); }

// Copies at once: the emulation checks what the kernels compute, not when
// their copies land.
inline void cp_async16(uint32_t dst, const void* src, bool pred) {
  if (pred)
    std::memcpy(emu_smem + dst, src, 16);
  else
    std::memset(emu_smem + dst, 0, 16);
}
inline void cp_async4(uint32_t dst, const void* src, bool pred) {
  if (pred)
    std::memcpy(emu_smem + dst, src, 4);
  else
    std::memset(emu_smem + dst, 0, 4);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

inline float ex2(float x) {
  const float y = exp2f(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;
}

inline void emu_ldmatrix(uint32_t addr, uint32_t (&r)[4], bool trans) {
  auto& x = emu_exchange();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (addr % 16) {
    std::fprintf(stderr, "ldmatrix: row address %u is not 16-byte aligned\n", addr);
    std::abort();
  }
  x[lane][0] = addr;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    if (!trans) {
      const uint16_t* row = (const uint16_t*)(emu_smem + x[8 * i + g][0]);
      r[i] = row[2 * t] | ((uint32_t)row[2 * t + 1] << 16);
    } else {
      const uint16_t lo = ((const uint16_t*)(emu_smem + x[8 * i + 2 * t][0]))[g];
      const uint16_t hi = ((const uint16_t*)(emu_smem + x[8 * i + 2 * t + 1][0]))[g];
      r[i] = lo | ((uint32_t)hi << 16);
    }
  }
  __syncwarp();
}
inline void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) { emu_ldmatrix(addr, r, false); }
inline void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) { emu_ldmatrix(addr, r, true); }

inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& x = emu_exchange();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) x[lane][i] = a[i];
  x[lane][4] = b0;
  x[lane][5] = b1;
  __syncwarp();
  auto A = [&](int row, int k) {  // a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
    const uint32_t v = x[4 * (row % 8) + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)];
    return emu_bf16_float(k & 1 ? v >> 16 : v);
  };
  auto B = [&](int k, int n) {  // b0 (k 2t.., n g), b1 (k 2t+8.., n g)
    const uint32_t v = x[4 * n + (k % 8) / 2][4 + (k >= 8)];
    return emu_bf16_float(k & 1 ? v >> 16 : v);
  };
  float d[4];
  for (int e = 0; e < 4; ++e) {  // c0, c1 (g, 2t..), c2, c3 (g+8, 2t..)
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    d[e] = s;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

}  // namespace sm90
}  // namespace rtt
