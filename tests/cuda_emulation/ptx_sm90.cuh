// Emulation of ops/csrc/ptx_sm90.cuh (see cuda_runtime.h here): the same
// functions, computing what the PTX instructions compute. Fragment layouts
// of ldmatrix, mma.m16n8k16 and mma.m16n8k8 as in the PTX ISA, lane = 4 g + t:
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
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// cvt.rna.tf32.f32: to nearest with ties away from zero, keeping 10 of the
// 23 mantissa bits (adding half the dropped range to the magnitude bits and
// cutting them rounds |x| half up); NaN stays NaN.
inline uint32_t cvt_tf32(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}

// A tf32 operand as the tensor cores read it: the top 19 bits of the
// register, so an unrounded f32 is truncated.
inline float emu_tf32_float(uint32_t bits) {
  const uint32_t u = bits & 0xffffe000u;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// The tensor cores add c and the 8 exact products of tf32 operands and keep
// no rounding bits: modelled here as their exact sum rounded toward zero
// once. With the model the emulated f32 kernels drift as the card's do when
// they sum a row of keys in the mma: ~1e-5 rel_l2 over rows of 1024 keys
// here, 2.7e-6 to 4.3e-6 over the main shape's causal rows on an H100, ~10x
// what they read with each k-chunk in a fresh fragment added in f32; so the
// kernels sum only a score's D / 8 chunks there (flash_tf32.cuh).
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& x = emu_exchange();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) x[lane][i] = a[i];
  x[lane][4] = b0;
  x[lane][5] = b1;
  __syncwarp();
  auto A = [&](int row, int k) {  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
    return emu_tf32_float(x[4 * (row % 8) + k % 4][(row >= 8) + 2 * (k >= 4)]);
  };
  auto B = [&](int k, int n) {  // b0 (k t, n g), b1 (k t+4, n g)
    return emu_tf32_float(x[4 * n + k % 4][4 + (k >= 4)]);
  };
  float d[4];
  for (int e = 0; e < 4; ++e) {  // c0, c1 (g, 2t..), c2, c3 (g+8, 2t..)
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double s = c[e];
    for (int k = 0; k < 8; ++k) s += (double)A(row, k) * B(k, col);
    float f = (float)s;
    if (std::fabs((double)f) > std::fabs(s)) f = std::nextafter(f, 0.f);
    d[e] = f;
  }
  for (int e = 0; e < 4; ++e) c[e] = d[e];
}

}  // namespace sm90
}  // namespace rtt
