// Stand-in for the CUDA headers when tests/test_torch_kernels_emulated.py
// compiles ops/csrc with g++: each block's threads run as host threads, and
// the warp collectives exchange values through per-warp buffers between
// barriers. Enough of CUDA for the flash kernels, nothing more.
#pragma once

#include <array>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
// The block's dynamic shared memory: blocks run one after another.
alignas(128) inline unsigned char emu_smem[232448];

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes {
  int numRegs;
  size_t sharedSizeBytes, localSizeBytes;
};
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes > (int)sizeof(emu_smem) ? cudaErrorInvalidValue : cudaSuccess;
}
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = {};
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated CUDA error"; }

struct __nv_bfloat16 {
  uint16_t bits;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline uint16_t emu_bf16_bits(float f) {  // round to nearest even, as __float2bfloat16
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40;  // NaN stays NaN
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
inline float emu_bf16_float(uint32_t bits) {
  const uint32_t u = (bits & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) { return {emu_bf16_bits(f)}; }
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) { return {{emu_bf16_bits(lo)}, {emu_bf16_bits(hi)}}; }

struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct float2 {
  float x, y;
};
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

struct EmuBlock {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<std::array<std::array<uint32_t, 8>, 32>> exchange;  // per warp: 8 words a lane
  explicit EmuBlock(int threads) : bar(threads), exchange(threads / 32) {
    for (int w = 0; w < threads / 32; ++w) warp_bars.emplace_back(new std::barrier<>(32));
  }
};
inline thread_local EmuBlock* emu_block;
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
inline std::array<std::array<uint32_t, 8>, 32>& emu_exchange() { return emu_block->exchange[threadIdx.x / 32]; }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  auto& x = emu_exchange();
  const int lane = threadIdx.x & 31;
  std::memcpy(&x[lane][0], &v, 4);
  __syncwarp();
  float r;
  std::memcpy(&r, &x[lane ^ mask][0], 4);
  __syncwarp();
  return r;
}

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// emu_launch(kernel, grid, block, smem, stream, args...): the blocks one
// after another, each with block.x host threads.
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(emu_smem, 0xcd, sizeof(emu_smem));  // no block finds another's data
      EmuBlock blk(block.x);
      std::vector<std::thread> threads;
      for (unsigned tx = 0; tx < block.x; ++tx)
        threads.emplace_back([&, tx] {
          threadIdx = dim3(tx);
          blockIdx = dim3(bx, by);
          blockDim = block;
          gridDim = grid;
          emu_block = &blk;
          kernel(args...);
        });
      for (auto& t : threads) t.join();
    }
}
