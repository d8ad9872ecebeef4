// Stand-in for the CUDA headers when tests/test_torch_kernels_emulated.py
// compiles ops/csrc with g++: each block's threads run as fibers on the
// launching thread, switched at barriers, and the warp collectives exchange
// values through per-warp buffers between barriers. Enough of CUDA for the
// flash kernels, nothing more.
#pragma once

#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
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

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// A block's threads are fibers on the thread that launches the kernel: a
// fiber runs until it waits at a barrier, then hands the thread back to
// emu_launch, which resumes the next one. Every mma is a warp collective,
// thousands a tile in the f32 kernels: as host threads each cost a kernel
// context switch per lane, and far more on a loaded box. emu_switch(&from,
// to) saves the callee-saved registers on the running stack, stores its
// pointer in `from` and resumes the stack `to`, saved the same way (x86-64
// System V; ucontext's swapcontext makes a system call a switch).
#if !defined(__x86_64__)
#error "the emulation's fiber switch is written for x86-64"
#endif
extern "C" void emu_switch(void** from, void* to);
asm(R"(
.text
.weak emu_switch
.type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size emu_switch, .-emu_switch
)");
struct EmuFiber {
  void* sp = nullptr;
  unsigned tid = 0, collectives = 0;
  bool done = false;
};
inline thread_local void* emu_sched_sp;       // emu_launch's stack
inline thread_local EmuFiber* emu_fiber;      // the fiber running now
inline thread_local unsigned long emu_steps;  // barrier arrivals and fiber ends: progress
inline void emu_yield() { emu_switch(&emu_fiber->sp, emu_sched_sp); }

class EmuBarrier {
 public:
  explicit EmuBarrier(int n) : n_(n) {}
  void arrive_and_wait() {
    ++emu_steps;
    const unsigned gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      return;
    }
    while (gen_ == gen) emu_yield();
  }

 private:
  const int n_;
  int count_ = 0;
  unsigned gen_ = 0;
};

struct EmuBlock {
  EmuBarrier bar;
  std::vector<std::unique_ptr<EmuBarrier>> warp_bars;
  // Per warp two buffers of 8 words a lane, used in turn by successive
  // collectives: a lane writes one only after the barrier of the collective
  // that used the other, which every lane passes after its reads of the
  // buffer before it, so one barrier per collective suffices.
  std::vector<std::array<std::array<uint32_t, 8>, 32>> exchange;
  explicit EmuBlock(int threads) : bar(threads), exchange(threads / 32 * 2) {
    for (int w = 0; w < threads / 32; ++w) warp_bars.emplace_back(new EmuBarrier(32));
  }
};
inline thread_local EmuBlock* emu_block;
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
inline thread_local unsigned emu_collectives;  // collectives the running fiber has entered
inline std::array<std::array<uint32_t, 8>, 32>& emu_exchange() {
  return emu_block->exchange[threadIdx.x / 32 * 2 + (emu_collectives++ & 1)];
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  auto& x = emu_exchange();
  const int lane = threadIdx.x & 31;
  std::memcpy(&x[lane][0], &v, 4);
  __syncwarp();
  float r;
  std::memcpy(&r, &x[lane ^ mask][0], 4);
  return r;
}

inline thread_local std::function<void()>* emu_body;  // the kernel call every fiber makes
inline void emu_fiber_main() {
  (*emu_body)();
  emu_fiber->done = true;
  ++emu_steps;
  emu_yield();  // never resumed
}

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// emu_launch(kernel, grid, block, smem, stream, args...): the blocks one
// after another, each with block.x fibers resumed in turn until all end.
// A pass in which no fiber reaches a barrier or its end is a deadlock.
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, A... args) {
  constexpr size_t kStack = 256 << 10;
  static thread_local std::vector<std::unique_ptr<char[]>> stacks;
  while (stacks.size() < block.x) stacks.emplace_back(new char[kStack]);
  std::function<void()> body = [&] { kernel(args...); };
  emu_body = &body;
  blockDim = block;
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(emu_smem, 0xcd, sizeof(emu_smem));  // no block finds another's data
      EmuBlock blk(block.x);
      emu_block = &blk;
      blockIdx = dim3(bx, by);
      std::vector<EmuFiber> fibers(block.x);
      for (unsigned tx = 0; tx < block.x; ++tx) {
        EmuFiber& f = fibers[tx];
        f.tid = tx;
        // A fresh stack as emu_switch leaves one: six registers, then
        // emu_fiber_main's address, then a return address it never uses.
        void** top = reinterpret_cast<void**>(stacks[tx].get() + kStack);
        top[-1] = nullptr;
        top[-2] = reinterpret_cast<void*>(&emu_fiber_main);
        for (int r = 3; r <= 8; ++r) top[-r] = nullptr;
        f.sp = top - 8;
      }
      for (unsigned left = block.x; left > 0;) {
        const unsigned long steps = emu_steps;
        for (EmuFiber& f : fibers) {
          if (f.done) continue;
          emu_fiber = &f;
          threadIdx = dim3(f.tid);
          emu_collectives = f.collectives;
          emu_switch(&emu_sched_sp, f.sp);
          f.collectives = emu_collectives;
          left -= f.done;
        }
        if (left > 0 && emu_steps == steps) {
          std::fprintf(stderr, "emulated block (%u, %u) deadlocked at a barrier\n", bx, by);
          std::abort();
        }
      }
    }
}
