// Host C++ stand-ins for the CUDA constructs that kernel K3's source
// (mpi_tpu_torch/csrc/bitltl.cu) and the seam band's kernel
// (mpi_tpu_torch/csrc/stencil.cu) use, so that the host compiler builds them
// and they run on the CPU: a thread a lane, the warps of a CTA one after
// another, a shuffle and __syncwarp through a barrier of the warp's 32
// threads, and one buffer for the dynamic shared memory.  K2's body in the
// same source needs a barrier across a CTA's warps, which this emulation
// does not have: it builds, and its __syncthreads aborts.
// tests/test_torch_k3_emulated.py and tests/test_torch_seam_fused.py include
// it in place of <cuda_runtime.h>.
#pragma once
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaDevAttrMultiProcessorCount = 16,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// one SM: the host's run lengths shrink to their floor on small grids
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;
  return cudaSuccess;
}
inline int min(int a, int b) { return a < b ? a : b; }
// the kernels here give each word one writing thread
inline uint32_t atomicAnd(uint32_t* p, uint32_t v) {
  const uint32_t old = *p;
  *p = old & v;
  return old;
}
inline uint32_t atomicOr(uint32_t* p, uint32_t v) {
  const uint32_t old = *p;
  *p = old | v;
  return old;
}

struct uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
// byte i of the result is byte (s >> 4i) & 7 of y:x
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}

inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (s & 31)) >> 32);
}

struct EmulatedWarp {
  std::barrier<> all{32};
  uint32_t value[32];
};
inline thread_local EmulatedWarp* this_warp;

inline uint32_t shuffle_from(uint32_t v, int from) {
  EmulatedWarp& w = *this_warp;
  w.value[threadIdx.x] = v;
  w.all.arrive_and_wait();
  const uint32_t got = from >= 0 && from < 32 ? w.value[from] : v;
  w.all.arrive_and_wait();
  return got;
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) {
  return shuffle_from(v, (int)threadIdx.x - d);
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d) {
  return shuffle_from(v, (int)threadIdx.x + d);
}

inline void __syncwarp() { this_warp->all.arrive_and_wait(); }
inline void __syncthreads() {
  std::fprintf(stderr, "__syncthreads: no barrier across warps here\n");
  std::abort();
}

alignas(16) inline uint32_t emulated_shared_memory[1 << 16];

// kernel<<<grid, block, shared, stream>>>(args...)
template <typename Kernel, typename... Args>
void emulated_launch(Kernel kernel, dim3 grid, dim3 block, size_t,
                     cudaStream_t, Args... args) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        // a CTA's shared memory starts as whatever was there: poison it
        for (uint32_t& word : emulated_shared_memory) word = 0xA5A5A5A5u;
        for (unsigned warp = 0; warp < block.y; ++warp) {
          EmulatedWarp w;
          std::vector<std::thread> lanes;
          for (unsigned lane = 0; lane < block.x; ++lane)
            lanes.emplace_back([&, lane] {
              threadIdx = dim3(lane, warp, 0);
              blockIdx = dim3(x, y, z);
              this_warp = &w;
              kernel(args...);
            });
          for (auto& t : lanes) t.join();
        }
      }
}
