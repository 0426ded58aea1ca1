// Host C++ stand-ins for the CUDA constructs that kernel K3's source
// (mpi_tpu_torch/csrc/bitltl.cu) uses, so that the host compiler builds it
// and it runs on the CPU: a thread a lane, the warps of a CTA one after
// another, a shuffle through a barrier of the warp's 32 threads, and one
// buffer for the dynamic shared memory.  tests/test_torch_k3_emulated.py
// includes it in place of <cuda_runtime.h>.
#pragma once
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)

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
  cudaDevAttrMultiProcessorCount = 16
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// one SM: the host's run lengths shrink to their floor on small grids
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;
  return cudaSuccess;
}
inline int min(int a, int b) { return a < b ? a : b; }

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

inline uint32_t emulated_shared_memory[1 << 16];

// kernel<<<grid, block, shared, stream>>>(args...)
template <typename Kernel, typename... Args>
void emulated_launch(Kernel kernel, dim3 grid, dim3 block, size_t,
                     cudaStream_t, Args... args) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x)
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
