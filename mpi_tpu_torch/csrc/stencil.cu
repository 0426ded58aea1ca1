// Kernel K2: `gens` generations of a radius-r outer-totalistic rule (r 1..7,
// gens * r <= 16) on a dense grid of uint8 0/1 cells, in one read and one
// write of device memory.
//
// Replaces the TPU kernel `pallas_step` (mpi_tpu/ops/pallas_stencil.py),
// which streams whole-row slabs through VMEM with DMA halos, sums the
// vertical window over row slices and the horizontal one by lane rotation,
// and steps the slab `gens` times (trapezoid) before writing it back.  The
// arithmetic per cell is the same: a (2r+1)-row window sum, a (2r+1)-column
// window sum of it, minus the centre, then the birth/survive test.
//
// What bounds it on an H100.  One pass moves 2 bytes per cell (one read, one
// write): at 3.35 TB/s a 16384^2 grid costs 0.16 ms of traffic.  The least
// arithmetic a generation needs is about 6 integer instructions per cell
// whatever r is, with sliding window sums (a three-input add slides each of
// the vertical and horizontal windows; the centre, the rule's test and the
// result), and every sum fits a byte (<= 225), so four cells can share one
// 32-bit instruction: ~1.5 per cell-generation, 0.024 ms per generation of
// that grid at ~16.7e12 int32 instructions/s.  So a pass is bound by its
// bytes up to 6 generations and by operations beyond.  This simple form
// does far more, one cell per lane and 2(2r+1) one-byte shared loads and
// adds per cell-generation (22 at r = 5).  The kernel
//   * reads each cell from device memory once and writes it once per pass,
//     stepping a tile `gens` times in shared memory (temporal blocking);
//   * tiles the grid in 2-D: a CTA owns 128 x 128 cells and loads a halo of
//     gens * r cells on all four sides (the TPU block spans whole rows, a CTA
//     does not), so generation g computes a window that shrinks by r cells
//     per side, and the last one is exactly the owned tile;
//   * keeps the vertical window sums of a generation in a third shared
//     buffer, so each cell's count is 2(2r+1) byte loads and adds;
//   * applies the rule from a 512-entry shared table indexed by
//     (alive, count), built from the rule's birth and survive bits, so any
//     rule the reference accepts runs, whatever its intervals.
// A warp walks tile rows; its 32 lanes take consecutive cells, so global
// loads and stores are 32 contiguous bytes and shared loads never conflict.
// Processing one byte per lane is the simple form; packing four cells per
// 32-bit lane is later work.
//
// Boundaries.  Periodic rows and columns wrap modulo H and W (any H, W >= 1:
// the tile is a window of the unrolled torus, so a grid smaller than its
// neighbourhood counts wrapped cells more than once, as the serial oracle
// does).  Dead cells outside the grid load as zero and are re-zeroed after
// every in-tile generation on both axes, so they never come alive.  Ragged
// last tiles are masked on the store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;   // owned rows and columns per CTA
constexpr int kWarps = 8;
constexpr int kLanes = 32;

struct DenseRule {
  uint32_t w[16];  // bit c of w[0..7]: born on c; of w[8..15]: stays on c
};

__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

template <int R>
__global__ void __launch_bounds__(kLanes * kWarps)
dense_step_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int H, int W, int gens, int periodic, DenseRule rule) {
  extern __shared__ uint8_t smem[];
  const int h = gens * R;                 // halo cells per side
  const int SR = kTile + 2 * h;           // tile rows, halos included
  const int SC = kTile + 2 * h;           // tile columns, halos included
  const int plane = SR * SC;              // bytes per ping-pong buffer
  uint8_t* vs = smem + 2 * plane;         // vertical window sums
  uint8_t* table = vs + plane;            // [alive * 256 + count]

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int r0 = blockIdx.y * kTile - h;  // grid row of tile row 0
  const int c0 = blockIdx.x * kTile - h;  // grid column of tile column 0

  for (int k = tid; k < 512; k += kLanes * kWarps) {
    table[k] = (rule.w[(k >> 8) * 8 + ((k & 255) >> 5)] >> (k & 31)) & 1u;
  }
  // generation 0: the tile and its halo
  for (int i = warp; i < SR; i += kWarps) {
    const int gr = r0 + i;
    const bool row_in = gr >= 0 && gr < H;
    for (int j = lane; j < SC; j += kLanes) {
      const int gc = c0 + j;
      uint8_t v = 0;
      if (periodic) {
        v = in[(size_t)wrap(gr, H) * W + wrap(gc, W)];
      } else if (row_in && gc >= 0 && gc < W) {
        v = in[(size_t)gr * W + gc];
      }
      smem[i * SC + j] = v;
    }
  }
  __syncthreads();

  // generation g computes the window [g R, S - g R) on both axes; the last
  // one is the owned tile and goes to device memory
  for (int g = 1; g <= gens; ++g) {
    const uint8_t* src = smem + ((g - 1) & 1) * plane;
    uint8_t* dst = smem + (g & 1) * plane;
    const bool last = g == gens;
    const int lo = g * R, hi = SR - g * R;      // this generation's window
    const int vlo = lo - R, vhi = hi + R;       // columns its sums read

    for (int i = lo + warp; i < hi; i += kWarps) {
      for (int j = vlo + lane; j < vhi; j += kLanes) {
        int s = 0;
#pragma unroll
        for (int d = -R; d <= R; ++d) s += src[(i + d) * SC + j];
        vs[i * SC + j] = (uint8_t)s;
      }
    }
    __syncthreads();

    for (int i = lo + warp; i < hi; i += kWarps) {
      const int gr = r0 + i;
      const bool row_in = gr >= 0 && gr < H;
      for (int j = lo + lane; j < hi; j += kLanes) {
        const int gc = c0 + j;
        const int alive = src[i * SC + j];
        int count = -alive;
#pragma unroll
        for (int d = -R; d <= R; ++d) count += vs[i * SC + j + d];
        uint8_t nv = table[alive * 256 + count];
        const bool in_grid = row_in && gc >= 0 && gc < W;
        if (last) {
          if (in_grid) out[(size_t)gr * W + gc] = nv;
        } else {
          if (!periodic && !in_grid) nv = 0;
          dst[i * SC + j] = nv;
        }
      }
    }
    if (!last) __syncthreads();
  }
}

template <int R>
int launch(const void* in, void* out, int H, int W, int gens, int periodic,
           const DenseRule& rule, cudaStream_t stream) {
  const int side = kTile + 2 * gens * R;
  const size_t smem = 3u * side * side + 512u;
  cudaError_t e = cudaFuncSetAttribute(
      dense_step_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(kLanes, kWarps);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  dense_step_kernel<R><<<grid, block, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, W,
      gens, periodic, rule);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one pass on `stream`; returns a CUDA error code (0 on success).
// `table` points to 16 host words: the rule's birth bits (0..7) and
// survive bits (8..15).  `in` and `out` must not overlap.
int gol_dense_step(const void* in, void* out, int H, int W, int radius,
                   int gens, int periodic, const unsigned* table,
                   void* stream) {
  if (H < 1 || W < 1 || gens < 1 || radius < 1 || radius > 7 ||
      gens * radius > 16)
    return (int)cudaErrorInvalidValue;
  DenseRule rule;
  for (int k = 0; k < 16; ++k) rule.w[k] = table[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(in, out, H, W, gens, periodic, rule, s);
    case 2: return launch<2>(in, out, H, W, gens, periodic, rule, s);
    case 3: return launch<3>(in, out, H, W, gens, periodic, rule, s);
    case 4: return launch<4>(in, out, H, W, gens, periodic, rule, s);
    case 5: return launch<5>(in, out, H, W, gens, periodic, rule, s);
    case 6: return launch<6>(in, out, H, W, gens, periodic, rule, s);
    default: return launch<7>(in, out, H, W, gens, periodic, rule, s);
  }
}

}  // extern "C"
