// Kernel K2: `gens` generations of a radius-r outer-totalistic rule (r 1..7,
// gens * r <= 16) on a dense grid of uint8 0/1 cells, in one read and one
// write of device memory.
//
// Replaces the TPU kernel `pallas_step` (mpi_tpu/ops/pallas_stencil.py),
// which streams whole-row slabs through VMEM with DMA halos, sums the
// vertical window over row slices and the horizontal one by lane rotation,
// and steps the slab `gens` times (trapezoid) before writing it back.  The
// arithmetic per cell is the same: a (2r+1)-row window sum, a (2r+1)-column
// window sum of it, then the birth/survive test.
//
// What bounds it on an H100.  One pass moves 2 bytes per cell (one read, one
// write): at 3.35 TB/s a 16384^2 grid costs 0.16 ms of traffic.  The least
// arithmetic a generation needs is about 6 integer instructions per cell
// whatever r is, with sliding window sums, and every sum fits a byte
// (<= 225), so four cells can share one 32-bit instruction: ~1.5 per
// cell-generation, 0.024 ms per generation of that grid at ~16.7e12 int32
// instructions/s.  So a pass is bound by its bytes up to 6 generations and by
// operations beyond.  The kernel's arithmetic is on words of four byte cells:
//   * a 32-bit add of two such words is four byte adds with no carry between
//     bytes, since every sum is at most (2r+1)^2 <= 225, so one IADD3 slides
//     four columns' vertical window sums down a row (the entering row's
//     word added, the leaving row's subtracted);
//   * each thread owns 4 words (16 cells) of a run of rows and keeps the
//     vertical sums of those words and of ceil(r/4) words either side in
//     registers; the horizontal window sum of a word is the sum of its 2r+1
//     byte-shifted neighbours (one PRMT each, none for a whole-word shift);
//   * the rule is a 512-byte shared table indexed by (alive, total), the
//     total counting the centre; the four indices of a word come from two
//     PRMTs that interleave totals and states.
// So a cell-generation costs about 8.4 instructions at r = 5 (the built
// row loop: 135 per 16 cells, chip_smoke.py phase 1), against 50-58 when a
// lane took one byte cell and summed its windows from shared memory.
//
// Tiling: a CTA owns 128 rows x 256 columns and loads a halo of gens * r
// rows and of 16 columns (the deepest halo) on either side, so generation g
// computes a window that shrinks by r cells per side, and the last one
// covers the owned tile.  A grid narrower than a tile (the seam band of a
// padded periodic grid is 4d columns) runs its own instance, which loads
// and steps only the W owned columns and their halo.  Cells stay bytes in two shared buffers.  A tile
// that lies inside the grid, where the width is a multiple of 16, moves in
// 16-byte chunks with several loads in flight per thread; tiles at an edge
// load byte by byte (wrapping, or zero beyond a dead edge).  Every byte a
// generation reads is 0 or 1 (the margins and the second buffer start at
// zero, and the rule writes only 0 and 1), so no sum of garbage can carry
// into a neighbouring cell.
//
// Boards: `in` and `out` hold B grids of (H, W) cells one after another;
// blockIdx.z picks the board (every index above is within it), so B boards
// take one launch and no halo reads across boards.
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

constexpr int kTileRows = 128;   // owned rows per CTA
constexpr int kTileCols = 256;   // owned columns per CTA
constexpr int kThreads = 256;
constexpr int kGroup = 4;        // words a thread owns per row
constexpr int kPad = 4;          // zero words on either side of a tile row
constexpr int kMaxDepth = 16;    // gens * r
// columns of halo on either side: the deepest halo, so every tile row
// starts 16-byte aligned in the grid and in shared memory
constexpr int kHaloCols = 16;
constexpr int kCellWords = (kTileCols + 2 * kHaloCols) / 4;  // 72
constexpr int kStride = kPad + kCellWords + kPad;  // words per tile row
constexpr int kChunks = kStride / 4;               // 16-byte chunks per row
static_assert(kStride % 4 == 0 && kCellWords % kGroup == 0, "tile layout");

struct DenseRule {
  uint32_t w[16];  // bit c of w[0..7]: born on c; of w[8..15]: stays on c
};

__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

// Word k of a byte-shifted view of the window `v` (words -M..kGroup-1+M of
// the thread's group, v[0] the first): its byte b is cell 4k + b + S.
template <int M, int S>
__device__ __forceinline__ uint32_t shifted(const uint32_t (&v)[kGroup + 2 * M],
                                            int k) {
  constexpr int q = (S >= 0 ? S / 4 : -((3 - S) / 4));  // floor(S / 4)
  constexpr int b = S - 4 * q;
  const int x = k + q + M;
  if constexpr (b == 0) {
    return v[x];
  } else {
    return __byte_perm(v[x], v[x + 1], 0x3210 + 0x1111 * b);
  }
}

template <int R, int M, int S>
__device__ __forceinline__ uint32_t hsum(const uint32_t (&v)[kGroup + 2 * M],
                                         int k) {
  if constexpr (S > R) {
    return 0u;
  } else {
    return shifted<M, S>(v, k) + hsum<R, M, S + 1>(v, k);
  }
}

// words [w - M, w + kGroup + M) of a shared row, w a multiple of kGroup
template <int M>
__device__ __forceinline__ void load_window(const uint32_t* row, int w,
                                            uint32_t (&v)[kGroup + 2 * M]) {
  const uint4 mid = *reinterpret_cast<const uint4*>(row + w);
  v[M] = mid.x; v[M + 1] = mid.y; v[M + 2] = mid.z; v[M + 3] = mid.w;
  if constexpr (M == 1) {
    v[0] = row[w - 1];
    v[kGroup + 1] = row[w + kGroup];
  } else {
    const uint2 l = *reinterpret_cast<const uint2*>(row + w - 2);
    const uint2 r = *reinterpret_cast<const uint2*>(row + w + kGroup);
    v[0] = l.x; v[1] = l.y; v[kGroup + 2] = r.x; v[kGroup + 3] = r.y;
  }
}

// One pass of a CTA.  NARROW (a grid narrower than one tile, W < 256,
// such as the seam band of a padded periodic grid, 4d columns): only the
// chunks and word groups that the W owned columns need are loaded and
// stepped, where a full tile would compute all 256.  It is a kernel of its
// own (dense_narrow_kernel) so that every other grid runs this body with
// the tile width a constant.
template <int R, bool NARROW>
__device__ __forceinline__ void dense_step_body(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int H, int W,
    int gens, int periodic, const DenseRule& rule) {
  constexpr int M = (R + 3) / 4;             // neighbour words per side
  constexpr int KV = kGroup + 2 * M;
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);  // [2][rows][kStride]
  __shared__ uint8_t table[512];             // [alive * 256 + total]
  const size_t board = (size_t)blockIdx.z * H * W;
  in += board;
  out += board;

  const int h = gens * R;                    // rows of halo per side
  const int rows = kTileRows + 2 * h;        // tile rows, halos included
  const int plane = rows * kStride;          // words per ping-pong buffer
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTileRows - h;           // grid row of row 0
  const int c0 = blockIdx.x * kTileCols - kHaloCols;   // grid column of cell 0
  // whole 16-byte chunks of a row can be read and written as such
  const bool aligned = W % 16 == 0 &&
                       ((reinterpret_cast<uintptr_t>(in) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  for (int k = tid; k < 512; k += kThreads) {
    const int alive = k >> 8, count = (k & 255) - alive;
    table[k] = count < 0 ? 0 : (rule.w[alive * 8 + (count >> 5)] >> (count & 31)) & 1u;
  }
  // generation 0: the tile and its halo into buffer 0, zero margins; buffer
  // 1 all zero.  Each thread keeps one 16-byte chunk column of a few rows
  // at a time.
  const int owned = NARROW ? W : kTileCols;  // columns the tile computes
  const int q = tid % kChunks - kPad / 4;    // this thread's chunk of cells
  const int qc = c0 + 16 * q;                // its grid column
  const bool cells = q >= 0 && q < kCellWords / 4 &&
                     (!NARROW || 16 * q < 2 * kHaloCols + owned);
  constexpr int kRowsAtOnce = kThreads / kChunks;
  const bool loader = tid < kRowsAtOnce * kChunks;
  uint4* buf = smem4;
  const int plane4 = plane / 4;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  if (aligned && c0 >= 0 && c0 + 4 * kCellWords <= W && r0 >= 0 &&
      r0 + rows <= H) {
    // every chunk of the tile is a whole chunk of the grid: batches of
    // loads in flight before their stores
    constexpr int kBatch = 8;
    for (int i0 = tid / kChunks; loader && i0 < rows;
         i0 += kBatch * kRowsAtOnce) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kRowsAtOnce;
        v[u] = cells && i < rows
                   ? *reinterpret_cast<const uint4*>(
                         in + (size_t)(r0 + i) * W + qc)
                   : zero4;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kRowsAtOnce;
        if (i < rows) {
          buf[i * kChunks + tid % kChunks] = v[u];
          buf[plane4 + i * kChunks + tid % kChunks] = zero4;
        }
      }
    }
  } else {
    // near an edge: byte by byte, wrapping, or zero beyond a dead edge
    for (int i = tid / kChunks; loader && i < rows; i += kRowsAtOnce) {
      const int gr = r0 + i;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (cells && (periodic || (gr >= 0 && gr < H))) {
        const size_t base = (size_t)(periodic ? wrap(gr, H) : gr) * W;
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int c = qc + b;
          uint32_t cell = 0u;
          if (periodic) {
            cell = in[base + wrap(c, W)];
          } else if (c >= 0 && c < W) {
            cell = in[base + c];
          }
          v[b / 4] |= cell << (8 * (b % 4));
        }
      }
      buf[i * kChunks + tid % kChunks] = make_uint4(v[0], v[1], v[2], v[3]);
      buf[plane4 + i * kChunks + tid % kChunks] = zero4;
    }
  }
  __syncthreads();

  // generation g computes rows [g R, rows - g R) and the groups of words
  // covering columns [16 - (gens - g) R, 16 + owned + (gens - g) R)
  for (int g = 1; g <= gens; ++g) {
    const uint32_t* src = smem + ((g - 1) & 1) * plane;
    uint32_t* dst = smem + (g & 1) * plane;
    const int lo = g * R, hi = rows - g * R;
    const int reach = (gens - g) * R;
    const int g0 = (kHaloCols - reach) / (4 * kGroup);
    const int groups = (kHaloCols + owned + reach + 4 * kGroup - 1) /
                           (4 * kGroup) - g0;
    const int chunks = kThreads / groups;
    const int chunk = (hi - lo + chunks - 1) / chunks;
    const int grp = g0 + tid % groups;
    const int a = lo + (tid / groups) * chunk;
    const int b = min(a + chunk, hi);
    const int w = kPad + kGroup * grp;        // the group's first word

    // dead edges: the bytes of the group's words that lie in the grid
    uint32_t keep[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      keep[j] = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = c0 + 4 * (kGroup * grp + j) + t;
        if (periodic || (c >= 0 && c < W)) keep[j] |= 0xFFu << (8 * t);
      }
    }

    if (a < b) {
      uint32_t v[KV];
#pragma unroll
      for (int x = 0; x < KV; ++x) v[x] = 0u;
#pragma unroll
      for (int d = -R; d <= R; ++d) {
        uint32_t t[KV];
        load_window<M>(src + (a + d) * kStride, w, t);
#pragma unroll
        for (int x = 0; x < KV; ++x) v[x] += t[x];
      }
      for (int i = a; i < b; ++i) {
        if (i > a) {
          uint32_t e[KV], l[KV];
          load_window<M>(src + (i + R) * kStride, w, e);
          load_window<M>(src + (i - R - 1) * kStride, w, l);
#pragma unroll
          for (int x = 0; x < KV; ++x) v[x] = v[x] + e[x] - l[x];
        }
        const uint4 c = *reinterpret_cast<const uint4*>(src + i * kStride + w);
        const uint32_t alive[kGroup] = {c.x, c.y, c.z, c.w};
        const int gr = r0 + i;
        const bool row_in = periodic || (gr >= 0 && gr < H);
        uint32_t nxt[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const uint32_t total = hsum<R, M, -R>(v, j);
          // (total, alive) pairs of bytes 0-1 and 2-3, as 16-bit indices
          const uint32_t p01 = __byte_perm(total, alive[j], 0x5140);
          const uint32_t p23 = __byte_perm(total, alive[j], 0x7362);
          const uint32_t n = table[p01 & 0xFFFFu] |
                             (uint32_t)table[p01 >> 16] << 8 |
                             (uint32_t)table[p23 & 0xFFFFu] << 16 |
                             (uint32_t)table[p23 >> 16] << 24;
          nxt[j] = row_in ? n & keep[j] : 0u;
        }
        *reinterpret_cast<uint4*>(dst + i * kStride + w) =
            make_uint4(nxt[0], nxt[1], nxt[2], nxt[3]);
      }
    }
    __syncthreads();
  }

  // the owned tile, from the last generation's buffer to device memory, a
  // 16-byte chunk at a time
  const uint4* fin = buf + (gens & 1) * plane4;
  constexpr int chunks_owned = kTileCols / 16;  // chunks per owned row
  for (int k = tid; k < kTileRows * chunks_owned; k += kThreads) {
    const int i = k / chunks_owned, x = k % chunks_owned;
    const int gr = blockIdx.y * kTileRows + i;
    const int gc = blockIdx.x * kTileCols + 16 * x;
    if (gr >= H || gc >= W) continue;
    const uint4 v = fin[(h + i) * kChunks + (kPad + kHaloCols / 4) / 4 + x];
    uint8_t* dst = out + (size_t)gr * W + gc;
    if (aligned && gc + 16 <= W) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      for (int t = 0; t < 16 && gc + t < W; ++t)
        dst[t] = (uint8_t)(words[t / 4] >> (8 * (t % 4)));
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
dense_step_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int H, int W, int gens, int periodic, DenseRule rule) {
  dense_step_body<R, false>(in, out, H, W, gens, periodic, rule);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
dense_narrow_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int H, int W, int gens, int periodic, DenseRule rule) {
  dense_step_body<R, true>(in, out, H, W, gens, periodic, rule);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const void* in, void* out, int B, int H,
                  int W, int gens, int periodic, int R, const DenseRule& rule,
                  cudaStream_t stream) {
  const size_t smem =
      2u * (kTileRows + 2 * gens * R) * kStride * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kTileCols - 1) / kTileCols,
                  (H + kTileRows - 1) / kTileRows, B);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, W,
      gens, periodic, rule);
  return (int)cudaGetLastError();
}

template <int R>
int launch(const void* in, void* out, int B, int H, int W, int gens,
           int periodic, const DenseRule& rule, cudaStream_t stream) {
  if (W < kTileCols)
    return launch_kernel(dense_narrow_kernel<R>, in, out, B, H, W, gens,
                         periodic, R, rule, stream);
  return launch_kernel(dense_step_kernel<R>, in, out, B, H, W, gens, periodic,
                       R, rule, stream);
}

}  // namespace

extern "C" {

// Launches one pass over B boards on `stream`; returns a CUDA error code (0
// on success).  `table` points to 16 host words: the rule's birth bits
// (0..7) and survive bits (8..15).  `in` and `out` must not overlap.
int gol_dense_step(const void* in, void* out, int B, int H, int W, int radius,
                   int gens, int periodic, const unsigned* table,
                   void* stream) {
  if (B < 1 || H < 1 || W < 1 || gens < 1 || radius < 1 || radius > 7 ||
      gens * radius > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  DenseRule rule;
  for (int k = 0; k < 16; ++k) rule.w[k] = table[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(in, out, B, H, W, gens, periodic, rule, s);
    case 2: return launch<2>(in, out, B, H, W, gens, periodic, rule, s);
    case 3: return launch<3>(in, out, B, H, W, gens, periodic, rule, s);
    case 4: return launch<4>(in, out, B, H, W, gens, periodic, rule, s);
    case 5: return launch<5>(in, out, B, H, W, gens, periodic, rule, s);
    case 6: return launch<6>(in, out, B, H, W, gens, periodic, rule, s);
    default: return launch<7>(in, out, B, H, W, gens, periodic, rule, s);
  }
}

}  // extern "C"
