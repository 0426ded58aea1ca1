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
// Tiling: a CTA owns K2_ROWS x K2_COLS cells (128 x 256 unless the build
// says otherwise: the tuner's tile variants, ops/_build.py) and loads a
// halo of gens * r rows and of 16 columns (the deepest halo) on either
// side, so generation g computes a window that shrinks by r cells per
// side, and the last one covers the owned tile.  Shared memory is two
// buffers of (K2_ROWS + 2 gens r) rows of 8 + (K2_COLS + 32) / 4 words.  A
// grid narrower than a tile (W < K2_COLS; the seam band of a padded
// periodic grid is 4d columns) runs its own instance, which loads and
// steps only the W owned columns and their halo, so that threshold moves
// with the tile's width.  Cells stay bytes in two shared buffers.  A tile
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
//
// Below K2 lies the seam band of a padded periodic pass in one launch,
// seam_band_kernel, which steps a thin strip as bits at radius 1 and with
// K2's row loop beyond (its own header says how).

#include <atomic>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

#ifndef K2_ROWS
#define K2_ROWS 128
#endif
#ifndef K2_COLS
#define K2_COLS 256
#endif

constexpr int kTileRows = K2_ROWS;   // owned rows per CTA
constexpr int kTileCols = K2_COLS;   // owned columns per CTA
constexpr int kThreads = 256;
constexpr int kGroup = 4;        // words a thread owns per row
constexpr int kPad = 4;          // zero words on either side of a tile row
constexpr int kMaxDepth = 16;    // gens * r
// columns of halo on either side: the deepest halo, so every tile row
// starts 16-byte aligned in the grid and in shared memory
constexpr int kHaloCols = 16;
constexpr int kCellWords = (kTileCols + 2 * kHaloCols) / 4;  // 72 at 256
constexpr int kStride = kPad + kCellWords + kPad;  // words per tile row
constexpr int kChunks = kStride / 4;               // 16-byte chunks per row
static_assert(kTileRows >= 1, "K2_ROWS must be positive");
static_assert(kTileCols >= 16 && kTileCols % 16 == 0,
              "K2_COLS must be a positive multiple of 16");
static_assert(kStride % 4 == 0 && kCellWords % kGroup == 0, "tile layout");
// every thread has a chunk column to load, and every word group of a row
// a thread to step it
static_assert(kChunks <= kThreads &&
                  (2 * kHaloCols + kTileCols) / (4 * kGroup) + 1 <= kThreads,
              "tile too wide for one CTA");

struct DenseRule {
  uint32_t w[16];  // bit c of w[0..7]: born on c; of w[8..15]: stays on c
};

__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

// Word k of a byte-shifted view of the window `v` (words -M..G-1+M of the
// thread's G words, v[0] the first): its byte b is cell 4k + b + S.
template <int G, int M, int S>
__device__ __forceinline__ uint32_t shifted(const uint32_t (&v)[G + 2 * M],
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

template <int R, int G, int M, int S>
__device__ __forceinline__ uint32_t hsum(const uint32_t (&v)[G + 2 * M],
                                         int k) {
  if constexpr (S > R) {
    return 0u;
  } else {
    return shifted<G, M, S>(v, k) + hsum<R, G, M, S + 1>(v, k);
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

// One pass of a CTA.  NARROW (a grid narrower than one tile, W < K2_COLS,
// such as the seam band of a padded periodic grid, 4d columns): only the
// chunks and word groups that the W owned columns need are loaded and
// stepped, where a full tile would compute all K2_COLS.  It is a kernel of
// its own (dense_narrow_kernel) so that every other grid runs this body
// with the tile width a constant.
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
          const uint32_t total = hsum<R, kGroup, M, -R>(v, j);
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

// Lets `Kernel` take `smem` bytes of dynamic shared memory on the current
// device.  The attribute is set the first time a launch asks for more than
// the kernel was allowed so far, and only then: never lowered, and never
// again for a size already allowed (a call costs microseconds of host time,
// and the seam band launches every pass).
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t allow_shared(size_t smem) {
  static std::atomic<size_t> allowed[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (smem <= allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> hold(lock);
  if (smem <= allowed[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) allowed[dev].store(smem, std::memory_order_release);
  return e;
}

template <auto Kernel>
int launch_kernel(const void* in, void* out, int B, int H, int W, int gens,
                  int periodic, int R, const DenseRule& rule,
                  cudaStream_t stream) {
  const size_t smem =
      2u * (kTileRows + 2 * gens * R) * kStride * sizeof(uint32_t);
  const cudaError_t e = allow_shared<Kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kTileCols - 1) / kTileCols,
                  (H + kTileRows - 1) / kTileRows, B);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  Kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, W,
      gens, periodic, rule);
  return (int)cudaGetLastError();
}

template <int R>
int launch(const void* in, void* out, int B, int H, int W, int gens,
           int periodic, const DenseRule& rule, cudaStream_t stream) {
  if (W < kTileCols)
    return launch_kernel<dense_narrow_kernel<R>>(in, out, B, H, W, gens,
                                                 periodic, R, rule, stream);
  return launch_kernel<dense_step_kernel<R>>(in, out, B, H, W, gens,
                                             periodic, R, rule, stream);
}

// -- the seam band of a padded periodic pass, in one launch -----------------
//
// A periodic grid whose width C is not a whole number of words runs on K1 or
// K3 at the padded width, its pad zeroed each generation, so after a pass of
// k generations the d = k r real columns on either side of the wrap seam
// are wrong (parallel/seam.py).  seam_band_kernel recomputes them straight
// from the pass's packed input `in` (which the pass does not write) and
// writes them into its output `out`, after the pass on the same stream:
//   * the strip is real columns [C-2d, C) ++ [0, 2d), 4d <= 124 cells.  A
//     warp owns a run of kSeamRows rows and loads it with d rows of halo
//     either side (the periodic row wrap), a lane a row: the row's packed
//     words that hold the strip (at C = 65000, d = 8: words 2030, 2031 and
//     0) become the strip's 4d bits, in one of the warp's two shared
//     buffers.  Cells beyond the strip's columns are zero, as
//     parallel/seam.py:evolve_band fills them;
//   * generation g steps rows [g r, rows - g r) of the buffer.  After k
//     generations the owned rows' middle 2d columns are exact (the
//     trapezoid argument: the fill's error creeps r columns a generation
//     inward, so no exact column depends on a cell beyond the strip);
//   * a lane an owned row takes strip cells [d, 3d) and writes real
//     columns [C-d, C) and [0, d) into `out` by word masking, so only the
//     seam's bits change and no other thread writes the row's words (word
//     0 holds both ends when C - d < 32).
// Radius 1 (every B/S rule, the padded Life path) steps the strip as bits,
// at most four words a row: a lane a row, its words in turn, the eight
// neighbours counted by full adders into four bit planes and the rule's
// state at each count picked by them (seam_bits).  Wider radii step it as
// K2's byte cells, four to a word (seam_bytes): a buffer row is the strip's
// d words rounded up to groups of four between four zero words a side, and
// K2's row loop (a thread's four words, a vertical window of byte sums slid
// down a stretch of rows, hsum, the (alive, total) table) steps it.
// The warps of a CTA are independent (no barrier but __syncwarp) and B
// boards lie along blockIdx.z as in K2.  The work is small (65000 x 32
// cells x 8 generations a Life pass); what matters is one launch instead
// of thirteen and ~1000 CTAs for the card's 132 SMs.

constexpr int kSeamRows = 32;      // rows a warp owns
constexpr int kSeamWarps = 2;      // warps a CTA
constexpr int kSeamMaxDepth = 31;  // d = k r: the stitch's word mask
constexpr int kTableWords = 128;   // the rule table, 512 bytes a warp
// rounds of a warp's lanes that load a run's rows and halos
constexpr int kLoadRounds = (kSeamRows + 2 * kSeamMaxDepth + 31) / 32;

// words of a byte-cell buffer row at depth d: the strip's d words rounded
// up to groups of four, and kPad zero words a side
__host__ __device__ constexpr int seam_stride(int d) {
  return kPad + (d + kGroup - 1) / kGroup * kGroup + kPad;
}

// words of one warp's shared memory at depth d: the table and two buffers
// of kSeamRows + 2 d rows (the byte cells' rows, the wider form)
__host__ __device__ constexpr int seam_warp_words(int d) {
  return kTableWords + 2 * (kSeamRows + 2 * d) * seam_stride(d);
}

// The strip of each buffer row of the warp's run as 4d bits: strip bits
// [0, 64) in `lo[u]`, [64, 128) in `hi[u]`, for buffer row lane + 32 u
// (grid row a - d + i, wrapped).  Every round's words are loaded before
// any is used: one memory latency.
__device__ __forceinline__ void load_strips(const uint32_t* in, int H, int NW,
                                            int C, int d, int a, int rows,
                                            uint64_t (&lo)[kLoadRounds],
                                            uint64_t (&hi)[kLoadRounds]) {
  const int c0 = C - 2 * d;
  const int w0 = c0 >> 5, sh = c0 & 31, wl = (C - 1) >> 5;
  const uint64_t half = (1ull << (2 * d)) - 1ull;
  uint32_t x[kLoadRounds][5];
#pragma unroll
  for (int u = 0; u < kLoadRounds; ++u) {
    const int i = threadIdx.x + 32 * u;
    if (i < rows) {
      const uint32_t* row = in + (size_t)wrap(a - d + i, H) * NW;
      x[u][0] = row[w0];
      x[u][1] = w0 + 1 <= wl ? row[w0 + 1] : 0u;
      x[u][2] = w0 + 2 <= wl ? row[w0 + 2] : 0u;
      x[u][3] = row[0];
      x[u][4] = 2 * d > 32 ? row[1] : 0u;
    } else {
      x[u][0] = x[u][1] = x[u][2] = x[u][3] = x[u][4] = 0u;
    }
  }
#pragma unroll
  for (int u = 0; u < kLoadRounds; ++u) {
    // real columns [C-2d, C): strip bits [0, 2d); [0, 2d): [2d, 4d)
    uint64_t l = (((uint64_t)x[u][1] << 32) | x[u][0]) >> sh;
    if (sh) l |= (uint64_t)x[u][2] << (64 - sh);
    const uint64_t b = ((uint64_t)x[u][4] << 32 | x[u][3]) & half;
    lo[u] = (l & half) | (b << (2 * d));
    hi[u] = b >> (64 - 2 * d);
  }
}

// `n` <= 31 bits of `field` into the packed row at cell column `col`: a
// clear and a set of the bits in each word they touch, done where the word
// lies (no read comes back to the thread); one thread's two operations on a
// word apply in its program order
__device__ __forceinline__ void put_bits(uint32_t* row, int col,
                                         uint32_t field, int n) {
  const int w = col >> 5, o = col & 31;
  const uint32_t m = (1u << n) - 1u;
  atomicAnd(row + w, ~(m << o));
  atomicOr(row + w, field << o);
  if (o + n > 32) {
    atomicAnd(row + w + 1, ~(m >> (32 - o)));
    atomicOr(row + w + 1, field >> (32 - o));
  }
}

// An owned row's exact columns from its strip bits (`lo`: [0, 64), `hi`:
// [64, 128)): strip [2d, 3d) to real columns [0, d), strip [d, 2d) to
// [C-d, C)
__device__ __forceinline__ void store_seam(uint32_t* row, int C, int d,
                                           uint64_t lo, uint64_t hi) {
  const uint32_t keep = (1u << d) - 1u;
  put_bits(row, 0, (uint32_t)((lo >> (2 * d)) | (hi << (64 - 2 * d))) & keep,
           d);
  put_bits(row, C - d, (uint32_t)((lo >> d) | (hi << (64 - d))) & keep, d);
}

// Radius 1: a rule's states by neighbour count, `e[c]` all ones or all
// zeros, picked for 32 cells by their count's bit planes c3 c2 c1 c0 (a
// count is at most 8, so c3 set means 8)
__device__ __forceinline__ uint32_t pick(const uint32_t (&e)[9], uint32_t c0,
                                         uint32_t c1, uint32_t c2,
                                         uint32_t c3) {
  const uint32_t m01 = (c0 & e[1]) | (~c0 & e[0]);
  const uint32_t m23 = (c0 & e[3]) | (~c0 & e[2]);
  const uint32_t m45 = (c0 & e[5]) | (~c0 & e[4]);
  const uint32_t m67 = (c0 & e[7]) | (~c0 & e[6]);
  const uint32_t m03 = (c1 & m23) | (~c1 & m01);
  const uint32_t m47 = (c1 & m67) | (~c1 & m45);
  const uint32_t m07 = (c2 & m47) | (~c2 & m03);
  return (c3 & e[8]) | (~c3 & m07);
}

// Radius 1: the next states of 32 cells from their rows' words aligned
// with them (west[r] bit s: cell s - 1 of row r; mid, east likewise; row 1
// the cells' own): the eight neighbours counted by full adders into bit
// planes, then the rule's states at those counts, `born` for a dead cell
// and `stays` for a live one
__device__ __forceinline__ uint32_t bits_next(const uint32_t (&west)[3],
                                              const uint32_t (&mid)[3],
                                              const uint32_t (&east)[3],
                                              const uint32_t (&born)[9],
                                              const uint32_t (&stays)[9]) {
  const uint32_t s1 = west[0] ^ mid[0] ^ east[0];
  const uint32_t k1 = (west[0] & mid[0]) | (east[0] & (west[0] ^ mid[0]));
  const uint32_t s2 = west[2] ^ mid[2] ^ east[2];
  const uint32_t k2 = (west[2] & mid[2]) | (east[2] & (west[2] ^ mid[2]));
  const uint32_t s3 = west[1] ^ east[1], k3 = west[1] & east[1];
  const uint32_t c0 = s1 ^ s2 ^ s3;
  const uint32_t k4 = (s1 & s2) | (s3 & (s1 ^ s2));
  const uint32_t t2 = k1 ^ k2 ^ k3;
  const uint32_t k5 = (k1 & k2) | (k3 & (k1 ^ k2));
  const uint32_t c1 = t2 ^ k4, k6 = t2 & k4;
  const uint32_t c2 = k5 ^ k6, c3 = k5 & k6;
  const uint32_t alive = mid[1];
  return (alive & pick(stays, c0, c1, c2, c3)) |
         (~alive & pick(born, c0, c1, c2, c3));
}

// Radius 1: the strip as NB = ceil(4d / 32) words of bits a buffer row
__device__ __forceinline__ void seam_bits(const uint32_t* in, uint32_t* out,
                                          int H, int NW, int C, int gens,
                                          const DenseRule& rule, int a,
                                          uint32_t* buf) {
  const int d = gens;
  const int NB = (4 * d + 31) >> 5;          // words of a row
  const int rows = kSeamRows + 2 * d;
  const int plane = rows * NB;
  const int lane = threadIdx.x;
  uint64_t lo[kLoadRounds], hi[kLoadRounds];
  load_strips(in, H, NW, C, d, a, rows, lo, hi);
#pragma unroll
  for (int u = 0; u < kLoadRounds; ++u) {
    const int i = lane + 32 * u;
    if (i < rows) {
      const uint32_t w[4] = {(uint32_t)lo[u], (uint32_t)(lo[u] >> 32),
                             (uint32_t)hi[u], (uint32_t)(hi[u] >> 32)};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < NB) buf[i * NB + q] = w[q];
    }
  }
  __syncwarp();
  // the rule by neighbour count (0..8): born from a dead cell, stays alive
  uint32_t born[9], stays[9];
#pragma unroll
  for (int c = 0; c <= 8; ++c) {
    born[c] = 0u - ((rule.w[0] >> c) & 1u);
    stays[c] = 0u - ((rule.w[8] >> c) & 1u);
  }
  // the last word keeps only the strip's bits: zero beyond column 4d
  const uint32_t tail = (4 * d) & 31 ? (1u << ((4 * d) & 31)) - 1u : ~0u;
  for (int g = 1; g <= gens; ++g) {
    const uint32_t* src = buf + ((g - 1) & 1) * plane;
    uint32_t* dst = buf + (g & 1) * plane;
    // a lane a row, its words one after another
    for (int i = g + lane; i < rows - g; i += 32) {
      uint32_t rw[3][5];                       // rows above, at and below
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rw[r][q] = q < NB ? src[(i - 1 + r) * NB + q] : 0u;
        rw[r][4] = 0u;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= NB) break;
        // each row's west and east neighbours as words aligned with the
        // cells (bit s sees cell s -/+ 1)
        uint32_t west[3], mid[3], east[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          west[r] = __funnelshift_l(q > 0 ? rw[r][q - 1] : 0u, rw[r][q], 1);
          mid[r] = rw[r][q];
          east[r] = __funnelshift_r(rw[r][q], rw[r][q + 1], 1);
        }
        const uint32_t next = bits_next(west, mid, east, born, stays);
        dst[i * NB + q] = q + 1 < NB ? next : next & tail;
      }
    }
    __syncwarp();
  }
  const uint32_t* fin = buf + (gens & 1) * plane;
  for (int i = lane; i < kSeamRows && a + i < H; i += 32) {
    const uint32_t* w = fin + (d + i) * NB;
    uint32_t x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = q < NB ? w[q] : 0u;
    store_seam(out + (size_t)(a + i) * NW, C, d,
               (uint64_t)x[1] << 32 | x[0], (uint64_t)x[3] << 32 | x[2]);
  }
}

// Radius 2..7: the strip as K2's byte cells
template <int R>
__device__ __forceinline__ void seam_bytes(const uint32_t* in, uint32_t* out,
                                           int H, int NW, int C, int gens,
                                           const DenseRule& rule, int a,
                                           uint32_t* mine) {
  constexpr int M = (R + 3) / 4;               // neighbour words a side
  constexpr int KV = kGroup + 2 * M;
  constexpr int kTotals = (2 * R + 1) * (2 * R + 1) + 1;
  const int d = gens * R;                      // depth, and rows of halo
  const int S = seam_stride(d);                // words of a buffer row
  const int rows = kSeamRows + 2 * d;          // buffer rows, halos included
  const int plane = rows * S;
  const int lane = threadIdx.x;
  uint8_t* table = reinterpret_cast<uint8_t*>(mine);
  uint32_t* buf = mine + kTableWords;

  // the rule at every total a window can hold: table[alive * 256 + total]
  for (int u = lane; u < 2 * kTotals; u += 32) {
    const int alive = u / kTotals, total = u - alive * kTotals;
    const int count = total - alive;
    table[alive * 256 + total] =
        count < 0 ? 0
                  : (rule.w[alive * 8 + (count >> 5)] >> (count & 31)) & 1u;
  }
  // generation 0: strip word j is strip bits [4j, 4j + 4) as byte cells
  uint64_t lo[kLoadRounds], hi[kLoadRounds];
  load_strips(in, H, NW, C, d, a, rows, lo, hi);
  const int groups = (d + kGroup - 1) / kGroup;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int u = 0; u < kLoadRounds; ++u) {
    const int i = lane + 32 * u;
    if (i >= rows) break;
    uint32_t* r0 = buf + i * S;
    *reinterpret_cast<uint4*>(r0) = zero4;
    *reinterpret_cast<uint4*>(r0 + S - kPad) = zero4;
    *reinterpret_cast<uint4*>(r0 + plane) = zero4;
    *reinterpret_cast<uint4*>(r0 + plane + S - kPad) = zero4;
    for (int q = 0; q < groups; ++q) {
      uint32_t v[kGroup];
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        const int j = kGroup * q + t;
        const uint32_t nib = (uint32_t)(j < 16 ? lo[u] >> (4 * j)
                                               : hi[u] >> (4 * j - 64)) & 0xFu;
        v[t] = (nib * 0x00204081u) & 0x01010101u;  // bit t -> byte t
      }
      *reinterpret_cast<uint4*>(r0 + kPad + kGroup * q) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncwarp();

  // each lane a group of four words and one of 32 / groups stretches
  const int parts = 32 / groups;
  const int part = lane / groups;
  const int w = kPad + kGroup * (lane % groups);
  for (int g = 1; g <= gens; ++g) {
    const uint32_t* src = buf + ((g - 1) & 1) * plane;
    uint32_t* dst = buf + (g & 1) * plane;
    const int top = g * R, bottom = rows - g * R;
    const int len = (bottom - top + parts - 1) / parts;
    const int i0 = top + part * len;
    const int i1 = i0 + len < bottom ? i0 + len : bottom;
    if (part < parts && i0 < i1) {
      uint32_t v[KV];
#pragma unroll
      for (int x = 0; x < KV; ++x) v[x] = 0u;
#pragma unroll
      for (int dr = -R; dr <= R; ++dr) {
        uint32_t t[KV];
        load_window<M>(src + (i0 + dr) * S, w, t);
#pragma unroll
        for (int x = 0; x < KV; ++x) v[x] += t[x];
      }
      for (int i = i0; i < i1; ++i) {
        if (i > i0) {
          uint32_t e[KV], l[KV];
          load_window<M>(src + (i + R) * S, w, e);
          load_window<M>(src + (i - R - 1) * S, w, l);
#pragma unroll
          for (int x = 0; x < KV; ++x) v[x] = v[x] + e[x] - l[x];
        }
        const uint4 c = *reinterpret_cast<const uint4*>(src + i * S + w);
        const uint32_t alive[kGroup] = {c.x, c.y, c.z, c.w};
        uint32_t nxt[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const uint32_t total = hsum<R, kGroup, M, -R>(v, j);
          const uint32_t p01 = __byte_perm(total, alive[j], 0x5140);
          const uint32_t p23 = __byte_perm(total, alive[j], 0x7362);
          nxt[j] = table[p01 & 0xFFFFu] | (uint32_t)table[p01 >> 16] << 8 |
                   (uint32_t)table[p23 & 0xFFFFu] << 16 |
                   (uint32_t)table[p23 >> 16] << 24;
        }
        *reinterpret_cast<uint4*>(dst + i * S + w) =
            make_uint4(nxt[0], nxt[1], nxt[2], nxt[3]);
      }
    }
    __syncwarp();
  }

  // strip cells [d, 3d) as bits (byte t of a word to bit t), then stored
  const uint32_t* fin = buf + (gens & 1) * plane;
  for (int i = lane; i < kSeamRows && a + i < H; i += 32) {
    const uint32_t* cells = fin + (d + i) * S + kPad;
    uint64_t l = 0, h = 0;                     // strip bits [0, 64), [64, 128)
    for (int j = d >> 2; j <= (3 * d - 1) >> 2; ++j) {
      const uint64_t nib = (cells[j] * 0x01020408u) >> 24;
      if (j < 16) l |= nib << (4 * j);
      else h |= nib << (4 * j - 64);
    }
    store_seam(out + (size_t)(a + i) * NW, C, d, l, h);
  }
}

template <int R>
__global__ void __launch_bounds__(kSeamWarps * 32)
seam_band_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int H, int NW, int C, int gens, DenseRule rule) {
  extern __shared__ uint4 smem4[];
  const int a = (blockIdx.y * kSeamWarps + threadIdx.y) * kSeamRows;
  if (a >= H) return;                          // uniform across the warp
  const size_t board = (size_t)blockIdx.z * H * NW;
  uint32_t* mine = reinterpret_cast<uint32_t*>(smem4) +
                   threadIdx.y * seam_warp_words(gens * R);
  if constexpr (R == 1)
    seam_bits(in + board, out + board, H, NW, C, gens, rule, a, mine);
  else
    seam_bytes<R>(in + board, out + board, H, NW, C, gens, rule, a, mine);
}

template <int R>
int launch_seam(const void* in, void* out, int B, int H, int NW, int C,
                int gens, const DenseRule& rule, cudaStream_t stream) {
  const size_t smem =
      (size_t)kSeamWarps * seam_warp_words(gens * R) * sizeof(uint32_t);
  const cudaError_t e = allow_shared<seam_band_kernel<R>>(smem);
  if (e != cudaSuccess) return (int)e;
  const int runs = (H + kSeamRows - 1) / kSeamRows;
  const dim3 grid(1, (runs + kSeamWarps - 1) / kSeamWarps, B);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(32, kSeamWarps);
  seam_band_kernel<R><<<grid, block, smem, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), H, NW,
      C, gens, rule);
  return (int)cudaGetLastError();
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

// Rewrites the seam columns of a pass of `gens` generations of a radius-r
// rule on B padded periodic boards: reads the pass's packed input `in`
// (B, H, NW) and writes real columns [C-d, C) and [0, d), d = gens r, of
// its output `out`, which the pass has written, on `stream` after it;
// every other bit of `out` is left as it is.  Returns a CUDA error code.
// Needs 1 <= d <= 31 and 4d <= C <= 32 NW; `table` as for gol_dense_step.
int gol_seam_band(const void* in, void* out, int B, int H, int NW, int C,
                  int radius, int gens, const unsigned* table, void* stream) {
  if (B < 1 || H < 1 || NW < 1 || gens < 1 || radius < 1 || radius > 7 ||
      gens * radius > kSeamMaxDepth || C < 4 * gens * radius ||
      C > 32LL * NW)
    return (int)cudaErrorInvalidValue;
  DenseRule rule;
  for (int k = 0; k < 16; ++k) rule.w[k] = table[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch_seam<1>(in, out, B, H, NW, C, gens, rule, s);
    case 2: return launch_seam<2>(in, out, B, H, NW, C, gens, rule, s);
    case 3: return launch_seam<3>(in, out, B, H, NW, C, gens, rule, s);
    case 4: return launch_seam<4>(in, out, B, H, NW, C, gens, rule, s);
    case 5: return launch_seam<5>(in, out, B, H, NW, C, gens, rule, s);
    case 6: return launch_seam<6>(in, out, B, H, NW, C, gens, rule, s);
    default: return launch_seam<7>(in, out, B, H, NW, C, gens, rule, s);
  }
}

}  // extern "C"
