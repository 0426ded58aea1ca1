// Kernel K1: `gens` generations (1..16) of a radius-1 outer-totalistic rule
// on a bit-packed Life grid, in one read and one write of device memory.
// Built once per rule: the rule is a header of straight-line LOP3s that
// ops/bit_codegen.py generates, named by -DBIT_RULE_HEADER and found on the
// include path (ops/_build.py: build_rules).
//
// Replaces the TPU kernel `pallas_bit_step` (mpi_tpu/ops/pallas_bitlife.py),
// which streams whole-row slabs through VMEM with DMA halos and rolls lanes
// for the cross-word carries.  The arithmetic per word is the same: carry-save
// column sums f0, f1 of the three rows, those sums shifted one bit left and
// right with carries from the neighbouring words (L0 L1 R0 R1), and the count
// decomposed as count = s0 + 2k, k = L1 + c1 + R1 + carry in 0..4.  The
// generated bit_rule(L0, L1, R0, R1, up, mid, down) does the decomposition and
// the rule in the compiled form of ops/bitlife.py: compile_rule (for Life,
// (k == 1) & (s0 | mid)), as the fewest LOP3s that cover its gates, each with
// its truth table spelled out (nvcc, given the gates as `& | ^` text, needs
// two more per word).
//
// Layout: `in` and `out` are (H, NW) 32-bit words, row-major; bit j of word w
// is the cell at column 32w + j.  The host holds them as int32 tensors; here
// they are uint32_t, so right shifts are logical.
//
// What bounds it on an H100.  One pass moves 8 bytes per word (0.25 B/cell):
// at 3.35 TB/s a 65536^2 grid costs 0.32 ms of traffic.  A generation of Life
// costs 15 integer instructions per word (11 LOP3 and 4 SHF;
// ops/bitlife.py: word_ops), and the card issues ~16.7e12 of those a second,
// so one generation of the same grid costs ~0.12 ms: from three generations
// per pass on, the pass is bound by integer instructions, not bytes.  What
// the design does about that:
//   * temporal blocking: each word is read from device memory once and
//     written once per pass; the tile steps `gens` times in shared memory;
//   * nothing but the generation's own arithmetic in the row loop: 15 LOP3
//     and SHF of 17.75 instructions per word.  The rule is compiled in.  A
//     lane holds K1_WPL (4) adjacent words, so a row moves as one 16-byte
//     shared load and store per lane, three of the four cross-word carries
//     are in the lane's own registers, and a row costs four shuffles for four
//     words.  The last generation, which stores to device memory, has its own
//     loop.  Nothing is tested per word: see the dead boundary below;
//   * one buffer: a generation overwrites the tile in place, so a CTA holds
//     (128 + 2 gens) x 128 words (72 KB at gens 8) and three CTAs share an
//     SM.  Each warp steps a run of rows; before any row is overwritten it
//     reads the row above its run and the row below it, which other warps
//     own, and the CTA synchronises (two barriers per generation);
//   * little redundant work: 126 of a tile row's 128 words are written (one
//     ghost word per side), and gens halo rows per side of 128;
//   * generation 0 goes from device memory to shared memory by cp.async,
//     word by word (a tile row starts at word 126 b - 1, which no wider piece
//     is aligned to), lane l moving words l, l + 32, ... so that a warp reads
//     consecutive words; passes of one generation, which are mostly this load
//     and the store, use 64-row tiles (rows_for).
//
// Why one ghost word per side is enough: a ghost word has no neighbour beyond
// it (the end lanes get their own sums back from the shuffle), so its outer
// bits go stale by one bit per generation; after gens <= 16 < 32 generations
// its inner bit, the only one an owned word reads, is still exact.
//
// Periodic rows and words wrap modulo H and NW (any H >= 1, NW >= 1: the
// tile is a window of the unrolled torus).  Dead rows and words outside the
// grid load as zero, and they stay zero because nothing steps them: a
// generation's row range is cut to the grid's rows once per CTA, and only a
// CTA whose tile row crosses the grid's left or right edge masks its words
// (a per-lane constant); every other CTA, and every CTA of a periodic grid,
// runs the bare loop.  Ragged last tiles are cut on the store.
//
// A padded grid (col_limit > 0: the real width ends inside word NW - 1, and
// the bits of that word at or past it are pad) has those bits zeroed after
// every generation, the stored one included, in every copy of word NW - 1
// that a tile holds: the owned word, a ghost word (whose pad bits an owned
// word would read two generations on), and on a periodic grid the left ghost
// of word 0, which is word NW - 1 of the unrolled torus.  So the mask is a
// per-lane constant from the word's index modulo NW, and only the CTAs whose
// tile holds such a copy take the masked loop (the input's pad bits are read
// as they are, as the plain version reads them).  Built with K1_COL_LIMIT 0
// the kernel has no such code (chip_smoke.py times the two in turns).
//
// Boards: `in` and `out` hold B grids of (H, NW) words one after another;
// blockIdx.z picks the board, so B boards of one rule, depth, boundary and
// width take one launch.
//
// Variants, for chip_smoke.py's timing in turns and nothing else (no wrapper
// and no main path picks one): K1_WPL 1 or 2 words per lane; K1_GHOST 4 (a
// whole ghost lane per side: 120 of 128 words owned, and the lane's four
// words move to and from device memory as one aligned 16-byte piece when NW
// is a multiple of 4 and the grids are 16-byte aligned); K1_ROWS rows per
// CTA at every depth; K1_CP_ASYNC 0 (generation 0 goes through registers);
// K1_RULE_GATES 1 (the rule as `& | ^` text, its cover left to nvcc);
// K1_ZERO_GHOSTS 1 (the end lanes zero the sums they shuffle in);
// K1_EDGE_TESTS 1 (every CTA masks its words); K1_COL_LIMIT 0 (no pad
// columns: the kernel without that code); and K1_RULE_MASKS 1: the rule
// evaluated from run-time birth and survive masks (set with
// gol_bit_set_masks) through indicators of k == v, the form this kernel had
// before the rule was compiled in.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef BIT_RULE_HEADER
#error "bitlife.cu is built per rule: -DBIT_RULE_HEADER=name"
#endif

// One LOP3: the boolean function of three words whose truth table is LUT
// (bit 4a + 2b + c is the output for operand bits a, b, c).
template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

#define BIT_STR2(x) #x
#define BIT_STR(x) BIT_STR2(x)
// bit_rule and bit_rule_gates (L0, L1, R0, R1, up, mid, down)
#include BIT_STR(BIT_RULE_HEADER)

#ifndef K1_WPL
#define K1_WPL 4
#endif
#ifndef K1_GHOST
#define K1_GHOST 1
#endif
#ifndef K1_ROWS
#define K1_ROWS 0
#endif
#ifndef K1_CP_ASYNC
#define K1_CP_ASYNC 1
#endif
#ifndef K1_RULE_GATES
#define K1_RULE_GATES 0
#endif
#ifndef K1_ZERO_GHOSTS
#define K1_ZERO_GHOSTS 0
#endif
#ifndef K1_EDGE_TESTS
#define K1_EDGE_TESTS 0
#endif
#ifndef K1_RULE_MASKS
#define K1_RULE_MASKS 0
#endif
#ifndef K1_COL_LIMIT
#define K1_COL_LIMIT 1
#endif

namespace {

constexpr int W = K1_WPL;              // adjacent words a lane holds
constexpr int kGhost = K1_GHOST;       // ghost words per side of a tile row
constexpr int kLanes = 32;
constexpr int kTileW = kLanes * W;     // words per tile row, ghosts included
constexpr int kOwned = kTileW - 2 * kGhost;  // words a CTA writes per row
constexpr int kWarps = 8;
constexpr int kMaxGens = 16;
// CTAs an SM should hold (caps the registers at 85 a thread); the run-time
// masks keep 20 more words live and are left uncapped
constexpr int kMinCtas = K1_RULE_MASKS ? 1 : 3;
constexpr unsigned kAll = 0xFFFFFFFFu;

// Rows a CTA writes in a pass of `gens` generations: 128, which keeps the
// halo rows under an eighth of the tile, but 64 for a pass of one
// generation, which is mostly the tile's load and store: smaller tiles let
// the CTAs that share an SM be in different phases more often.
__host__ __device__ constexpr int rows_for(int gens) {
  return K1_ROWS ? K1_ROWS : (gens == 1 ? 64 : 128);
}

static_assert(W == 1 || W == 2 || W == 4, "a lane holds 1, 2 or 4 words");
static_assert(kGhost >= 1 && kOwned >= 1, "a tile row owns a word");

// A lane's W adjacent words of one tile row.
struct Words {
  uint32_t w[W];
};

// W words at p, which is aligned to 4 W bytes.
__device__ __forceinline__ Words load_words(const uint32_t* p) {
  Words v;
  if constexpr (W == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v.w[0] = q.x, v.w[1] = q.y, v.w[2] = q.z, v.w[3] = q.w;
  } else if constexpr (W == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v.w[0] = q.x, v.w[1] = q.y;
  } else {
    v.w[0] = *p;
  }
  return v;
}

__device__ __forceinline__ void store_words(uint32_t* p, const Words& v) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  } else {
    *p = v.w[0];
  }
}

#if K1_RULE_MASKS
// The rule from run-time masks: bit c of birth (survive) set iff a dead
// (live) cell with c neighbours is alive next.  Exact for every rule by
// construction: five indicators of k == v, each multiplexed on s0 and mid.
__constant__ uint32_t k1_masks[2];

struct RuleState {
  uint32_t born[10], stay[10];

  __device__ RuleState() {
#pragma unroll
    for (int c = 0; c < 10; ++c) {
      born[c] = (c < 9 && ((k1_masks[0] >> c) & 1u)) ? kAll : 0u;
      stay[c] = (c < 9 && ((k1_masks[1] >> c) & 1u)) ? kAll : 0u;
    }
  }

  __device__ __forceinline__ uint32_t operator()(uint32_t L0, uint32_t L1,
                                                 uint32_t R0, uint32_t R1,
                                                 uint32_t up, uint32_t mid,
                                                 uint32_t down) const {
    // count = s0 + 2k, k = L1 + c1 + R1 + ca
    const uint32_t c0 = up ^ down, c1 = up & down;
    const uint32_t u = L0 ^ c0;
    const uint32_t s0 = u ^ R0;
    const uint32_t ca = (L0 & c0) | (R0 & u);
    const uint32_t p1 = L1 & c1, p2 = R1 & ca, o1 = L1 | c1, o2 = R1 | ca;
    const uint32_t ge1 = o1 | o2;
    const uint32_t ge2 = p1 | p2 | (o1 & o2);
    const uint32_t ge3 = (p1 & o2) | (p2 & o1);
    const uint32_t ge4 = p1 & p2;
    const uint32_t eq[5] = {~ge1, ge1 & ~ge2, ge2 & ~ge3, ge3 & ~ge4, ge4};
    uint32_t next = 0u;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const uint32_t b = (~s0 & born[2 * k]) | (s0 & born[2 * k + 1]);
      const uint32_t s = (~s0 & stay[2 * k]) | (s0 & stay[2 * k + 1]);
      next |= eq[k] & ((~mid & b) | (mid & s));
    }
    return next;
  }
};
#else
struct RuleState {
  __device__ __forceinline__ uint32_t operator()(uint32_t L0, uint32_t L1,
                                                 uint32_t R0, uint32_t R1,
                                                 uint32_t up, uint32_t mid,
                                                 uint32_t down) const {
#if K1_RULE_GATES
    return bit_rule_gates(L0, L1, R0, R1, up, mid, down);
#else
    return bit_rule(L0, L1, R0, R1, up, mid, down);
#endif
  }
};
#endif

// Next state of the lane's words `mid`, given the rows above and below.
// Every lane of the warp calls it together: the column sums of the word
// before the lane's first and after its last arrive by shuffle.  The end
// lanes get their own sums back, which only ever reach a ghost word's outer
// bits (see "one ghost word per side" above).
__device__ __forceinline__ Words next_words(const Words& up, const Words& mid,
                                            const Words& down,
                                            const RuleState& rule, int lane) {
  uint32_t f0[W], f1[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint32_t t = up.w[k] ^ mid.w[k];
    f0[k] = t ^ down.w[k];
    f1[k] = (up.w[k] & mid.w[k]) | (down.w[k] & t);
  }
  uint32_t f0p = __shfl_up_sync(kAll, f0[W - 1], 1);
  uint32_t f1p = __shfl_up_sync(kAll, f1[W - 1], 1);
  uint32_t f0n = __shfl_down_sync(kAll, f0[0], 1);
  uint32_t f1n = __shfl_down_sync(kAll, f1[0], 1);
#if K1_ZERO_GHOSTS
  if (lane == 0) f0p = f1p = 0u;
  if (lane == kLanes - 1) f0n = f1n = 0u;
#endif
  Words next;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint32_t p0 = k > 0 ? f0[k > 0 ? k - 1 : 0] : f0p;
    const uint32_t p1 = k > 0 ? f1[k > 0 ? k - 1 : 0] : f1p;
    const uint32_t n0 = k < W - 1 ? f0[k < W - 1 ? k + 1 : 0] : f0n;
    const uint32_t n1 = k < W - 1 ? f1[k < W - 1 ? k + 1 : 0] : f1n;
    const uint32_t L0 = __funnelshift_l(p0, f0[k], 1);  // f0 << 1 | p0 >> 31
    const uint32_t L1 = __funnelshift_l(p1, f1[k], 1);
    const uint32_t R0 = __funnelshift_r(f0[k], n0, 1);  // f0 >> 1 | n0 << 31
    const uint32_t R1 = __funnelshift_r(f1[k], n1, 1);
    next.w[k] = rule(L0, L1, R0, R1, up.w[k], mid.w[k], down.w[k]);
  }
  (void)lane;
  return next;
}

// Index into [0, n) of a possibly out-of-range row or word index, wrapping.
__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

// The grid index of unrolled row or word index i: wrapped when periodic,
// -1 outside a dead grid.
__device__ __forceinline__ int grid_index(int i, int n, int periodic) {
  if (periodic) return wrap(i, n);
  return i >= 0 && i < n ? i : -1;
}

// BYTES (4 or 16) from device memory to shared memory without passing
// through registers; both addresses are aligned to BYTES.
template <int BYTES>
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src) {
  const uint32_t to = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to),
                 "l"(src)
                 : "memory");
  }
}

// Waits for every copy_async of this thread.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Generation 0: the tile plus `gens` halo rows above and below.  VEC: a lane
// moves the W adjacent words it will step, as one aligned 16-byte piece
// (they lie inside or outside the grid together; W is 4).  Otherwise word by
// word, lane l moving words l, l + 32, ... of a tile row, so that a warp
// reads consecutive words whatever the alignment.  With K1_CP_ASYNC the
// words go straight to shared memory; without, through registers, a batch
// of rows' loads in flight before their stores.
template <bool VEC>
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ in,
                                          uint32_t* tile, int H, int NW,
                                          int gens, int periodic, int span,
                                          int r0, int w0, int lane, int warp) {
  constexpr int N = VEC ? 1 : W;            // pieces a lane moves per row
  constexpr int kStep = VEC ? W : 1;        // words per piece
  constexpr int kStride = VEC ? 0 : kLanes; // words between a lane's pieces
  const int first = VEC ? lane * W : lane;  // the lane's first tile word
  int col[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    col[k] = grid_index(w0 - kGhost + first + k * kStride, NW, periodic);
  uint32_t* mine = tile + first;
#if K1_CP_ASYNC
  for (int i = warp; i < span; i += kWarps) {
    const int row = grid_index(r0 - gens + i, H, periodic);
    const uint32_t* src = in + (size_t)max(row, 0) * NW;
    uint32_t* dst = mine + i * kTileW;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (row >= 0 && col[k] >= 0) {
        copy_async<4 * kStep>(dst + k * kStride, src + col[k]);
      } else if constexpr (VEC) {
        store_words(dst, Words{});
      } else {
        dst[k * kStride] = 0u;
      }
    }
  }
  copy_async_wait();
#else
  constexpr int kBatch = 16 / W;
  for (int i0 = warp; i0 < span; i0 += kWarps * kBatch) {
    Words v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kWarps;
      v[u] = Words{};
      const int row = i < span ? grid_index(r0 - gens + i, H, periodic) : -1;
      if (row >= 0) {
        const uint32_t* src = in + (size_t)row * NW;
        if constexpr (VEC) {
          if (col[0] >= 0) v[u] = load_words(src + col[0]);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k)
            if (col[k] >= 0) v[u].w[k] = src[col[k]];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kWarps;
      if (i >= span) continue;
      if constexpr (VEC) {
        store_words(mine + i * kTileW, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) mine[i * kTileW + k * kLanes] = v[u].w[k];
      }
    }
  }
#endif
}

// One generation of tile rows [a, b), a < b, in place: `up` and `mid` are
// rows a - 1 and a, `bot` is row b, all read before any row was overwritten.
// MASKED: words outside the grid's columns stay zero.
template <bool MASKED>
__device__ __forceinline__ void step_rows(uint32_t* mine, int a, int b,
                                          Words up, Words mid,
                                          const Words& bot,
                                          const uint32_t (&cm)[W],
                                          const RuleState& rule, int lane) {
  uint32_t* p = mine + a * kTileW;
#pragma unroll 3
  for (int i = a; i < b - 1; ++i, p += kTileW) {
    const Words down = load_words(p + kTileW);
    Words next = next_words(up, mid, down, rule, lane);
    if constexpr (MASKED) {
#pragma unroll
      for (int k = 0; k < W; ++k) next.w[k] &= cm[k];
    }
    store_words(p, next);
    up = mid;
    mid = down;
  }
  Words next = next_words(up, mid, bot, rule, lane);
  if constexpr (MASKED) {
#pragma unroll
    for (int k = 0; k < W; ++k) next.w[k] &= cm[k];
  }
  store_words(p, next);
}

// The last generation of tile rows [a, b), a < b, to device memory: tile
// row i is row `row0 + i` of `out`, whose words of this lane start at `dst`
// (row 0).  VEC: the lane stores its W words as one piece if `keep[0]`;
// else word k if `keep[k]`.  MASKED: word k is stored ANDed with cm[k].
template <bool VEC, bool MASKED>
__device__ __forceinline__ void store_rows(const uint32_t* mine, int a, int b,
                                           uint32_t* __restrict__ dst,
                                           int row0, int NW,
                                           const bool (&keep)[W],
                                           const uint32_t (&cm)[W],
                                           const RuleState& rule, int lane) {
  const uint32_t* p = mine + a * kTileW;
  Words up = load_words(p - kTileW), mid = load_words(p);
  uint32_t* q = dst + (size_t)(row0 + a) * NW;
#pragma unroll 3
  for (int i = a; i < b; ++i, p += kTileW, q += NW) {
    const Words down = load_words(p + kTileW);
    Words next = next_words(up, mid, down, rule, lane);
    if constexpr (MASKED) {
#pragma unroll
      for (int k = 0; k < W; ++k) next.w[k] &= cm[k];
    }
    if constexpr (VEC) {
      if (keep[0]) store_words(q, next);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (keep[k]) q[k] = next.w[k];
    }
    up = mid;
    mid = down;
  }
}

__global__ void __launch_bounds__(kLanes * kWarps, kMinCtas)
bit_step_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int H, int NW, int gens, int periodic, int col_limit,
                int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int rows = rows_for(gens);            // rows this CTA writes
  const int span = rows + 2 * gens;           // tile rows, halos included
  const size_t board = (size_t)blockIdx.z * H * NW;
  in += board;
  out += board;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int w0 = blockIdx.x * kOwned;         // first owned word
  const int r0 = blockIdx.y * rows;           // first owned row
  const int gw0 = w0 - kGhost + lane * W;     // the lane's first word, unrolled
  uint32_t* mine = smem + lane * W;           // the lane's words of tile row 0
  const RuleState rule{};

  if (W == 4 && vec) {
    load_tile<W == 4>(in, smem, H, NW, gens, periodic, span, r0, w0, lane,
                      warp);
  } else {
    load_tile<false>(in, smem, H, NW, gens, periodic, span, r0, w0, lane,
                     warp);
  }
  __syncthreads();

  // The tile rows [row_lo, row_hi) and the lane's words with cm set lie in
  // the grid; the rest of a dead grid's tile stays zero, as loaded, because
  // no generation steps it.
  int row_lo = 0, row_hi = span;
  uint32_t cm[W];
  bool masked = K1_EDGE_TESTS;
#pragma unroll
  for (int k = 0; k < W; ++k) cm[k] = kAll;
  if (!periodic) {
    row_lo = max(0, gens - r0);
    row_hi = min(span, H - r0 + gens);
#pragma unroll
    for (int k = 0; k < W; ++k)
      cm[k] = gw0 + k >= 0 && gw0 + k < NW ? kAll : 0u;
    masked = masked || w0 - kGhost < 0 || w0 - kGhost + kTileW > NW;
  }
#if K1_COL_LIMIT
  if (col_limit > 0) {
    // bits [tail, 32) of word NW - 1 are pad, in each copy the tile holds
    const uint32_t keep_bits = (1u << (col_limit - 32 * (NW - 1))) - 1u;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if ((periodic ? wrap(gw0 + k, NW) : gw0 + k) == NW - 1)
        cm[k] &= keep_bits;
    // the first copy of word NW - 1 at or after the tile's first word
    const int u0 = w0 - kGhost;
    const int first = periodic ? u0 + wrap(NW - 1 - u0, NW) : NW - 1;
    masked = masked || (first >= u0 && first < u0 + kTileW);
  }
#else
  (void)col_limit;
#endif

  // generation g < gens steps rows [g, span - g) in place, each warp a run
  for (int g = 1; g < gens; ++g) {
    const int lo = max(g, row_lo), hi = min(span - g, row_hi);
    const int chunk = (hi - lo + kWarps - 1) / kWarps;
    const int a = lo + warp * chunk;
    const int b = min(a + chunk, hi);
    // uniform across the warp: every lane joins the shuffles
    const bool active = a < b;
    Words up, mid, bot;
    if (active) {
      up = load_words(mine + (a - 1) * kTileW);
      mid = load_words(mine + a * kTileW);
      bot = load_words(mine + b * kTileW);
    }
    __syncthreads();  // rows a - 1 and b are other warps' to overwrite
    if (active) {
      if (masked) {
        step_rows<true>(mine, a, b, up, mid, bot, cm, rule, lane);
      } else {
        step_rows<false>(mine, a, b, up, mid, bot, cm, rule, lane);
      }
    }
    __syncthreads();
  }

  // the last generation writes the owned rows and words that lie in the grid
  const int lo = gens, hi = gens + min(rows, H - r0);
  const int chunk = (hi - lo + kWarps - 1) / kWarps;
  const int a = lo + warp * chunk;
  const int b = min(a + chunk, hi);
  if (a < b) {
    bool keep[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = lane * W + k;
      keep[k] = j >= kGhost && j < kTileW - kGhost && gw0 + k < NW;
    }
    uint32_t* dst = out + gw0;
    const int row0 = r0 - gens;
    if (vec) {
      if (masked) {
        store_rows<true, true>(mine, a, b, dst, row0, NW, keep, cm, rule, lane);
      } else {
        store_rows<true, false>(mine, a, b, dst, row0, NW, keep, cm, rule,
                                lane);
      }
    } else if (masked) {
      store_rows<false, true>(mine, a, b, dst, row0, NW, keep, cm, rule, lane);
    } else {
      store_rows<false, false>(mine, a, b, dst, row0, NW, keep, cm, rule,
                               lane);
    }
  }
}

constexpr size_t tile_bytes(int gens) {
  return (size_t)(rows_for(gens) + 2 * gens) * kTileW * sizeof(uint32_t);
}

constexpr size_t max_tile_bytes() {
  size_t most = 0;
  for (int g = 1; g <= kMaxGens; ++g)
    most = tile_bytes(g) > most ? tile_bytes(g) : most;
  return most;
}

// Lets the kernel take the shared memory of its deepest pass (above the
// 48 KB a kernel gets unasked); once per process.
cudaError_t allow_shared_memory() {
  static const cudaError_t err = cudaFuncSetAttribute(
      bit_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)max_tile_bytes());
  return err;
}

}  // namespace

extern "C" {

// Launches one pass over B boards on `stream`; returns a CUDA error code (0
// on success).  `col_limit`: 0, or the real width in cells of a padded grid,
// in (32 (NW - 1), 32 NW].  `in` and `out` must not overlap: neighbouring
// CTAs read each other's rows.
int gol_bit_step(const void* in, void* out, int B, int H, int NW, int gens,
                 int periodic, int col_limit, void* stream) {
  if (B < 1 || H < 1 || NW < 1 || gens < 1 || gens > kMaxGens)
    return (int)cudaErrorInvalidValue;
  if (col_limit == 32LL * NW) col_limit = 0;  // no pad
  if (col_limit != 0 &&
      (!K1_COL_LIMIT || col_limit <= 32LL * (NW - 1) || col_limit > 32LL * NW))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kLanes, kWarps);
  const int rows = rows_for(gens);
  const dim3 grid((NW + kOwned - 1) / kOwned, (H + rows - 1) / rows, B);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return (int)err;
  // a lane's W words move as one piece when every row of every board keeps
  // them aligned
  const uintptr_t align = sizeof(uint32_t) * W;
  const int vec = W == 4 && kGhost % W == 0 && NW % W == 0 &&
                  reinterpret_cast<uintptr_t>(in) % align == 0 &&
                  reinterpret_cast<uintptr_t>(out) % align == 0;
  bit_step_kernel<<<grid, block, tile_bytes(gens),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), H, NW,
      gens, periodic, col_limit, vec);
  return (int)cudaGetLastError();
}

// CTAs of a `gens`-generation pass that fit one SM together, or minus the
// CUDA error code.
int gol_bit_ctas_per_sm(int gens) {
  cudaError_t err = allow_shared_memory();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bit_step_kernel, kLanes * kWarps, tile_bytes(gens));
  return err == cudaSuccess ? n : -(int)err;
}

// Rows a CTA writes in a pass of `gens` generations; also gives the words
// a lane holds and the words a CTA writes per row.
int gol_bit_tile(int gens, int* words_per_lane, int* owned_words) {
  *words_per_lane = W, *owned_words = kOwned;
  return rows_for(gens);
}

#if K1_RULE_MASKS
// The rule of every later launch: bit c of `birth` (`survive`) set iff a
// dead (live) cell with c neighbours is alive next.
int gol_bit_set_masks(unsigned birth, unsigned survive) {
  const uint32_t masks[2] = {birth, survive};
  return (int)cudaMemcpyToSymbol(k1_masks, masks, sizeof(masks));
}
#endif

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
