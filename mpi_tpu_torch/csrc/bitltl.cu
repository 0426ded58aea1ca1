// Kernel K3: `gens` generations (1..floor(8/r)) of a radius-r (2..7)
// outer-totalistic rule on a bit-packed grid, computed on bit planes, in one
// read and one write of device memory.  Built once per rule: the radius
// (-DLTL_RADIUS) and the rule (a header that ops/ltl_codegen.py generates,
// named by -DLTL_RULE_HEADER and found on the include path) are fixed at
// compile time (ops/_build.py: build_rules).
//
// Replaces the TPU kernel `pallas_ltl_step` (mpi_tpu/ops/pallas_bitltl.py),
// which streams whole-row slabs through VMEM with DMA halos and rolls lanes
// for the cross-word bits.  The arithmetic per word is that of
// ops/bitltl.py: every per-cell integer is a set of 32-bit bit planes (plane
// k holds bit k of 32 cells), and the total is summed rows first
// (ops/bitltl.py: row_count, slide_total):
//   1. the count of each row word's live cells over the 2r+1 columns
//      j-r..j+r, for each bit j: the word and its 2r funnel-shifted copies
//      (the bits beyond it from the neighbouring words, by shuffle) through
//      a carry-save adder tree, bit_width(2r+1) planes; once a row;
//   2. the neighbourhood total, centre included, slides down the rows: the
//      count of the row entering the 2r+1-row window is added and that of
//      the row leaving it subtracted (their difference, sign extended),
//      bit_width((2r+1)^2) planes, whatever the radius;
//   3. the rule: ltl_rule(total, centre), straight-line gates that split
//      the rule's birth and survive tables on the total's planes (a
//      multiplexer each, constant and equal halves folded).
// A sliding window cannot run along the bits of a word, where all 32
// columns are computed at once, but it can down the rows; summing the
// columns first (vertical sums slid down, then a horizontal sum of those
// 4-plane numbers) pays every shift, shuffle and adder of the horizontal
// sum once a plane, and took 171 LOP3 and SHF a word-generation for Bosco
// where this order takes 58 (ops/bitltl.py: ltl_word_ops).
//
// Layout: `in` and `out` are (H, NW) 32-bit words, row-major; bit j of word
// w is the cell at column 32w + j.  The host holds them as int32 tensors;
// here they are uint32_t, so right shifts are logical.
//
// What bounds it on an H100.  One pass moves 8 bytes per word: at 3.35 TB/s
// a 65536^2 grid (2^27 words) costs 0.32 ms of traffic.  A generation of
// Bosco (r = 5) issues 79 instructions a word-generation in its row loop
// (chip_smoke.py, phase "sass"): 63 LOP3 and SHF, 2 SHFL, a load, a
// store, and ~12 for addresses, edges and the loop.  At two integer
// warp-instructions a clock an SM, that and the halo put a 65536^2 pass
// near 0.6 ms, which the 0.70 ms it takes is close to: its time is integer
// instructions, not bytes.  So the kernel
//   * is built per rule, so the plane arrays, the adder trees and the rule
//     are fixed at compile time and live in registers, and the rule costs a
//     few LOP3 (9 for Bosco);
//   * maps one warp lane to one word column of a 32-word column tile (30
//     owned words plus one ghost word per side, as kernel K1 does): the
//     neighbouring words arrive by register shuffle, two a row;
//   * gives each warp its own run of rows and its own state: the counts of
//     the last 2r+1 rows in a ring, the total, and the row words (the
//     centres, and the loads in flight, issued 2(2r+1) - r rows ahead), in
//     registers; no barrier.  The warps of a CTA lie side by side along
//     the rows, so the warps in flight read neighbouring stretches of the
//     same rows;
//   * steps `gens` generations in a wavefront down the run (temporal
//     blocking without a tile): generation g + 1 takes the rows generation
//     g emits, r rows behind it, so a pass still reads and writes device
//     memory once.  One instance of the kernel a depth, so that each takes
//     only the registers its depth needs; deeper than one generation the
//     rings of counts live in the warp's shared memory, since G rings in
//     registers left too few warps an SM (r = 4 at gens 2 took 184
//     registers and ran 14% slower than summing columns first; with its
//     rings in shared memory it runs 34% faster);
//   * makes runs long: a run of L rows computes L + 2 gens r rows at each
//     level (the halo, and the ring filling from zero), 2 r per run at the
//     least, so the host takes K3_ROWS (256) rows a warp, rounded up to
//     whole iterations of the 2(2r+1)-step unrolled loop, and shortens it
//     only for a grid with too few runs to fill the card; runs of 64 rows cost Bosco 13% more than runs of 256,
//     and runs of 512 gain at most 1-2% over 256 at any radius (at gens 1
//     and r <= 3 the host takes 64: see gol_ltl_step).
//
// Why one ghost word per side is enough: a ghost word has no neighbour
// beyond it, so its outer bits go stale by r bits per generation; after
// gens - 1 <= 8/r - 1 generations at most 8 - r of them are stale, and the r
// inner bits that the owned words read are exact.
//
// Periodic rows and words wrap modulo H and NW (any H >= 1, NW >= 1: the
// column tile is a window of the unrolled torus).  Dead rows and words
// outside the grid load as zero and are re-zeroed each generation.  A run
// stores only its own rows.
//
// A padded grid (col_limit > 0: the real width ends inside word NW - 1) has
// the pad bits of word NW - 1 zeroed after every generation in every lane
// that holds a copy of that word, ghost lanes included (on a periodic grid
// the left ghost of word 0 is one): a per-lane mask from the word's index
// modulo NW.  Only warps of a dead grid and warps whose tile holds such a
// copy apply masks; the others store what the rule gives.
//
// Boards: `in` and `out` hold B grids of (H, NW) words one after another;
// blockIdx.z picks the board, so B boards take one launch.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#if !defined(LTL_RADIUS) || !defined(LTL_RULE_HEADER)
#error "bitltl.cu is built per rule: -DLTL_RADIUS=r -DLTL_RULE_HEADER=name"
#endif
// rows a warp steps (rounded up to whole iterations of its row loop): a
// build variant the plan tuner searches (mpi_tpu_torch/tune/space.py)
#ifndef K3_ROWS
#define K3_ROWS 256
#endif
#define LTL_STR2(x) #x
#define LTL_STR(x) LTL_STR2(x)
#include LTL_STR(LTL_RULE_HEADER)  // LTL_RULE_PLANES, ltl_rule(T, mid)

namespace {

constexpr int R = LTL_RADIUS;
constexpr int N = 2 * R + 1;           // rows and columns of a neighbourhood
constexpr int kLanes = 32;             // words per tile row, ghosts included
constexpr int kOwned = kLanes - 2;     // words a warp writes per row
constexpr int kWarps = 4;              // warps a CTA, each on its own run
constexpr unsigned kAll = 0xFFFFFFFFu;
static_assert(R >= 2 && R <= 7, "K3 serves radius 2..7");

__host__ __device__ constexpr int bit_width(int x) {
  return x > 0 ? 1 + bit_width(x >> 1) : 0;
}

// Column sums of a carry-save adder tree over M numbers of P planes each:
// column w holds the numbers' bits of weight w (w < P) and the carries out
// of column w - 1; full adders reduce it to one bit, each pushing a carry
// into column w + 1, so K bits give K / 2 carries.
__host__ __device__ constexpr int col_bits(int M, int P, int w) {
  return w < 0 ? 0 : (w < P ? M : 0) + col_bits(M, P, w - 1) / 2;
}

__host__ __device__ constexpr int out_planes(int M, int P) {
  int w = 0;
  while (col_bits(M, P, w) > 0) ++w;
  return w;
}

template <int M, int P, int W, int NP>
struct Column {
  template <typename Get>
  static __device__ __forceinline__ void run(const Get& get,
                                             const uint32_t* cin,
                                             uint32_t* out) {
    constexpr int own = W < P ? M : 0;
    constexpr int K = col_bits(M, P, W);
    uint32_t bits[K];
#pragma unroll
    for (int n = 0; n < own; ++n) bits[n] = get(n, W);
#pragma unroll
    for (int c = 0; c < K - own; ++c) bits[own + c] = cin[c];
    uint32_t cout[K / 2 > 0 ? K / 2 : 1];
    uint32_t acc = bits[0];
#pragma unroll
    for (int k = 0; k < (K - 1) / 2; ++k) {  // full adders
      const uint32_t x = bits[1 + 2 * k], y = bits[2 + 2 * k];
      const uint32_t t = acc ^ x;
      cout[k] = (acc & x) | (y & t);
      acc = t ^ y;
    }
    if constexpr ((K - 1) % 2 == 1) {        // a half adder for the last bit
      cout[K / 2 - 1] = acc & bits[K - 1];
      acc ^= bits[K - 1];
    }
    out[W] = acc;
    if constexpr (W + 1 < NP) Column<M, P, W + 1, NP>::run(get, cout, out);
  }
};

// out = the sum of M numbers of P planes, get(n, p) giving plane p of number n
template <int M, int P, typename Get>
__device__ __forceinline__ void csa_sum(const Get& get,
                                        uint32_t (&out)[out_planes(M, P)]) {
  Column<M, P, 0, out_planes(M, P)>::run(get, nullptr, out);
}

constexpr int NT = bit_width(N * N);   // planes of the total
static_assert(NT == LTL_RULE_PLANES, "the rule header is for another radius");

// A bit-sliced number of P planes.
template <int P>
struct Num {
  uint32_t p[P];
};

__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

constexpr int NH = out_planes(N, 1);   // planes of a row's count, bit_width(N)
static_assert(NH == bit_width(N), "a row's count keeps every plane");
constexpr int kMaxGens = 8 / R > 1 ? 8 / R : 1;

// The live cells among columns j - R .. j + R of row word x, for each bit
// j: the 2R + 1 funnel-shifted copies of x (the bits beyond the word from
// the neighbouring words px and nx) through a carry-save adder tree.
__device__ __forceinline__ Num<NH> row_count(uint32_t x, uint32_t px,
                                             uint32_t nx) {
  Num<NH> h;
  csa_sum<N, 1>(
      [&](int n, int) {
        if (n == 0) return x;
        if (n <= R) return __funnelshift_r(x, nx, n);
        return __funnelshift_l(px, x, n - R);
      },
      h.p);
  return h;
}

// T + enter - leave, where leave is a count already in T: the difference
// of the two counts (NH planes and its borrow, the sign) is added to T
// with its sign extended.  Modulo 2^NT the sum is exact, and the result
// (at most N^2) fits NT planes, so no plane overflows.
__device__ __forceinline__ void slide(Num<NT>& T, const Num<NH>& enter,
                                      const Num<NH>& leave) {
  uint32_t d[NH], b = 0u;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const uint32_t e = enter.p[k], l = leave.p[k], t = e ^ l;
    d[k] = t ^ b;
    b = (~e & l) | (~t & b);
  }
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const uint32_t x = k < NH ? d[k] : b, t = T.p[k] ^ x;
    const uint32_t carry = (T.p[k] & x) | (c & t);
    T.p[k] = t ^ c;
    c = carry;
  }
}

// How a run treats the grid's edges: a torus whose every bit is a cell, a
// torus with pad bits (col_limit), or dead edges (and perhaps pad bits).
enum Edge { kTorus, kPaddedTorus, kDead };

// Steps an iteration of the row loop: 2N, so that every slot of every
// ring is fixed at compile time and stays in registers, and each is
// rewritten twice an iteration, alternating between two sets of registers
// (no moves); a row's load is issued M - R >= 8 steps before it enters.
constexpr int M = 2 * N;

// The word `i` rows of `nwb` bytes past `p`: one IMAD.WIDE.U32 (byte
// arithmetic on the pointer, which keeps it a global one: LDG and STG)
template <typename T>
__device__ __forceinline__ T* row_at(T* p, unsigned i, unsigned nwb) {
  using Byte = std::conditional_t<std::is_const_v<T>, const char, char>;
  return reinterpret_cast<T*>(reinterpret_cast<Byte*>(p) + (size_t)i * nwb);
}

// One warp's run of rows [a, b): G generations in a wavefront down the
// rows.  Level g (0-based) takes one row word a step from level g - 1
// (level 0 from device memory) and emits the row R above the one that
// entered, whose window that row completed: level g emits row
// s + t - (g + 1) R at step t, and the last level rows a .. b - 1 at steps
// 2 G R onwards.  Every state starts at zero and each total stays the sum
// of the counts in its ring, so a level's first steps, before its window
// holds real rows, emit rows outside the run's halo that nothing reads:
// they cost time and never correctness.  So do the steps that round the
// run up to whole iterations.  `src` is this lane's word column of row 0,
// `out` its word of row a; at gens > 1 the rings of counts live in `cnt`,
// this lane's column of the warp's shared memory, since G levels of them
// in registers would leave too few warps an SM.
template <int G, Edge E>
__device__ __forceinline__ void run_rows(const uint32_t* __restrict__ src,
                                         uint32_t* __restrict__ out,
                                         uint32_t* cnt, int H, int NW, int a,
                                         int b, bool col_in, bool col_out,
                                         uint32_t cm) {
  constexpr bool kShared = G > 1;
  Num<NH> ring[G][N];   // the counts of the last N rows a level took
  Num<NT> total[G];     // their sum: the neighbourhood totals of a row
  uint32_t word[G][M];  // the row words a level took (the centres); level
                        // 0's hold the loads in flight too
  // plane k of the count in slot n of level g's ring, in shared memory
  const auto count = [cnt](int g, int n, int k) -> uint32_t& {
    return cnt[((g * N + n) * NH + k) * kLanes];
  };
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int n = 0; n < M; ++n) word[g][n] = 0u;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        if (kShared)
          count(g, n, k) = 0u;
        else
          ring[g][n].p[k] = 0u;
      }
#pragma unroll
    for (int k = 0; k < NT; ++k) total[g].p[k] = 0u;
  }
  const int s = a - G * R;  // the first row level 0 takes
  const int steps = b - a + 2 * G * R;
  const unsigned nwb = 4u * NW;  // bytes a row
  // level 0's next row, wrapped on a torus; a row is loaded M - R steps
  // before it enters, into the slot whose row has just served as a centre
  int q = E == kDead ? s : wrap(s, H);
  const auto load = [&]() -> uint32_t {
    uint32_t w = 0u;
    if (E != kDead || (col_in && (unsigned)q < (unsigned)H))
      w = *row_at(src, q, nwb);
    ++q;
    if (E != kDead && q == H) q = 0;
    return w;
  };
#pragma unroll
  for (int n = 0; n < M - R; ++n) word[0][n] = load();
  // the last level's row at step t is a + t - 2 G R
  const unsigned rows = col_out ? b - a : 0;
  for (int t0 = 0; t0 < steps; t0 += M) {
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int t = t0 + u;
      uint32_t x = word[0][u];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g > 0) word[g][u % N] = x;
        const uint32_t px = __shfl_up_sync(kAll, x, 1);
        const uint32_t nx = __shfl_down_sync(kAll, x, 1);
        Num<NH> leave;
#pragma unroll
        for (int k = 0; k < NH; ++k)
          leave.p[k] = kShared ? count(g, u % N, k) : ring[g][u % N].p[k];
        const Num<NH> h = row_count(x, px, nx);
        slide(total[g], h, leave);
#pragma unroll
        for (int k = 0; k < NH; ++k) {
          if (kShared)
            count(g, u % N, k) = h.p[k];
          else
            ring[g][u % N].p[k] = h.p[k];
        }
        // the centre: the row that entered R steps ago
        const int c = g == 0 ? (u + M - R) % M : (u + N - R) % N;
        uint32_t nw = ltl_rule(total[g].p, word[g][c]);
        if (g == 0) word[0][c] = load();
        if (E == kPaddedTorus) nw &= cm;
        if (E == kDead) {
          const int gr = s + t - (g + 1) * R;  // the row it emits
          nw &= (unsigned)gr < (unsigned)H ? cm : 0u;
        }
        if (g == G - 1) {
          const unsigned i = t - 2 * G * R;
          if (i < rows) *row_at(out, i, nwb) = nw;
        }
        x = nw;
      }
    }
  }
}

// Shared memory of ltl_step_kernel<G>: the rings of counts of its warps
// at gens > 1
__host__ __device__ constexpr int shared_bytes(int G) {
  return G > 1 ? kWarps * G * N * NH * kLanes * 4 : 0;
}

// K3 at `gens` = G: each warp steps a run of `run` rows of a column tile
// 32 words wide (30 owned words and a ghost word a side).  The warps of a
// CTA lie side by side along the rows (`across`), so that the warps in
// flight read neighbouring stretches of the same rows, or, on a grid of
// few tiles, one above the other.
// (No __launch_bounds__: given the CTA's size, ptxas trades a few bytes
// of spills for one more CTA an SM, and the kernel must not spill.)
template <int G>
__global__ void ltl_step_kernel(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out, int H, int NW,
                                int periodic, int col_limit, int run,
                                int across) {
  extern __shared__ uint32_t smem[];
  const size_t board = (size_t)blockIdx.z * H * NW;
  in += board;
  out += board;
  const int lane = threadIdx.x;
  const int tile = across ? blockIdx.x * kWarps + threadIdx.y : blockIdx.x;
  const int w0 = tile * kOwned;        // first owned word
  const int a = (across ? blockIdx.y : blockIdx.y * kWarps + threadIdx.y) *
                run;                   // first row
  if (w0 >= NW || a >= H) return;      // uniform across the warp
  const int b = min(a + run, H);

  // this lane's word column: gw is the unrolled index, col its grid index
  const int gw = w0 - 1 + lane;
  const bool col_in = periodic || (gw >= 0 && gw < NW);
  const int col = col_in ? wrap(gw, NW) : 0;
  const bool col_out = lane >= 1 && lane <= kOwned && gw < NW;
  // the bits of this lane's word that a generation keeps: none outside a
  // dead grid, the real ones of word NW - 1, else all; a padded torus
  // masks only in CTAs whose tile holds a copy of word NW - 1
  uint32_t cm = col_in ? kAll : 0u;
  bool padded = false;
  if (col_limit > 0) {
    if (col_in && col == NW - 1) cm = (1u << (col_limit - 32 * (NW - 1))) - 1u;
    const int u0 = w0 - 1;
    const int first = periodic ? u0 + wrap(NW - 1 - u0, NW) : NW - 1;
    padded = first >= u0 && first < u0 + kLanes;
  }
  const uint32_t* src = in + col;
  uint32_t* dst = out + (size_t)a * NW + gw;
  uint32_t* cnt = smem + threadIdx.y * (shared_bytes(G) / 4 / kWarps) + lane;
  if (!periodic)
    run_rows<G, kDead>(src, dst, cnt, H, NW, a, b, col_in, col_out, cm);
  else if (padded)
    run_rows<G, kPaddedTorus>(src, dst, cnt, H, NW, a, b, col_in, col_out,
                              cm);
  else
    run_rows<G, kTorus>(src, dst, cnt, H, NW, a, b, col_in, col_out, cm);
}

// launches ltl_step_kernel<gens>, for gens in G..kMaxGens
template <int G>
void launch_gens(int gens, dim3 grid, dim3 block, cudaStream_t stream,
                 const uint32_t* in, uint32_t* out, int H, int NW,
                 int periodic, int col_limit, int run, int across) {
  if constexpr (G <= kMaxGens) {
    if (gens == G)
      ltl_step_kernel<G><<<grid, block, shared_bytes(G), stream>>>(
          in, out, H, NW, periodic, col_limit, run, across);
    else
      launch_gens<G + 1>(gens, grid, block, stream, in, out, H, NW, periodic,
                         col_limit, run, across);
  }
}
}  // namespace

extern "C" {

// Launches one pass over B boards on `stream`; returns a CUDA error code (0
// on success).  `radius` must be the radius this library was built for.
// `col_limit`: 0, or the real width in cells of a padded grid, in
// (32 (NW - 1), 32 NW].  `in` and `out` must not overlap.
int gol_ltl_step(const void* in, void* out, int B, int H, int NW, int radius,
                 int gens, int periodic, int col_limit, void* stream) {
  if (B < 1 || H < 1 || NW < 1 || radius != R || gens < 1 || gens > kMaxGens)
    return (int)cudaErrorInvalidValue;
  if (col_limit == 32LL * NW) col_limit = 0;  // no pad
  if (col_limit != 0 &&
      (col_limit <= 32LL * (NW - 1) || col_limit > 32LL * NW))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kLanes, kWarps);
  // K3_ROWS rows a warp, and kShortRun at gens 1 and r <= 3,
  // where a row is little work next to its bytes and short runs move them
  // faster (65536^2 in ms a pass, runs of 64 against 256: r = 2 0.49 and
  // 0.78, r = 3 0.52 and 0.62; r = 4 0.70 and 0.65).  Halved (down to
  // kMinRun) while the grid's runs would not fill the card kFill warps an
  // SM: a small board gets shorter runs, whose halo costs more, rather
  // than idle SMs
  constexpr int kShortRun = 64, kMinRun = 32, kFill = 16;
  const int halo = 2 * gens * R;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const long long strips = (NW + kOwned - 1) / kOwned;
  int most = gens == 1 && R <= 3 && K3_ROWS > kShortRun ? kShortRun : K3_ROWS;
  while (most > kMinRun &&
         strips * B * ((H + most - 1) / most) < (long long)kFill * sms)
    most /= 2;
  // the shortest run of at least `most` rows whose steps, its rows and
  // the halo of 2 gens R, are whole iterations (rounding down would leave
  // a cap of 32 rows at r = 5 runs of 12); on a grid of more than 65535
  // such runs, the shortest that leaves at most 65535
  const auto whole = [halo](int rows) {
    return (rows + halo + M - 1) / M * M - halo;
  };
  int run = whole(most);
  if ((H + run - 1) / run > 65535) run = whole((H + 65534) / 65535);
  // a CTA's warps side by side on a grid of enough tiles, else stacked
  const int across = strips >= 2 * kWarps;
  const int runs = (H + run - 1) / run;
  const dim3 grid(across ? (strips + kWarps - 1) / kWarps : strips,
                  across ? runs : (runs + kWarps - 1) / kWarps, B);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  launch_gens<1>(gens, grid, block, static_cast<cudaStream_t>(stream),
                 static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
                 H, NW, periodic, col_limit, run, across);
  return (int)cudaGetLastError();
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
