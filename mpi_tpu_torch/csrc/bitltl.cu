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
// k holds bit k of 32 cells);
//   1. the vertical sum of the 2r+1 row words of a column (at most 4
//      planes) slides down the rows: the entering row's word is added and the
//      leaving row's subtracted, bit-sliced;
//   2. the horizontal sum over 2r+1 columns (the neighbourhood total, centre
//      included, at most 8 planes), either by carry-save adders over the
//      2r+1 funnel-shifted copies of the vertical sum (LTL_HSUM 0), or by
//      doubling window sums S2 = v + (v >> 1), S4 = S2 + (S2 >> 2), ...
//      (LTL_HSUM 1); ops/_build.py picks the faster by radius, from
//      chip_smoke.py phase 4, which times both in turns;
//   3. the rule: ltl_rule(total, centre), straight-line gates that split
//      the rule's birth and survive tables on the total's planes (a
//      multiplexer each, constant and equal halves folded).
//
// Layout: `in` and `out` are (H, NW) 32-bit words, row-major; bit j of word
// w is the cell at column 32w + j.  The host holds them as int32 tensors;
// here they are uint32_t, so right shifts are logical.
//
// What bounds it on an H100.  One pass moves 8 bytes per word: at 3.35 TB/s
// a 65536^2 grid (2^27 words) costs 0.32 ms of traffic.  A generation of
// Bosco (r = 5) costs at least 7 and, in the carry-save form, 171 LOP3 and
// SHF per word (ops/bitltl.py: ltl_word_ops_lower, ltl_word_ops); the
// kernel issues about 180 instructions per word-generation, so its time is
// integer instructions at every depth, not bytes.  So the kernel
//   * is built per rule, so the plane arrays, the adder trees and the rule
//     are fixed at compile time and live in registers, and the rule costs a
//     few LOP3 (9 for Bosco) instead of comparators over run-time
//     thresholds (about 194 instructions per word-generation for Bosco);
//   * maps one warp lane to one word column of a 32-word tile row (30 owned
//     words plus one ghost word per side, as kernel K1 does): the
//     neighbouring words' planes arrive by register shuffle;
//   * gives each warp a run of rows, summing the first row's 2r+1 words in
//     full and sliding the sum down the rest: three shared loads per
//     word-generation;
//   * steps the tile `gens` times in shared memory (temporal blocking), each
//     generation shrinking the valid rows by r per side, and re-zeroes,
//     after every in-tile generation, the cells outside a dead-boundary grid.
//
// Why one ghost word per side is enough: a ghost word has no neighbour
// beyond it, so its outer bits go stale by r bits per generation; after
// gens - 1 <= 8/r - 1 generations at most 8 - r of them are stale, and the r
// inner bits that the owned words read are exact.
//
// Periodic rows and words wrap modulo H and NW (any H >= 1, NW >= 1: the tile
// is a window of the unrolled torus).  Dead rows and words outside the grid
// load as zero and are re-zeroed each generation.  Ragged last tiles are
// masked on the store.
//
// A padded grid (col_limit > 0: the real width ends inside word NW - 1) has
// the pad bits of word NW - 1 zeroed after every generation in every lane
// that holds a copy of that word, ghost lanes included (on a periodic grid
// the left ghost of word 0 is one): a per-lane mask from the word's index
// modulo NW.  Only CTAs of a dead grid and CTAs whose tile holds such a copy
// apply masks; the others store what the rule gives.
//
// Boards: `in` and `out` hold B grids of (H, NW) words one after another;
// blockIdx.z picks the board, so B boards take one launch.

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(LTL_RADIUS) || !defined(LTL_RULE_HEADER)
#error "bitltl.cu is built per rule: -DLTL_RADIUS=r -DLTL_RULE_HEADER=name"
#endif
#ifndef LTL_HSUM
#define LTL_HSUM 1
#endif
// rows a CTA writes: the CTA tile, a build variant the plan tuner searches
// (mpi_tpu_torch/tune/space.py); a tile of more than 128 rows opts in to
// more than the 48 KB of shared memory a kernel gets unasked
#ifndef K3_ROWS
#define K3_ROWS 128
#endif
#define LTL_STR2(x) #x
#define LTL_STR(x) LTL_STR2(x)
#include LTL_STR(LTL_RULE_HEADER)  // LTL_RULE_PLANES, ltl_rule(T, mid)

namespace {

constexpr int R = LTL_RADIUS;
constexpr int N = 2 * R + 1;           // rows and columns of a neighbourhood
constexpr int kLanes = 32;             // words per tile row, ghosts included
constexpr int kOwned = kLanes - 2;     // words a CTA writes per row
constexpr int kRows = K3_ROWS;         // rows a CTA writes
constexpr int kWarps = 8;
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

constexpr int NV = out_planes(N, 1);   // planes of a vertical sum
constexpr int NT = bit_width(N * N);   // planes of the total
static_assert(NT == LTL_RULE_PLANES, "the rule header is for another radius");

// A bit-sliced number of P planes.
template <int P>
struct Num {
  uint32_t p[P];
};

// v - leave + enter, where leave is a row already in v: the decrement comes
// first, so no plane overflows.
__device__ __forceinline__ void slide(Num<NV>& v, uint32_t enter,
                                      uint32_t leave) {
  uint32_t b = leave, c = enter;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const uint32_t t = ~v.p[k] & b;
    v.p[k] ^= b;
    b = t;
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const uint32_t t = v.p[k] & c;
    v.p[k] ^= c;
    c = t;
  }
}

// The planes of the next lane's (ahead) or previous lane's number.  The
// ghost lanes at either end get their own planes back: the bits those
// feed are a ghost word's outer bits, stale in any case, and no lane
// reads them (see "one ghost word per side" above).
template <int P>
__device__ __forceinline__ Num<P> next_lane(const Num<P>& x) {
  Num<P> o;
#pragma unroll
  for (int k = 0; k < P; ++k) o.p[k] = __shfl_down_sync(kAll, x.p[k], 1);
  return o;
}

template <int P>
__device__ __forceinline__ Num<P> prev_lane(const Num<P>& x) {
  Num<P> o;
#pragma unroll
  for (int k = 0; k < P; ++k) o.p[k] = __shfl_up_sync(kAll, x.p[k], 1);
  return o;
}

// x seen from s columns to the right (bit j is column j + s), the bits
// beyond the word from the next word `nx`
template <int S, int P>
__device__ __forceinline__ Num<P> ahead(const Num<P>& x, const Num<P>& nx) {
  if constexpr (S == 0) return x;
  Num<P> o;
#pragma unroll
  for (int k = 0; k < P; ++k) o.p[k] = __funnelshift_r(x.p[k], nx.p[k], S);
  return o;
}

// a + b in PO planes (the sum fits them)
template <int PO, int PA, int PB>
__device__ __forceinline__ Num<PO> add(const Num<PA>& a, const Num<PB>& b) {
  Num<PO> o;
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < PO; ++k) {
    const uint32_t x = k < PA ? a.p[k] : 0u, y = k < PB ? b.p[k] : 0u;
    const uint32_t t = x ^ y;
    o.p[k] = t ^ c;
    c = (x & y) | (c & t);
  }
  return o;
}

// The neighbourhood total of each cell of this lane's word, from the
// column's vertical sum v; every lane of the warp calls it together.
__device__ __forceinline__ Num<NT> horizontal_sum(const Num<NV>& v) {
  Num<NT> total;
  const Num<NV> nv = next_lane(v);
#if LTL_HSUM == 0
  const Num<NV> pv = prev_lane(v);
  // number 0 is v itself, 1..R are v seen from columns j+1..j+R, R+1..2R
  // from columns j-1..j-R
  constexpr int NC = out_planes(N, NV);
  static_assert(NC >= NT, "the adder tree keeps every plane of the total");
  uint32_t sum[NC];
  csa_sum<N, NV>(
      [&](int n, int p) {
        if (n == 0) return v.p[p];
        if (n <= R) return __funnelshift_r(v.p[p], nv.p[p], n);
        return __funnelshift_l(pv.p[p], v.p[p], n - R);
      },
      sum);
#pragma unroll
  for (int k = 0; k < NT; ++k) total.p[k] = sum[k];  // the rest are zero
#else
  // one-sided window sums W(j) = v(j) + ... + v(j + 2R) by doubling: S_m is
  // the sum over m columns, S_2m = S_m + S_m seen m columns ahead; W adds
  // the S_m of N's set bits at growing offsets; the total is W seen R
  // columns back
  constexpr int P2 = bit_width(2 * N), P4 = bit_width(4 * N);
  constexpr int P8 = bit_width(8 * N);
  constexpr bool b8 = N & 8, b4 = N & 4, b2 = N & 2;
  constexpr int o4 = b8 ? 8 : 0, o2 = o4 + (b4 ? 4 : 0);
  constexpr int o1 = o2 + (b2 ? 2 : 0);
  const Num<P2> s2 = add<P2>(v, ahead<1>(v, nv));
  const Num<P2> n2 = next_lane(s2);
  const Num<P4> s4 = add<P4>(s2, ahead<2>(s2, n2));
  Num<P4> n4 = {};
  if constexpr (b8 || (b4 && o4 > 0)) n4 = next_lane(s4);
  Num<NT> w = {};
  if constexpr (b8) w = add<NT>(w, add<P8>(s4, ahead<4>(s4, n4)));
  if constexpr (b4) w = add<NT>(w, ahead<o4>(s4, n4));
  if constexpr (b2) w = add<NT>(w, ahead<o2>(s2, n2));
  w = add<NT>(w, ahead<o1>(v, nv));  // N is odd
  const Num<NT> pw = prev_lane(w);
#pragma unroll
  for (int k = 0; k < NT; ++k) total.p[k] = __funnelshift_l(pw.p[k], w.p[k], R);
#endif
  return total;
}

// The vertical sum of the 2r+1 rows centred on tile row i, in full.
__device__ __forceinline__ Num<NV> vertical_sum(const uint32_t* src, int i,
                                                int lane) {
  Num<NV> v;
  csa_sum<N, 1>([&](int n, int) { return src[(i - R + n) * kLanes + lane]; },
                v.p);
  return v;
}

__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

__global__ void __launch_bounds__(kLanes * kWarps)
ltl_step_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int H, int NW, int gens, int periodic, int col_limit) {
  extern __shared__ uint32_t smem[];
  const size_t board = (size_t)blockIdx.z * H * NW;
  in += board;
  out += board;
  const int halo = gens * R;
  const int span = kRows + 2 * halo;          // tile rows, halos included
  // words per ping-pong buffer: the tile rows and one spare row, which the
  // slide past a generation's last row reads and discards
  const int plane = (span + 1) * kLanes;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int w0 = blockIdx.x * kOwned;         // first owned word
  const int r0 = blockIdx.y * kRows;          // first owned row

  // this lane's word column: gw is the unrolled index, col its grid index
  const int gw = w0 - 1 + lane;
  const bool col_in = periodic || (gw >= 0 && gw < NW);
  const int col = col_in ? wrap(gw, NW) : 0;
  const bool col_out = lane >= 1 && lane <= kOwned && gw < NW;
  // the bits of this lane's word that a generation keeps: none outside a
  // dead grid, the real ones of word NW - 1, else all; `masked` (uniform
  // across the CTA) says whether any lane or row needs masking
  uint32_t cm = col_in ? kAll : 0u;
  bool masked = !periodic;
  if (col_limit > 0) {
    if (col_in && col == NW - 1) cm = (1u << (col_limit - 32 * (NW - 1))) - 1u;
    const int u0 = w0 - 1;
    const int first = periodic ? u0 + wrap(NW - 1 - u0, NW) : NW - 1;
    masked = masked || (first >= u0 && first < u0 + kLanes);
  }

  // generation 0: the tile plus `halo` rows above and below, in batches of
  // loads in flight before their stores
  constexpr int kBatch = 6;
  for (int i0 = warp; i0 < span; i0 += kWarps * kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kWarps, gr = r0 - halo + i;
      v[u] = 0u;
      if (i < span) {
        if (periodic) {
          v[u] = in[(size_t)wrap(gr, H) * NW + col];
        } else if (col_in && gr >= 0 && gr < H) {
          v[u] = in[(size_t)gr * NW + col];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kWarps;
      if (i < span) smem[i * kLanes + lane] = v[u];
    }
  }
  __syncthreads();

  // generation g computes rows [g R, span - g R), each warp a run of them;
  // the last generation writes the owned rows
  for (int g = 1; g <= gens; ++g) {
    const uint32_t* src = smem + ((g - 1) & 1) * plane;
    uint32_t* dst = smem + (g & 1) * plane;
    const bool last = g == gens;
    const int lo = g * R, hi = span - g * R;
    const int chunk = (hi - lo + kWarps - 1) / kWarps;
    const int a = lo + warp * chunk;
    const int b = min(a + chunk, hi);
    // uniform across the warp: every lane joins the shuffles
    if (a < b) {
      Num<NV> v = vertical_sum(src, a, lane);
      for (int i = a; i < b; ++i) {
        const Num<NT> total = horizontal_sum(v);
        uint32_t nw = ltl_rule(total.p, src[i * kLanes + lane]);
        const int gr = r0 - halo + i;
        if (masked) nw &= periodic || (gr >= 0 && gr < H) ? cm : 0u;
        if (last) {
          if (col_out && gr < H) out[(size_t)gr * NW + gw] = nw;
        } else {
          dst[i * kLanes + lane] = nw;
        }
        // on to row i + 1, after the last row too (a branch would cost more
        // than the slide; its entering row is at most the spare row)
        slide(v, src[(i + 1 + R) * kLanes + lane], src[(i - R) * kLanes + lane]);
      }
    }
    if (!last) __syncthreads();
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
  if (B < 1 || H < 1 || NW < 1 || radius != R || gens < 1 ||
      gens > (8 / R > 1 ? 8 / R : 1))
    return (int)cudaErrorInvalidValue;
  if (col_limit == 32LL * NW) col_limit = 0;  // no pad
  if (col_limit != 0 &&
      (col_limit <= 32LL * (NW - 1) || col_limit > 32LL * NW))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kLanes, kWarps);
  const dim3 grid((NW + kOwned - 1) / kOwned, (H + kRows - 1) / kRows, B);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      2u * (kRows + 2 * gens * R + 1) * kLanes * sizeof(uint32_t);
#if K3_ROWS > 128
  // the deepest pass's share, once per library
  static const cudaError_t allowed = cudaFuncSetAttribute(
      ltl_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2u * (kRows + 2 * (8 / R > 1 ? 8 / R : 1) * R + 1) * kLanes *
            sizeof(uint32_t)));
  if (allowed != cudaSuccess) return (int)allowed;
#endif
  ltl_step_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), H, NW,
      gens, periodic, col_limit);
  return (int)cudaGetLastError();
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
