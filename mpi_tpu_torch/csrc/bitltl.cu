// Kernel K3: `gens` generations (1..floor(8/r)) of a radius-r (2..7)
// outer-totalistic rule on a bit-packed grid, computed on bit planes, in one
// read and one write of device memory.
//
// Replaces the TPU kernel `pallas_ltl_step` (mpi_tpu/ops/pallas_bitltl.py),
// which streams whole-row slabs through VMEM with DMA halos and rolls lanes
// for the cross-word bits.  The arithmetic per word is that of
// ops/bitltl.py: every per-cell integer is a set of 32-bit bit planes (plane
// k holds bit k of 32 cells);
//   1. the 2r+1 row words of a column are summed by carry-save adders into
//      the column's vertical sum (at most 4 planes);
//   2. each plane is shifted by d = -r..r bits, the cross-word bits coming
//      from the neighbouring words' planes (one funnel shift each);
//   3. the 2r+1 shifted sums are summed by carry-save adders into the
//      neighbourhood total, centre included (at most 8 planes);
//   4. the rule is a set of interval tests on the total, each two bit-sliced
//      comparisons (`bs_ge`); survive intervals are tested at +1, because the
//      total includes the live centre.
//
// Layout: `in` and `out` are (H, NW) 32-bit words, row-major; bit j of word
// w is the cell at column 32w + j.  The host holds them as int32 tensors;
// here they are uint32_t, so right shifts are logical.
//
// What bounds it on an H100.  One pass moves 8 bytes per word: at 3.35 TB/s
// a 65536^2 grid (2^27 words) costs 0.32 ms of traffic.  A generation of
// Bosco (r = 5) in this form costs 63 to 171 integer instructions per word
// (LOP3 and SHF; ops/bitltl.py: ltl_word_ops_lower bounds the count from
// below, ltl_word_ops from above), so one generation of the same grid costs
// 0.5 to 1.4 ms of ALU time: the kernel is bound by integer instructions at
// every depth.  So the kernel
//   * is templated on the radius, so the plane arrays and the adder trees
//     are fixed at compile time and live in registers;
//   * maps one warp lane to one word column of a 32-word tile row (30 owned
//     words plus one ghost word per side, as kernel K1 does): the
//     neighbouring words' vertical sums arrive by register shuffle, and
//     each lane walks a run of rows, reading 2r+1 row words from shared
//     memory for each;
//   * steps the tile `gens` times in shared memory (temporal blocking), each
//     generation shrinking the valid rows by r per side, and re-zeroes,
//     after every in-tile generation, the cells outside a dead-boundary grid.
// The rule arrives at run time as interval thresholds and is evaluated by
// comparison on the planes; compiling a per-rule expression is later work.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;             // words per tile row, ghosts included
constexpr int kOwned = kLanes - 2;     // words a CTA writes per row
constexpr int kRows = 128;             // rows a CTA writes
constexpr int kWarps = 8;
constexpr int kMaxIntervals = 128;     // a rule has at most 113 per set
constexpr unsigned kAll = 0xFFFFFFFFu;

// Column sums of a carry-save adder tree over N numbers of P planes each:
// column w holds the N numbers' bits of weight w (w < P) and the carries out
// of column w - 1; full adders reduce it to one bit, each pushing a carry
// into column w + 1, so M bits give M / 2 carries.
__host__ __device__ constexpr int col_bits(int N, int P, int w) {
  return w < 0 ? 0 : (w < P ? N : 0) + col_bits(N, P, w - 1) / 2;
}

__host__ __device__ constexpr int out_planes(int N, int P) {
  int w = 0;
  while (col_bits(N, P, w) > 0) ++w;
  return w;
}

template <int N, int P, int W, int NP>
struct Column {
  template <typename Get>
  static __device__ __forceinline__ void run(const Get& get,
                                             const uint32_t* cin,
                                             uint32_t* out) {
    constexpr int own = W < P ? N : 0;
    constexpr int M = col_bits(N, P, W);
    uint32_t bits[M];
#pragma unroll
    for (int n = 0; n < own; ++n) bits[n] = get(n, W);
#pragma unroll
    for (int c = 0; c < M - own; ++c) bits[own + c] = cin[c];
    uint32_t cout[M / 2 > 0 ? M / 2 : 1];
    uint32_t acc = bits[0];
#pragma unroll
    for (int k = 0; k < (M - 1) / 2; ++k) {  // full adders
      const uint32_t x = bits[1 + 2 * k], y = bits[2 + 2 * k];
      const uint32_t t = acc ^ x;
      cout[k] = (acc & x) | (y & t);
      acc = t ^ y;
    }
    if constexpr ((M - 1) % 2 == 1) {        // a half adder for the last bit
      cout[M / 2 - 1] = acc & bits[M - 1];
      acc ^= bits[M - 1];
    }
    out[W] = acc;
    if constexpr (W + 1 < NP) Column<N, P, W + 1, NP>::run(get, cout, out);
  }
};

// out = the sum of N numbers of P planes, get(n, p) giving plane p of number n
template <int N, int P, typename Get>
__device__ __forceinline__ void csa_sum(const Get& get,
                                        uint32_t (&out)[out_planes(N, P)]) {
  Column<N, P, 0, out_planes(N, P)>::run(get, nullptr, out);
}

// Mask of the cells whose NP-plane value is >= t (an MSB-first comparator;
// t is uniform across the warp).
template <int NP>
__device__ __forceinline__ uint32_t ge(const uint32_t (&T)[NP], int t) {
  if (t <= 0) return kAll;
  if (t >= (1 << NP)) return 0u;
  uint32_t gt = 0u, eq = kAll;
#pragma unroll
  for (int k = NP - 1; k >= 0; --k) {
    const uint32_t m = ((t >> k) & 1) ? kAll : 0u;
    gt |= eq & T[k] & ~m;
    eq &= ~(T[k] ^ m);
  }
  return gt | eq;
}

// OR over n intervals of lo <= total < hi, given as (lo, hi) pairs
template <int NP>
__device__ __forceinline__ uint32_t in_intervals(const uint32_t (&T)[NP],
                                                 const int16_t* iv, int n) {
  uint32_t acc = 0u;
  for (int k = 0; k < n; ++k) acc |= ge(T, iv[2 * k]) & ~ge(T, iv[2 * k + 1]);
  return acc;
}

// Next state of the word at tile row i of this lane's column.  Every lane of
// the warp calls it together: the neighbouring words' vertical sums arrive
// by shuffle, and the ghost lanes at either end see zero beyond themselves.
template <int R>
__device__ __forceinline__ uint32_t next_word(const uint32_t* src, int i,
                                              int lane, const int16_t* thr,
                                              int nb, int ns) {
  constexpr int N = 2 * R + 1;
  constexpr int NV = out_planes(N, 1);      // planes of a vertical sum
  constexpr int NT = out_planes(N, NV);     // planes of the total
  uint32_t rows[N];                         // mid, then +1..+R, then -1..-R
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int d = n == 0 ? 0 : (n <= R ? n : R - n);
    rows[n] = src[(i + d) * kLanes + lane];
  }
  uint32_t v[NV];
  csa_sum<N, 1>([&](int n, int) { return rows[n]; }, v);

  uint32_t prv[NV], nxt[NV];
#pragma unroll
  for (int p = 0; p < NV; ++p) {
    prv[p] = __shfl_up_sync(kAll, v[p], 1);
    nxt[p] = __shfl_down_sync(kAll, v[p], 1);
    if (lane == 0) prv[p] = 0u;
    if (lane == kLanes - 1) nxt[p] = 0u;
  }
  // number 0 is v itself, 1..R are v seen from columns j+1..j+R, R+1..2R
  // from columns j-1..j-R
  uint32_t total[NT];
  csa_sum<N, NV>(
      [&](int n, int p) {
        if (n == 0) return v[p];
        if (n <= R) return __funnelshift_r(v[p], nxt[p], n);
        return __funnelshift_l(prv[p], v[p], n - R);
      },
      total);

  const uint32_t mid = rows[0];
  const uint32_t born = in_intervals(total, thr, nb);
  const uint32_t stay = in_intervals(total, thr + 2 * nb, ns);
  return (~mid & born) | (mid & stay);
}

__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

template <int R>
__global__ void __launch_bounds__(kLanes * kWarps)
ltl_step_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int H, int NW, int gens, int periodic,
                const int16_t* __restrict__ thresholds, int nb, int ns) {
  extern __shared__ uint32_t smem[];
  __shared__ int16_t thr[4 * kMaxIntervals];  // the rule, read by every lane
  const int halo = gens * R;
  const int span = kRows + 2 * halo;          // tile rows, halos included
  const int plane = span * kLanes;            // words per ping-pong buffer

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int w0 = blockIdx.x * kOwned;         // first owned word
  const int r0 = blockIdx.y * kRows;          // first owned row

  // this lane's word column: gw is the unrolled index, col its grid index
  const int gw = w0 - 1 + lane;
  const bool col_in = periodic || (gw >= 0 && gw < NW);
  const int col = col_in ? wrap(gw, NW) : 0;
  const bool col_out = lane >= 1 && lane <= kOwned && gw < NW;

  for (int k = warp * kLanes + lane; k < 2 * (nb + ns); k += kLanes * kWarps)
    thr[k] = thresholds[k];
  // generation 0: the tile plus `halo` rows above and below
  for (int i = warp; i < span; i += kWarps) {
    const int gr = r0 - halo + i;
    uint32_t v = 0u;
    if (periodic) {
      v = in[(size_t)wrap(gr, H) * NW + col];
    } else if (col_in && gr >= 0 && gr < H) {
      v = in[(size_t)gr * NW + col];
    }
    smem[i * kLanes + lane] = v;
  }
  __syncthreads();

  // generation g computes rows [g R, span - g R); the last writes the owned
  // rows
  for (int g = 1; g <= gens; ++g) {
    const uint32_t* src = smem + ((g - 1) & 1) * plane;
    uint32_t* dst = smem + (g & 1) * plane;
    const bool last = g == gens;
    const int lo = g * R, hi = span - g * R;
    const int chunk = (hi - lo + kWarps - 1) / kWarps;
    const int a = lo + warp * chunk;
    const int b = min(a + chunk, hi);
    // uniform across the warp: every lane joins the shuffles
    for (int i = a; i < b; ++i) {
      uint32_t nw = next_word<R>(src, i, lane, thr, nb, ns);
      const int gr = r0 - halo + i;
      if (!periodic && !(col_in && gr >= 0 && gr < H)) nw = 0u;
      if (last) {
        if (col_out && gr < H) out[(size_t)gr * NW + gw] = nw;
      } else {
        dst[i * kLanes + lane] = nw;
      }
    }
    if (!last) __syncthreads();
  }
}

template <int R>
int launch(const void* in, void* out, int H, int NW, int gens, int periodic,
           const void* thresholds, int nb, int ns, cudaStream_t stream) {
  if (gens > (8 / R > 1 ? 8 / R : 1)) return (int)cudaErrorInvalidValue;
  const dim3 block(kLanes, kWarps);
  const dim3 grid((NW + kOwned - 1) / kOwned, (H + kRows - 1) / kRows);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = 2u * (kRows + 2 * gens * R) * kLanes * sizeof(uint32_t);
  ltl_step_kernel<R><<<grid, block, smem, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), H, NW,
      gens, periodic, static_cast<const int16_t*>(thresholds), nb, ns);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one pass on `stream`; returns a CUDA error code (0 on success).
// `thresholds` points to 2 (nb + ns) int16 values on the device: nb birth
// pairs (lo, hi + 1), then ns survive pairs (lo + 1, hi + 2).  `in` and
// `out` must not overlap.
int gol_ltl_step(const void* in, void* out, int H, int NW, int radius,
                 int gens, int periodic, const void* thresholds, int nb,
                 int ns, void* stream) {
  if (H < 1 || NW < 1 || gens < 1 || radius < 2 || radius > 7 || nb < 0 ||
      nb > kMaxIntervals || ns < 0 || ns > kMaxIntervals)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GOL_LTL(R) launch<R>(in, out, H, NW, gens, periodic, thresholds, nb, ns, s)
  switch (radius) {
    case 2: return GOL_LTL(2);
    case 3: return GOL_LTL(3);
    case 4: return GOL_LTL(4);
    case 5: return GOL_LTL(5);
    case 6: return GOL_LTL(6);
    default: return GOL_LTL(7);
  }
#undef GOL_LTL
}

}  // extern "C"
