// golcore — native C++ engine for mpi_tpu.
//
// The reference implements its native layer with MPI (main.cpp) and a serial
// C++ oracle (main_serial.cpp).  This is the framework's equivalent, built
// from scratch:
//
//   * gol_init            — the decomposition-invariant hash init, bit-identical
//                           to utils/hashinit.py (replaces srand(rank)/srand(seed),
//                           reference main.cpp:70 / main_serial.cpp:36).
//   * gol_step/gol_evolve — serial engine: separable window-sum neighbor counts
//                           + rule-table apply, double buffered (the corrected,
//                           generalized form of main_serial.cpp:45-71; boundary
//                           is a flag instead of hardcoded periodic).
//   * gol_evolve_par      — multi-worker engine: 2D tile decomposition over a
//                           worker mesh, each tile owning a radius-wide ghost
//                           ring filled by an explicit 8-neighbor halo exchange
//                           with barrier phases — the shared-memory analog of
//                           the reference's MPI_Isend/Irecv distr_borders
//                           (main.cpp:36-65), with the halo pairing bug fixed
//                           (ghosts hold the geometrically adjacent neighbor's
//                           edge, SURVEY.md §5.8 quirk #1).
//
// Exposed via a C ABI for the ctypes wrapper in backends/cpp.py.

#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Hash init — must match utils/hashinit.py exactly (pinned by tests).
// murmur3 32-bit finalizer; keys folded in with odd multiplicative constants.
// ---------------------------------------------------------------------------

inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

inline uint32_t cell_hash(uint32_t seed, uint32_t i, uint32_t j) {
    uint32_t hi = fmix32(seed ^ (i * 0x9E3779B1u));
    return fmix32(hi ^ (j * 0x85EBCA77u));
}

// ---------------------------------------------------------------------------
// Stencil on a padded tile.
//
// buf: (rows + 2r) x (cols + 2r), row-major, ghost ring included.
// Separable counts: vertical window sum into a rowsum scratch (kept at full
// padded width so the horizontal pass sees shifted columns), then horizontal
// window sum minus the center — same algorithm as ops/stencil.py, O(2r+1)
// adds per cell per axis instead of (2r+1)^2 gathers.
// ---------------------------------------------------------------------------

struct RuleTables {
    const uint8_t* birth;    // indexed by neighbor count
    const uint8_t* survive;
    int radius;
};

void step_padded(const uint8_t* in, uint8_t* out, int64_t rows, int64_t cols,
                 const RuleTables& rule, uint8_t* rowsum /* rows x (cols+2r) */) {
    const int r = rule.radius;
    const int win = 2 * r + 1;
    const int64_t pw = cols + 2 * r;  // padded width
    for (int64_t i = 0; i < rows; ++i) {
        const uint8_t* base = in + i * pw;
        uint8_t* rs = rowsum + i * pw;
        for (int64_t j = 0; j < pw; ++j) rs[j] = base[j];
        for (int k = 1; k < win; ++k) {
            const uint8_t* row = in + (i + k) * pw;
            for (int64_t j = 0; j < pw; ++j) rs[j] += row[j];
        }
    }
    for (int64_t i = 0; i < rows; ++i) {
        const uint8_t* rs = rowsum + i * pw;
        const uint8_t* center_row = in + (i + r) * pw + r;
        uint8_t* dst = out + (i + r) * pw + r;
        for (int64_t j = 0; j < cols; ++j) {
            uint8_t c = rs[j];
            for (int k = 1; k < win; ++k) c += rs[j + k];
            c -= center_row[j];
            dst[j] = center_row[j] ? rule.survive[c] : rule.birth[c];
        }
    }
}

// ---------------------------------------------------------------------------
// Reusable spinning-free barrier (C++17; std::barrier is C++20).
// ---------------------------------------------------------------------------

class Barrier {
  public:
    explicit Barrier(int n) : n_(n), waiting_(0), phase_(0) {}
    void arrive_and_wait() {
        std::unique_lock<std::mutex> lk(m_);
        int phase = phase_;
        if (++waiting_ == n_) {
            waiting_ = 0;
            ++phase_;
            cv_.notify_all();
        } else {
            cv_.wait(lk, [&] { return phase_ != phase; });
        }
    }

  private:
    int n_, waiting_, phase_;
    std::mutex m_;
    std::condition_variable cv_;
};

// ---------------------------------------------------------------------------
// Bitpacked SWAR engine (radius-1 rules, cols % 64 == 0) — the native
// mirror of the TPU backend's ops/bitlife.py design: 64 cells per uint64,
// neighbor counts as bit-sliced carry-save sums, any outer-totalistic B/S
// rule applied as per-count bit-equality indicators.  Measured ~24x the byte
// engine's throughput per core; the byte path remains the general
// fallback (any radius, any width).
//
// Layout: (rows + 2) x nw words, one ghost row above and below (periodic
// rows copied, dead rows zeroed, each generation); LSB of word j = column
// j*64; horizontal neighbors come from 1-bit shifts with cross-word carry
// bits, ghost columns from the wrapped (periodic) or zero (dead) carry.
// ---------------------------------------------------------------------------

struct SwarScratch {
    std::vector<uint64_t> f0, f1, c0, c1;
    explicit SwarScratch(int64_t nw) : f0(nw), f1(nw), c0(nw), c1(nw) {}
};

// One generation over rows [lo, hi) (1-based interior rows of the padded
// buffer).  Reads cur (with valid ghost rows), writes nxt interior.
void swar_gen_rows(const uint64_t* cur, uint64_t* nxt, int64_t nw,
                   int64_t lo, int64_t hi, bool periodic,
                   const uint8_t* birth, const uint8_t* survive,
                   SwarScratch& s) {
    for (int64_t i = lo; i < hi; ++i) {
        const uint64_t* u = cur + (i - 1) * nw;
        const uint64_t* m = cur + i * nw;
        const uint64_t* d = cur + (i + 1) * nw;
        for (int64_t j = 0; j < nw; ++j) {
            const uint64_t a = u[j], b = m[j], c = d[j];
            const uint64_t t = a ^ b;
            s.f0[j] = t ^ c;                 // vertical sum, weight 1
            s.f1[j] = (a & b) | (c & t);     // vertical sum, weight 2 (majority)
            s.c0[j] = a ^ c;                 // center-excluded vertical sum
            s.c1[j] = a & c;
        }
        uint64_t* out = nxt + i * nw;
        for (int64_t j = 0; j < nw; ++j) {
            // column sums of the left/right neighbor columns: this word's
            // sums shifted by one bit, carry bit from the adjacent word
            // (wrapped under periodic columns, zero under dead)
            const int64_t jp = j > 0 ? j - 1 : nw - 1;
            const int64_t jn = j < nw - 1 ? j + 1 : 0;
            const bool wl = j > 0 || periodic;   // left carry word exists
            const bool wr = j < nw - 1 || periodic;
            const uint64_t p0 = wl ? s.f0[jp] : 0, p1 = wl ? s.f1[jp] : 0;
            const uint64_t q0 = wr ? s.f0[jn] : 0, q1 = wr ? s.f1[jn] : 0;
            const uint64_t l0 = (s.f0[j] << 1) | (p0 >> 63);
            const uint64_t l1 = (s.f1[j] << 1) | (p1 >> 63);
            const uint64_t r0 = (s.f0[j] >> 1) | (q0 << 63);
            const uint64_t r1 = (s.f1[j] >> 1) | (q1 << 63);
            // count = left + right + center-excluded middle: two bit-sliced
            // 2-bit adds producing count bits n0..n3 (0..8)
            const uint64_t s0 = l0 ^ r0, car0 = l0 & r0;
            const uint64_t x1 = l1 ^ r1;
            const uint64_t s1 = x1 ^ car0;
            const uint64_t car1 = (l1 & r1) | (car0 & x1);
            const uint64_t n0 = s0 ^ s.c0[j], k0 = s0 & s.c0[j];
            const uint64_t y1 = s1 ^ s.c1[j];
            const uint64_t n1 = y1 ^ k0;
            const uint64_t k1 = (s1 & s.c1[j]) | (k0 & y1);
            const uint64_t n2 = car1 ^ k1;
            const uint64_t n3 = car1 & k1;
            uint64_t bi = 0, si = 0;
            for (int k = 0; k <= 8; ++k) {
                if (!birth[k] && !survive[k]) continue;
                const uint64_t eq = ((k & 1) ? n0 : ~n0) & ((k & 2) ? n1 : ~n1) &
                                    ((k & 4) ? n2 : ~n2) & ((k & 8) ? n3 : ~n3);
                if (birth[k]) bi |= eq;
                if (survive[k]) si |= eq;
            }
            const uint64_t alive = m[j];
            out[j] = (alive & si) | (~alive & bi);
        }
    }
}

static void ltl_fill_ghost_rows(uint64_t* buf, int64_t rows, int64_t nw,
                                int r, bool periodic);

void swar_fill_ghost_rows(uint64_t* buf, int64_t rows, int64_t nw, bool periodic) {
    ltl_fill_ghost_rows(buf, rows, nw, 1, periodic);
}

// ghost = leading ghost rows in buf (1 for the padded layout, 0 interior-only)
void swar_pack(const uint8_t* grid, uint64_t* buf, int64_t rows, int64_t cols,
               int ghost) {
    const int64_t nw = cols / 64;
    for (int64_t i = 0; i < rows; ++i) {
        const uint8_t* row = grid + i * cols;
        uint64_t* prow = buf + (i + ghost) * nw;
        for (int64_t j = 0; j < nw; ++j) {
            uint64_t w = 0;
            for (int b = 0; b < 64; ++b)
                w |= (uint64_t)(row[j * 64 + b] & 1) << b;
            prow[j] = w;
        }
    }
}

void swar_unpack(const uint64_t* buf, uint8_t* grid, int64_t rows, int64_t cols,
                 int ghost) {
    const int64_t nw = cols / 64;
    for (int64_t i = 0; i < rows; ++i) {
        uint8_t* row = grid + i * cols;
        const uint64_t* prow = buf + (i + ghost) * nw;
        for (int64_t j = 0; j < nw; ++j)
            for (int b = 0; b < 64; ++b)
                row[j * 64 + b] = (prow[j] >> b) & 1u;
    }
}

bool swar_eligible(int64_t cols, int radius) {
    return radius == 1 && cols % 64 == 0 && cols > 0;
}

// ---------------------------------------------------------------------------
// Bit-sliced radius-r (Larger-than-Life) engine — the native mirror of
// ops/bitltl.py.  Per-cell integers live as uint64 bit planes (plane k
// holds bit k of each cell's value, 64 cells per word): a ripple
// carry-save accumulation of the 2r+1 vertically adjacent row words
// builds each column's sum (<=4 planes), shifted copies with cross-word
// carry bits are ripple-added into the <=8-plane neighborhood total, and
// B/S membership is an MSB-first bit-sliced comparator over count
// intervals derived from the rule tables.  The total includes the center
// cell, so survive intervals are tested shifted by +1 (no bit-sliced
// subtraction), exactly as the Python engine does.
// ---------------------------------------------------------------------------

static std::vector<std::pair<int, int>> table_intervals(const uint8_t* t,
                                                        int n) {
    std::vector<std::pair<int, int>> out;
    int lo = -1;
    for (int c = 0; c <= n; ++c) {
        const bool on = c < n && t[c];
        if (on && lo < 0) lo = c;
        if (!on && lo >= 0) { out.push_back({lo, c - 1}); lo = -1; }
    }
    return out;
}

static inline int bit_len(int v) {
    int n = 0;
    while (v >> n) ++n;
    return n;
}

// mask of cells whose bit-sliced value (planes t[0..np), LSB first) >= T
static inline uint64_t bs_ge_word(const uint64_t* t, int np, int T) {
    if (T <= 0) return ~0ull;
    if (T >= (1 << np)) return 0ull;
    uint64_t gt = 0, eq = ~0ull;
    for (int k = np - 1; k >= 0; --k) {
        const uint64_t p = t[k];
        if ((T >> k) & 1) {
            eq &= p;
        } else {
            gt |= eq & p;
            eq &= ~p;
        }
    }
    return gt | eq;
}

// ripple-add b (nb planes) into a (na planes); na must cover the maximum
static inline void add_planes(uint64_t* a, int na, const uint64_t* b, int nb) {
    uint64_t carry = 0;
    for (int p = 0; p < na; ++p) {
        const uint64_t x = a[p], y = p < nb ? b[p] : 0;
        const uint64_t t = x ^ y;
        a[p] = t ^ carry;
        carry = (x & y) | (carry & t);
    }
}

// (A carry-save 3:2-compressor accumulator — the Wallace-tree shape the
// Python engine's bs_sum uses, ops/bitltl.py — was tried here and
// MEASURED SLOWER on CPU: 0.35 vs 0.42 Gcell/s for Bosco at 2048², one
// core.  The per-weight bucket arrays force stack traffic and dynamic
// indexing where the ripple chains keep t[]/addL/addR in registers with
// plenty of scalar ILP; the op-count saving only pays on wide-vector
// machines, which is why the TPU engines use bs_sum and this one keeps
// sequential add_planes.)

// one generation of rows [lo_row, hi_row) on an r-ghost-row padded packed
// buffer; vplanes is nv*nw scratch for the per-row vertical sums
static void ltl_gen_rows(const uint64_t* cur, uint64_t* nxt, int64_t nw,
                         int64_t lo_row, int64_t hi_row, int r, bool periodic,
                         const std::vector<std::pair<int, int>>& birth_iv,
                         const std::vector<std::pair<int, int>>& survive_iv,
                         int nv, int np, uint64_t* vplanes) {
    for (int64_t i = lo_row; i < hi_row; ++i) {
        for (int64_t j = 0; j < nw; ++j) {
            uint64_t planes[4] = {0, 0, 0, 0};
            for (int d = -r; d <= r; ++d) {
                uint64_t bit = cur[(i + d) * nw + j];
                for (int p = 0; p < nv; ++p) {
                    const uint64_t s = planes[p] ^ bit;
                    bit = planes[p] & bit;
                    planes[p] = s;
                }
            }
            for (int p = 0; p < nv; ++p) vplanes[p * nw + j] = planes[p];
        }
        uint64_t* out = nxt + i * nw;
        for (int64_t j = 0; j < nw; ++j) {
            const int64_t jp = j > 0 ? j - 1 : nw - 1;
            const int64_t jn = j < nw - 1 ? j + 1 : 0;
            const bool wl = j > 0 || periodic;
            const bool wr = j < nw - 1 || periodic;
            uint64_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            for (int p = 0; p < nv; ++p) t[p] = vplanes[p * nw + j];
            for (int d = 1; d <= r; ++d) {
                uint64_t addL[4], addR[4];
                for (int p = 0; p < nv; ++p) {
                    const uint64_t vj = vplanes[p * nw + j];
                    const uint64_t vp = wl ? vplanes[p * nw + jp] : 0;
                    const uint64_t vn = wr ? vplanes[p * nw + jn] : 0;
                    addL[p] = (vj << d) | (vp >> (64 - d));  // column j-d
                    addR[p] = (vj >> d) | (vn << (64 - d));  // column j+d
                }
                add_planes(t, np, addL, nv);
                add_planes(t, np, addR, nv);
            }
            uint64_t born = 0, stay = 0;
            for (const auto& iv : birth_iv)
                born |= bs_ge_word(t, np, iv.first) &
                        ~bs_ge_word(t, np, iv.second + 1);
            // total = count + 1 for alive cells (center included)
            for (const auto& iv : survive_iv)
                stay |= bs_ge_word(t, np, iv.first + 1) &
                        ~bs_ge_word(t, np, iv.second + 2);
            const uint64_t alive = cur[i * nw + j];
            out[j] = (alive & stay) | (~alive & born);
        }
    }
}

static void ltl_fill_ghost_rows(uint64_t* buf, int64_t rows, int64_t nw,
                                int r, bool periodic) {
    for (int g = 0; g < r; ++g) {
        uint64_t* top = buf + g * nw;
        uint64_t* bot = buf + (rows + r + g) * nw;
        if (periodic) {
            // top ghost g is global row rows-r+g = buffer row rows+g;
            // bottom ghost g is global row g = buffer row r+g
            std::memcpy(top, buf + (rows + g) * nw, (size_t)nw * 8);
            std::memcpy(bot, buf + (r + g) * nw, (size_t)nw * 8);
        } else {
            std::memset(top, 0, (size_t)nw * 8);
            std::memset(bot, 0, (size_t)nw * 8);
        }
    }
}

bool ltl_eligible(int64_t rows, int64_t cols, int radius) {
    return radius > 1 && radius <= 7 && cols % 64 == 0 && cols > 0 &&
           rows >= 2 * radius + 1;
}

void ltl_evolve(uint8_t* grid, int64_t rows, int64_t cols, int64_t steps,
                const uint8_t* birth_table, const uint8_t* survive_table,
                int r, bool periodic) {
    const int64_t nw = cols / 64;
    const int side = 2 * r + 1;
    const int nmax = side * side - 1;
    const int nv = bit_len(side);       // vertical sums reach 2r+1
    const int np = bit_len(side * side);  // totals reach (2r+1)^2
    const auto birth_iv = table_intervals(birth_table, nmax + 1);
    const auto survive_iv = table_intervals(survive_table, nmax + 1);
    std::vector<uint64_t> a((size_t)((rows + 2 * r) * nw), 0);
    std::vector<uint64_t> b((size_t)((rows + 2 * r) * nw), 0);
    std::vector<uint64_t> vplanes((size_t)(nv * nw));
    swar_pack(grid, a.data(), rows, cols, r);
    uint64_t *cur = a.data(), *nxt = b.data();
    for (int64_t s = 0; s < steps; ++s) {
        ltl_fill_ghost_rows(cur, rows, nw, r, periodic);
        ltl_gen_rows(cur, nxt, nw, r, rows + r, r, periodic,
                     birth_iv, survive_iv, nv, np, vplanes.data());
        std::swap(cur, nxt);
    }
    swar_unpack(cur, grid, rows, cols, r);
}

// ---------------------------------------------------------------------------
// Temporal blocking for DRAM-resident grids — the CPU mirror of the Pallas
// kernel's gens-deep VMEM blocking (ops/pallas_bitlife.py): each sweep
// advances independent row blocks G generations inside a cache-resident
// slab (block rows + 2G halo rows + 1 ghost row per side), touching DRAM
// once per G generations instead of once per generation.  Neighboring
// blocks recompute each other's halo rows redundantly from the same
// source sweep (overlapped/trapezoidal tiling), so blocks — and threads —
// stay independent between barriers.
// ---------------------------------------------------------------------------

struct SwarSlab {
    std::vector<uint64_t> a, b;
    SwarScratch scratch;
    SwarSlab(int64_t max_slab_rows, int64_t nw)
        : a((size_t)(max_slab_rows * nw)),
          b((size_t)(max_slab_rows * nw)),
          scratch(nw) {}
};

// Packed-grid bytes above which the temporally-blocked sweeps kick in.
// Default: disabled — measured on this machine (1 core, 16384², 16
// steps) the plain per-generation sweep is compute-bound at ~0.7 GB/s of
// traffic, and blocking's slab copies + redundant halo rows cost more
// than the cache locality earns (2.85 → 2.40 Gcell/s).  The machinery
// stays available (GOLCORE_SWAR_BLOCK_THRESHOLD=bytes) for hosts where
// many cores share DRAM bandwidth and the plain sweep *is* memory-bound;
// tests force 0 to pin its correctness.
int64_t swar_block_threshold() {
    const char* e = std::getenv("GOLCORE_SWAR_BLOCK_THRESHOLD");
    return e ? std::atoll(e) : INT64_MAX;
}

// Pick the block height so one slab buffer stays cache-resident.
int64_t swar_pick_block_rows(int64_t nw, int64_t G) {
    const int64_t budget = 768 << 10;  // bytes per slab buffer (~L2-sized)
    int64_t S = budget / (nw * 8);
    int64_t B = S - 2 * G - 2;
    if (B < 32) return 0;  // rows too wide to block profitably
    if (B > 512) B = 512;
    return B;
}

// One G-generation sweep over blocks [blk0, blk1) of height B: reads the
// full src grid (interior-only, rows x nw), writes those blocks' rows of
// dst stepped G generations.
void swar_blocked_sweep(const uint64_t* src, uint64_t* dst, int64_t rows,
                        int64_t nw, bool periodic, const uint8_t* birth,
                        const uint8_t* survive, int64_t G, int64_t B,
                        int64_t blk0, int64_t blk1, SwarSlab& slab) {
    for (int64_t blk = blk0; blk < blk1; ++blk) {
        const int64_t base = blk * B;
        const int64_t Beff = std::min(B, rows - base);
        const int64_t S = Beff + 2 * G + 2;  // slab rows incl. ghosts
        uint64_t* cur = slab.a.data();
        uint64_t* nxt = slab.b.data();
        // slab row s holds grid row base - G - 1 + s (wrapped / zeroed)
        for (int64_t s = 0; s < S; ++s) {
            int64_t r = base - G - 1 + s;
            if (periodic) {
                r = ((r % rows) + rows) % rows;
                std::memcpy(cur + s * nw, src + r * nw, (size_t)nw * 8);
            } else if (r < 0 || r >= rows) {
                std::memset(cur + s * nw, 0, (size_t)nw * 8);
            } else {
                std::memcpy(cur + s * nw, src + r * nw, (size_t)nw * 8);
            }
        }
        for (int64_t g = 0; g < G; ++g) {
            // validity shrinks one row per side per generation
            swar_gen_rows(cur, nxt, nw, 1 + g, S - 1 - g, periodic, birth,
                          survive, slab.scratch);
            if (!periodic) {
                // slab rows outside the grid are not real cells; live grid
                // neighbors "give birth" into them — re-kill after every
                // in-slab generation (same discipline as the Pallas
                // kernel's edge blocks and the overlap steppers)
                const int64_t lead = std::max<int64_t>(0, G + 1 - base);
                const int64_t tail =
                    std::max<int64_t>(0, (base + Beff + G + 1) - rows);
                for (int64_t s = 1 + g; s < std::min(lead, S - 1 - g); ++s)
                    std::memset(nxt + s * nw, 0, (size_t)nw * 8);
                for (int64_t s = std::max(S - tail, 1 + g); s < S - 1 - g; ++s)
                    std::memset(nxt + s * nw, 0, (size_t)nw * 8);
            }
            std::swap(cur, nxt);
        }
        std::memcpy(dst + base * nw, cur + (1 + G) * nw,
                    (size_t)(Beff * nw) * 8);
    }
}

// Evolve an interior-only packed grid `steps` generations with temporal
// blocking, `threads_n` workers owning disjoint block ranges per sweep.
// One code path for any worker count (a 1-thread group pays one spawn per
// evolve call, not per step); the final-result buffer is bufs[sweeps % 2].
void swar_evolve_blocked(uint64_t* grid0, uint64_t* grid1, int64_t rows,
                         int64_t nw, bool periodic, const uint8_t* birth,
                         const uint8_t* survive, int64_t steps, int64_t B,
                         int64_t G, int threads_n) {
    const int64_t nblocks = (rows + B - 1) / B;
    if (threads_n > nblocks) threads_n = (int)nblocks;
    if (threads_n < 1) threads_n = 1;
    uint64_t* bufs[2] = {grid0, grid1};
    Barrier barrier(threads_n);
    std::vector<std::thread> threads;
    threads.reserve((size_t)threads_n);
    for (int t = 0; t < threads_n; ++t) {
        const int64_t b0 = nblocks * t / threads_n;
        const int64_t b1 = nblocks * (t + 1) / threads_n;
        threads.emplace_back([=, &barrier]() {
            SwarSlab slab(B + 2 * G + 2, nw);
            int cur = 0;
            int64_t done = 0;
            while (done < steps) {
                const int64_t g = std::min(G, steps - done);
                swar_blocked_sweep(bufs[cur], bufs[1 - cur], rows, nw,
                                   periodic, birth, survive, g, B, b0, b1,
                                   slab);
                cur = 1 - cur;
                done += g;
                barrier.arrive_and_wait();  // all blocks of this sweep done
            }
        });
    }
    for (auto& th : threads) th.join();
    const int64_t sweeps = (steps + G - 1) / G;
    if (sweeps % 2)
        std::memcpy(grid0, grid1, (size_t)(rows * nw) * 8);
}

// Shared dispatch for both public entry points: run the blocked engine if
// the grid qualifies (returns true), else leave it to the caller's plain
// path.  Keeping the G/B/threshold policy in ONE place so the two entry
// points cannot drift.
bool swar_try_blocked(uint8_t* grid, int64_t rows, int64_t cols,
                      const uint8_t* birth, const uint8_t* survive,
                      int64_t steps, int periodic, int threads_n) {
    const int64_t nw = cols / 64;
    const int64_t G = std::min<int64_t>(8, steps);
    const int64_t B = swar_pick_block_rows(nw, G);
    if (steps < 2 || B <= 0 || rows * nw * 8 <= swar_block_threshold())
        return false;
    std::vector<uint64_t> a((size_t)(rows * nw), 0);
    std::vector<uint64_t> b((size_t)(rows * nw), 0);
    swar_pack(grid, a.data(), rows, cols, 0);
    swar_evolve_blocked(a.data(), b.data(), rows, nw, periodic != 0, birth,
                        survive, steps, B, G, threads_n);
    swar_unpack(a.data(), grid, rows, cols, 0);
    return true;
}

// Fill the ghost ring of a standalone padded buffer from its own interior
// (periodic) or zeros (dead).  Used by the serial engine.
void fill_ghosts_self(uint8_t* buf, int64_t rows, int64_t cols, int r, bool periodic) {
    const int64_t pw = cols + 2 * r;
    const int64_t ph = rows + 2 * r;
    if (!periodic) {
        for (int64_t i = 0; i < ph; ++i) {
            uint8_t* row = buf + i * pw;
            if (i < r || i >= rows + r) {
                std::memset(row, 0, pw);
            } else {
                std::memset(row, 0, r);
                std::memset(row + cols + r, 0, r);
            }
        }
        return;
    }
    // periodic: wrap rows then columns (row pass first so column wrap copies
    // the already-wrapped rows — corners come out right).
    for (int k = 0; k < r; ++k) {
        std::memcpy(buf + k * pw + r, buf + (rows + k) * pw + r, cols);
        std::memcpy(buf + (rows + r + k) * pw + r, buf + (r + k) * pw + r, cols);
    }
    for (int64_t i = 0; i < ph; ++i) {
        uint8_t* row = buf + i * pw;
        for (int k = 0; k < r; ++k) {
            row[k] = row[cols + k];
            row[cols + r + k] = row[r + k];
        }
    }
}


// ---------------------------------------------------------------------------
// Parallel engine: tile mesh + ghost-ring halo exchange.
// ---------------------------------------------------------------------------

struct Tile {
    int64_t r0, c0, rows, cols;  // interior placement in the global grid
    std::vector<uint8_t> a, b;   // double-buffered padded storage
    std::vector<uint8_t> rowsum;
};

struct ParEngine {
    int ti, tj, radius;
    bool periodic;
    std::vector<Tile> tiles;

    Tile& at(int i, int j) { return tiles[(size_t)i * tj + j]; }

    // Neighbor tile index along one axis, honoring boundary; -1 = none (dead).
    int wrap(int x, int n) const {
        if (x >= 0 && x < n) return x;
        return periodic ? (x + n) % n : -1;
    }
};

// Copy a rect from src tile's CURRENT interior into dst tile's padded buffer.
// Coordinates are interior-relative (0-based); dst offsets are padded-buffer
// absolute.  cur selects which double buffer is "current" this step.
inline void copy_rect(const Tile& src, const std::vector<uint8_t>& src_buf, int r,
                      int64_t si, int64_t sj, Tile& dst, std::vector<uint8_t>& dst_buf,
                      int64_t di, int64_t dj, int64_t h, int64_t w) {
    const int64_t spw = src.cols + 2 * r;
    const int64_t dpw = dst.cols + 2 * r;
    for (int64_t k = 0; k < h; ++k) {
        std::memcpy(dst_buf.data() + (di + k) * dpw + dj,
                    src_buf.data() + (si + r + k) * spw + sj + r, w);
    }
}

// Fill every ghost slab of tile (i, j) from its 8 mesh neighbors' interiors —
// the shared-memory distr_borders.  Reads neighbors' current buffers (stable
// during the exchange phase; a barrier separates exchange from compute).
void exchange_tile(ParEngine& e, int i, int j, bool cur_is_a) {
    Tile& t = e.at(i, j);
    std::vector<uint8_t>& dst = cur_is_a ? t.a : t.b;
    const int r = e.radius;
    const int64_t pw = t.cols + 2 * r;

    for (int di = -1; di <= 1; ++di) {
        for (int dj = -1; dj <= 1; ++dj) {
            if (di == 0 && dj == 0) continue;
            // Destination slab in t's padded buffer.
            int64_t dst_i = di < 0 ? 0 : (di == 0 ? r : t.rows + r);
            int64_t dst_j = dj < 0 ? 0 : (dj == 0 ? r : t.cols + r);
            int64_t h = di == 0 ? t.rows : r;
            int64_t w = dj == 0 ? t.cols : r;
            int ni = e.wrap(i + di, e.ti);
            int nj = e.wrap(j + dj, e.tj);
            if (ni < 0 || nj < 0) {
                for (int64_t k = 0; k < h; ++k)
                    std::memset(dst.data() + (dst_i + k) * pw + dst_j, 0, w);
                continue;
            }
            Tile& s = e.at(ni, nj);
            const std::vector<uint8_t>& src = cur_is_a ? s.a : s.b;
            // Source rect: the neighbor's interior edge facing us.
            int64_t si = di < 0 ? s.rows - r : 0;  // coming from above: its bottom
            int64_t sj = dj < 0 ? s.cols - r : 0;
            copy_rect(s, src, r, si, sj, t, dst, dst_i, dst_j, h, w);
        }
    }
}

}  // namespace

extern "C" {

// Fill a (rows x cols) uint8 tile of the global grid starting at
// (row_off, col_off); alive iff hash % 3 == 0 (P = 1/3, matching the
// reference's rand() % 3 == 0 density, main.cpp:69-73).
void gol_init(uint8_t* grid, int64_t rows, int64_t cols, uint32_t seed,
              int64_t row_off, int64_t col_off) {
    for (int64_t i = 0; i < rows; ++i) {
        uint32_t gi = (uint32_t)(row_off + i);
        for (int64_t j = 0; j < cols; ++j) {
            uint32_t gj = (uint32_t)(col_off + j);
            grid[i * cols + j] = cell_hash(seed, gi, gj) % 3u == 0u;
        }
    }
}

// One serial step: in/out are UNPADDED (rows x cols) buffers.
void gol_step(const uint8_t* in, uint8_t* out, int64_t rows, int64_t cols,
              const uint8_t* birth_table, const uint8_t* survive_table,
              int radius, int periodic) {
    const int r = radius;
    const int64_t pw = cols + 2 * r, ph = rows + 2 * r;
    std::vector<uint8_t> pin((size_t)(ph * pw)), pout((size_t)(ph * pw));
    std::vector<uint8_t> rowsum((size_t)(rows * pw));
    for (int64_t i = 0; i < rows; ++i)
        std::memcpy(pin.data() + (i + r) * pw + r, in + i * cols, cols);
    fill_ghosts_self(pin.data(), rows, cols, r, periodic != 0);
    RuleTables rule{birth_table, survive_table, r};
    step_padded(pin.data(), pout.data(), rows, cols, rule, rowsum.data());
    for (int64_t i = 0; i < rows; ++i)
        std::memcpy(out + i * cols, pout.data() + (i + r) * pw + r, cols);
}

// Serial evolution, double buffered in padded space; result lands in grid.
// Radius-1 rules on 64-aligned widths take the bitpacked SWAR fast path.
void gol_evolve(uint8_t* grid, int64_t rows, int64_t cols, int64_t steps,
                const uint8_t* birth_table, const uint8_t* survive_table,
                int radius, int periodic) {
    if (ltl_eligible(rows, cols, radius) && steps > 0) {
        ltl_evolve(grid, rows, cols, steps, birth_table, survive_table,
                   radius, periodic != 0);
        return;
    }
    if (swar_eligible(cols, radius) && rows >= 1 && steps > 0) {
        const int64_t nw = cols / 64;
        if (swar_try_blocked(grid, rows, cols, birth_table, survive_table,
                             steps, periodic, 1))
            return;
        std::vector<uint64_t> a((size_t)((rows + 2) * nw), 0);
        std::vector<uint64_t> b((size_t)((rows + 2) * nw), 0);
        swar_pack(grid, a.data(), rows, cols, 1);
        SwarScratch scr(nw);
        uint64_t *cur = a.data(), *nxt = b.data();
        for (int64_t s = 0; s < steps; ++s) {
            swar_fill_ghost_rows(cur, rows, nw, periodic != 0);
            swar_gen_rows(cur, nxt, nw, 1, rows + 1, periodic != 0,
                          birth_table, survive_table, scr);
            std::swap(cur, nxt);
        }
        swar_unpack(cur, grid, rows, cols, 1);
        return;
    }
    const int r = radius;
    const int64_t pw = cols + 2 * r, ph = rows + 2 * r;
    std::vector<uint8_t> a((size_t)(ph * pw)), b((size_t)(ph * pw));
    std::vector<uint8_t> rowsum((size_t)(rows * pw));
    for (int64_t i = 0; i < rows; ++i)
        std::memcpy(a.data() + (i + r) * pw + r, grid + i * cols, cols);
    RuleTables rule{birth_table, survive_table, r};
    uint8_t *cur = a.data(), *nxt = b.data();
    for (int64_t s = 0; s < steps; ++s) {
        fill_ghosts_self(cur, rows, cols, r, periodic != 0);
        step_padded(cur, nxt, rows, cols, rule, rowsum.data());
        std::swap(cur, nxt);
    }
    for (int64_t i = 0; i < rows; ++i)
        std::memcpy(grid + i * cols, cur + (i + r) * pw + r, cols);
}

// Parallel evolution over a ti x tj worker-tile mesh (one thread per tile).
// Requires rows % ti == 0 and cols % tj == 0; returns 0 on success.
// worker_us (nullable): ti*tj slots, each ACCUMULATING its worker thread's
// measured wall time inside the evolve loop (includes barrier waits — the
// per-rank duration the reference's MPI_Reduce summed, main.cpp:319-324);
// accumulation lets segmented callers (snapshot gaps) total across calls.
int gol_evolve_par_t(uint8_t* grid, int64_t rows, int64_t cols, int64_t steps,
                     const uint8_t* birth_table, const uint8_t* survive_table,
                     int radius, int periodic, int ti, int tj,
                     int64_t* worker_us) {
    if (ti < 1 || tj < 1 || rows % ti || cols % tj) return 1;
    if (swar_eligible(cols, radius) && rows >= 1) {
        // Packed engine: the requested ti x tj mesh supplies the worker
        // count; internally workers own contiguous row BANDS of the one
        // packed global buffer (no per-tile ghosts to exchange — a band's
        // neighbor rows are just the adjacent bands' rows, stable during
        // the compute phase between barriers).  Results are identical to
        // the tile engine: same CA, same global grid.
        int w = ti * tj;
        if ((int64_t)w > rows) w = (int)rows;
        const int64_t nw = cols / 64;
        {
            auto b0 = std::chrono::steady_clock::now();
            if (swar_try_blocked(grid, rows, cols, birth_table, survive_table,
                                 steps, periodic, w)) {
                if (worker_us) {
                    // the blocked engine forks/joins its workers every block
                    // row, so each worker's measured span is the whole call.
                    // Credit >= 1us so a nonzero slot reliably means "this
                    // worker ran" (gol_main derives the active-worker count
                    // from nonzero slots) even when the span truncates to 0.
                    int64_t us = std::chrono::duration_cast<
                        std::chrono::microseconds>(
                        std::chrono::steady_clock::now() - b0).count();
                    if (us < 1) us = 1;
                    for (int t = 0; t < w; ++t) worker_us[t] += us;
                }
                return 0;
            }
        }
        std::vector<uint64_t> a((size_t)((rows + 2) * nw), 0);
        std::vector<uint64_t> b((size_t)((rows + 2) * nw), 0);
        swar_pack(grid, a.data(), rows, cols, 1);
        if (steps > 0) {
            Barrier barrier(w);
            std::vector<std::thread> threads;
            threads.reserve((size_t)w);
            uint64_t* bufs[2] = {a.data(), b.data()};
            for (int t = 0; t < w; ++t) {
                const int64_t lo = 1 + rows * t / w;
                const int64_t hi = 1 + rows * (t + 1) / w;
                threads.emplace_back([=, &barrier]() {
                    auto w0 = std::chrono::steady_clock::now();
                    SwarScratch scr(nw);
                    int cur = 0;
                    for (int64_t s = 0; s < steps; ++s) {
                        if (lo == 1)  // first band owns the ghost rows
                            swar_fill_ghost_rows(bufs[cur], rows, nw,
                                                 periodic != 0);
                        barrier.arrive_and_wait();  // ghosts valid
                        swar_gen_rows(bufs[cur], bufs[1 - cur], nw, lo, hi,
                                      periodic != 0, birth_table,
                                      survive_table, scr);
                        cur = 1 - cur;
                        barrier.arrive_and_wait();  // all bands written
                    }
                    if (worker_us) {
                        int64_t us = std::chrono::duration_cast<
                            std::chrono::microseconds>(
                            std::chrono::steady_clock::now() - w0).count();
                        worker_us[t] += us < 1 ? 1 : us;  // nonzero == ran
                    }
                });
            }
            for (auto& th : threads) th.join();
        }
        swar_unpack(steps % 2 ? b.data() : a.data(), grid, rows, cols, 1);
        return 0;
    }
    const int r = radius;
    const int64_t trows = rows / ti, tcols = cols / tj;
    if (trows < r || tcols < r) return 2;  // ghost slab must fit in one neighbor

    ParEngine e;
    e.ti = ti; e.tj = tj; e.radius = r; e.periodic = periodic != 0;
    e.tiles.resize((size_t)ti * tj);
    const int64_t pw = tcols + 2 * r, ph = trows + 2 * r;
    for (int i = 0; i < ti; ++i) {
        for (int j = 0; j < tj; ++j) {
            Tile& t = e.at(i, j);
            t.r0 = i * trows; t.c0 = j * tcols; t.rows = trows; t.cols = tcols;
            t.a.assign((size_t)(ph * pw), 0);
            t.b.assign((size_t)(ph * pw), 0);
            t.rowsum.assign((size_t)(trows * pw), 0);
            for (int64_t k = 0; k < trows; ++k)
                std::memcpy(t.a.data() + (k + r) * pw + r,
                            grid + (t.r0 + k) * cols + t.c0, tcols);
        }
    }

    Barrier barrier(ti * tj);
    std::vector<std::thread> workers;
    workers.reserve((size_t)ti * tj);
    for (int i = 0; i < ti; ++i) {
        for (int j = 0; j < tj; ++j) {
            workers.emplace_back([&e, &barrier, i, j, steps, birth_table,
                                  survive_table, worker_us]() {
                auto w0 = std::chrono::steady_clock::now();
                Tile& t = e.at(i, j);
                RuleTables rule{birth_table, survive_table, e.radius};
                bool cur_is_a = true;
                for (int64_t s = 0; s < steps; ++s) {
                    exchange_tile(e, i, j, cur_is_a);
                    barrier.arrive_and_wait();  // all ghosts filled
                    uint8_t* cur = cur_is_a ? t.a.data() : t.b.data();
                    uint8_t* nxt = cur_is_a ? t.b.data() : t.a.data();
                    step_padded(cur, nxt, t.rows, t.cols, rule, t.rowsum.data());
                    cur_is_a = !cur_is_a;
                    barrier.arrive_and_wait();  // all interiors written
                }
                if (worker_us) {
                    int64_t us = std::chrono::duration_cast<
                        std::chrono::microseconds>(
                        std::chrono::steady_clock::now() - w0).count();
                    worker_us[(size_t)i * e.tj + j] += us < 1 ? 1 : us;
                }
            });
        }
    }
    for (auto& w : workers) w.join();

    const bool final_is_a = (steps % 2) == 0;
    for (int i = 0; i < ti; ++i) {
        for (int j = 0; j < tj; ++j) {
            Tile& t = e.at(i, j);
            const uint8_t* buf = final_is_a ? t.a.data() : t.b.data();
            for (int64_t k = 0; k < trows; ++k)
                std::memcpy(grid + (t.r0 + k) * cols + t.c0,
                            buf + (k + r) * pw + r, tcols);
        }
    }
    return 0;
}

// Untimed entry (the ctypes binding's stable surface).
int gol_evolve_par(uint8_t* grid, int64_t rows, int64_t cols, int64_t steps,
                   const uint8_t* birth_table, const uint8_t* survive_table,
                   int radius, int periodic, int ti, int tj) {
    return gol_evolve_par_t(grid, rows, cols, steps, birth_table,
                            survive_table, radius, periodic, ti, tj, nullptr);
}

}  // extern "C"
