// Serial CPU emulation of fhp_step.cu's kernel, for the CPU tests only:
// the same per-thread functions (fhp_step.cuh) run for every thread of a
// block, one barrier phase at a time -- load, then per step and round a
// compute phase (registers kept per thread) and a write phase (run in
// reverse thread order, so a write that another thread's phase depends on
// shows), then moments and the store -- with the block's moment counts
// summed directly instead of through warp shuffles and atomics.  Also
// exported: the copy plans, the tile geometry and the Bernoulli word, for
// their own tests.
// Build with
//   g++ -std=c++17 -O1 -shared -fPIC -o libfhp_host.so host_emulate.cpp
#include <vector>

#include "fhp_step.cuh"

namespace {

using namespace fhp;

template <class Rule, bool STATIC, int MODE>
int run_blocks(const Params& P) {
  typedef Moments<Rule, STATIC> M;
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  int nbx = (P.Wd + P.bw - 1) / P.bw, nby = (P.H + P.bh - 1) / P.bh;
  std::vector<uint32_t> smem(smem_words(NPS, P.bh, P.bw, P.T, STATIC));
  std::vector<Lane> lanes(THREADS);
  std::vector<uint32_t> regs(THREADS * 2 * Rule::NP);
  typedef uint32_t Pair[2][Rule::NP];
  Pair* o = reinterpret_cast<Pair*>(regs.data());
  for (int bz = 0; bz < P.B; ++bz)
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx) {
        Tile tl = make_tile(P, bx, by, bz);
        Smem sm = carve(P, NPS, STATIC, smem.data());
        for (int i = 0; i < THREADS; ++i) {
          int x = i & 31, w = i >> 5;
          load_tile<MODE>(P, tl, P.in + (long)bz * NPS * P.H * P.Wd, NPS,
                          sm.buf, x, w);
          if (STATIC) load_tile<MODE>(P, tl, P.solid, 1, sm.sol, x, w);
          for (int r = i; r < P.R; r += THREADS)
            sm.rows[r] = row_entry<MODE>(P, tl, r);
          lanes[i] = make_lane<MODE>(P, tl, x, w);
        }
        for (int s = 0; s < P.T; ++s) {
          StepGeom g = step_geom(P, s);
          for (int a = g.r_lo; a < g.r_hi; a += P.NWR) {
            for (int i = 0; i < THREADS; ++i) {  // compute phase
              int r = a + lanes[i].wrow;
              if (!lanes[i].idle && r < g.r_hi)
                compute_row<Rule, STATIC, MODE>(P, tl, lanes[i], g, sm, r,
                                                o[i]);
            }
            for (int i = THREADS - 1; i >= 0; --i) {  // write phase
              int r = a + lanes[i].wrow;
              if (!lanes[i].idle && r < g.r_hi)
                write_row<Rule, STATIC>(P, tl, lanes[i], g, sm, r, o[i]);
            }
          }
          if ((P.record_mask >> s) & 1) {
            int cnt[M::N_TERMS] = {0};
            for (int i = 0; i < THREADS; ++i) {
              const Lane& ln = lanes[i];
              if (ln.idle) continue;
              for (int r = P.T + ln.wrow; r < P.T + P.bh; r += P.NWR)
                moment_row<Rule, STATIC>(P, tl, ln, sm, s, r, cnt);
            }
            int m[M::N_MOMENTS];
            M::combine(cnt, m);
            int rec = __builtin_popcount((unsigned)P.record_mask &
                                         ((1u << s) - 1u));
            int32_t* dst =
                P.moments + ((long)bz * P.n_rec + rec) * M::N_MOMENTS;
            for (int k = 0; k < M::N_MOMENTS; ++k)
              dst[k] = (int32_t)((uint32_t)dst[k] + (uint32_t)m[k]);
          }
        }
        for (int i = 0; i < THREADS; ++i)
          store_tile(P, tl, NPS, sm.buf, i & 31, i >> 5);
      }
  return 0;
}

// The mode combinations fhp_step.cu's launch_rule accepts.
template <class Rule>
int run_rule(const Params& P, int mode) {
  if (P.solid) {
    if constexpr (Rule::SOLID >= 0) {
      if (mode == PERIODIC) return run_blocks<Rule, true, PERIODIC>(P);
      if (mode == EXTENDED) return run_blocks<Rule, true, EXTENDED>(P);
    }
    return 1;
  }
  if (mode == PERIODIC) return run_blocks<Rule, false, PERIODIC>(P);
  if (mode == EXTENDED) return run_blocks<Rule, false, EXTENDED>(P);
  if (mode == PRE_RNG && P.T == 1)
    return run_blocks<Rule, false, PRE_RNG>(P);
  return 1;
}

}  // namespace

// Same arguments as fhp_step_launch, on host pointers, without a stream.
extern "C" int fhp_step_host(const void* in, void* out, const void* solid,
                             const void* chi, const void* acc, void* moments,
                             int rule, int mode, int B, int H, int Wd, int bh,
                             int bw, int T, unsigned t0, int y0, int xw0,
                             int hg, int wdg, int r0, int r1, int c0, int c1,
                             int pq, int record_mask) {
  Params P = make_params(in, out, solid, chi, acc, moments, B, H, Wd, bh, bw,
                         T, t0, y0, xw0, hg, wdg, r0, r1, c0, c1, pq,
                         record_mask);
#define FHP_CASE(R) \
  case R::ID:       \
    return run_rule<R>(P, mode);
  switch (rule) { FHP_FOR_EACH_RULE(FHP_CASE) }
#undef FHP_CASE
  return 1;
}

// The copy plans of the tile at word tx of an (H, Wd) array (16-byte
// copies allowed when `vec`): for the load plan (`store` 0) every unit's
// first tile column (0 .. W) and width (4 for a 16-byte chunk, else 1),
// with the source word (wrapped, or clamped when `extended`) and the
// shared-memory word (SH + column) it moves; for the store plan the same
// over interior words.  Returns the number of units.
extern "C" int fhp_plan_host(int store, int extended, int vec, int Wd,
                             int bw, int T, int tx, int* col, int* width,
                             int* src, int* dst) {
  uint32_t dummy[4];
  Params P = make_params(dummy, dummy, nullptr, nullptr, nullptr, nullptr, 1,
                         1, Wd, 1, bw, T, 0, 0, 0, 2, 1, 0, 0, 0, 0, 0, 0);
  P.vec = vec;
  RowPlan pl = store ? store_plan(P, tx) : load_plan(P, tx);
  int sh = (tx - T) & 3;
  for (int u = 0; u < pl.units; ++u) {
    int c = pl.col(u);
    col[u] = c;
    width[u] = pl.chunk(u) ? 4 : 1;
    if (store) {
      src[u] = tx + c;
      dst[u] = sh + T + c;  // the shared-memory word it is read from
    } else {
      int g = tx - T + c;
      src[u] = pl.chunk(u) ? g
               : extended  ? src_index<EXTENDED>(g, Wd)
                           : src_index<PERIODIC>(g, Wd);
      dst[u] = sh + c;
    }
  }
  return pl.units;
}

// The tile geometry a launch of tile (bh, bw) at T with `nps` stack planes
// (and the solid tile when `solid`) gets: out[0] the row pitch, out[1] the
// words per plane, out[2] the dynamic shared bytes of a block, out[3] the
// tile's words (bw, or the most a block covers).
extern "C" void fhp_geometry_host(int nps, int bh, int bw, int T, int solid,
                                  int* out) {
  uint32_t dummy[4];
  Params P = make_params(dummy, dummy, nullptr, nullptr, nullptr, nullptr, 1,
                         bh, bw, bh, bw, T, 0, 0, 0, 2, 1, 0, 0, 0, 0, 0, 0);
  out[0] = P.WP;
  out[1] = P.PS;
  out[2] = (int)(4 * smem_words(nps, P.bh, P.bw, T, solid != 0));
  out[3] = P.bw;
}

// bernoulli_word at n (row, word) counters.
extern "C" void fhp_bernoulli_host(const unsigned* rows, const unsigned* cols,
                                   int n, unsigned t, int pq, unsigned* out) {
  fhp::Params P = fhp::make_params(nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, 1, 1, 1, 1, 1, 1, 0, 0,
                                   0, 2, 1, 0, 0, 0, 0, pq, 0);
  for (int i = 0; i < n; ++i)
    out[i] = fhp::bernoulli_word(rows[i], cols[i], t, pq, P.pq_lo,
                                 P.pq_bits);
}
