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
#include <algorithm>
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

// The row-streaming kernel: every block's share in turn, segment by
// segment; per wave the input-row loads of every thread (host copies land
// at once, so a compute that read a slot being loaded would see the new
// row), then the compute of every thread in reverse order (a write that a
// thread of the same wave reads would show), then the barrier; after each
// segment the warps' sums of their threads' moment counters, then the
// flush.  HOST_PERSISTENT_BLOCKS stands for the blocks the card holds.
const int HOST_PERSISTENT_BLOCKS = 5;

template <class Rule, int J>
int run_stream(const Params& P, StreamGeom S) {
  S.G = stream_blocks(P, S, HOST_PERSISTENT_BLOCKS);
  std::vector<uint32_t> smem(stream_smem_words(Rule::NP, S.W, P.T));
  std::vector<int> acc(STREAM_WARPS * Rule::N_TERMS);
  typedef int Row[Rule::N_TERMS];
  Row* rows = reinterpret_cast<Row*>(acc.data());
  const int nt = 32 * S.NWS;
  std::vector<StreamLane> lanes(nt);
  std::vector<SegLane<J>> segl(nt);
  std::vector<int> cnt(nt * Rule::N_TERMS);
  for (int i = 0; i < nt; ++i)
    lanes[i] = make_stream_lane<Rule::NP>(S, i & 31, i >> 5);
  for (int blk = 0; blk < S.G; ++blk) {
    long long g = share_begin(S, blk), g1 = share_begin(S, blk + 1);
    while (g < g1) {
      Segment sg = make_segment(P, S, g, g1);
      for (int i = 0; i < nt; ++i)
        segl[i] = make_seg_lane<Rule::NP, J>(P, sg, lanes[i], nt);
      g += sg.n;
      std::fill(acc.begin(), acc.end(), 0);
      std::fill(cnt.begin(), cnt.end(), 0);
      for (int q = 0; q < STREAM_AHEAD; ++q)
        for (int i = 0; i < nt; ++i)
          stream_load<Rule::NP, J>(P, S, sg, segl[i], smem.data(), q, nt);
      for (int wv = 0; wv < sg.n + 3 * P.T; ++wv) {
        for (int i = 0; i < nt; ++i)
          stream_load<Rule::NP, J>(P, S, sg, segl[i], smem.data(),
                                   wv + STREAM_AHEAD, nt);
        for (int i = nt - 1; i >= 0; --i)
          stream_compute<Rule, J>(P, S, sg, lanes[i], segl[i], smem.data(),
                                  wv, &cnt[i * Rule::N_TERMS]);
      }
      if (P.record_mask) {
        for (int i = 0; i < nt; ++i)
          warp_accumulate<Rule::N_TERMS>(rows[i >> 5], &cnt[i * Rule::N_TERMS],
                                         i & 31);
        for (int i = 0; i < nt; ++i)
          stream_flush<Rule>(P, S, sg, rows, i & 31, i >> 5);
      }
    }
  }
  return 0;
}

template <class Rule>
int run_stream(const Params& P) {
  if (stream_max_owned(P.T, Rule::NP) < 1) return 1;
  StreamGeom S = stream_geom(P.B, P.H, P.Wd, P.T, Rule::NP, P.bw);
  switch (S.J) {
    case 1:
      return run_stream<Rule, 1>(P, S);
    case 2:
      return run_stream<Rule, 2>(P, S);
  }
  if constexpr (Rule::NP <= 4) {
    if (S.J == 4) return run_stream<Rule, 4>(P, S);
    if (S.J == 8) return run_stream<Rule, 8>(P, S);
  }
  return 1;
}

// The mode combinations fhp_step.cu's launch_rule accepts.
template <class Rule>
int run_rule(const Params& P, int mode) {
  if (mode == STREAM && !P.solid) return run_stream<Rule>(P);
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
  if (mode == STREAM) P.bw = bw;
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

// The streamed geometry of a launch (stream_geom): out[0] strips, out[1]
// the widest strip row with its apron (words), out[2] the words of a ring
// slot,
// out[3] chunks a warp, out[4] warps a block, out[5] dynamic shared bytes;
// out[6] the most words a strip can own (< 1: the launch cannot stream,
// and out[0 .. 5] are left as they are).
extern "C" void fhp_stream_geometry_host(int Wd, int T, int nps, int bw,
                                         int* out) {
  out[6] = stream_max_owned(T, nps);
  if (out[6] < 1) return;
  StreamGeom S = stream_geom(1, 1, Wd, T, nps, bw);
  out[0] = S.NS;
  out[1] = S.W;
  out[2] = S.SLOT;
  out[3] = S.J;
  out[4] = S.NWS;
  out[5] = (int)(4 * stream_smem_words(nps, S.W, T));
}

// The wave schedule of a segment of n rows at T, for waves [0, n + 3T):
// per wave and level L in 0 .. T, the segment row the level writes (level
// 0: the input row whose load is issued, AHEAD rows ahead) or -1, and the
// ring slot it goes to (-1 for level T, which writes device memory); per
// wave and level s in 1 .. T the slots of the three rows it reads, or -1.
// ``written`` is (waves, T + 1, 2), ``read`` (waves, T, 3).
extern "C" int fhp_stream_schedule_host(int T, int n, int* written,
                                        int* read) {
  Params P;
  P.T = T;
  Segment sg;
  sg.n = n;
  int waves = n + 3 * T;
  for (int i = 0; i < waves; ++i) {
    for (int L = 0; L <= T; ++L) {
      int q = L == 0 ? i + STREAM_AHEAD : wave_row(L, i);
      bool on = L == 0 ? q < n + 2 * T : level_has_row(P, sg, L, q);
      int* o = written + (i * (T + 1) + L) * 2;
      o[0] = on ? q : -1;
      o[1] = on && L < T ? ring_slot(L, q) : -1;
    }
    for (int s = 1; s <= T; ++s) {
      int q = wave_row(s, i);
      bool on = level_has_row(P, sg, s, q);
      for (int k = 0; k < 3; ++k)
        read[(i * T + s - 1) * 3 + k] = on ? ring_slot(s - 1, q + 1 - k) : -1;
    }
  }
  return waves;
}
