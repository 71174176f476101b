// Serial CPU emulation of fhp_step.cu's kernel, for the CPU tests only:
// the same per-element functions (fhp_step.cuh) run block by block, one
// barrier phase at a time, with the block's moment counts summed directly
// instead of through warp shuffles and atomics.  Build with
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
  for (int bz = 0; bz < P.B; ++bz)
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx) {
        Tile tl = make_tile(P, bx, by, bz);
        uint32_t* buf[2] = {smem.data(), smem.data() + NPS * tl.RW};
        uint32_t* sol = smem.data() + 2 * NPS * tl.RW;
        for (int i = 0; i < NPS * tl.RW; ++i)
          load_elem<NPS, MODE>(P, tl, buf[0], i);
        if (STATIC)
          for (int i = 0; i < tl.RW; ++i) load_solid_elem<MODE>(P, tl, sol, i);
        for (int s = 0; s < P.T; ++s) {
          int n = (tl.R - 2 * s - 2) * (tl.W - 2 * s - 2);
          for (int i = 0; i < n; ++i)
            step_elem<Rule, STATIC, MODE>(P, tl, s, i, buf[s & 1],
                                          buf[(s + 1) & 1], sol);
          if ((P.record_mask >> s) & 1) {
            int cnt[M::N_TERMS] = {0};
            for (int i = 0; i < P.bh * P.bw; ++i)
              moment_elem<Rule, STATIC>(P, tl, i, buf[(s + 1) & 1], cnt);
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
        for (int i = 0; i < NPS * P.bh * P.bw; ++i)
          store_elem<NPS>(P, tl, buf[P.T & 1], i);
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
