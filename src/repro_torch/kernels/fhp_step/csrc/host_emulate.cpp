// Serial CPU emulation of fhp_step.cu's kernel, for the CPU tests only:
// the same per-element functions (fhp_step.cuh) run block by block, one
// barrier phase at a time, with the block's moment counts summed directly
// instead of through warp shuffles and atomics.  Build with
//   g++ -std=c++17 -O1 -shared -fPIC -o libfhp_host.so host_emulate.cpp
#include <vector>

#include "fhp_step.cuh"

namespace {

using namespace fhp;

template <class Rule, bool STATIC>
void run_blocks(const Params& P) {
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
        for (int i = 0; i < NPS * tl.RW; ++i) load_elem<NPS>(P, tl, buf[0], i);
        if (STATIC)
          for (int i = 0; i < tl.RW; ++i) load_solid_elem(P, tl, sol, i);
        for (int s = 0; s < P.T; ++s) {
          int n = (tl.R - 2 * s - 2) * (tl.W - 2 * s - 2);
          for (int i = 0; i < n; ++i)
            step_elem<Rule, STATIC>(P, tl, s, i, buf[s & 1],
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
}

template <class Rule>
int run_rule(const Params& P) {
  if (P.solid) {
    if constexpr (Rule::SOLID >= 0) {
      run_blocks<Rule, true>(P);
      return 0;
    }
    return 1;
  }
  run_blocks<Rule, false>(P);
  return 0;
}

}  // namespace

// Same arguments as fhp_step_launch, on host pointers, without a stream.
extern "C" int fhp_step_host(const void* in, void* out, const void* solid,
                             void* moments, int rule, int B, int H, int Wd,
                             int bh, int bw, int T, unsigned t0, unsigned y0,
                             unsigned xw0, int pq, int record_mask) {
  Params P;
  P.in = static_cast<const uint32_t*>(in);
  P.out = static_cast<uint32_t*>(out);
  P.solid = static_cast<const uint32_t*>(solid);
  P.moments = static_cast<int32_t*>(moments);
  P.B = B;
  P.H = H;
  P.Wd = Wd;
  P.bh = bh;
  P.bw = bw;
  P.T = T;
  P.t0 = t0;
  P.y0 = y0;
  P.xw0 = xw0;
  P.pq = pq;
  P.record_mask = record_mask;
  P.n_rec = __builtin_popcount((unsigned)record_mask);
#define FHP_CASE(R) \
  case R::ID:       \
    return run_rule<R>(P);
  switch (rule) { FHP_FOR_EACH_RULE(FHP_CASE) }
#undef FHP_CASE
  return 1;
}
