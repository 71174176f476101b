// Compile-only probes of fhp_step.cu's per-word work; never launched.
//
// kernels/fhp_step/opcount.py compiles this file to a cubin for sm_90a and
// counts the SASS instructions of each probe.  The probes keep their words
// in registers and take p_force as a compile-time constant
// (-DPROBE_PQ=<quantised p_force>), so each body is straight-line code:
//   step_even / step_odd  one fhp2 word-step -- word_step, the function the
//                         kernel runs -- for a centre row of either parity;
//   pre_even / pre_odd    the same with precomputed random words
//                         (word_step_pre, kernel mode K2), loaded;
//   terms                 one word's moment popcount terms (Rule::terms);
//   copy                  the same thread indexing, loads and stores and
//                         nothing else, which opcount.py subtracts.
#include "fhp_step.cuh"

#ifndef PROBE_PQ
#error "compile with -DPROBE_PQ=<quantised p_force>"
#endif

namespace {

typedef Rule_fhp2 R;

// The lowest set bit of pq (Params::pq_lo), at compile time.
__host__ __device__ constexpr int lowest_bit(int pq) {
  int b = 0;
  while (pq > 0 && !((pq >> b) & 1)) ++b;
  return b;
}

const int HOOD = R::NP * 9;  // every plane's 3 x 3 word neighbourhood
const int N = 32;            // stride between one thread's words

// fhp::PqBits for the probes: PROBE_PQ's bits known at compile time, so
// each comparator round compiles to the least it needs (the kernel, which
// gets pq at run time, spends one more logic op a round).
struct ProbeBits {
  __device__ __forceinline__ uint32_t compare(uint32_t lt, uint32_t r,
                                              int i) const {
    return (PROBE_PQ >> i) & 1 ? lt | ~r : lt & ~r;
  }
};

template <int ODD, bool PRE>
__device__ __forceinline__ void step_probe(const uint32_t* __restrict__ in,
                                           uint32_t* __restrict__ out,
                                           uint32_t t) {
  const int i = threadIdx.x;
  uint32_t w[HOOD];
  #pragma unroll
  for (int k = 0; k < HOOD; ++k) w[k] = in[k * N + i];
  fhp::Reader<false, R::SOLID> rd;
  rd.ctr = w + 4;  // the centre of each plane's 3 x 3 words
  rd.ps = 9;
  rd.rs = 3;
  rd.sol = nullptr;
  rd.odd[0] = rd.odd[2] = !ODD;  // rows r + 1 and r - 1
  rd.odd[1] = ODD;
  uint32_t o[R::NP];
  if (PRE)  // the chirality and force words
    fhp::word_step_pre<R>(rd, in[HOOD * N + i], in[(HOOD + 1) * N + i],
                          PROBE_PQ > 0, t, o);
  else      // the row and word counters
    fhp::word_step<R>(rd, in[HOOD * N + i], in[(HOOD + 1) * N + i], t,
                      PROBE_PQ, lowest_bit(PROBE_PQ), ProbeBits(), o);
  #pragma unroll
  for (int p = 0; p < R::NP; ++p) out[p * N + i] = o[p];
}

}  // namespace

extern "C" __global__ void step_even(const uint32_t* __restrict__ in,
                                     uint32_t* __restrict__ out, uint32_t t) {
  step_probe<0, false>(in, out, t);
}

extern "C" __global__ void step_odd(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out, uint32_t t) {
  step_probe<1, false>(in, out, t);
}

extern "C" __global__ void pre_even(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out, uint32_t t) {
  step_probe<0, true>(in, out, t);
}

extern "C" __global__ void pre_odd(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out, uint32_t t) {
  step_probe<1, true>(in, out, t);
}

// The counters are loaded, as the kernel's accumulate across words.
extern "C" __global__ void terms(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out) {
  const int i = threadIdx.x;
  uint32_t p[R::NP];
  int c[R::N_TERMS];
  #pragma unroll
  for (int k = 0; k < R::NP; ++k) p[k] = in[k * N + i];
  #pragma unroll
  for (int k = 0; k < R::N_TERMS; ++k) c[k] = (int)in[(R::NP + k) * N + i];
  R::terms(p, c);
  #pragma unroll
  for (int k = 0; k < R::N_TERMS; ++k) out[k * N + i] = (uint32_t)c[k];
}

extern "C" __global__ void copy(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out) {
  const int i = threadIdx.x;
  #pragma unroll
  for (int k = 0; k < R::NP; ++k) out[k * N + i] = in[k * N + i];
}
