// Fused, temporally blocked FHP step for Hopper (sm_90a), with a plain C
// launch interface for ctypes.
//
// Replaces repro/kernels/fhp_step/kernel.py::fhp_kernel (built by
// make_fhp_step, kernel.py:489; the pl.pallas_call at kernel.py:600) in
// every mode: K1 (T fused steps, in-kernel RNG), K3 (2-D tiles), K4 (fused
// moments), K5 (extended shard: a halo-extended array that does not wrap,
// RNG on global coordinates mod the global extents), K6 (static solid, in
// periodic and extended mode) and K2 (one step with precomputed RNG
// planes).  Modes are template arguments (fhp_step.cuh, ``Mode``).
//
// Design (the paper's own CUDA blocking): one thread block owns a
// (bh, bw)-word tile of one lane, loads it with a T-row, T-word apron of
// every plane into dynamic shared memory (apron loads wrap mod (H, Wd) in
// periodic mode and clamp at the array edge in extended mode), runs T
// steps over the shrinking extent with two ping-pong buffers and
// __syncthreads() between steps, and writes its interior back.  Each
// thread updates whole 32-node words.  Moments: after each recorded step a
// block popcounts its own interior inside the moment window (__popc),
// reduces over the block, and adds into the (B, n_rec, n_moments) int32
// output with atomicAdd -- integer adds, so the sum is exact in any order.
// The output is always a fresh array: where the reference aliases its
// extended-mode carry in place (``donate``), the host loop here
// ping-pongs between launches, which costs memory, not results.
//
// What bounds it on the H100: per launch each plane word is read once and
// written once (NPS * 4 bytes per word, over T steps), while each
// word-step issues the compiled instructions of word_step (fhp_step.cuh:
// the taps, the chirality hash, the collision circuit and up to 16 hashed
// Bernoulli rounds; word_step_pre reads two words instead).
// kernels/fhp_step/opcount.py counts them per pipe from the sm_90a SASS
// of op_count.cu, and chip_smoke.py prints the count and the bound it
// sets; PERF.md keeps both.  At T = 8 the integer instructions, not the
// 3.35 TB/s of device memory, are the bound; the apron adds
// (bh+2T)(bw+2T)/(bh*bw) redundant work per step.  This first version
// keeps the design simple; PERF.md holds its times.
#include <cuda_runtime.h>

#include "fhp_step.cuh"

namespace fhp {

static const int THREADS = 256;

template <class Rule, bool STATIC, int MODE>
__global__ void __launch_bounds__(THREADS) fhp_step_kernel(Params P) {
  typedef Moments<Rule, STATIC> M;
  extern __shared__ uint32_t smem[];
  __shared__ int blk[M::N_TERMS];
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  Tile tl = make_tile(P, blockIdx.x, blockIdx.y, blockIdx.z);
  uint32_t* buf[2] = {smem, smem + NPS * tl.RW};
  uint32_t* sol = smem + 2 * NPS * tl.RW;

  for (int i = threadIdx.x; i < NPS * tl.RW; i += blockDim.x)
    load_elem<NPS, MODE>(P, tl, buf[0], i);
  if (STATIC)
    for (int i = threadIdx.x; i < tl.RW; i += blockDim.x)
      load_solid_elem<MODE>(P, tl, sol, i);
  if (threadIdx.x < M::N_TERMS) blk[threadIdx.x] = 0;
  __syncthreads();

  for (int s = 0; s < P.T; ++s) {
    const uint32_t* cur = buf[s & 1];
    uint32_t* nxt = buf[(s + 1) & 1];
    int n = (tl.R - 2 * s - 2) * (tl.W - 2 * s - 2);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      step_elem<Rule, STATIC, MODE>(P, tl, s, i, cur, nxt, sol);
    __syncthreads();
    if ((P.record_mask >> s) & 1) {
      int cnt[M::N_TERMS];
      for (int k = 0; k < M::N_TERMS; ++k) cnt[k] = 0;
      for (int i = threadIdx.x; i < P.bh * P.bw; i += blockDim.x)
        moment_elem<Rule, STATIC>(P, tl, i, nxt, cnt);
      for (int k = 0; k < M::N_TERMS; ++k) {
        int v = cnt[k];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xFFFFFFFFu, v, off);
        if ((threadIdx.x & 31) == 0) atomicAdd(&blk[k], v);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int m[M::N_MOMENTS];
        M::combine(blk, m);
        int rec = __popc((unsigned)P.record_mask & ((1u << s) - 1u));
        int32_t* dst =
            P.moments + ((long)tl.b * P.n_rec + rec) * M::N_MOMENTS;
        for (int k = 0; k < M::N_MOMENTS; ++k) atomicAdd(dst + k, m[k]);
        // Reused after the next step's barrier.
        for (int k = 0; k < M::N_TERMS; ++k) blk[k] = 0;
      }
    }
  }

  const uint32_t* fin = buf[P.T & 1];
  for (int i = threadIdx.x; i < NPS * P.bh * P.bw; i += blockDim.x)
    store_elem<NPS>(P, tl, fin, i);
}

template <class Rule, bool STATIC, int MODE>
static int launch(const Params& P, cudaStream_t stream) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  size_t smem = (size_t)smem_words(NPS, P.bh, P.bw, P.T, STATIC) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fhp_step_kernel<Rule, STATIC, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P.Wd + P.bw - 1) / P.bw, (P.H + P.bh - 1) / P.bh, P.B);
  fhp_step_kernel<Rule, STATIC, MODE><<<grid, THREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

// Static solid runs in periodic and extended mode only; PRE_RNG is a
// one-step, 8-plane mode (the reference refuses the same combinations).
template <class Rule>
static int launch_rule(const Params& P, int mode, cudaStream_t stream) {
  if (P.solid) {
    if constexpr (Rule::SOLID >= 0) {
      if (mode == PERIODIC) return launch<Rule, true, PERIODIC>(P, stream);
      if (mode == EXTENDED) return launch<Rule, true, EXTENDED>(P, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (mode == PERIODIC) return launch<Rule, false, PERIODIC>(P, stream);
  if (mode == EXTENDED) return launch<Rule, false, EXTENDED>(P, stream);
  if (mode == PRE_RNG && P.T == 1)
    return launch<Rule, false, PRE_RNG>(P, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fhp

// Returns a cudaError_t code (0 = launched).  Pointers are device
// pointers; `solid` selects static-solid mode, `chi` / `acc` are the
// precomputed planes of mode 2, `moments` (zeroed by the caller) is
// written only when record_mask != 0, counting array rows [r0, r1) x
// words [c0, c1).  `mode`: 0 periodic, 1 extended (hg, wdg), 2 PRE_RNG.
extern "C" int fhp_step_launch(const void* in, void* out, const void* solid,
                               const void* chi, const void* acc,
                               void* moments, int rule, int mode, int B,
                               int H, int Wd, int bh, int bw, int T,
                               unsigned t0, int y0, int xw0, int hg, int wdg,
                               int r0, int r1, int c0, int c1, int pq,
                               int record_mask, void* stream) {
  fhp::Params P = fhp::make_params(in, out, solid, chi, acc, moments, B, H,
                                   Wd, bh, bw, T, t0, y0, xw0, hg, wdg, r0,
                                   r1, c0, c1, pq, record_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FHP_CASE(R) \
  case R::ID:       \
    return fhp::launch_rule<R>(P, mode, st);
  switch (rule) { FHP_FOR_EACH_RULE(FHP_CASE) }
#undef FHP_CASE
  return (int)cudaErrorInvalidValue;
}
