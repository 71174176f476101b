// Fused, temporally blocked FHP step for Hopper (sm_90a), with a plain C
// launch interface for ctypes.  Two kernels: fhp_step_stream_kernel, a
// row-streaming wavefront, takes every periodic launch without a solid
// operand whose T level rings fit shared memory (T <= 24 for 8 planes);
// fhp_step_kernel, the tile design, takes the rest -- static solid,
// extended shard, precomputed RNG, and periodic launches of larger T.
//
// Replaces repro/kernels/fhp_step/kernel.py::fhp_kernel (built by
// make_fhp_step, kernel.py:489; the pl.pallas_call at kernel.py:600) in
// every mode: K1 (T fused steps, in-kernel RNG), K3 (2-D tiles), K4 (fused
// moments), K5 (extended shard: a halo-extended array that does not wrap,
// RNG on global coordinates mod the global extents), K6 (static solid, in
// periodic and extended mode) and K2 (one step with precomputed RNG
// planes).  Modes are template arguments (fhp_step.cuh, ``Mode``).
//
// What bounds it on the H100: per launch each plane word is read once and
// written once (NPS * 4 bytes per word, over T steps), while each
// word-step issues the compiled instructions of word_step (fhp_step.cuh:
// the taps, the chirality hash, the collision circuit and up to 16 hashed
// Bernoulli rounds; word_step_pre reads two words instead).
// kernels/fhp_step/opcount.py counts them per pipe from the sm_90a SASS
// of op_count.cu, and chip_smoke.py prints the count and the bound it
// sets.  At T = 8 the integer ALU pipe, not the 3.35 TB/s of device
// memory, is the bound; a one-step launch is bound by its bytes.  Beyond
// the bound's word-steps a launch computes the apron's (sum_s (R-2s-2) x
// (W-2s-2) / (T bh bw) - 1 more), the lanes its warps leave idle where a
// row is narrower than its passes, and its own indexing and barriers.
//
// What the design does about it (fhp_step.cuh has the layout):
// - Row-mapped threads: a warp covers 32 adjacent words of one tile row,
//   twice (columns c and c + 32), so the RNG row and row parity are
//   warp-uniform, read from a table built once per tile, and the RNG and
//   source columns are computed once per thread per tile; the step,
//   moment and store loops hold no runtime division or modulo, and no
//   tap's shift differs inside a warp.  The two words of a thread share
//   their row's setup and address registers.
// - One stepping buffer: each round of rows is computed into registers,
//   then written back in place one slot higher, so no round overwrites a
//   row that a later round reads.  A 32 x 32 tile at T = 8 needs 73,728 B
//   where two ping-pong buffers took 147,456 B; the default 40 x 48 tile
//   with its apron, 56 x 64 words, takes 114,688 B for eight planes.
// - Several resident blocks per SM (route (a); no persistent grid): two
//   512-thread blocks share an SM, 32 warps, so one block's apron loads
//   and stores overlap the other's steps.  Loads are cp.async, issued all
//   at once: 16-byte chunks where a row segment does not wrap or clamp
//   and Wd % 4 == 0, 4-byte copies elsewhere; interior stores are 16-byte
//   where aligned.  __launch_bounds__(512, 2) caps the registers at 64 a
//   thread (ptxas reports no spills).
// - The 16 Bernoulli rounds are unrolled, so their independent hashes
//   interleave; pq's bits are kernel parameters used as logic operands,
//   and the rounds below pq's lowest set bit are predicated off four at
//   a time.
// Tensor cores (wgmma, mma) do not apply: the step is bitwise logic,
// shifts and 32-bit integer hashes, with no matrix product.
//
// The tile design repeats the apron's word-steps (a 40 x 48 tile at T = 8
// issues 1.567 thread word-steps per word-step it owns) and loads, steps
// and stores each tile in turn.  The row-streaming kernel (fhp_step.cuh,
// "Row-streaming wavefront", has the schedule and layout) keeps an apron
// only at the sides of long strips and at the ends of a block's share of
// rows:
// - Persistent blocks, as many as the card holds at once, each walk down
//   a contiguous share of the lanes' strip rows; step level s keeps a
//   4-row ring in shared memory and computes its row two rows behind
//   level s - 1, so ONE barrier a wave orders every read after its write.
//   The main launch (fhp2, 4 x 4096 x 1024 words, T = 8) runs 6 strips of
//   171 words: 1.165 thread word-steps per owned one.
// - Input rows stream in by cp.async four waves ahead of use; level T
//   writes its row from registers straight to device memory, so loading
//   and storing overlap the steps instead of bracketing them.
// - A ring row is column-chunked (a word's planes 32 words apart), so the
//   taps, ring stores and a thread's J words (1 or 2 chunks for 8 planes,
//   up to 8 for 2) are constant offsets from per-wave pointers; rows of
//   alternating parity take taps whose shifts are compile-time.
// - __launch_bounds__(768, 1) leaves up to 80 registers a thread; ptxas
//   reports no spills for the instantiations the geometry picks.
//
// Moments: after each recorded step each thread popcounts its interior
// words inside the moment window (__popc), the block reduces by warp
// shuffles and shared atomics, and one thread adds into the (B, n_rec,
// n_moments) int32 output with atomicAdd -- integer adds, so the sum is
// exact in any order.  The output is always a fresh array: where the
// reference aliases its extended-mode carry in place (``donate``), the
// host loop here ping-pongs between launches, which costs memory, not
// results.
#include <cuda_runtime.h>

#include "fhp_step.cuh"

namespace fhp {

static const int MIN_BLOCKS = 2;  // per SM: at most 64 registers a thread

template <class Rule, bool STATIC, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fhp_step_kernel(Params P) {
  typedef Moments<Rule, STATIC> M;
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int blk[M::N_TERMS];
  const int x = threadIdx.x, w = threadIdx.y;
  Tile tl = make_tile(P, blockIdx.x, blockIdx.y, blockIdx.z);
  Smem sm = carve(P, NPS, STATIC, smem);

  load_tile<MODE>(P, tl, P.in + (long)tl.b * NPS * P.H * P.Wd, NPS, sm.buf,
                  x, w);
  if (STATIC) load_tile<MODE>(P, tl, P.solid, 1, sm.sol, x, w);
  for (int i = w * 32 + x; i < P.R; i += THREADS)
    sm.rows[i] = row_entry<MODE>(P, tl, i);
  Lane ln = make_lane<MODE>(P, tl, x, w);
  if (w == 0 && x < M::N_TERMS) blk[x] = 0;
  copy_wait();
  __syncthreads();

  for (int s = 0; s < P.T; ++s) {
    StepGeom g = step_geom(P, s);
    for (int a = g.r_lo; a < g.r_hi; a += P.NWR) {
      const int r = a + ln.wrow;
      const bool on = !ln.idle && r < g.r_hi;
      uint32_t o[2][Rule::NP];
      if (on) compute_row<Rule, STATIC, MODE>(P, tl, ln, g, sm, r, o);
      __syncthreads();
      if (on) write_row<Rule, STATIC>(P, tl, ln, g, sm, r, o);
      __syncthreads();
    }
    if ((P.record_mask >> s) & 1) {
      int cnt[M::N_TERMS];
      for (int k = 0; k < M::N_TERMS; ++k) cnt[k] = 0;
      if (!ln.idle)
        for (int r = P.T + ln.wrow; r < P.T + P.bh; r += P.NWR)
          moment_row<Rule, STATIC>(P, tl, ln, sm, s, r, cnt);
      for (int k = 0; k < M::N_TERMS; ++k) {
        int v = cnt[k];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xFFFFFFFFu, v, off);
        if (x == 0) atomicAdd(&blk[k], v);
      }
      __syncthreads();
      if (x == 0 && w == 0) {
        int m[M::N_MOMENTS];
        M::combine(blk, m);
        int rec = __popc((unsigned)P.record_mask & ((1u << s) - 1u));
        int32_t* dst =
            P.moments + ((long)tl.b * P.n_rec + rec) * M::N_MOMENTS;
        for (int k = 0; k < M::N_MOMENTS; ++k) atomicAdd(dst + k, m[k]);
        // Reused after the next step's barriers.
        for (int k = 0; k < M::N_TERMS; ++k) blk[k] = 0;
      }
    }
  }
  store_tile(P, tl, NPS, sm.buf, x, w);
}

// The row-streaming kernel of the periodic launches without a solid
// operand (fhp_step.cuh, "Row-streaming wavefront"): persistent blocks, each
// walking down its share of strip rows in waves of one barrier; J chunks a
// warp.
template <class Rule, int J>
__global__ void __launch_bounds__(32 * STREAM_WARPS, 1)
    fhp_step_stream_kernel(Params P, StreamGeom S) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int acc[STREAM_WARPS][Rule::N_TERMS];
  const int x = threadIdx.x, w = threadIdx.y, nt = 32 * S.NWS;
  const StreamLane ln = make_stream_lane<Rule::NP>(S, x, w);
  long long g = share_begin(S, blockIdx.x);
  const long long g1 = share_begin(S, blockIdx.x + 1);
  while (g < g1) {
    const Segment sg = make_segment(P, S, g, g1);
    SegLane<J> sl = make_seg_lane<Rule::NP, J>(P, sg, ln, nt);
    g += sg.n;
    int cnt[Rule::N_TERMS];
    for (int k = 0; k < Rule::N_TERMS; ++k) cnt[k] = 0;
    if (P.record_mask && x == 0)
      for (int k = 0; k < Rule::N_TERMS; ++k) acc[w][k] = 0;
    for (int q = 0; q < STREAM_AHEAD; ++q) {
      stream_load<Rule::NP, J>(P, S, sg, sl, smem, q, nt);
      copy_commit();
    }
    const int waves = sg.n + 3 * P.T;
    for (int i = 0; i < waves; ++i) {
      stream_load<Rule::NP, J>(P, S, sg, sl, smem, i + STREAM_AHEAD, nt);
      copy_commit();
      stream_compute<Rule, J>(P, S, sg, ln, sl, smem, i, cnt);
      copy_wait_ahead();
      __syncthreads();
    }
    if (P.record_mask) {
      warp_accumulate<Rule::N_TERMS>(acc[w], cnt, x);
      __syncthreads();
      stream_flush<Rule>(P, S, sg, acc, x, w);
      __syncthreads();
    }
  }
}

// What a launch of one instantiation needs and gets; returns a
// cudaError_t code.  info[]: resident blocks per SM, registers a thread,
// local (spill) bytes a thread, dynamic shared bytes a block.
template <class Rule, bool STATIC, int MODE>
static int prepare(const Params& P, int* info) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  size_t smem = (size_t)smem_words(NPS, P.bh, P.bw, P.T, STATIC) * 4;
  auto kern = fhp_step_kernel<Rule, STATIC, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess || !info) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS,
                                                    smem);
  info[0] = blocks;
  info[1] = fa.numRegs;
  info[2] = (int)fa.localSizeBytes;
  info[3] = (int)smem;
  return (int)e;
}

template <class Rule, bool STATIC, int MODE>
static int launch(const Params& P, cudaStream_t stream, int* info) {
  int e = prepare<Rule, STATIC, MODE>(P, info);
  if (e || info) return e;
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  size_t smem = (size_t)smem_words(NPS, P.bh, P.bw, P.T, STATIC) * 4;
  dim3 grid((P.Wd + P.bw - 1) / P.bw, (P.H + P.bh - 1) / P.bh, P.B);
  fhp_step_kernel<Rule, STATIC, MODE>
      <<<grid, dim3(32, NW), smem, stream>>>(P);
  return (int)cudaGetLastError();
}

// A streamed launch: its geometry, its blocks (the card's resident blocks
// of this kernel on every SM unless P.bh > 0), the launch; or, with
// ``info``, what the kernel gets, as prepare's.
template <class Rule, int J>
static int launch_stream(const Params& P, StreamGeom S, cudaStream_t stream,
                         int* info) {
  size_t smem = (size_t)stream_smem_words(Rule::NP, S.W, P.T) * 4;
  auto kern = fhp_step_stream_kernel<Rule, J>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                    32 * S.NWS, smem);
  if (e != cudaSuccess) return (int)e;
  if (info) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    info[0] = blocks;
    info[1] = fa.numRegs;
    info[2] = (int)fa.localSizeBytes;
    info[3] = (int)smem;
    return (int)e;
  }
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  S.G = stream_blocks(P, S, blocks * sms);
  kern<<<S.G, dim3(32, S.NWS), smem, stream>>>(P, S);
  return (int)cudaGetLastError();
}

template <class Rule>
static int launch_stream(const Params& P, cudaStream_t stream, int* info) {
  if (stream_max_owned(P.T, Rule::NP) < 1) return (int)cudaErrorInvalidValue;
  StreamGeom S = stream_geom(P.B, P.H, P.Wd, P.T, Rule::NP, P.bw);
  switch (S.J) {
    case 1:
      return launch_stream<Rule, 1>(P, S, stream, info);
    case 2:
      return launch_stream<Rule, 2>(P, S, stream, info);
  }
  if constexpr (Rule::NP <= 4) {
    if (S.J == 4) return launch_stream<Rule, 4>(P, S, stream, info);
    if (S.J == 8) return launch_stream<Rule, 8>(P, S, stream, info);
  }
  return (int)cudaErrorInvalidValue;
}

// Static solid runs in periodic and extended mode only; PRE_RNG is a
// one-step, 8-plane mode (the reference refuses the same combinations);
// STREAM is a periodic launch without a solid.
// With ``info`` the instantiation is prepared and described, not launched.
template <class Rule>
static int launch_rule(const Params& P, int mode, cudaStream_t stream,
                       int* info) {
  if (mode == STREAM && !P.solid) return launch_stream<Rule>(P, stream, info);
  if (P.solid) {
    if constexpr (Rule::SOLID >= 0) {
      if (mode == PERIODIC)
        return launch<Rule, true, PERIODIC>(P, stream, info);
      if (mode == EXTENDED)
        return launch<Rule, true, EXTENDED>(P, stream, info);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (mode == PERIODIC) return launch<Rule, false, PERIODIC>(P, stream, info);
  if (mode == EXTENDED) return launch<Rule, false, EXTENDED>(P, stream, info);
  if (mode == PRE_RNG && P.T == 1)
    return launch<Rule, false, PRE_RNG>(P, stream, info);
  return (int)cudaErrorInvalidValue;
}

static int dispatch(const Params& P, int rule, int mode, cudaStream_t st,
                    int* info) {
#define FHP_CASE(R) \
  case R::ID:       \
    return launch_rule<R>(P, mode, st, info);
  switch (rule) { FHP_FOR_EACH_RULE(FHP_CASE) }
#undef FHP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace fhp

// Returns a cudaError_t code (0 = launched).  Pointers are device
// pointers; `solid` selects static-solid mode, `chi` / `acc` are the
// precomputed planes of mode 2, `moments` (zeroed by the caller) is
// written only when record_mask != 0, counting array rows [r0, r1) x
// words [c0, c1).  `mode`: 0 periodic, 1 extended (hg, wdg), 2 PRE_RNG,
// 3 periodic by the row-streaming kernel (bh: the rows a block owns, 0 for
// one block a resident slot of the card; bw: the most words a strip owns).
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
  if (mode == fhp::STREAM) P.bw = bw;  // strips have their own widest
  return fhp::dispatch(P, rule, mode, static_cast<cudaStream_t>(stream),
                       nullptr);
}

// The instantiation a launch with these arguments would run, without
// launching it: info[0] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[1] registers a
// thread, info[2] local (spill) bytes a thread, info[3] dynamic shared
// bytes a block.  `solid` only selects static-solid mode (any non-null
// value).  Returns a cudaError_t code.
extern "C" int fhp_step_info(int rule, int mode, int solid, int bh, int bw,
                             int T, int* info) {
  static uint32_t dummy[4];
  fhp::Params P = fhp::make_params(dummy, dummy, solid ? dummy : nullptr,
                                   nullptr, nullptr, nullptr, 1, bh, bw, bh,
                                   bw, T, 0, 0, 0, 2, 1, 0, 0, 0, 0, 0, 0);
  if (mode == fhp::STREAM) P.bw = bw;
  return fhp::dispatch(P, rule, mode, nullptr, info);
}
