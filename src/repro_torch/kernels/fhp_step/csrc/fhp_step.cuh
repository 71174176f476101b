// Per-element body of the fused, temporally blocked FHP step.
//
// Replaces the TPU kernel repro/kernels/fhp_step/kernel.py::fhp_kernel
// (the one pl.pallas_call, kernel.py:600) in all its modes: T fused
// stream -> collide -> force steps per launch on a (bh, bw)-word tile with
// a T-row, T-word apron, counter RNG hashed in-kernel, optional
// static-solid operand and fused moments, in periodic or extended-shard
// mode; or one step with the random words read from precomputed planes.
//
// Every function here is __host__ __device__: fhp_step.cu runs them in a
// CUDA kernel (one thread block per tile, threads striding over words,
// __syncthreads() between phases), and host_emulate.cpp runs the same
// functions serially, one barrier phase at a time, for CPU tests.
//
// Tile layout in shared memory: two ping-pong buffers of NPS planes x R
// rows x W words (R = bh + 2T, W = bw + 2T), plus the solid plane in
// static-solid mode.  Buffer row r, word c holds array row tile_y - T + r,
// word tile_x - T + c: wrapped mod (H, Wd) in periodic mode, clamped into
// the array in extended mode (apron rows past the edge of a halo-extended
// shard hold garbage that the caller's validity window drops).  Step s
// reads rows [s, R-s) x words [s, W-s) and writes rows [s+1, R-s-1) x
// words [s+1, W-s-1); after T steps the tile's own (bh, bw) interior is
// exact and is written back.
//
// Modes (the MODE template argument):
//   PERIODIC   K1/K3/K4/K6: the lattice wraps; RNG and parity rows are
//              y0 + (local mod H), words xw0 + (local mod Wd)
//              (kernel.py:460-461).
//   EXTENDED   K5 and K6's extended half: a halo-extended shard; RNG rows
//              are (y0 + local) mod hg, words (xw0 + local) mod wdg, in
//              signed arithmetic (y0 and xw0 are negative on shard 0), so
//              apron cells across the global wrap draw the owning shard's
//              stream (kernel.py:456-459).
//   PRE_RNG    K2: T = 1; the chirality and force words are read from two
//              (H, Wd) planes instead of hashed (kernel.py:468-476).
#pragma once
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

static __host__ __device__ __forceinline__ uint32_t popc32(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __popc(v);
#else
  return (uint32_t)__builtin_popcount(v);
#endif
}

#include "rules_gen.cuh"

namespace fhp {

enum Mode { PERIODIC = 0, EXTENDED = 1, PRE_RNG = 2 };

struct Params {
  const uint32_t* in;     // (B, NPS, H, Wd)
  uint32_t* out;          // (B, NPS, H, Wd)
  const uint32_t* solid;  // (H, Wd) or null (static-solid mode when set)
  const uint32_t* chi;    // PRE_RNG: (H, Wd) chirality words, or null
  const uint32_t* acc;    // PRE_RNG: (H, Wd) force words, or null (no force)
  int32_t* moments;       // (B, n_rec, n_moments) or null; zeroed by caller
  int B, H, Wd, bh, bw, T;
  uint32_t t0;            // step counter of the launch's first step
  int32_t y0, xw0;        // global coords of word (0, 0); negative allowed
  int hg, wdg;            // EXTENDED: global extents (hg even)
  int r0, r1, c0, c1;     // moments count array rows [r0, r1) x words [c0, c1)
  int pq;                 // quantised force probability (0 = no force)
  int record_mask;        // bit s: record moments after in-launch step s
  int n_rec;              // popcount(record_mask)
};

// Params from the C launch interface's arguments (fhp_step_launch in
// fhp_step.cu, fhp_step_host in host_emulate.cpp).
static inline Params make_params(const void* in, void* out, const void* solid,
                                 const void* chi, const void* acc,
                                 void* moments, int B, int H, int Wd, int bh,
                                 int bw, int T, unsigned t0, int y0, int xw0,
                                 int hg, int wdg, int r0, int r1, int c0,
                                 int c1, int pq, int record_mask) {
  Params P;
  P.in = static_cast<const uint32_t*>(in);
  P.out = static_cast<uint32_t*>(out);
  P.solid = static_cast<const uint32_t*>(solid);
  P.chi = static_cast<const uint32_t*>(chi);
  P.acc = static_cast<const uint32_t*>(acc);
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
  P.hg = hg;
  P.wdg = wdg;
  P.r0 = r0;
  P.r1 = r1;
  P.c0 = c0;
  P.c1 = c1;
  P.pq = pq;
  P.record_mask = record_mask;
  P.n_rec = __builtin_popcount((unsigned)record_mask);
  return P;
}

static __host__ __device__ __forceinline__ int pmod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// murmur3 finalizer; bit-identical to core.prng.hash_u32.
static __host__ __device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// core.prng.word_u32_at for one (row, word) counter.
static __host__ __device__ __forceinline__ uint32_t word_u32(
    uint32_t row, uint32_t col, uint32_t t, uint32_t salt) {
  return hash_u32((row * 0x01000193u + col) ^
                  (t * 0x9E3779B9u + salt * 0xC2B2AE35u));
}

// core.prng.bernoulli_words_at: MSB-first comparator against the binary
// expansion of pq, skipping the rounds below its lowest set bit.
static __host__ __device__ __forceinline__ uint32_t bernoulli_word(
    uint32_t row, uint32_t col, uint32_t t, int pq) {
  if (pq <= 0) return 0u;
  if (pq >= 65536) return 0xFFFFFFFFu;
  uint32_t res = 0u, eq = 0xFFFFFFFFu;
  for (int i = 15; i >= 0; --i) {
    uint32_t r = word_u32(row, col, t, 0x22u * 0x100u + (uint32_t)i);
    if ((pq >> i) & 1) {
      res |= eq & ~r;
      eq &= r;
    } else {
      eq &= ~r;
    }
    if ((pq & ((1 << i) - 1)) == 0) break;  // no set bit below i
  }
  return res;
}

struct Tile {
  int b, ty, tx;   // lane, tile origin (lattice row, word)
  int R, W, RW;    // extended extent and plane stride in the buffers
};

static __host__ __device__ __forceinline__ Tile make_tile(
    const Params& P, int bx, int by, int bz) {
  Tile tl;
  tl.b = bz;
  tl.ty = by * P.bh;
  tl.tx = bx * P.bw;
  tl.R = P.bh + 2 * P.T;
  tl.W = P.bw + 2 * P.T;
  tl.RW = tl.R * tl.W;
  return tl;
}

// Shared-memory words one block needs.
static __host__ __device__ __forceinline__ long smem_words(
    int nps, int bh, int bw, int T, bool with_solid) {
  long rw = (long)(bh + 2 * T) * (bw + 2 * T);
  return 2 * nps * rw + (with_solid ? rw : 0);
}

// The array index an apron position reads: wrapped in periodic mode,
// clamped into [0, n) in extended mode (kernel.py:540-556).
template <int MODE>
static __host__ __device__ __forceinline__ int src_index(int a, int n) {
  if (MODE == EXTENDED) return a < 0 ? 0 : (a >= n ? n - 1 : a);
  return pmod(a, n);
}

// Load phase, element i of [0, NPS * RW): one word of one plane.
template <int NPS, int MODE>
static __host__ __device__ __forceinline__ void load_elem(
    const Params& P, const Tile& tl, uint32_t* buf, int i) {
  int p = i / tl.RW, rem = i - p * tl.RW;
  int r = rem / tl.W, c = rem - r * tl.W;
  int gy = src_index<MODE>(tl.ty - P.T + r, P.H);
  int gx = src_index<MODE>(tl.tx - P.T + c, P.Wd);
  buf[i] = P.in[(((long)tl.b * NPS + p) * P.H + gy) * P.Wd + gx];
}

// Load phase for the solid operand, element i of [0, RW).
template <int MODE>
static __host__ __device__ __forceinline__ void load_solid_elem(
    const Params& P, const Tile& tl, uint32_t* sol, int i) {
  int r = i / tl.W, c = i - r * tl.W;
  int gy = src_index<MODE>(tl.ty - P.T + r, P.H);
  int gx = src_index<MODE>(tl.tx - P.T + c, P.Wd);
  sol[i] = P.solid[(long)gy * P.Wd + gx];
}

// Streaming read of one tap at buffer position (r, c): destination-centric,
// the value at (r, c) is the plane at (r - dy, c - dx), with dx chosen by
// the parity of the *source* row.
template <bool STATIC, int SOLID>
struct Reader {
  const uint32_t* cur;
  const uint32_t* sol;
  int RW, W, r, c;
  int odd[3];  // odd[dy + 1]: parity of source row r - dy

  __host__ __device__ __forceinline__ uint32_t tap(int plane, int dx0,
                                                   int dx1, int dy) const {
    if (STATIC && plane == SOLID) return sol[r * W + c];  // read-only operand
    const uint32_t* row = cur + plane * RW + (r - dy) * W;
    int dx = odd[dy + 1] ? dx1 : dx0;
    uint32_t v = row[c];
    if (dx == 1) return (v << 1) | (row[c - 1] >> 31);
    if (dx == -1) return (v >> 1) | (row[c + 1] << 31);
    return v;
  }
};

// The work of one word-step, from the taps to the forced output planes:
// streaming reads, chirality hash, collision circuit, Bernoulli rounds and
// force.  op_count.cu compiles this same function to count it.
template <class Rule, class Rd>
static __host__ __device__ __forceinline__ void word_step(
    const Rd& rd, uint32_t row, uint32_t col, uint32_t t, int pq,
    uint32_t* o) {
  uint32_t v[Rule::NTAPS];
  Rule::taps(rd, v);
  uint32_t chi = Rule::NEEDS_RNG ? word_u32(row, col, t, 0x11u) : 0u;
  Rule::collide(v, chi, t, o);
  if (Rule::HAS_FORCE && pq > 0)
    Rule::force(o, bernoulli_word(row, col, t, pq));
}

// word_step with its random words given (PRE_RNG mode, kernel mode K2):
// ``force`` says whether a force plane was passed.
template <class Rule, class Rd>
static __host__ __device__ __forceinline__ void word_step_pre(
    const Rd& rd, uint32_t chi, uint32_t acc, bool force, uint32_t t,
    uint32_t* o) {
  uint32_t v[Rule::NTAPS];
  Rule::taps(rd, v);
  Rule::collide(v, chi, t, o);
  if (Rule::HAS_FORCE && force) Rule::force(o, acc);
}

// Step phase s, element i of [0, (R-2s-2) * (W-2s-2)): one output word.
template <class Rule, bool STATIC, int MODE>
static __host__ __device__ __forceinline__ void step_elem(
    const Params& P, const Tile& tl, int s, int i, const uint32_t* cur,
    uint32_t* nxt, const uint32_t* sol) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  int ow = tl.W - 2 * s - 2;
  int r = s + 1 + i / ow, c = s + 1 + i % ow;
  int ly = tl.ty - P.T + r, lx = tl.tx - P.T + c;  // unwrapped array coords
  uint32_t t = P.t0 + (uint32_t)s;

  Reader<STATIC, Rule::SOLID> rd;
  rd.cur = cur;
  rd.sol = sol;
  rd.RW = tl.RW;
  rd.W = tl.W;
  rd.r = r;
  rd.c = c;

  uint32_t o[Rule::NP];
  if (MODE == EXTENDED) {
    // Global coordinates mod the global extents, in signed arithmetic;
    // hg is even, so the unreduced row has the reduced row's parity.
    int gy = P.y0 + ly;
    for (int k = 0; k < 3; ++k) rd.odd[k] = (gy - (k - 1)) & 1;
    word_step<Rule>(rd, (uint32_t)pmod(gy, P.hg),
                    (uint32_t)pmod(P.xw0 + lx, P.wdg), t, P.pq, o);
  } else {
    // Periodic: y0 is added after the local modulo (kernel.py:460-461).
    int my = pmod(ly, P.H), mx = pmod(lx, P.Wd);
    for (int k = 0; k < 3; ++k)
      rd.odd[k] =
          (int)(((uint32_t)P.y0 + (uint32_t)pmod(ly - (k - 1), P.H)) & 1u);
    if (MODE == PRE_RNG) {
      long at = (long)my * P.Wd + mx;
      word_step_pre<Rule>(rd, P.chi ? P.chi[at] : 0u,
                          P.acc ? P.acc[at] : 0u, P.acc != nullptr, t, o);
    } else {
      word_step<Rule>(rd, (uint32_t)P.y0 + (uint32_t)my,
                      (uint32_t)P.xw0 + (uint32_t)mx, t, P.pq, o);
    }
  }
  for (int p = 0; p < NPS; ++p) nxt[p * tl.RW + r * tl.W + c] = o[p];
}

// Moment phase, element i of [0, bh * bw): adds the word's term popcounts
// into c[] when the word lies inside the window [r0, r1) x [c0, c1), which
// the caller keeps inside the array (ragged edge tiles, extended mode's
// validity window: kernel.py:428-434).
template <class Rule, bool STATIC>
static __host__ __device__ __forceinline__ void moment_elem(
    const Params& P, const Tile& tl, int i, const uint32_t* buf, int* cnt) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  int y = i / P.bw, x = i - y * P.bw;
  int gy = tl.ty + y, gx = tl.tx + x;
  if (gy < P.r0 || gy >= P.r1 || gx < P.c0 || gx >= P.c1) return;
  uint32_t p[Rule::NP];
  for (int k = 0; k < NPS; ++k)
    p[k] = buf[k * tl.RW + (y + P.T) * tl.W + x + P.T];
  if constexpr (STATIC)
    Rule::terms_static(p, cnt);
  else
    Rule::terms(p, cnt);
}

template <class Rule, bool STATIC>
struct Moments {
  static const int N_TERMS = Rule::N_TERMS;
  static const int N_MOMENTS = Rule::N_MOMENTS;
  static __host__ __device__ __forceinline__ void combine(const int* c,
                                                          int* m) {
    Rule::combine(c, m);
  }
};

template <class Rule>
struct Moments<Rule, true> {
  static const int N_TERMS = Rule::N_TERMS_STATIC;
  static const int N_MOMENTS = Rule::N_MOMENTS_STATIC;
  static __host__ __device__ __forceinline__ void combine(const int* c,
                                                          int* m) {
    Rule::combine_static(c, m);
  }
};

// Store phase, element i of [0, NPS * bh * bw).
template <int NPS>
static __host__ __device__ __forceinline__ void store_elem(
    const Params& P, const Tile& tl, const uint32_t* buf, int i) {
  int n = P.bh * P.bw;
  int p = i / n, rem = i - p * n;
  int y = rem / P.bw, x = rem - y * P.bw;
  int gy = tl.ty + y, gx = tl.tx + x;
  if (gy >= P.H || gx >= P.Wd) return;
  P.out[(((long)tl.b * NPS + p) * P.H + gy) * P.Wd + gx] =
      buf[p * tl.RW + (y + P.T) * tl.W + x + P.T];
}

}  // namespace fhp
