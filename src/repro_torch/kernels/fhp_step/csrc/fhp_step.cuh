// Per-element body of the fused, temporally blocked FHP step.
//
// Replaces the TPU kernel repro/kernels/fhp_step/kernel.py::fhp_kernel
// (the one pl.pallas_call, kernel.py:600) in periodic mode: T fused
// stream -> collide -> force steps per launch on a (bh, bw)-word tile with
// a T-row, T-word apron, counter RNG hashed in-kernel, optional
// static-solid operand and fused moments.
//
// Every function here is __host__ __device__: fhp_step.cu runs them in a
// CUDA kernel (one thread block per tile, threads striding over words,
// __syncthreads() between phases), and host_emulate.cpp runs the same
// functions serially, one barrier phase at a time, for CPU tests.
//
// Tile layout in shared memory: two ping-pong buffers of NPS planes x R
// rows x W words (R = bh + 2T, W = bw + 2T), plus the solid plane in
// static-solid mode.  Buffer row r, word c holds lattice row
// pmod(tile_y - T + r, H), word pmod(tile_x - T + c, Wd): the apron wraps
// (periodic mode).  Step s reads rows [s, R-s) x words [s, W-s) and writes
// rows [s+1, R-s-1) x words [s+1, W-s-1); after T steps the tile's own
// (bh, bw) interior is exact and is written back.
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

struct Params {
  const uint32_t* in;     // (B, NPS, H, Wd)
  uint32_t* out;          // (B, NPS, H, Wd)
  const uint32_t* solid;  // (H, Wd) or null (static-solid mode when set)
  int32_t* moments;       // (B, n_rec, n_moments) or null; zeroed by caller
  int B, H, Wd, bh, bw, T;
  uint32_t t0, y0, xw0;   // step counter, global coords of word (0, 0)
  int pq;                 // quantised force probability (0 = no force)
  int record_mask;        // bit s: record moments after in-launch step s
  int n_rec;              // popcount(record_mask)
};

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

// Load phase, element i of [0, NPS * RW): one word of one plane.
template <int NPS>
static __host__ __device__ __forceinline__ void load_elem(
    const Params& P, const Tile& tl, uint32_t* buf, int i) {
  int p = i / tl.RW, rem = i - p * tl.RW;
  int r = rem / tl.W, c = rem - r * tl.W;
  int gy = pmod(tl.ty - P.T + r, P.H), gx = pmod(tl.tx - P.T + c, P.Wd);
  buf[i] = P.in[(((long)tl.b * NPS + p) * P.H + gy) * P.Wd + gx];
}

// Load phase for the solid operand, element i of [0, RW).
static __host__ __device__ __forceinline__ void load_solid_elem(
    const Params& P, const Tile& tl, uint32_t* sol, int i) {
  int r = i / tl.W, c = i - r * tl.W;
  int gy = pmod(tl.ty - P.T + r, P.H), gx = pmod(tl.tx - P.T + c, P.Wd);
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

// Step phase s, element i of [0, (R-2s-2) * (W-2s-2)): one output word.
template <class Rule, bool STATIC>
static __host__ __device__ __forceinline__ void step_elem(
    const Params& P, const Tile& tl, int s, int i, const uint32_t* cur,
    uint32_t* nxt, const uint32_t* sol) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  int ow = tl.W - 2 * s - 2;
  int r = s + 1 + i / ow, c = s + 1 + i % ow;
  int ly = tl.ty - P.T + r, lx = tl.tx - P.T + c;  // unwrapped lattice coords
  // Periodic mode: y0 is added after the local modulo (kernel.py:460-461).
  uint32_t row = P.y0 + (uint32_t)pmod(ly, P.H);
  uint32_t col = P.xw0 + (uint32_t)pmod(lx, P.Wd);
  uint32_t t = P.t0 + (uint32_t)s;

  Reader<STATIC, Rule::SOLID> rd;
  rd.cur = cur;
  rd.sol = sol;
  rd.RW = tl.RW;
  rd.W = tl.W;
  rd.r = r;
  rd.c = c;
  for (int k = 0; k < 3; ++k)
    rd.odd[k] = (int)((P.y0 + (uint32_t)pmod(ly - (k - 1), P.H)) & 1u);

  uint32_t o[Rule::NP];
  word_step<Rule>(rd, row, col, t, P.pq, o);
  for (int p = 0; p < NPS; ++p) nxt[p * tl.RW + r * tl.W + c] = o[p];
}

// Moment phase, element i of [0, bh * bw): adds the word's term popcounts
// into c[] when the word lies inside the lattice (ragged edge tiles).
template <class Rule, bool STATIC>
static __host__ __device__ __forceinline__ void moment_elem(
    const Params& P, const Tile& tl, int i, const uint32_t* buf, int* cnt) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  int y = i / P.bw, x = i - y * P.bw;
  if (tl.ty + y >= P.H || tl.tx + x >= P.Wd) return;
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
