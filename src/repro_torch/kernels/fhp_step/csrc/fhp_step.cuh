// Per-thread body of the fused, temporally blocked FHP step.
//
// Replaces the TPU kernel repro/kernels/fhp_step/kernel.py::fhp_kernel
// (the one pl.pallas_call, kernel.py:600) in all its modes: T fused
// stream -> collide -> force steps per launch on a (bh, bw)-word tile with
// a T-row, T-word apron, counter RNG hashed in-kernel, optional
// static-solid operand and fused moments, in periodic or extended-shard
// mode; or one step with the random words read from precomputed planes.
//
// Every function here is __host__ __device__: fhp_step.cu runs them in a
// CUDA kernel (one thread block per tile, __syncthreads() between phases),
// and host_emulate.cpp runs the same functions for every thread of a
// block, one barrier phase at a time, for the CPU tests.
//
// Threads are row-mapped.  A block is NW = 16 warps of 32 lanes.  A warp
// takes the columns c and c + 32 of one tile row (c = 64m + lane), so it
// covers 32 adjacent words twice over; NM = ceil(W / 64) warps share a
// row and the NW / NM warp rows of the block take one row each per round.
// Everything that depends on the column alone -- the RNG column, the
// wrapped or clamped source column, the moment mask -- is computed once
// per thread per tile (``Lane``); the RNG row and row parity come from a
// table of the tile's rows built once per tile, and are warp-uniform.  No
// runtime division or modulo is left in the step, moment or store loops.
//
// Shared memory: ONE buffer of NPS planes x R slots x WP words (R = bh +
// 2T, W = bw + 2T, WP = W rounded up so 16-byte chunks stay aligned; the
// planes PS = R x WP words apart), in static-solid mode the solid tile,
// and the row table (R words).
// Slot r, column c holds array row ty - T + r, word tx - T + c at load
// (wrapped mod (H, Wd) in periodic mode, clamped into the array in
// extended mode, kernel.py:540-556), at word r * WP + SH + c of its
// plane, where SH = (tx - T) & 3 puts every 16-byte-aligned source chunk
// on a 16-byte-aligned destination.
//
// Step s updates tile rows [s+1, R-s-1) x words [s+1, W-s-1) in place,
// round by round down the tile: every thread computes its words' output
// planes into registers (compute phase), the block synchronises, every
// thread writes them back (write phase), the block synchronises.  Row r
// is read from slot r - s and written to slot r - s - 1, so the tile
// moves up one slot per step: a round overwrites only slots that it has
// read and that no later round of the step reads.  After T steps tile
// row T + y, the interior, sits in slot y and is written back.
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
#include <string.h>

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

static const int NW = 16;        // warps per block
static const int THREADS = 32 * NW;

// The majority of (a, ~b, c): one LOP3 (lookup table 0xB2).  Written as
// the instruction, so that the compiler does not merge b's last xor into
// it and split the four inputs over three.
static __host__ __device__ __forceinline__ uint32_t majority_not(uint32_t a,
                                                                 uint32_t b,
                                                                 uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xB2;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return (a & ~b) | (a & c) | (~b & c);
#endif
}

// Bit i of pq as a word of 32 copies (0 or ~0), rounds 0 .. 15, and the
// comparator's round i (see bernoulli_word) with that bit.
struct PqBits {
  uint32_t m[16];
  __host__ __device__ __forceinline__ uint32_t compare(uint32_t lt,
                                                       uint32_t r,
                                                       int i) const {
    return majority_not(lt, r, m[i]);
  }
};

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
  int pq_lo;              // lowest set bit of pq (rounds below it skipped)
  PqBits pq_bits;         // the bits of pq as masks
  int record_mask;        // bit s: record moments after in-launch step s
  int n_rec;              // popcount(record_mask)
  int vec;                // 16-byte copies allowed: Wd % 4 == 0, aligned
  // Tile geometry, the same for every block.
  int R, W, WP, NM, NWR;  // rows, words, row pitch, warps per row, rows
  int PS;                 // words per plane in the tile buffer
};

static __host__ __device__ __forceinline__ int pmod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// a mod n for an a >= 0 that is at most a few n: by subtraction.
static __host__ __device__ __forceinline__ int wrap_down(int a, int n) {
  while (a >= n) a -= n;
  return a;
}

// Row pitch of the tile buffers: W, or W + 3 rounded up to a multiple of
// 4 where the tile origin's alignment (tx - T) & 3 can be nonzero.
static __host__ __device__ __forceinline__ int row_pitch(int bw, int T) {
  int W = bw + 2 * T;
  return (W + (((bw | T) & 3) ? 3 : 0) + 3) & ~3;
}

// The words of a tile row a block takes: a warp covers 64 words of a row
// (two 32-word passes) and the NW warps one row with its apron, so a wider
// tile runs as tiles of that width -- the same result, in more blocks.
static __host__ __device__ __forceinline__ int tile_words(int bw, int T) {
  return bw + 2 * T > 64 * NW ? 64 * NW - 2 * T : bw;
}

// Shared-memory words one block needs: the tile, the solid, the rows.
// (``bw`` as tile_words gives it.)
static __host__ __device__ __forceinline__ long smem_words(
    int nps, int bh, int bw, int T, bool with_solid) {
  long ps = (long)(bh + 2 * T) * row_pitch(bw, T);
  return nps * ps + (with_solid ? ps : 0) + bh + 2 * T;
}

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
  P.bw = tile_words(bw, T);
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
  P.pq_lo = pq > 0 ? __builtin_ctz((unsigned)pq) : 0;
  for (int i = 0; i < 16; ++i)
    P.pq_bits.m[i] = 0u - (uint32_t)((pq >> i) & 1);
  P.record_mask = record_mask;
  P.n_rec = __builtin_popcount((unsigned)record_mask);
  uintptr_t bits = (uintptr_t)in | (uintptr_t)out | (uintptr_t)solid;
  P.vec = (Wd % 4 == 0) && (bits & 15) == 0;
  P.R = bh + 2 * T;
  P.W = P.bw + 2 * T;
  P.WP = row_pitch(P.bw, T);
  P.PS = P.R * P.WP;
  P.NM = (P.W + 63) / 64;  // each warp covers 64 words
  P.NWR = NW / P.NM;
  return P;
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

// core.prng.bernoulli_words_at: per bit, R < pq for the 16-bit R whose
// bit i is round i's hashed word.  The reference compares MSB-first and
// skips the rounds below pq's lowest set bit ``lo``; this compares
// LSB-first, which needs one state word and one logic op a round (for
// pq's bit 1, lt | ~r; for 0, lt & ~r), done by ``k.compare``.  A round
// below lo leaves lt at 0, so those are predicated off, four at a time
// (lo is the same for every thread), and the result is the reference's.
// All 16 rounds are unrolled, so their independent hashes interleave.
template <class K>
static __host__ __device__ __forceinline__ uint32_t bernoulli_word(
    uint32_t row, uint32_t col, uint32_t t, int pq, int lo, const K& k) {
  if (pq <= 0) return 0u;
  if (pq >= 65536) return 0xFFFFFFFFu;
  uint32_t lt = 0u;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < 16; ++i) {
    if ((i | 3) >= lo) {
      uint32_t r = word_u32(row, col, t, 0x22u * 0x100u + (uint32_t)i);
      lt = k.compare(lt, r, i);
    }
  }
  return lt;
}

// ---------------------------------------------------------------------------
// Copy plan.  A row segment of ``n`` words, whose word j lies at source
// word g0 + j, is moved in ``units``: 16-byte chunks at j = q0 + 4i
// (i < nq), which lie in [lo, hi) -- the part that does not wrap or clamp
// -- and start on a source word that is a multiple of 4, and single words
// for the rest.  Chunks are used only when ``vec`` (every row starts on a
// 16-byte boundary).
// ---------------------------------------------------------------------------
struct RowPlan {
  int q0, nq, units;

  __host__ __device__ __forceinline__ bool chunk(int u) const {
    return u < nq;
  }
  // First segment word of unit u.
  __host__ __device__ __forceinline__ int col(int u) const {
    if (u < nq) return q0 + 4 * u;
    int j = u - nq;
    return j < q0 ? j : j + 4 * nq;
  }
};

static __host__ __device__ __forceinline__ RowPlan row_plan(int n, int g0,
                                                            int lo, int hi,
                                                            int vec) {
  RowPlan pl;
  pl.q0 = 0;
  pl.nq = 0;
  if (vec && hi - lo >= 4) {
    int q0 = lo + ((-(g0 + lo)) & 3);
    int nq = (hi - q0) >> 2;
    if (nq > 0) {
      pl.q0 = q0;
      pl.nq = nq;
    }
  }
  pl.units = n - 3 * pl.nq;
  return pl;
}

// The load plan of a tile row: W words from source word tx - T; the
// straight part is where that lies inside [0, Wd).
static __host__ __device__ __forceinline__ RowPlan load_plan(const Params& P,
                                                             int tx) {
  int g0 = tx - P.T;
  int lo = g0 < 0 ? -g0 : 0;
  int hi = P.Wd - g0 < P.W ? P.Wd - g0 : P.W;
  return row_plan(P.W, g0, lo, hi < lo ? lo : hi, P.vec);
}

// The store plan of a tile row: the interior words that lie in the array.
static __host__ __device__ __forceinline__ RowPlan store_plan(const Params& P,
                                                              int tx) {
  int n = P.Wd - tx < P.bw ? P.Wd - tx : P.bw;
  return row_plan(n, tx, 0, n, P.vec);
}

// The array index an apron position reads: wrapped in periodic mode (by
// adding or subtracting n: a lies within a tile's width of [0, n)),
// clamped into [0, n) in extended mode (kernel.py:540-556).
template <int MODE>
static __host__ __device__ __forceinline__ int src_index(int a, int n) {
  if (MODE == EXTENDED) return a < 0 ? 0 : (a >= n ? n - 1 : a);
  while (a < 0) a += n;
  return wrap_down(a, n);
}

// Asynchronous copies global -> shared: cp.async on the card (16 bytes
// through L2 only, 4 bytes through L1), plain copies on the host.
static __host__ __device__ __forceinline__ void copy16(uint32_t* dst,
                                                       const uint32_t* src) {
#ifdef __CUDA_ARCH__
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

static __host__ __device__ __forceinline__ void copy4(uint32_t* dst,
                                                      const uint32_t* src) {
#ifdef __CUDA_ARCH__
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

// One 16-byte store of aligned words.
static __host__ __device__ __forceinline__ void move16(uint32_t* dst,
                                                       const uint32_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// Waits for this thread's copies (the block then synchronises).
static __host__ __device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

struct Tile {
  int b, ty, tx;   // lane, tile origin (lattice row, word)
  int SH;          // (tx - T) & 3: column offset in the buffers
  RowPlan lp;      // load plan of every apron row
};

static __host__ __device__ __forceinline__ Tile make_tile(const Params& P,
                                                          int bx, int by,
                                                          int bz) {
  Tile tl;
  tl.b = bz;
  tl.ty = by * P.bh;
  tl.tx = bx * P.bw;
  tl.SH = (tl.tx - P.T) & 3;
  tl.lp = load_plan(P, tl.tx);
  return tl;
}

// Word (plane p, buffer slot r, column c) of a tile buffer.
static __host__ __device__ __forceinline__ int at(const Params& P,
                                                  const Tile& tl, int p,
                                                  int r, int c) {
  return p * P.PS + r * P.WP + tl.SH + c;
}

// Pointers of one block's shared memory.
struct Smem {
  uint32_t* buf;   // NPS x R x WP: the tile
  uint32_t* sol;   // R x WP: the solid tile (static-solid mode)
  uint32_t* rows;  // R: the RNG row of every tile row
};

static __host__ __device__ __forceinline__ Smem carve(const Params& P,
                                                      int nps, bool solid,
                                                      uint32_t* base) {
  Smem sm;
  sm.buf = base;
  sm.sol = base + nps * P.PS;  // a multiple of 4 words
  sm.rows = sm.sol + (solid ? P.PS : 0);
  return sm;
}

// Load phase, thread (x, w) of the block: warp w takes planes x rows
// w, w + NW, ...; its lanes take the row's copy units.  ``np`` planes of
// ``src`` (an (np, H, Wd) stack) go to ``dst``.
template <int MODE>
static __host__ __device__ __forceinline__ void load_tile(
    const Params& P, const Tile& tl, const uint32_t* src, int np,
    uint32_t* dst, int x, int w) {
  for (int p = 0; p < np; ++p)
    for (int r = w; r < P.R; r += NW) {
      int gy = src_index<MODE>(tl.ty - P.T + r, P.H);
      const uint32_t* row = src + ((long)p * P.H + gy) * P.Wd;
      uint32_t* d = dst + at(P, tl, p, r, 0);
      for (int u = x; u < tl.lp.units; u += 32) {
        int c = tl.lp.col(u);
        if (tl.lp.chunk(u)) {
          copy16(d + c, row + tl.tx - P.T + c);
        } else {
          copy4(d + c, row + src_index<MODE>(tl.tx - P.T + c, P.Wd));
        }
      }
    }
}

// The row table, entry r of [0, R): the RNG row of tile row r --
// y0 + ((ty - T + r) mod H) in periodic mode (kernel.py:460-461),
// (y0 + ty - T + r) mod hg in extended mode (kernel.py:456-459).  Its low
// bit is the row's parity in both (hg is even), and in periodic mode
// minus y0 it is the array row.
template <int MODE>
static __host__ __device__ __forceinline__ uint32_t row_entry(
    const Params& P, const Tile& tl, int r) {
  int ly = tl.ty - P.T + r;
  if (MODE == EXTENDED) return (uint32_t)pmod(P.y0 + ly, P.hg);
  return (uint32_t)P.y0 + (uint32_t)pmod(ly, P.H);
}

// What a thread keeps for the whole tile: its two columns -- c and
// c + 32, 32 adjacent words each for its warp -- and everything that
// depends on the column alone.
struct Lane {
  int c[2];         // buffer columns; >= W owns nothing
  int wrow;         // its warp's row in a round (0 .. NWR - 1)
  bool idle;        // a warp beyond NWR * NM takes no column
  uint32_t rcol[2]; // RNG columns (global words)
  int mx[2];        // PRE_RNG: source columns of the random planes
  bool mom[2];      // inside the interior and the moments' column window
};

template <int MODE>
static __host__ __device__ __forceinline__ Lane make_lane(const Params& P,
                                                          const Tile& tl,
                                                          int x, int w) {
  Lane ln;
  ln.wrow = w / P.NM;
  ln.idle = ln.wrow >= P.NWR;
  for (int j = 0; j < 2; ++j) {
    int c = (w - ln.wrow * P.NM) * 64 + 32 * j + x;
    ln.c[j] = ln.idle || c >= P.W ? 1 << 20 : c;
    int lx = tl.tx - P.T + ln.c[j];  // unwrapped array column
    if (MODE == EXTENDED) {
      ln.rcol[j] = (uint32_t)pmod(P.xw0 + lx, P.wdg);
      ln.mx[j] = 0;
    } else {
      ln.mx[j] = pmod(lx, P.Wd);
      ln.rcol[j] = (uint32_t)P.xw0 + (uint32_t)ln.mx[j];
    }
    ln.mom[j] = ln.c[j] >= P.T && ln.c[j] < P.T + P.bw && lx >= P.c0 &&
                lx < P.c1;
  }
  return ln;
}

// The streamed word at a destination from its source word ``v`` and the
// source's neighbour ``nb`` on the side it shifts in from (dx = 1: the
// word to the left, dx = -1: to the right).  The card and the host both
// read nb from the tile buffer.
static __host__ __device__ __forceinline__ uint32_t stream_word(uint32_t v,
                                                                uint32_t nb,
                                                                int dx) {
  if (dx == 1) return (v << 1) | (nb >> 31);
  if (dx == -1) return (v >> 1) | (nb << 31);
  return v;
}

// Streaming read of one tap: destination-centric, the value is the plane
// at (r - dy, c - dx), with dx chosen by the parity of the *source* row.
// ``ctr`` points at the destination's own word of plane 0; planes are
// ``ps`` words apart, rows ``rs``.
template <bool STATIC, int SOLID>
struct Reader {
  const uint32_t* ctr;
  const uint32_t* sol;  // the solid word at the destination
  int ps, rs;
  int odd[3];           // odd[dy + 1]: parity of source row r - dy

  __host__ __device__ __forceinline__ uint32_t tap(int plane, int dx0,
                                                   int dx1, int dy) const {
    if (STATIC && plane == SOLID) return *sol;  // read-only operand
    const uint32_t* src = ctr + plane * ps - dy * rs;
    int dx = odd[dy + 1] ? dx1 : dx0;
    return stream_word(src[0], dx ? src[-dx] : 0u, dx);
  }
};

// The work of one word-step, from the taps to the forced output planes:
// streaming reads, chirality hash, collision circuit, Bernoulli rounds and
// force.  op_count.cu compiles this same function to count it.
template <class Rule, class Rd, class K>
static __host__ __device__ __forceinline__ void word_step(
    const Rd& rd, uint32_t row, uint32_t col, uint32_t t, int pq, int pq_lo,
    const K& k, uint32_t* o) {
  uint32_t v[Rule::NTAPS];
  Rule::taps(rd, v);
  uint32_t chi = Rule::NEEDS_RNG ? word_u32(row, col, t, 0x11u) : 0u;
  Rule::collide(v, chi, t, o);
  if (Rule::HAS_FORCE && pq > 0)
    Rule::force(o, bernoulli_word(row, col, t, pq, pq_lo, k));
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

// One step: its rows and columns, its counter, and the buffer slot that
// holds tile row r before it (r - s; the step writes row r to slot
// r - s - 1, so the tile moves up one slot a step and a round never
// overwrites a row that a later round of the step reads).
struct StepGeom {
  int s, r_lo, r_hi, c_lo, c_hi;
  uint32_t t;
};

static __host__ __device__ __forceinline__ StepGeom step_geom(
    const Params& P, int s) {
  StepGeom g;
  g.s = s;
  g.r_lo = s + 1;
  g.r_hi = P.R - s - 1;
  g.c_lo = s + 1;
  g.c_hi = P.W - s - 1;
  g.t = P.t0 + (uint32_t)s;
  return g;
}

static __host__ __device__ __forceinline__ bool active(const StepGeom& g,
                                                       int c) {
  return c >= g.c_lo && c < g.c_hi;
}

// Compute phase of row r: the output planes of the thread's two words,
// into o[0] and o[1] (left untouched for a column the step skips).
template <class Rule, bool STATIC, int MODE>
static __host__ __device__ __forceinline__ void compute_row(
    const Params& P, const Tile& tl, const Lane& ln, const StepGeom& g,
    const Smem& sm, int r, uint32_t (*o)[Rule::NP]) {
  Reader<STATIC, Rule::SOLID> rd;
  rd.ps = P.PS;
  rd.rs = P.WP;
  uint32_t rrow = sm.rows[r];
  for (int k = 0; k < 3; ++k) rd.odd[k] = (int)(sm.rows[r - (k - 1)] & 1u);
  const uint32_t* ctr = sm.buf + at(P, tl, 0, r - g.s, 0);
  const uint32_t* sol = sm.sol + r * P.WP + tl.SH;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int j = 0; j < 2; ++j) {
    if (!active(g, ln.c[j])) continue;
    rd.ctr = ctr + ln.c[j];
    rd.sol = sol + ln.c[j];
    if (MODE == PRE_RNG) {
      long ai = (long)(rrow - (uint32_t)P.y0) * P.Wd + ln.mx[j];
      word_step_pre<Rule>(rd, P.chi ? P.chi[ai] : 0u,
                          P.acc ? P.acc[ai] : 0u, P.acc != nullptr, g.t,
                          o[j]);
    } else {
      word_step<Rule>(rd, rrow, ln.rcol[j], g.t, P.pq, P.pq_lo, P.pq_bits,
                      o[j]);
    }
  }
}

// Write phase of row r: the new words of the thread's active columns go
// to slot r - s - 1.
template <class Rule, bool STATIC>
static __host__ __device__ __forceinline__ void write_row(
    const Params& P, const Tile& tl, const Lane& ln, const StepGeom& g,
    const Smem& sm, int r, const uint32_t (*o)[Rule::NP]) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  uint32_t* dst = sm.buf + at(P, tl, 0, r - g.s - 1, 0);
  for (int j = 0; j < 2; ++j) {
    if (!active(g, ln.c[j])) continue;
    for (int p = 0; p < NPS; ++p) dst[p * P.PS + ln.c[j]] = o[j][p];
  }
}

// Moment phase: adds the term popcounts of the thread's interior words of
// tile row r, in slot r - s - 1 after step s, into cnt[] when row and
// column lie inside the window [r0, r1) x [c0, c1), which the caller
// keeps inside the array (ragged edge tiles, extended mode's validity
// window: kernel.py:428-434).
template <class Rule, bool STATIC>
static __host__ __device__ __forceinline__ void moment_row(
    const Params& P, const Tile& tl, const Lane& ln, const Smem& sm, int s,
    int r, int* cnt) {
  const int NPS = STATIC ? Rule::NP - 1 : Rule::NP;
  int gy = tl.ty - P.T + r;
  if (gy < P.r0 || gy >= P.r1) return;
  const uint32_t* row = sm.buf + at(P, tl, 0, r - s - 1, 0);
  for (int j = 0; j < 2; ++j) {
    if (!ln.mom[j]) continue;
    uint32_t p[Rule::NP];
    for (int k = 0; k < NPS; ++k) p[k] = row[k * P.PS + ln.c[j]];
    if constexpr (STATIC)
      Rule::terms_static(p, cnt);
    else
      Rule::terms(p, cnt);
  }
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

// Store phase, thread (x, w): warp w takes planes x interior rows w,
// w + NW, ... that lie in the array; its lanes take the row's units of
// the store plan (16-byte stores where aligned, single words elsewhere).
// After T steps tile row T + y sits in slot y.
static __host__ __device__ __forceinline__ void store_tile(
    const Params& P, const Tile& tl, int nps, const uint32_t* buf, int x,
    int w) {
  RowPlan sp = store_plan(P, tl.tx);
  for (int p = 0; p < nps; ++p)
    for (int y = w; y < P.bh && tl.ty + y < P.H; y += NW) {
      uint32_t* dst =
          P.out + (((long)tl.b * nps + p) * P.H + tl.ty + y) * P.Wd + tl.tx;
      const uint32_t* src = buf + at(P, tl, p, y, P.T);
      for (int u = x; u < sp.units; u += 32) {
        int c = sp.col(u);
        if (sp.chunk(u)) {
          move16(dst + c, src + c);
        } else {
          dst[c] = src[c];
        }
      }
    }
}

}  // namespace fhp
