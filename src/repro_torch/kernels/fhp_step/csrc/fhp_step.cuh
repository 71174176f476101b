// Per-thread body of the fused, temporally blocked FHP step.
//
// Replaces the TPU kernel repro/kernels/fhp_step/kernel.py::fhp_kernel
// (the one pl.pallas_call, kernel.py:600) in all its modes: T fused
// stream -> collide -> force steps per launch on a (bh, bw)-word tile with
// a T-row, T-word apron, counter RNG hashed in-kernel, optional
// static-solid operand and fused moments, in periodic or extended-shard
// mode; or one step with the random words read from precomputed planes.
//
// Every function here is __host__ __device__: fhp_step.cu runs them in two
// CUDA kernels -- the tile kernel (one thread block per tile,
// __syncthreads() between phases) and, for periodic launches without a
// solid operand, the row-streaming kernel (section "Row-streaming
// wavefront" below) -- and host_emulate.cpp runs the same functions for
// every thread of a block, one barrier phase at a time, for the CPU tests.
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
//   STREAM     a periodic launch without a solid operand, run by the
//              row-streaming kernel instead of tiles (the section "Row-
//              streaming wavefront" below); the same result as PERIODIC.
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

enum Mode { PERIODIC = 0, EXTENDED = 1, PRE_RNG = 2, STREAM = 3 };

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

// ---------------------------------------------------------------------------
// Row-streaming wavefront: fhp_step_stream_kernel (fhp_step.cu), the
// launches in periodic mode without a solid operand.
//
// A lane's row of Wd words is cut into NS strips, spread evenly (strip k
// owns words [k Wd / NS, (k + 1) Wd / NS)); a strip row with its T-word
// apron on each side is Ws = owned + 2T words, at most W.  The strip rows
// of all lanes, B x NS x H of them in (lane, strip, row) order, are shared
// out in G contiguous shares, one a block; a share runs as segments, one
// for each (lane, strip) it touches, and a segment of rows [ra, ra + n)
// walks down n + 2T input rows (its T-row apron above and below, wrapped
// mod H) in n + 3T waves, ONE barrier each.
//
// Step level L (0 = the input, s = 1 .. T after step s - 1) holds segment
// row q (lattice row ra - T + q) in a ring in shared memory: slot q mod
// RING0 for level 0, q mod RING for levels 1 .. T - 1; level T has none.
// In wave i level s computes row q = i - 2s from level s - 1's rows q - 1,
// q, q + 1, which it wrote in waves i - 3 .. i - 1 (level 0: loaded by
// cp.async from wave q - AHEAD on, waited for at the end of wave q).  The
// slot a level writes in a wave is none that the next level reads in it
// (q mod 4 against q - 3 .. q - 1), nor one whose row it still needs, so
// the wave's barrier is the only one.  Level s computes strip columns [s,
// Ws - s); level T writes its row, the owned columns, from registers to
// device memory.
//
// A ring row is column-chunked: strip column c sits at j = SH + c (SH =
// (x0 - T) & 3, so a 16-byte source chunk lands on a 16-byte boundary),
// word (j, plane p) at (j / 32) x 32 NP + 32 p + j mod 32.  A thread's
// words of every plane, and those of its next chunks, are then constant
// offsets from one address, so the taps, the ring stores and the J words
// of a thread take no address arithmetic of their own.
//
// Threads: warp w takes level s = w / WPL + 1 and the J 32-word chunks
// J (w mod WPL) .. of its row, one word a lane in each, so the row's RNG
// row, parity and counter are warp-uniform and word_step is the tile
// kernel's.  Where the three rows alternate in parity (everywhere but at
// the wrap of an odd H) the taps' shifts are compile-time.  Moments after
// recorded step s - 1 are counted by level s's threads over owned rows and
// columns inside [r0, r1) x [c0, c1), in registers through a segment, then
// summed per warp and added with integer atomics.
// ---------------------------------------------------------------------------
static const int STREAM_WARPS = 24;   // most warps a block
static const int STREAM_AHEAD = 4;    // input rows loaded ahead of use
static const int RING = 4;            // slots of the rings of levels 1 .. T-1
static const int RING0 = RING + STREAM_AHEAD;  // slots of level 0's ring
static_assert((RING0 & (RING0 - 1)) == 0 && (RING & (RING - 1)) == 0,
              "ring slots are taken by masking");
// Dynamic shared memory a block may take: the card's 227 KB less 1 KB
// for the static moment counters.
static const long STREAM_SMEM_BYTES = 232448 - 1024;

// 32-word chunks of a ring row of strip rows of at most W words (the
// first word sits up to 3 words in).
static __host__ __device__ __forceinline__ int stream_chunks(int W) {
  return (W + 3 + 31) / 32;
}

static __host__ __device__ __forceinline__ int stream_ring_rows(int T) {
  return RING0 + RING * (T - 1);
}

static __host__ __device__ __forceinline__ long stream_smem_words(int nps,
                                                                  int W,
                                                                  int T) {
  return (long)stream_ring_rows(T) * stream_chunks(W) * 32 * nps;
}

// The most 32-word chunks a warp takes: 16 / nps (8 for 2 planes, 2 for
// 8), as many as the shared memory lets an nps-plane strip need.
static __host__ __device__ __forceinline__ int stream_max_j(int nps) {
  int j = 1;
  while (j < 8 && 2 * j * nps <= 16) j *= 2;
  return j;
}

// The least chunks a warp J (1, 2, 4 or 8, at most stream_max_j) under
// which T levels of rows of W words take at most STREAM_WARPS warps; 0 if
// none.
static __host__ __device__ __forceinline__ int stream_chunks_per_warp(
    int W, int T, int nps) {
  int nc = stream_chunks(W);
  for (int j = 1; j <= stream_max_j(nps); j *= 2)
    if (T * ((nc + j - 1) / j) <= STREAM_WARPS) return j;
  return 0;
}

// The most words a strip owns at T with nps planes: its row with the
// apron within the warps and the shared memory; < 1 when none fits.
static __host__ __device__ __forceinline__ int stream_max_owned(int T,
                                                                int nps) {
  long by_smem = STREAM_SMEM_BYTES / (128L * stream_ring_rows(T) * nps);
  long by_warps = (long)stream_max_j(nps) * (STREAM_WARPS / T);
  long nc = by_smem < by_warps ? by_smem : by_warps;
  return (int)(32 * nc - 3) - 2 * T;
}

// The streamed geometry of a launch of T steps on rows of Wd words with
// strips of at most ``bw`` owned words (capped to stream_max_owned); the
// blocks G are set by the caller.
struct StreamGeom {
  int NS;          // strips across a row
  int W;           // widest strip row with its apron, words
  int SLOT;        // words of a ring slot: stream_chunks(W) x 32 x NP
  int J;           // 32-word chunks a warp takes in its level's row
  int WPL;         // warps a level
  int NWS;         // warps a block: T x WPL
  long long rows;  // B x NS x H strip rows
  int G;           // blocks
};

static __host__ __device__ __forceinline__ StreamGeom stream_geom(
    int B, int H, int Wd, int T, int nps, int bw) {
  StreamGeom S;
  int most = stream_max_owned(T, nps);
  if (bw > most) bw = most;
  if (bw < 1) bw = 1;
  S.NS = (Wd + bw - 1) / bw;
  S.W = (Wd + S.NS - 1) / S.NS + 2 * T;
  S.SLOT = stream_chunks(S.W) * 32 * nps;
  S.J = stream_chunks_per_warp(S.W, T, nps);
  S.WPL = (stream_chunks(S.W) + S.J - 1) / S.J;
  S.NWS = T * S.WPL;
  S.rows = (long long)B * S.NS * H;
  S.G = 1;
  return S;
}

// Blocks of a streamed launch: one a share of ``bh`` rows of every (lane,
// strip) when bh > 0, else ``persistent`` (the blocks the card holds at
// once), never more than the strip rows.
static __host__ __device__ __forceinline__ int stream_blocks(
    const Params& P, const StreamGeom& S, int persistent) {
  long long g = P.bh > 0 ? (long long)P.B * S.NS * ((P.H + P.bh - 1) / P.bh)
                         : persistent;
  if (g > S.rows) g = S.rows;
  return g < 1 ? 1 : (int)g;
}

// First strip row of block ``blk``'s share (blk = G: the end).
static __host__ __device__ __forceinline__ long long share_begin(
    const StreamGeom& S, int blk) {
  return S.rows * blk / S.G;
}

// One segment: the rows of a share inside one (lane, strip).
struct Segment {
  int b, ra, n;        // lane, first row, rows
  int x0, width, Ws;   // strip's first word, owned words, owned + 2T
  int SH;              // (x0 - T) & 3: ring column of strip column 0
  RowPlan lp;          // load plan of an input row (Ws words from x0 - T)
};

static __host__ __device__ __forceinline__ Segment make_segment(
    const Params& P, const StreamGeom& S, long long g, long long g1) {
  Segment sg;
  long long sr = g / P.H;  // (lane, strip) index
  sg.b = (int)(sr / S.NS);
  int k = (int)(sr - (long long)sg.b * S.NS);
  sg.ra = (int)(g - sr * P.H);
  long long end = (sr + 1) * P.H < g1 ? (sr + 1) * P.H : g1;
  sg.n = (int)(end - g);
  sg.x0 = (int)((long long)k * P.Wd / S.NS);
  sg.width = (int)((long long)(k + 1) * P.Wd / S.NS) - sg.x0;
  sg.Ws = sg.width + 2 * P.T;
  int g0 = sg.x0 - P.T;
  sg.SH = g0 & 3;
  int lo = g0 < 0 ? -g0 : 0;
  int hi = P.Wd - g0 < sg.Ws ? P.Wd - g0 : sg.Ws;
  sg.lp = row_plan(sg.Ws, g0, lo, hi < lo ? lo : hi, P.vec);
  return sg;
}

// The ring of level L (0 .. T-1): its first word and the slot of segment
// row q.
static __host__ __device__ __forceinline__ long ring_base(const StreamGeom& S,
                                                          int L) {
  return L == 0 ? 0L : (long)(RING0 + RING * (L - 1)) * S.SLOT;
}

static __host__ __device__ __forceinline__ int ring_slot(int L, int q) {
  return q & ((L == 0 ? RING0 : RING) - 1);
}

// A ring row's word of column j, plane 0 (planes 32 words apart).
template <int NPS>
static __host__ __device__ __forceinline__ int ring_word(int j) {
  return (j >> 5) * (32 * NPS) + (j & 31);
}

// The segment row level L (1 .. T) takes in wave i, and whether it takes
// one.
static __host__ __device__ __forceinline__ int wave_row(int L, int i) {
  return i - 2 * L;
}

static __host__ __device__ __forceinline__ bool level_has_row(const Params& P,
                                                              const Segment& sg,
                                                              int L, int q) {
  return q >= L && q < sg.n + 2 * P.T - L;
}

// What a thread keeps for a launch: its level, its first ring column and
// where its words and their neighbours sit in a ring row.
struct StreamLane {
  int s;     // level 1 .. T
  int j0;    // first ring column: 32 J (w mod WPL) + x
  int tid;   // thread index in the block
  int at;    // ring_word(j0)
  int lf;    // offset of the word to the left (column j0 - 1) from ``at``
  int rt;    // ... and to the right (j0 + 1)
};

template <int NPS>
static __host__ __device__ __forceinline__ StreamLane make_stream_lane(
    const StreamGeom& S, int x, int w) {
  StreamLane ln;
  ln.s = w / S.WPL + 1;
  ln.j0 = 32 * S.J * (w - (ln.s - 1) * S.WPL) + x;
  ln.tid = w * 32 + x;
  ln.at = ring_word<NPS>(ln.j0);
  ln.lf = x > 0 ? -1 : 31 - 32 * NPS;
  ln.rt = x < 31 ? 1 : 32 * NPS - 31;
  return ln;
}

// A column of the strip row's source, x0 - T + c, wrapped into [0, Wd):
// by one add or subtract where the apron is no wider than the lattice.
static __host__ __device__ __forceinline__ int wrap_col(int a, int n) {
  if (a < 0) a += n;
  if (a >= n) a -= n;
  if (a < 0 || a >= n) a = pmod(a, n);
  return a;
}

static __host__ __device__ __forceinline__ int next_row(int y, int H) {
  return y + 1 == H ? 0 : y + 1;
}

// What a thread keeps for a segment: which of its J words its level
// computes, which it counts moments of, their RNG columns, its copies of
// an input row (the first STREAM_COPIES of its block-strided (plane, plan
// unit) pairs, p-major), and two running lattice rows.
static const int STREAM_COPIES = 2;

template <int J>
struct SegLane {
  uint32_t active;   // bit m: word m lies in [s, Ws - s)
  uint32_t counted;  // bit m: owned, and its array word in [c0, c1)
  uint32_t rcol[J];  // RNG column of word m: xw0 + (x0 - T + c) mod Wd
  int ncp;           // copies kept below (the rest: ``more``)
  uint32_t wide;     // bit k: copy k moves 16 bytes
  int cdst[STREAM_COPIES];   // ring word of copy k in slot 0
  long csrc[STREAM_COPIES];  // its source word from the lane's row, plane 0
  int more;          // first copy past STREAM_COPIES (found per row)
  int ly;            // lattice row of the next input row to load
  int cy;            // lattice row of the level's row in the coming wave
};

// The source word and the ring word of copy v of an input row.
template <int NPS>
static __host__ __device__ __forceinline__ void copy_of(
    const Params& P, const Segment& sg, int v, long* src, int* dst,
    bool* wide) {
  const int p = v / sg.lp.units, u = v - p * sg.lp.units;
  const int c = sg.lp.col(u), g0 = sg.x0 - P.T;
  *wide = sg.lp.chunk(u);
  *src = (long)p * P.H * P.Wd + (*wide ? g0 + c : wrap_col(g0 + c, P.Wd));
  *dst = ring_word<NPS>(sg.SH + c) + 32 * p;
}

template <int NPS, int J>
static __host__ __device__ __forceinline__ SegLane<J> make_seg_lane(
    const Params& P, const Segment& sg, const StreamLane& ln, int nt) {
  SegLane<J> sl;
  sl.active = sl.counted = 0;
  const int s = ln.s;
  int lx = pmod(sg.x0 - P.T + ln.j0 - sg.SH, P.Wd);
  for (int m = 0; m < J; ++m) {
    const int c = ln.j0 + 32 * m - sg.SH;  // strip column
    if (m) lx = wrap_col(lx + 32, P.Wd);
    sl.rcol[m] = (uint32_t)P.xw0 + (uint32_t)lx;
    const int ax = sg.x0 - P.T + c;
    if (c >= s && c < sg.Ws - s) sl.active |= 1u << m;
    if (c >= P.T && c < P.T + sg.width && ax >= P.c0 && ax < P.c1)
      sl.counted |= 1u << m;
  }
  const int copies = NPS * sg.lp.units;
  sl.ncp = 0;
  sl.wide = 0;
  for (int k = 0; k < STREAM_COPIES; ++k) {
    sl.cdst[k] = 0;
    sl.csrc[k] = 0;
    const int v = ln.tid + k * nt;
    if (v >= copies) continue;
    bool wide;
    copy_of<NPS>(P, sg, v, &sl.csrc[k], &sl.cdst[k], &wide);
    if (wide) sl.wide |= 1u << k;
    ++sl.ncp;
  }
  sl.more = ln.tid + STREAM_COPIES * nt;
  sl.ly = pmod(sg.ra - P.T, P.H);
  sl.cy = pmod(sg.ra - P.T - 2 * s, P.H);
  return sl;
}

// Load of input row q (issued AHEAD waves before it is needed): the
// thread's copies.  Called for q = 0, 1, ... in turn (it steps ``ly``).
template <int NPS, int J>
static __host__ __device__ __forceinline__ void stream_load(
    const Params& P, const StreamGeom& S, const Segment& sg, SegLane<J>& sl,
    uint32_t* ring0, int q, int nt) {
  if (q >= sg.n + 2 * P.T) return;
  const uint32_t* src = P.in + ((long)sg.b * NPS * P.H + sl.ly) * P.Wd;
  uint32_t* dst = ring0 + ring_slot(0, q) * S.SLOT;
  sl.ly = next_row(sl.ly, P.H);
  for (int k = 0; k < STREAM_COPIES; ++k) {
    if (k >= sl.ncp) break;
    if ((sl.wide >> k) & 1u)
      copy16(dst + sl.cdst[k], src + sl.csrc[k]);
    else
      copy4(dst + sl.cdst[k], src + sl.csrc[k]);
  }
  for (int v = sl.more; v < NPS * sg.lp.units; v += nt) {
    long so;
    int d;
    bool wide;
    copy_of<NPS>(P, sg, v, &so, &d, &wide);
    if (wide)
      copy16(dst + d, src + so);
    else
      copy4(dst + d, src + so);
  }
}

// Streaming reads of one level from its ring for one word: ``c[k]``,
// ``l[k]`` and ``r[k]`` point at the word and its left and right
// neighbours in source rows r + 1, r, r - 1 (k = dy + 1 for source row
// r - dy), plane 0, planes 32 words apart.  PAR = 0 or 1: the rows
// alternate in parity and row r's is PAR, so each tap's shift is known at
// compile time; PAR = -1: ``odd`` holds the three parities.
template <int PAR>
struct RingReader {
  const uint32_t* c[3];
  const uint32_t* l[3];
  const uint32_t* r[3];
  int odd[3];  // odd[dy + 1]: parity of source row r - dy (PAR = -1)

  __host__ __device__ __forceinline__ uint32_t tap(int plane, int dx0,
                                                   int dx1, int dy) const {
    const int k = dy + 1;
    const int o = PAR < 0 ? odd[k] : (PAR ^ (dy & 1));
    const int dx = o ? dx1 : dx0;
    const uint32_t v = c[k][32 * plane];
    if (dx == 0) return v;
    return stream_word(v, (dx > 0 ? l[k] : r[k])[32 * plane], dx);
  }

  // The same reader for the word ``n`` words further in every row.
  __host__ __device__ __forceinline__ RingReader shifted(int n) const {
    RingReader rd = *this;
    for (int k = 0; k < 3; ++k) {
      rd.c[k] += n;
      rd.l[k] += n;
      rd.r[k] += n;
    }
    return rd;
  }
};

// The block's moment counters: a warp's sum over its lanes added into its
// own row ``acc`` (REDUX on the card; each thread in turn on the host).
template <int N>
static __host__ __device__ __forceinline__ void warp_accumulate(int* acc,
                                                                const int* cnt,
                                                                int x) {
#ifdef __CUDA_ARCH__
  for (int k = 0; k < N; ++k) {
    int v = __reduce_add_sync(0xFFFFFFFFu, cnt[k]);
    if (x == 0) acc[k] += v;
  }
#else
  (void)x;
  for (int k = 0; k < N; ++k) acc[k] += cnt[k];
#endif
}

static __host__ __device__ __forceinline__ void add_moment(int32_t* dst,
                                                           int v) {
#ifdef __CUDA_ARCH__
  atomicAdd(dst, v);
#else
  *dst = (int32_t)((uint32_t)*dst + (uint32_t)v);
#endif
}

// The J words of a thread in one wave: word_step on each active one, the
// result into level s's ring at smem[ring] (planes 32 words apart, word m
// 32 NP further) or, at level T (``out`` set), into the output row
// (planes ``plane`` words apart, word m 32 further), and its moment terms
// into ``cnt`` where counted.
template <class Rule, int J, int PAR>
static __host__ __device__ __forceinline__ void stream_words(
    const Params& P, const SegLane<J>& sl, const RingReader<PAR>& rd,
    uint32_t rrow, uint32_t t, uint32_t* smem, long ring, uint32_t* out,
    long plane, bool rec, int* cnt) {
  const int CH = 32 * Rule::NP;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int m = 0; m < J; ++m) {
    if (!((sl.active >> m) & 1u)) continue;
    uint32_t o[Rule::NP];
    word_step<Rule>(rd.shifted(m * CH), rrow, sl.rcol[m], t, P.pq, P.pq_lo,
                    P.pq_bits, o);
    if (out) {
      for (int p = 0; p < Rule::NP; ++p) out[p * plane + 32 * m] = o[p];
    } else {
      for (int p = 0; p < Rule::NP; ++p) smem[ring + m * CH + 32 * p] = o[p];
    }
    if (rec && ((sl.counted >> m) & 1u)) Rule::terms(o, cnt);
  }
}

// Compute of wave i, thread ``ln``: level s's row q = i - 2s, its J words.
// Called for every wave in turn (it steps ``cy``); does nothing more where
// the level takes no row this wave (warp-uniform).  ``cnt`` are the
// thread's moment counters of the segment.
template <class Rule, int J>
static __host__ __device__ __forceinline__ void stream_compute(
    const Params& P, const StreamGeom& S, const Segment& sg,
    const StreamLane& ln, SegLane<J>& sl, uint32_t* smem, int i, int* cnt) {
  const int s = ln.s, q = wave_row(s, i);
  const int gy = sl.cy;  // lattice row of segment row q, wrapped
  sl.cy = next_row(gy, P.H);
  if (!level_has_row(P, sg, s, q)) return;
  const int T = P.T;
  const int gn = next_row(gy, P.H);
  const int gp = gy == 0 ? P.H - 1 : gy - 1;
  const uint32_t rrow = (uint32_t)P.y0 + (uint32_t)gy;
  const int odd[3] = {(int)(((uint32_t)P.y0 + (uint32_t)gn) & 1u),
                      (int)(rrow & 1u),
                      (int)(((uint32_t)P.y0 + (uint32_t)gp) & 1u)};
  const int L = s - 1;
  const uint32_t* in = smem + ring_base(S, L) + ln.at;
  const uint32_t* rows[3];
  for (int k = 0; k < 3; ++k) rows[k] = in + ring_slot(L, q + 1 - k) * S.SLOT;
  const uint32_t t = P.t0 + (uint32_t)L;
  long ring = 0;
  uint32_t* out = nullptr;
  const long plane = (long)P.H * P.Wd;
  if (s == T) {
    const int r = sg.ra - T + q;  // an owned row: inside [0, H)
    out = P.out + ((long)sg.b * Rule::NP * P.H + r) * P.Wd + sg.x0 - T +
          ln.j0 - sg.SH;
  } else {
    ring = ring_base(S, s) + ring_slot(s, q) * S.SLOT + ln.at;
  }
  const bool rec = ((P.record_mask >> L) & 1) && q >= T && q < sg.n + T &&
                   sg.ra - T + q >= P.r0 && sg.ra - T + q < P.r1;
  const uint32_t* lr[3] = {rows[0] + ln.lf, rows[1] + ln.lf, rows[2] + ln.lf};
  const uint32_t* rr[3] = {rows[0] + ln.rt, rows[1] + ln.rt, rows[2] + ln.rt};
  if (odd[0] == odd[2] && odd[0] != odd[1]) {
    if (odd[1]) {
      const RingReader<1> rd = {{rows[0], rows[1], rows[2]},
                                {lr[0], lr[1], lr[2]},
                                {rr[0], rr[1], rr[2]},
                                {0, 1, 0}};
      stream_words<Rule, J, 1>(P, sl, rd, rrow, t, smem, ring, out, plane, rec,
                               cnt);
    } else {
      const RingReader<0> rd = {{rows[0], rows[1], rows[2]},
                                {lr[0], lr[1], lr[2]},
                                {rr[0], rr[1], rr[2]},
                                {1, 0, 1}};
      stream_words<Rule, J, 0>(P, sl, rd, rrow, t, smem, ring, out, plane, rec,
                               cnt);
    }
  } else {
    const RingReader<-1> rd = {{rows[0], rows[1], rows[2]},
                               {lr[0], lr[1], lr[2]},
                               {rr[0], rr[1], rr[2]},
                               {odd[0], odd[1], odd[2]}};
    stream_words<Rule, J, -1>(P, sl, rd, rrow, t, smem, ring, out, plane, rec,
                              cnt);
  }
}

// After a segment's last wave, and once the warps have summed their
// threads' counters into their rows of ``acc`` (warp_accumulate), thread
// (x, 0) with x < T adds level x + 1's moments (its warps' sums) into
// record popc(mask below x) of lane b.
template <class Rule>
static __host__ __device__ __forceinline__ void stream_flush(
    const Params& P, const StreamGeom& S, const Segment& sg,
    int (*acc)[Rule::N_TERMS], int x, int w) {
  if (w != 0 || x >= P.T || !((P.record_mask >> x) & 1)) return;
  int cnt[Rule::N_TERMS];
  for (int k = 0; k < Rule::N_TERMS; ++k) cnt[k] = 0;
  for (int v = x * S.WPL; v < (x + 1) * S.WPL; ++v)
    for (int k = 0; k < Rule::N_TERMS; ++k) cnt[k] += acc[v][k];
  int m[Rule::N_MOMENTS];
  Rule::combine(cnt, m);
  int rec = popc32((uint32_t)P.record_mask & ((1u << x) - 1u));
  int32_t* dst =
      P.moments + ((long)sg.b * P.n_rec + rec) * Rule::N_MOMENTS;
  for (int k = 0; k < Rule::N_MOMENTS; ++k) add_moment(dst + k, m[k]);
}

// cp.async groups: one committed a wave; a wave ends when all but the last
// AHEAD groups (the rows still ahead) have landed.
static __host__ __device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

static __host__ __device__ __forceinline__ void copy_wait_ahead() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STREAM_AHEAD));
#endif
}

}  // namespace fhp
