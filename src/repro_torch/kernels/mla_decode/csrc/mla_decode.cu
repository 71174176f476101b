// MLA decode's attention core over each row's live latent (see ops.py's
// note for what it computes, what bounds it and why it is shaped so).
//
// split_kernel: one block a (64-head tile, key split, row), 8 warps.  The
// block keeps its 64 heads' absorbed query (C + R wide) in shared memory
// and walks its split of the row's live keys in tiles of 64 keys, the next
// tile's latent copied in (cp.async) while this one is used.  Each key
// tile, C + R wide, serves both products: the scores (q_lat c + q_rope kr,
// one fp32 accumulator) and, its first C columns, the context.  Warp
// (wm, wn) scores heads 16 wm.. of keys 32 wn.. and accumulates the
// context of heads 16 wm.. over columns C/2 wn.., both with
// mma.sync.m16n8k16 (bf16 or fp16 operands, fp32 sums).  The online
// softmax runs in fp32 (in log2 units); the probabilities are rounded to
// the queries' type for the context product; the context is rounded once.
// With one split the block writes the context; with more it writes its
// normalised fp32 context and log-sum, and merge_kernel combines them.
//
// Widths are compile-time, padded with zeros: (CP, RP) = (512, 64) for
// DeepSeek-V3's latent and rotary widths, (32, 16) for its smoke twins.
// A cache in the queries' type is copied by cp.async; any other float
// cache (float32, the other half type) is read and rounded to the queries'
// type as it loads, as the plain core's c.to(x.dtype).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BH = 64;   // heads a block: the products' M
constexpr int BN = 64;   // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

enum CacheKind { SAME = 0, F32 = 1, BF16 = 2, F16 = 3 };

struct Args {
  const void* q_lat;
  const void* q_rope;
  const void* c;
  const void* kr;
  const void* pos;
  void* out;
  float* part_o;
  float* part_lse;
  long long s_qb, s_qh, s_rb, s_rh, s_cb, s_ct, s_kb, s_kt, s_p, s_ob, s_oh;
  int B, H, C, R, T, chunk, n_splits;
  float scale_log2;
  int cache_kind, pos64;
};

template <typename T> struct Num;
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};
template <> struct Num<__half> {
  static __device__ __forceinline__ __half from(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 16 bytes from global to shared memory, or 16 zero bytes if !ok.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Offset of element (row, col) in a shared tile W elements wide.  Where a
// row holds a multiple of 8 chunks of 16 bytes, the chunk index is XORed
// with the row's low 3 bits, so that the 8 rows an ldmatrix reads at one
// column fall in 8 different bank groups.
template <int W>
__device__ __forceinline__ int sw(int row, int col) {
  if constexpr ((W / 8) % 8 == 0)
    return row * W + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
  else
    return row * W + col;
}

__device__ __forceinline__ float load_as_float(const void* p, long long i,
                                               int kind) {
  switch (kind) {
    case F32:
      return static_cast<const float*>(p)[i];
    case BF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    default:
      return __half2float(static_cast<const __half*>(p)[i]);
  }
}

__device__ __forceinline__ int live_keys(const Args& a, long long b) {
  long long p = a.pos64 ? static_cast<const long long*>(a.pos)[b * a.s_p]
                        : static_cast<const int*>(a.pos)[b * a.s_p];
  p += 1;
  return static_cast<int>(p < 0 ? 0 : (p > a.T ? a.T : p));
}

template <int CP, int RP>
constexpr size_t smem_bytes(size_t elem) {
  return elem * (BH * (CP + RP) + 2 * BN * (CP + RP) + BH * BN) +
         sizeof(float) * 4 * BH;
}

template <typename T, int CP, int RP>
__global__ void __launch_bounds__(THREADS, 1) split_kernel(const Args a) {
  constexpr int D = CP + RP;   // a key's (and a query's) width
  constexpr int CH = D / 8;    // its 16-byte chunks
  constexpr int CW = CP / 2;   // context columns a warp
  constexpr int NT_O = CW / 8; // their n8 tiles
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BH * D;  // two stages of BN keys
  T* sP = sK + 2 * BN * D;
  float* sMax = reinterpret_cast<float*>(sP + BH * BN);  // [wn][head]
  float* sSum = sMax + 2 * BH;                           // [wn][head]

  const int ht = blockIdx.x, sp = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int live = live_keys(a, b);
  const int start = sp * a.chunk;
  const int end = min(start + a.chunk, live);
  if (start >= end) return;  // a split past the row's position

  const T zero = Num<T>::from(0.f);
  {
    const T* ql = static_cast<const T*>(a.q_lat) + b * a.s_qb;
    const T* qr = static_cast<const T*>(a.q_rope) + b * a.s_rb;
    for (int i = tid; i < BH * D; i += THREADS) {
      const int hr = i / D, col = i % D, h = ht * BH + hr;
      T v = zero;
      if (h < a.H) {
        if (col < CP) {
          if (col < a.C) v = ql[h * a.s_qh + col];
        } else if (col - CP < a.R) {
          v = qr[h * a.s_rh + col - CP];
        }
      }
      sQ[sw<D>(hr, col)] = v;
    }
  }

  // Keys n0..n0+BN-1 into stage `stage`, zero past the split's end and in
  // the padded columns.
  auto load_tile = [&](int n0, int stage) {
    T* dst = sK + stage * BN * D;
    if (a.cache_kind == SAME) {
      const T* cb = static_cast<const T*>(a.c) + b * a.s_cb;
      const T* kb = static_cast<const T*>(a.kr) + b * a.s_kb;
      for (int i = tid; i < BN * CH; i += THREADS) {
        const int row = i / CH, col = (i % CH) * 8, key = n0 + row;
        bool ok = key < end;
        const T* src;
        if (col < CP) {
          ok = ok && col < a.C;
          src = cb + key * a.s_ct + col;
        } else {
          ok = ok && col - CP < a.R;
          src = kb + key * a.s_kt + (col - CP);
        }
        cp16(dst + sw<D>(row, col), ok ? src : cb, ok);
      }
    } else {
      const size_t esz = a.cache_kind == F32 ? 4 : 2;
      const char* cb = static_cast<const char*>(a.c) + b * a.s_cb * esz;
      const char* kb = static_cast<const char*>(a.kr) + b * a.s_kb * esz;
      for (int i = tid; i < BN * CH; i += THREADS) {
        const int row = i / CH, col = (i % CH) * 8, key = n0 + row;
        const bool in_c = col < CP;
        const bool ok = key < end && (in_c ? col < a.C : col - CP < a.R);
        T* d = dst + sw<D>(row, col);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = 0.f;
          if (ok)
            v = in_c ? load_as_float(cb, key * a.s_ct + col + j, a.cache_kind)
                     : load_as_float(kb, key * a.s_kt + col - CP + j,
                                     a.cache_kind);
          d[j] = Num<T>::from(v);
        }
      }
    }
  };

  const int r0 = wm * 16 + (lane >> 2);  // this thread's heads r0, r0 + 8
  float m_r[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l_r[2] = {0.f, 0.f};              // running sum, this thread's keys
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const bool async = a.cache_kind == SAME;
  const int ntiles = (end - start + BN - 1) / BN;
  if (async) {
    load_tile(start, 0);
    cp_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1, n0 = start + it * BN;
    if (async) {
      if (it + 1 < ntiles) load_tile(n0 + BN, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      load_tile(n0, stage);
    }
    __syncthreads();
    const T* K = sK + stage * BN * D;

    // Scores of heads 16 wm.. against keys 32 wn.. of the tile.
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; k += 16) {
      uint32_t af[4];
      ldsm_x4(af, sQ + sw<D>(wm * 16 + (lane & 15), k + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t bf[4];
        const int key = wn * 32 + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bf, K + sw<D>(key, k + ((lane >> 3) & 1) * 8));
        Num<T>::mma(s[j], af, bf);
        Num<T>::mma(s[j + 1], af, bf + 2);
      }
    }

    // Online softmax: the tile's max over both key halves, via sMax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
        const float v = key < end ? s[j][e] * a.scale_log2 : -INFINITY;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if ((lane & 3) == 0) {
      sMax[wn * BH + r0] = mx[0];
      sMax[wn * BH + r0 + 8] = mx[1];
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float t = fmaxf(sMax[r0 + 8 * i], sMax[BH + r0 + 8 * i]);
      const float m_new = fmaxf(m_r[i], t);
      alpha[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
      const int col = wn * 32 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(sP + sw<BN>(r0, col)) =
          Num<T>::pack(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(sP + sw<BN>(r0 + 8, col)) =
          Num<T>::pack(s[j][2], s[j][3]);
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    __syncthreads();

    // Context of heads 16 wm.. over columns CW wn..: P (all BN keys) times
    // the tile's latent.
#pragma unroll
    for (int k = 0; k < BN; k += 16) {
      uint32_t af[4];
      ldsm_x4(af, sP + sw<BN>(wm * 16 + (lane & 15), k + (lane >> 4) * 8));
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t bf[4];
        const int key = k + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = wn * CW + n * 8 + (lane >> 4) * 8;
        ldsm_x4_t(bf, K + sw<D>(key, col));
        Num<T>::mma(acc[n], af, bf);
        Num<T>::mma(acc[n + 1], af, bf + 2);
      }
    }
    __syncthreads();
  }

  // The sums of both key halves, via sSum.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  if ((lane & 3) == 0) {
    sSum[wn * BH + r0] = l_r[0];
    sSum[wn * BH + r0 + 8] = l_r[1];
  }
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    inv[i] = 1.f / (sSum[r0 + 8 * i] + sSum[BH + r0 + 8 * i]);

  const int h0 = ht * BH + r0;
  if (a.n_splits == 1) {
    T* o = static_cast<T*>(a.out) + b * a.s_ob;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = wn * CW + n * 8 + (lane & 3) * 2;
      if (col >= a.C) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (h0 + 8 * i < a.H)
          *reinterpret_cast<uint32_t*>(o + (h0 + 8 * i) * a.s_oh + col) =
              Num<T>::pack(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
    }
  } else {
    const long long row0 = (b * a.n_splits + sp) * a.H;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = wn * CW + n * 8 + (lane & 3) * 2;
      if (col >= a.C) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (h0 + 8 * i < a.H)
          *reinterpret_cast<float2*>(a.part_o + (row0 + h0 + 8 * i) * a.C +
                                     col) =
              make_float2(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
    }
    if (wn == 0 && (lane & 3) == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (h0 + 8 * i < a.H)
          a.part_lse[row0 + h0 + 8 * i] =
              m_r[i] + log2f(sSum[r0 + 8 * i] + sSum[BH + r0 + 8 * i]);
  }
}

// One block a (head, row): the row's live splits' contexts weighted by
// their sums, in fp32, rounded once.
template <typename T>
__global__ void __launch_bounds__(128) merge_kernel(const Args a) {
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int n_live = (live_keys(a, b) + a.chunk - 1) / a.chunk;
  const long long row0 = b * a.n_splits * a.H + h;
  float mx = -INFINITY;
  for (int sp = 0; sp < n_live; ++sp)
    mx = fmaxf(mx, a.part_lse[row0 + sp * a.H]);
  float wsum = 0.f;
  for (int sp = 0; sp < n_live; ++sp)
    wsum += exp2f(a.part_lse[row0 + sp * a.H] - mx);
  T* o = static_cast<T*>(a.out) + b * a.s_ob + h * a.s_oh;
  for (int col = threadIdx.x; col < a.C; col += blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < n_live; ++sp)
      v += exp2f(a.part_lse[row0 + sp * a.H] - mx) *
           a.part_o[(row0 + sp * a.H) * a.C + col];
    o[col] = Num<T>::from(v / wsum);
  }
}

template <typename T, int CP, int RP>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CP, RP>(sizeof(T));
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && !opted[dev]) {
    e = cudaFuncSetAttribute(split_kernel<T, CP, RP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  dim3 grid((a.H + BH - 1) / BH, a.n_splits, a.B);
  split_kernel<T, CP, RP><<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return e;
  merge_kernel<T><<<dim3(a.H, a.B), 128, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_widths(const Args& a, cudaStream_t stream) {
  if (a.C <= 32 && a.R <= 16) return launch<T, 32, 16>(a, stream);
  if (a.C <= 512 && a.R <= 64) return launch<T, 512, 64>(a, stream);
  return -1;
}

}  // namespace

extern "C" {

// Launch the split pass and, with n_splits > 1, the merge on `stream`.
// qtype: 0 bf16, 1 fp16.  Returns a cudaError_t (0: launched), or -1 for
// widths with no compiled kernel.
int mla_decode_launch(const void* q_lat, const void* q_rope, const void* c,
                      const void* kr, const void* pos, void* out,
                      void* part_o, void* part_lse, long long s_qb,
                      long long s_qh, long long s_rb, long long s_rh,
                      long long s_cb, long long s_ct, long long s_kb,
                      long long s_kt, long long s_p, long long s_ob,
                      long long s_oh, int B, int H, int C, int R, int T,
                      int chunk, int n_splits, float scale_log2, int qtype,
                      int cache_kind, int pos64, void* stream) {
  Args a{q_lat, q_rope, c, kr, pos, out,
         static_cast<float*>(part_o), static_cast<float*>(part_lse),
         s_qb, s_qh, s_rb, s_rh, s_cb, s_ct, s_kb, s_kt, s_p, s_ob, s_oh,
         B, H, C, R, T, chunk, n_splits, scale_log2, cache_kind, pos64};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qtype == 0 ? launch_widths<__nv_bfloat16>(a, st)
                    : launch_widths<__half>(a, st);
}

}  // extern "C"
