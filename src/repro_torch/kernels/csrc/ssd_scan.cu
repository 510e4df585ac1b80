// Mamba2 SSD chunk scan for Hopper (sm_90a): chunk-parallel, products on
// the tensor cores (mma.sync bf16) with float32 accuracy.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan_pallas,
// body _ssd_kernel; wrapper src/repro/kernels/ops.py::ssd_chunk_scan).
// Same function, on the wrapper's own inputs: per (batch b, head h), with
// a = -exp(A_log[h]), and per chunk z of c rows cum = cumsum(dt * a):
//   y_t     = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//             + exp(cum_t) C_t . prev[z]                 (hd x N state)
//   prev[z + 1] = exp(cum_end[z]) prev[z]
//                 + sum_s (x_s dt_s exp(cum_end[z] - cum_s)) (x) B_s
// with prev[0] = 0, where head h reads group g = h / (H / G) of B and C.
//
// Bound.  At the evaluation shape (B=4, S=2048, H=24, hd=64, G=1, N=128,
// c=256) the work is the causal half of the two intra-chunk products,
// c (c + 1) / 2 * 2 (N + hd) a chunk, plus the inter-chunk term and the
// state update, 2 c hd N each for every chunk with a state before or
// after it: 15.34 GFLOP, 15.5 us at the 989 TFLOP/s of the bf16 tensor
// cores that this kernel feeds (229 us at the 67 TFLOP/s of float32 on
// CUDA cores, the basis of the walk-per-head kernel this one replaced).
// The bytes (x and y in bf16, B and C compact, dt) are 54.9 MB, 16.4 us:
// the call is bound by its bytes.  The workspace below is the design's
// own traffic and is in neither bound.  What the design does:
//   * The grid walks every chunk at once instead of one block per (b, h)
//     walking its chunks in order (96 blocks at the evaluation shape, on
//     132 SMs).  Three launches on the caller's stream, one C entry point:
//       1. chunk_state_kernel, one block per (b, h, chunk but the last,
//          64 columns of N): cum, and s_chunk = sum_s (x_s dt_s
//          exp(cum_end - cum_s)) (x) B_s (hd x N, float32) into the
//          workspace, cum_end beside it.
//       2. state_pass_kernel, one thread per (b, h, d, n): walks the
//          chunks in order, prev <- exp(cum_end) prev + s_chunk, and
//          overwrites each s_chunk slot z with prev[z + 1] in place.
//       3. chunk_scan_kernel, one block per (b, h, chunk, 64 output rows):
//          y once, the inter-chunk term from prev (skipped for the first
//          chunk, whose state is zero) plus the intra-chunk product over
//          the source tiles s <= t.  Longest row tiles first.
//     At the evaluation shape that is 1344, 3072 and 3072 blocks.
//   * Every product runs on mma.sync m16n8k16 with bf16 operands and a
//     float32 accumulator.  A bf16 input (x, B, C of the model) is exact
//     as one bf16 part.  A float32 operand is split into bf16 parts,
//     v = p0 + p1 (+ p2), each the bf16 rounding of what the earlier parts
//     leave; A . B is the sum of the part products p_i q_j with i + j <
//     kSplit, smallest first.  For bf16 inputs kSplit = 2: C B^T is one
//     product; W = C B^T * decay * dt against x, C against prev and
//     x dt decay against B are two.  For float32 inputs every operand has
//     three parts (six products each).  Emulated on the host
//     (tests/test_torch_ssd_scan.py), this holds 2e-6 (bf16) and 4e-6
//     (float32) of max |y| against float64 at A_log = 0 and c = 256; one
//     part (plain bf16), like plain TF32, misses 5e-5 by far.
//   * Tiles are staged in shared memory as they lie in device memory
//     (C, B and x as [row][n] or [row][d], prev as [d][n]) with a padded
//     row stride, by 16-byte loads: cp.async for a bf16 tile copied as it
//     is, registers for a tile that is split or scaled (x dt decay, prev,
//     float32 inputs).  Fragments whose contraction runs along a tile's
//     rows (x in both phases, B in phase 1) are read by ldmatrix.trans,
//     the others by conflict-free 32-bit loads.  Three or four blocks an
//     SM hide one another's copies.  S = C B^T stays in registers: its
//     accumulator fragment is the A fragment of W x, split there.
//   * exp(cum_t - cum_s) is evaluated only where s <= t: above the
//     diagonal it overflows to inf at c = 256 (cum falls by about 180
//     over a chunk), and inf times a 0/1 mask would be NaN.  Masked
//     entries are set to 0 without evaluating it (the fast exp, whose
//     relative error is under 1e-6 for the terms that count); a warp
//     skips the source columns of the diagonal tile that lie wholly past
//     its rows.
//   * x (B, S, H, hd), B and C (B, S, G, N) and dt (B, S, H) are read in
//     place through strides.  Ragged edges are masked in the kernels: any
//     c up to 1024 (rows past c staged as zeros), head_dim <= 64,
//     d_state <= 128.
//   * No atomics: every sum runs in a fixed order, so the result is the
//     same on every run and a bf16 output is the float32 one rounded.
//
// Workspace (float32, from the caller): (B H (nc - 1)) slots of hd x N,
// then (B H (nc - 1)) cum_end values; none when nc = 1.
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns the first CUDA error of the three launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;       // 4 warps, 16 rows each
constexpr int kTile = 64;           // rows of a staged tile
constexpr int kMaxN = 128;          // d_state
constexpr int kMaxHd = kTile;       // head_dim: one tile of columns
constexpr int kMaxChunk = 1024;
constexpr int kNS = kMaxN + 8;      // bf16 row stride of [row][n] tiles
constexpr int kDS = kMaxHd + 8;     // bf16 row stride of [row][d] tiles
constexpr int kPS = kMaxN + 8;      // float row stride of prev [d][n]
constexpr int kPassThreads = 256;

// kIn: bf16 parts of an input operand; kSplit: parts of a float32 operand
// formed in the kernel, and the pairs kept: p_i q_j with i + j < kSplit.
template <typename T>
struct Prec;
template <>
struct Prec<bf16> {
  static constexpr int kIn = 1, kSplit = 2;
};
template <>
struct Prec<float> {
  static constexpr int kIn = 3, kSplit = 3;
};

struct Args {
  const void* x;
  const void* B;
  const void* C;
  const void* dt;
  const float* a_log;
  void* y;
  float* states;  // (B, H, nc - 1, hd, N): s_chunk, then prev in place
  float* ce;      // (B, H, nc - 1): cum_end of each chunk but the last
  int S, H, hd, G, N, chunk;
  long long xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g, ds_b,
      ds_s, ds_h;
  bool vec_x, vec_b, vec_c, vec_prev;  // rows allow 16-byte loads
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st2(float* p, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *p = a;
}
__device__ __forceinline__ void st2(bf16* p, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else
    *p = __float2bfloat16(a);
}

// Splits v (n values) into P bf16 parts in place: part p goes to out[p]
// (n / 2 words), and v keeps what the parts leave.
template <int P, int n>
__device__ __forceinline__ void split_words(float (&v)[n],
                                            uint32_t (&out)[P][n / 2]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      out[p][i] = *reinterpret_cast<const uint32_t*>(&h);
      const float2 f = __bfloat1622float2(h);
      v[2 * i] -= f.x;
      v[2 * i + 1] -= f.y;
    }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages a kTile x COLS tile: dst[r][c] (row stride dld, part stride part)
// = the P bf16 parts of src[r * rs + c] (times scale[r] if SCALE) for
// r < rows, c < cols, and 0 elsewhere.  vec: every row starts 16-byte
// aligned and cols is a whole number of 16-byte pieces, so the tile moves
// in 16-byte loads -- by cp.async when the tile is copied as it is (the
// caller commits and waits), through registers otherwise.
template <typename T, int P, int COLS, bool SCALE>
__device__ __forceinline__ void stage(bf16* dst, int dld, int part,
                                      const T* src, long long rs, int rows,
                                      int cols, const float* scale,
                                      bool vec) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte piece
  constexpr int kPer = COLS / V;     // pieces a row
  constexpr int kLoads = kTile * kPer / kThreads;
  static_assert(kLoads * kThreads == kTile * kPer, "whole pieces a thread");
  if (!vec) {
    for (int i = threadIdx.x; i < kTile * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      float v = r < rows && c < cols ? ld(src + r * rs + c) : 0.f;
      if (SCALE && r < rows) v *= scale[r];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bf16 h = __float2bfloat16_rn(v);
        dst[p * part + r * dld + c] = h;
        v -= __bfloat162float(h);
      }
    }
    return;
  }
  if constexpr (sizeof(T) == 2 && P == 1 && !SCALE) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int piece = threadIdx.x + i * kThreads;
      const int r = piece / kPer, c = (piece % kPer) * V;
      bf16* const d = dst + r * dld + c;
      if (r < rows && c < cols)
        cp_async16(d, src + r * rs + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    uint4 buf[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int piece = threadIdx.x + i * kThreads;
      const int r = piece / kPer, c = (piece % kPer) * V;
      buf[i] = r < rows && c < cols
                   ? __ldg(reinterpret_cast<const uint4*>(src + r * rs + c))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int piece = threadIdx.x + i * kThreads;
      const int r = piece / kPer, c = (piece % kPer) * V;
      float v[V];
      unpack(buf[i], v);
      if (SCALE) {
        const float sc = r < rows ? scale[r] : 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] *= sc;
      }
      uint32_t w[P][V / 2];
      split_words<P, V>(v, w);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        bf16* const d = dst + p * part + r * dld + c;
        if constexpr (V == 8)
          *reinterpret_cast<uint4*>(d) =
              make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
        else
          *reinterpret_cast<uint2*>(d) = make_uint2(w[p][0], w[p][1]);
      }
    }
  }
}

// dst[r][c] (row stride kPS floats) = src[r * rs + c] for r < rows, c <
// cols, 0 elsewhere in the kTile x kMaxN tile, by cp.async when vec (the
// caller commits and waits).
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long rs, int rows, int cols,
                                          bool vec) {
  if (vec) {
    constexpr int kPer = kMaxN / 4;
#pragma unroll
    for (int i = 0; i < kTile * kPer / kThreads; ++i) {
      const int piece = threadIdx.x + i * kThreads;
      const int r = piece / kPer, c = (piece % kPer) * 4;
      float* const d = dst + r * kPS + c;
      if (r < rows && c < cols)
        cp_async16(d, src + r * rs + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int i = threadIdx.x; i < kTile * kMaxN; i += kThreads) {
    const int r = i / kMaxN, c = i % kMaxN;
    dst[r * kPS + c] = r < rows && c < cols ? src[r * rs + c] : 0.f;
  }
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment (16 x 16, row-major) of tile t[m][k] (row stride ld) at
// (m0, k0), and the B fragment (16 x 8, k-major) of t[n][k] at (n0, k0):
// lane = 4 g + q holds rows g, g + 8 and columns 2q, 2q + 1 (+ 8).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int m0, int k0, int g,
                                       int q) {
  const bf16* r0 = t + (m0 + g) * ld + k0 + 2 * q;
  const bf16* r1 = r0 + 8 * ld;
  a[0] = word(r0);
  a[1] = word(r1);
  a[2] = word(r0 + 8);
  a[3] = word(r1 + 8);
}
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* t,
                                       int ld, int n0, int k0, int g,
                                       int q) {
  const bf16* r = t + (n0 + g) * ld + k0 + 2 * q;
  b[0] = word(r);
  b[1] = word(r + 8);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// From a tile stored with the contraction index k along its rows,
// t[k][m] (row stride ld), by ldmatrix.trans: the A fragment of the
// 16 x 16 block at (m0, k0) ...
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* t,
                                             int ld, int m0, int k0,
                                             int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4_trans(a, t + (k0 + r + 8 * (mi >> 1)) * ld + m0 + 8 * (mi & 1));
}
// ... and the B fragments of the two 16 x 8 blocks at (n0, k0) and
// (n0 + 8, k0) of t[k][n].
__device__ __forceinline__ void load_b2_trans(uint32_t (&b0)[2],
                                              uint32_t (&b1)[2],
                                              const bf16* t, int ld, int n0,
                                              int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  uint32_t v[4];
  ldsm_x4_trans(v, t + (k0 + r + 8 * (mi & 1)) * ld + n0 + 8 * (mi >> 1));
  b0[0] = v[0];
  b0[1] = v[1];
  b1[0] = v[2];
  b1[1] = v[3];
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += sum of a_i b_j over i < NA, j < NB, i + j < NS, smallest first.
template <int NA, int NB, int NS>
__device__ __forceinline__ void mma_parts(float (&d)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
#pragma unroll
  for (int k = NS - 1; k >= 0; --k)
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (k - i >= 0 && k - i < NB) mma(d, a[i], b[k - i]);
}

// The A fragment, in NS parts, of the 16 x 16 block of a float32
// accumulator held as two m16n8 tiles (columns 0-7 and 8-15).
template <int NS>
__device__ __forceinline__ void split_acc(uint32_t (&a)[NS][4],
                                          const float (&lo)[4],
                                          const float (&hi)[4]) {
  float v[8] = {lo[0], lo[1], lo[2], lo[3], hi[0], hi[1], hi[2], hi[3]};
  split_words<NS, 8>(v, a);
}

// cum[s] = sum_{s' <= s} dtv[s'] * av for s < c, by one warp: lane l sums
// its run of consecutive rows, then the runs' totals are scanned across
// the warp.  Every kernel runs this same code, so their cums agree.
__device__ __forceinline__ void chunk_cum(const float* dtv, float* cum,
                                          int c, float av, int lane) {
  const int per = (c + 31) / 32;
  const int lo = min(lane * per, c), hi = min(lo + per, c);
  float run = 0.f;
  for (int s = lo; s < hi; ++s) {
    run += dtv[s] * av;
    cum[s] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float before = incl - run;
  for (int s = lo; s < hi; ++s) cum[s] += before;
}

// The chunk's dt into dtv and its cum, by the whole block.
template <typename T>
__device__ __forceinline__ void stage_cum(const T* dtp, long long ds_s,
                                          int z0, int c, float av,
                                          float* dtv, float* cum) {
  for (int s = threadIdx.x; s < c; s += kThreads)
    dtv[s] = ld(dtp + (long long)(z0 + s) * ds_s);
  __syncthreads();
  if (threadIdx.x < 32) chunk_cum(dtv, cum, c, av, threadIdx.x);
  __syncthreads();
}

constexpr int kStateCols = 64;  // n columns of s_chunk a phase-1 block

template <typename T>
size_t state_smem_bytes(int chunk) {
  return sizeof(bf16) * kTile * kDS * (Prec<T>::kSplit + Prec<T>::kIn) +
         sizeof(float) * 3 * chunk;
}

// Phase 1: s_chunk[d][n] = sum_s x_s[d] dt_s exp(cum_end - cum_s) B_s[n]
// for one chunk (all but the last) and kStateCols columns n of it.  Warp
// w owns rows d = 16 w .. 16 w + 15; the sum runs over s, 64 staged rows
// at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(Args a) {
  constexpr int PI = Prec<T>::kIn, PS = Prec<T>::kSplit;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const xw = reinterpret_cast<bf16*>(smem);  // x dt decay [PS][s][d]
  bf16* const bs = xw + PS * kTile * kDS;           // B [PI][s][n]
  float* const dtv = reinterpret_cast<float*>(bs + PI * kTile * kDS);
  float* const cum = dtv + a.chunk;
  float* const dec = cum + a.chunk;

  const int n_blocks = (a.N + kStateCols - 1) / kStateCols;
  const int z = blockIdx.x / n_blocks, h = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x % n_blocks * kStateCols;
  const int gi = h / (a.H / a.G);
  const int c = a.chunk, z0 = z * c, nc1 = a.S / c - 1;
  const int N = a.N, hd = a.hd, ncols = min(kStateCols, N - n0);
  const T* const x = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const T* const Bp =
      static_cast<const T*>(a.B) + b * a.bs_b + gi * a.bs_g + n0;
  const T* const dtp =
      static_cast<const T*>(a.dt) + b * a.ds_b + h * a.ds_h;
  const float av = -expf(a.a_log[h]);
  const long long slot = ((long long)b * a.H + h) * nc1 + z;

  stage_cum(dtp, a.ds_s, z0, c, av, dtv, cum);
  const float ce = cum[c - 1];
  for (int s = threadIdx.x; s < c; s += kThreads)
    dec[s] = dtv[s] * expf(ce - cum[s]);
  if (threadIdx.x == 0 && n0 == 0) a.ce[slot] = ce;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nP = (ncols + 15) / 16;  // pairs of 8-column n tiles
  float acc[kStateCols / 8][4] = {};
  for (int s0 = 0; s0 < c; s0 += kTile) {
    const int rows = min(kTile, c - s0);
    __syncthreads();  // dec written; the previous tile consumed
    stage<T, PS, kMaxHd, true>(xw, kDS, kTile * kDS,
                               x + (long long)(z0 + s0) * a.xs_s, a.xs_s,
                               rows, hd, dec + s0, a.vec_x);
    stage<T, PI, kStateCols, false>(bs, kDS, kTile * kDS,
                                    Bp + (long long)(z0 + s0) * a.bs_s,
                                    a.bs_s, rows, ncols, nullptr, a.vec_b);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int kk = 0; 16 * kk < rows; ++kk) {
      uint32_t af[PS][4];
#pragma unroll
      for (int p = 0; p < PS; ++p)
        load_a_trans(af[p], xw + p * kTile * kDS, kDS, 16 * warp, 16 * kk,
                     lane);
#pragma unroll
      for (int jj = 0; jj < kStateCols / 16; ++jj) {
        if (jj < nP) {
          uint32_t b0[PI][2], b1[PI][2];
#pragma unroll
          for (int p = 0; p < PI; ++p)
            load_b2_trans(b0[p], b1[p], bs + p * kTile * kDS, kDS, 16 * jj,
                          16 * kk, lane);
          mma_parts<PS, PI, PS>(acc[2 * jj], af, b0);
          mma_parts<PS, PI, PS>(acc[2 * jj + 1], af, b1);
        }
      }
    }
  }
  float* const out = a.states + slot * hd * N + n0;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < kStateCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * warp + g + 8 * (e >> 1), n = 8 * j + 2 * q + (e & 1);
      if (d < hd && n < ncols) out[d * N + n] = acc[j][e];
    }
}

// Phase 2: for each (b, h, d, n), walk the chunks in order.  Slot z holds
// s_chunk[z] on entry and prev[z + 1] on exit.
__global__ void __launch_bounds__(kPassThreads)
    state_pass_kernel(float* states, const float* ce, long long bh_count,
                      int nc1, int hdN) {
  const long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= bh_count * hdN) return;
  const long long bh = i / hdN, e = i % hdN;
  float* p = states + bh * nc1 * hdN + e;
  const float* dec = ce + bh * nc1;
  float prev = 0.f;
  for (int z = 0; z < nc1; ++z, p += hdN) {
    prev = prev * expf(dec[z]) + *p;
    *p = prev;
  }
}

// Phase 3's shared memory: C [PI][t][n]; prev [d][n] in float32, then
// over the same bytes one source tile at a time, B [PI][s][n] and x
// [PI][s][d]; then the chunk's dt and cum.  (A second tile buffer, to copy the next
// tile while this one is used, cost more in blocks an SM than it saved.)
template <typename T>
struct ScanSmem {
  static constexpr int PI = Prec<T>::kIn, PS = Prec<T>::kSplit;
  static constexpr size_t kTileBytes = sizeof(bf16) * PI * kTile * (kNS + kDS);
  static constexpr size_t kPrevBytes = sizeof(float) * kTile * kPS;
  static constexpr size_t kRegion =
      kTileBytes > kPrevBytes ? kTileBytes : kPrevBytes;
  static constexpr size_t kFixed = sizeof(bf16) * PI * kTile * kNS + kRegion;
  static size_t bytes(int chunk) { return kFixed + sizeof(float) * 2 * chunk; }
};

// Phase 3: 64 output rows t of chunk z.  Warp w owns rows 16 w .. 16 w +
// 15 of the tile and every d.
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(Args a) {
  using M = ScanSmem<T>;
  constexpr int PI = M::PI, PS = M::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const cs = reinterpret_cast<bf16*>(smem);
  bf16* const region = cs + PI * kTile * kNS;
  float* const prevs = reinterpret_cast<float*>(region);  // before the tiles
  float* const dtv = reinterpret_cast<float*>(smem + M::kFixed);
  float* const cum = dtv + a.chunk;

  const int c = a.chunk, nR = (c + kTile - 1) / kTile;
  const int R = nR - 1 - blockIdx.x % nR, z = blockIdx.x / nR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int gi = h / (a.H / a.G);
  const int z0 = z * c, r0 = R * kTile, rows = min(kTile, c - r0);
  const int nc1 = a.S / c - 1;
  const int N = a.N, hd = a.hd;
  const T* const x = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h +
                     (long long)z0 * a.xs_s;
  const T* const Bp = static_cast<const T*>(a.B) + b * a.bs_b +
                      gi * a.bs_g + (long long)z0 * a.bs_s;
  const T* const Cp = static_cast<const T*>(a.C) + b * a.cs_b +
                      gi * a.cs_g + (long long)z0 * a.cs_s;
  const T* const dtp =
      static_cast<const T*>(a.dt) + b * a.ds_b + h * a.ds_h;
  const float av = -expf(a.a_log[h]);

  stage<T, PI, kMaxN, false>(cs, kNS, kTile * kNS, Cp + r0 * a.cs_s, a.cs_s,
                             rows, N, nullptr, a.vec_c);
  if (z > 0)
    stage_f32(prevs, a.states + (((long long)b * a.H + h) * nc1 + z - 1) *
                                    hd * N,
              N, hd, N, a.vec_prev);
  cp_async_commit();
  stage_cum(dtp, a.ds_s, z0, c, av, dtv, cum);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nK = (N + 15) / 16, nDP = (hd + 15) / 16;
  const int tl = 16 * warp + g;  // this lane's rows: tl and tl + 8
  float yacc[kMaxHd / 8][4] = {};

  if (z > 0) {
    // inter-chunk: exp(cum_t) C_t . prev[z]; prev, copied as float32
    // with C (before the tiles use its bytes), is split into parts as its
    // fragments are read
    cp_async_wait<0>();
    __syncthreads();
    float iacc[kMaxHd / 8][4] = {};
    for (int kk = 0; kk < nK; ++kk) {
      uint32_t af[PI][4];
#pragma unroll
      for (int p = 0; p < PI; ++p)
        load_a(af[p], cs + p * kTile * kNS, kNS, 16 * warp, 16 * kk, g, q);
#pragma unroll
      for (int j = 0; j < kMaxHd / 8; ++j) {
        if (j < 2 * nDP) {
          const float* const r = prevs + (8 * j + g) * kPS + 16 * kk + 2 * q;
          const float2 lo = *reinterpret_cast<const float2*>(r);
          const float2 hi = *reinterpret_cast<const float2*>(r + 8);
          float v[4] = {lo.x, lo.y, hi.x, hi.y};
          uint32_t bf[PS][2];
          split_words<PS, 4>(v, bf);
          mma_parts<PI, PS, PS>(iacc[j], af, bf);
        }
      }
    }
    const float e0 = tl < rows ? expf(cum[r0 + tl]) : 0.f;
    const float e1 = tl + 8 < rows ? expf(cum[r0 + tl + 8]) : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHd / 8; ++j) {
      yacc[j][0] += iacc[j][0] * e0;
      yacc[j][1] += iacc[j][1] * e0;
      yacc[j][2] += iacc[j][2] * e1;
      yacc[j][3] += iacc[j][3] * e1;
    }
  }

  // intra-chunk: source tiles s <= t
  bf16* const bs = region;                       // B [PI][s][n]
  bf16* const xs = region + PI * kTile * kNS;    // x [PI][s][d]
  for (int Sp = 0; Sp <= R; ++Sp) {
    const int s0 = Sp * kTile, srows = min(kTile, c - s0);
    const bool diag = Sp == R;
    if (Sp == 0 && z > 0) __syncthreads();  // prev's readers are done
    stage<T, PI, kMaxN, false>(bs, kNS, kTile * kNS, Bp + s0 * a.bs_s,
                               a.bs_s, srows, N, nullptr, a.vec_b);
    stage<T, PI, kMaxHd, false>(xs, kDS, kTile * kDS, x + s0 * a.xs_s,
                                a.xs_s, srows, hd, nullptr, a.vec_x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // on the diagonal tile, columns past this warp's last row are all
    // masked: n-tiles from 2 warp + 2 and k-steps from warp + 1 on
    const int jmax = diag ? 2 * warp + 2 : kTile / 8;
    float sacc[kTile / 8][4] = {};
    for (int kk = 0; kk < nK; ++kk) {
      uint32_t af[PI][4];
#pragma unroll
      for (int p = 0; p < PI; ++p)
        load_a(af[p], cs + p * kTile * kNS, kNS, 16 * warp, 16 * kk, g, q);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        if (j < jmax) {
          uint32_t bf[PI][2];
#pragma unroll
          for (int p = 0; p < PI; ++p)
            load_b(bf[p], bs + p * kTile * kNS, kNS, 8 * j, 16 * kk, g, q);
          mma_parts<PI, PI, PS>(sacc[j], af, bf);
        }
      }
    }
    // W = S * exp(cum_t - cum_s) * dt_s where s <= t, else 0 (no exp;
    // the fast exp: its error is relative, under 1e-6 where the term
    // counts, cum_t - cum_s > -20)
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = tl + 8 * (e >> 1), s = 8 * j + 2 * q + (e & 1);
        const bool keep = j < jmax && r < rows && s < srows &&
                          (!diag || s <= r);
        sacc[j][e] =
            keep ? sacc[j][e] * __expf(cum[r0 + r] - cum[s0 + s]) * dtv[s0 + s]
                 : 0.f;
      }
    const int kmax = diag ? warp + 1 : kTile / 16;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (kk < kmax) {
        uint32_t af[PS][4];
        split_acc<PS>(af, sacc[2 * kk], sacc[2 * kk + 1]);
#pragma unroll
        for (int jj = 0; jj < kMaxHd / 16; ++jj) {
          if (jj < nDP) {
            uint32_t b0[PI][2], b1[PI][2];
#pragma unroll
            for (int p = 0; p < PI; ++p)
              load_b2_trans(b0[p], b1[p], xs + p * kTile * kDS, kDS, 16 * jj,
                            16 * kk, lane);
            mma_parts<PS, PI, PS>(yacc[2 * jj], af, b0);
            mma_parts<PS, PI, PS>(yacc[2 * jj + 1], af, b1);
          }
        }
      }
    }
    __syncthreads();  // the tile consumed
  }

  const long long ys = (long long)a.H * hd;  // y is (B, S, H, hd)
  TO* const y = static_cast<TO*>(a.y) +
                ((long long)b * a.S * a.H + h) * hd +
                (long long)(z0 + r0) * ys;
  const bool pairs = hd % 2 == 0;
#pragma unroll
  for (int j = 0; j < kMaxHd / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = tl + 8 * (e >> 1), d = 8 * j + 2 * q;
      if (r < rows && d < hd)
        st2(y + r * ys + d, yacc[j][e], yacc[j][e + 1], pairs);
    }
  if (!pairs) {
#pragma unroll
    for (int j = 0; j < kMaxHd / 8; ++j)
#pragma unroll
      for (int e = 1; e < 4; e += 2) {
        const int r = tl + 8 * (e >> 1), d = 8 * j + 2 * q + 1;
        if (r < rows && d < hd) st2(y + r * ys + d, yacc[j][e], 0.f, false);
      }
  }
}

template <class K>
cudaError_t launch_one(K kernel, dim3 grid, size_t smem,
                       cudaStream_t stream, const Args& a) {
  // the attribute is per device: set it at every launch
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TO>
int launch(const Args& a, int Bsz, cudaStream_t stream) {
  const int nc = a.S / a.chunk, nR = (a.chunk + kTile - 1) / kTile;
  cudaError_t e;
  if (nc > 1) {
    const int n_blocks = (a.N + kStateCols - 1) / kStateCols;
    e = launch_one(chunk_state_kernel<T>, dim3((nc - 1) * n_blocks, a.H, Bsz),
                   state_smem_bytes<T>(a.chunk), stream, a);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long bh = (long long)Bsz * a.H, hdN = a.hd * a.N;
    const long long blocks = (bh * hdN + kPassThreads - 1) / kPassThreads;
    state_pass_kernel<<<static_cast<unsigned>(blocks), kPassThreads, 0,
                        stream>>>(a.states, a.ce, bh, nc - 1,
                                  static_cast<int>(hdN));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = launch_one(chunk_scan_kernel<T, TO>, dim3(nR * nc, a.H, Bsz),
                 ScanSmem<T>::bytes(a.chunk), stream, a);
  return static_cast<int>(e);
}

// Whether rows of a tensor of element size `size` (base p, strides in
// elements, `cols` values a row) can be read in 16-byte pieces.
bool vec_ok(const void* p, int size, int cols, long long s0, long long s1,
            long long s2) {
  const long long v = 16 / size;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && cols % v == 0 &&
         s0 % v == 0 && s1 % v == 0 && s2 % v == 0;
}

}  // namespace

// x (B, S, H, hd), B / C (B, S, G, N), dt (B, S, H): float32 or bf16
// (in_bf16), unit last stride, the other strides in elements; a_log (H,)
// float32; y (B, S, H, hd) contiguous, float32 or bf16 (out_bf16);
// workspace: ws_floats >= B H (S / chunk - 1) (hd N + 1) float32, 16-byte
// aligned.
extern "C" int ssd_scan(const void* x, const void* B, const void* C,
                        const void* dt, const void* a_log, void* y,
                        void* workspace, long long ws_floats, int Bsz,
                        int S, int H, int hd, int G, int N, int chunk,
                        int in_bf16, int out_bf16, long long xs_b,
                        long long xs_s, long long xs_h, long long bs_b,
                        long long bs_s, long long bs_g, long long cs_b,
                        long long cs_s, long long cs_g, long long ds_b,
                        long long ds_s, long long ds_h, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || S <= 0 || H <= 0 || H > 65535 || G <= 0 ||
      H % G || hd <= 0 || hd > kMaxHd || N <= 0 || N > kMaxN || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = (long long)Bsz * H * (S / chunk - 1);
  if (ws_floats < slots * ((long long)hd * N + 1) ||
      (slots > 0 && (workspace == nullptr ||
                     reinterpret_cast<uintptr_t>(workspace) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* const states = static_cast<float*>(workspace);
  const int size = in_bf16 ? 2 : 4;
  const Args a{x, B, C, dt, static_cast<const float*>(a_log), y, states,
               states + slots * hd * N, S, H, hd, G, N, chunk, xs_b, xs_s,
               xs_h, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g, ds_b, ds_s, ds_h,
               vec_ok(x, size, hd, xs_b, xs_s, xs_h),
               vec_ok(B, size, N, bs_b, bs_s, bs_g),
               vec_ok(C, size, N, cs_b, cs_s, cs_g), N % 4 == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? launch<bf16, bf16>(a, Bsz, s)
                    : launch<bf16, float>(a, Bsz, s);
  return out_bf16 ? launch<float, bf16>(a, Bsz, s)
                  : launch<float, float>(a, Bsz, s);
}
