// Mamba2 SSD chunk scan for Hopper (sm_90a), float32 arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan_pallas,
// body _ssd_kernel; wrapper src/repro/kernels/ops.py::ssd_chunk_scan).
// Same function, on the wrapper's own inputs: per (batch b, head h), with
// a = -exp(A_log[h]), and per chunk of c rows cum = cumsum(dt * a):
//   y_t   = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) (x_s dt_s)
//           + exp(cum_t) C_t . state                      (hd x N state)
//   state <- exp(cum_end) state
//            + sum_s (x_s dt_s exp(cum_end - cum_s)) (x) B_s
// where head h reads group g = h / (H / G) of B and C.
//
// Bound.  At the evaluation shape (B=4, S=2048, H=24, hd=64, G=1, N=128,
// c=256) the work is the causal half of the two intra-chunk products,
// c (c + 1) / 2 * 2 (N + hd) a chunk, plus the inter-chunk term and the
// state update, 2 c hd N each for every chunk that has a state before or
// after it: about 15.3 GFLOP, 229 us at the 67 TFLOP/s of float32 on CUDA
// cores.  The bytes (x and y in bf16, B and C compact, dt) are about 55 MB,
// 16 us.  So the FMAs are the floor.  What the design does:
//   * No sequential grid axis on the card: one block per (b, h) walks its
//     chunks in order, the state in shared memory ([n][d], float32) for
//     the whole sequence.  That is B * H = 96 blocks at the evaluation
//     shape, under the 132 SMs: simple and right first.  Splitting the
//     chunks over blocks (chunk summaries, a short scan of chunk states,
//     then the inter-chunk term) is later work.
//   * The wrapper's preparation is folded in: x (B, S, H, hd), B and C
//     (B, S, G, N) and dt (B, S, H) are read in place through strides;
//     x * dt and dt * a are formed as each tile is staged.  The
//     reference's repeat of B and C to heads, its transposes and its
//     float32 copies (24x the compact B and C for mamba2-130m) never
//     exist.
//   * A chunk's rows are taken 64 at a time, so any chunk up to 1024 fits
//     the shared memory (the chunk's dt, cum and decay only are kept
//     whole).  For each 64-row output tile the loop runs over the source
//     tiles s <= t; every product is a 64 x 64 float32 tile product
//     (fp32_tile.cuh, exact float32 FMAs, no TF32: the reference sums in
//     float32 and its test asks 5e-5 of max |y|).
//   * exp(cum_t - cum_s) is evaluated only where s <= t: above the
//     diagonal it overflows to inf at c = 256 (cum falls by about 180
//     over a chunk), and inf times a 0/1 mask would be NaN.  Masked
//     entries are set to 0 without evaluating it.
//   * The inter-chunk term of the first chunk (a zero state) and the
//     state update after the last chunk (no state is returned) are
//     skipped.
//   * Ragged edges are masked in the kernel: any c (rows past c staged
//     as zeros), head_dim <= 64, d_state <= 128.
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"

namespace {

using fp32_tile::Acc;
using fp32_tile::kStride;
using fp32_tile::kThreads;
using fp32_tile::kTile;

constexpr int kMaxN = 128;          // d_state
constexpr int kMaxHd = kTile;       // head_dim: one tile of output columns
constexpr int kMaxChunk = 1024;
constexpr int kBnStride = kMaxN + 4;

// shared memory, in floats
constexpr int kCt = 0;                          // C tile    [n][t]
constexpr int kBt = kCt + kMaxN * kStride;      // B tile    [n][s], or [s][n]
constexpr int kSs = kBt + kMaxN * kStride;      // state     [n][d]
constexpr int kWs = kSs + kMaxN * kStride;      // weights   [s][t]
constexpr int kXs = kWs + kTile * kStride;      // x dt      [s][d]
constexpr int kDt = kXs + kTile * kStride;      // the chunk's dt
constexpr int kCum = kDt + kMaxChunk;           // its cumulative dt * a
constexpr int kDec = kCum + kMaxChunk;          // dt exp(cum_end - cum)
constexpr int kFloats = kDec + kMaxChunk;
constexpr size_t kSmemBytes = sizeof(float) * kFloats;
static_assert(kTile * kBnStride <= kMaxN * kStride, "B in [s][n] fits");

struct Args {
  const void* x;
  const void* B;
  const void* C;
  const void* dt;
  const float* a_log;
  void* y;
  int S, H, hd, G, N, chunk;
  long long xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g, ds_b,
      ds_s, ds_h;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// dst[n][r] = src[row0 + r][n] for r < rows, n < N; rows past `rows` are
// zero.  Consecutive threads read consecutive n: coalesced.
template <typename T>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 int row0, int rows,
                                                 long long rs, int N) {
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    dst[n * kStride + r] =
        r < rows ? ld(src + (long long)(row0 + r) * rs + n) : 0.f;
  }
}

// dst[r][n] = src[row0 + r][n] for r < rows, n < N; zero elsewhere up to
// `cols` columns.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int row0, int rows, long long rs,
                                           int N, int cols) {
  for (int i = threadIdx.x; i < kTile * cols; i += kThreads) {
    const int r = i / cols, n = i - r * cols;
    dst[r * kBnStride + n] =
        r < rows && n < N ? ld(src + (long long)(row0 + r) * rs + n) : 0.f;
  }
}

// dst[r][d] = x[row0 + r][d] * scale[r] for r < rows, d < hd; zero
// elsewhere in the 64 x 64 tile.
template <typename T>
__device__ __forceinline__ void stage_x(float* dst, const T* src, int row0,
                                        int rows, long long rs, int hd,
                                        const float* scale) {
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, d = i % kTile;
    dst[r * kStride + d] =
        r < rows && d < hd
            ? ld(src + (long long)(row0 + r) * rs + d) * scale[r]
            : 0.f;
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* const Ct = smem + kCt;
  float* const Bt = smem + kBt;
  float* const Ss = smem + kSs;
  float* const Ws = smem + kWs;
  float* const Xs = smem + kXs;
  float* const dtv = smem + kDt;
  float* const cum = smem + kCum;
  float* const dec = smem + kDec;

  const int t = threadIdx.x, tr = t >> 4, tc = t & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int N = a.N, hd = a.hd, c = a.chunk;
  const T* const x =
      static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const T* const Bp =
      static_cast<const T*>(a.B) + b * a.bs_b + g * a.bs_g;
  const T* const Cp =
      static_cast<const T*>(a.C) + b * a.cs_b + g * a.cs_g;
  const T* const dtp =
      static_cast<const T*>(a.dt) + b * a.ds_b + h * a.ds_h;
  const long long ys = (long long)a.H * hd;       // y is (B, S, H, hd)
  TO* const y = static_cast<TO*>(a.y) + ((long long)b * a.S * a.H + h) * hd;
  const float av = -expf(a.a_log[h]);
  const int nG = (N + kTile - 1) / kTile;          // state column tiles
  const int nR = (c + kTile - 1) / kTile;          // row tiles a chunk

  for (int i = t; i < kMaxN * kStride; i += kThreads) Ss[i] = 0.f;

  for (int z0 = 0; z0 < a.S; z0 += c) {
    // -- the chunk's dt, cum = cumsum(dt * a) and the decay to its end.
    // Readers of the previous chunk's arrays passed a barrier since.
    for (int s = t; s < c; s += kThreads)
      dtv[s] = ld(dtp + (long long)(z0 + s) * a.ds_s);
    __syncthreads();
    if (t < 32) {
      // lane l sums its run of consecutive rows, then the runs' totals
      // are scanned across the warp
      const int per = (c + 31) / 32;
      const int lo = min(t * per, c), hi = min(lo + per, c);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) {
        run += dtv[s] * av;
        cum[s] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (t >= o) incl += v;
      }
      const float before = incl - run;
      for (int s = lo; s < hi; ++s) cum[s] += before;
    }
    __syncthreads();
    const float cum_end = cum[c - 1];
    const bool last = z0 + c >= a.S;
    for (int s = t; s < c; s += kThreads)
      dec[s] = dtv[s] * expf(cum_end - cum[s]);

    // -- the output, 64 rows at a time
    for (int R = 0; R < nR; ++R) {
      const int r0 = R * kTile, rows = min(kTile, c - r0);
      stage_transposed(Ct, Cp, z0 + r0, rows, a.cs_s, N);
      __syncthreads();
      Acc yacc;
      yacc.zero();
      if (z0 > 0) {
        // inter-chunk: exp(cum_t) C_t . state
        fp32_tile::fma_chunk(Ct, kStride, Ss, kStride, N, tr, tc, yacc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * tr + i;
          const float e = r < rows ? expf(cum[r0 + r]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc.v[i][j] *= e;
        }
      }
      for (int Sp = 0; Sp <= R; ++Sp) {
        const int s0 = Sp * kTile, srows = min(kTile, c - s0);
        stage_transposed(Bt, Bp, z0 + s0, srows, a.bs_s, N);
        stage_x(Xs, x, z0 + s0, srows, a.xs_s, hd, dtv + s0);
        __syncthreads();
        Acc w;
        w.zero();
        fp32_tile::fma_chunk(Ct, kStride, Bt, kStride, N, tr, tc, w);
        // decay and causal mask: exp only where s <= t
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * tr + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = 4 * tc + j;
            const bool keep = r < rows && s < srows && (Sp < R || s <= r);
            w.v[i][j] =
                keep ? w.v[i][j] * expf(cum[r0 + r] - cum[s0 + s]) : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(Ws + (4 * tc + j) * kStride + 4 * tr) =
              make_float4(w.v[0][j], w.v[1][j], w.v[2][j], w.v[3][j]);
        __syncthreads();
        fp32_tile::fma_chunk(Ws, kStride, Xs, kStride, srows, tr, tc, yacc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * tr + i;
        if (r >= rows) continue;
        TO* const row = y + (long long)(z0 + r0 + r) * ys;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = 4 * tc + j;
          if (d < hd) st(row + d, yacc.v[i][j]);
        }
      }
    }
    if (last) break;

    // -- state update; thread (tr, tc) owns d = 4 tr + i and
    // n = 4 tc + j (+ 64)
    Acc s_lo, s_hi;
    const float ce = expf(cum_end);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          Ss + (4 * tc + j) * kStride + 4 * tr);
      s_lo.v[0][j] = ce * v.x;
      s_lo.v[1][j] = ce * v.y;
      s_lo.v[2][j] = ce * v.z;
      s_lo.v[3][j] = ce * v.w;
      const float4 u = *reinterpret_cast<const float4*>(
          Ss + (kTile + 4 * tc + j) * kStride + 4 * tr);
      s_hi.v[0][j] = ce * u.x;
      s_hi.v[1][j] = ce * u.y;
      s_hi.v[2][j] = ce * u.z;
      s_hi.v[3][j] = ce * u.w;
    }
    for (int Sp = 0; Sp < nR; ++Sp) {
      const int s0 = Sp * kTile, srows = min(kTile, c - s0);
      stage_rows(Bt, Bp, z0 + s0, srows, a.bs_s, N, nG * kTile);
      stage_x(Xs, x, z0 + s0, srows, a.xs_s, hd, dec + s0);
      __syncthreads();
      fp32_tile::fma_chunk(Xs, kStride, Bt, kBnStride, srows, tr, tc, s_lo);
      if (nG > 1)
        fp32_tile::fma_chunk(Xs, kStride, Bt + kTile, kBnStride, srows, tr,
                             tc, s_hi);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Ss + (4 * tc + j) * kStride + 4 * tr) =
          make_float4(s_lo.v[0][j], s_lo.v[1][j], s_lo.v[2][j], s_lo.v[3][j]);
      if (nG > 1)
        *reinterpret_cast<float4*>(Ss + (kTile + 4 * tc + j) * kStride +
                                   4 * tr) =
            make_float4(s_hi.v[0][j], s_hi.v[1][j], s_hi.v[2][j],
                        s_hi.v[3][j]);
    }
    __syncthreads();
  }
}

template <typename T, typename TO>
int launch(const Args& a, int Bsz, cudaStream_t stream) {
  // the attribute is per device: set it at every launch
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_kernel<T, TO><<<dim3(a.H, Bsz), kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, hd), B / C (B, S, G, N), dt (B, S, H): float32 or bf16
// (in_bf16), unit last stride, the other strides in elements; a_log (H,)
// float32; y (B, S, H, hd) contiguous, float32 or bf16 (out_bf16).
extern "C" int ssd_scan(const void* x, const void* B, const void* C,
                        const void* dt, const void* a_log, void* y, int Bsz,
                        int S, int H, int hd, int G, int N, int chunk,
                        int in_bf16, int out_bf16, long long xs_b,
                        long long xs_s, long long xs_h, long long bs_b,
                        long long bs_s, long long bs_g, long long cs_b,
                        long long cs_s, long long cs_g, long long ds_b,
                        long long ds_s, long long ds_h, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || S <= 0 || H <= 0 || G <= 0 || H % G ||
      hd <= 0 || hd > kMaxHd || N <= 0 || N > kMaxN || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, B, C, dt, static_cast<const float*>(a_log), y, S, H, hd,
               G, N, chunk, xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, cs_b, cs_s,
               cs_g, ds_b, ds_s, ds_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, Bsz, s)
                    : launch<__nv_bfloat16, float>(a, Bsz, s);
  return out_bf16 ? launch<float, __nv_bfloat16>(a, Bsz, s)
                  : launch<float, float>(a, Bsz, s);
}
