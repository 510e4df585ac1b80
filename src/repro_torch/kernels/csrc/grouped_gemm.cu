// Grouped GEMM for the mixture-of-experts layers on Hopper (sm_90a): the
// expert products over rows sorted by expert, on each expert's rows only.
//
// Replaces jax.lax.ragged_dot at src/repro/models/moe.py:91-93 (the
// reference's moe_apply_ragged: gate, up and down over token rows sorted
// by expert) and its transpose under jax.grad.  ragged_dot is an XLA op,
// not a pallas_call: the reference leaves it to XLA's grouped GEMM.  Two
// kernels, one template:
//   K7  grouped_gemm:    Y[rows of g] = X[rows of g] . W[g]
//                        (with W's strides swapped, dX = dY . W[g]^T)
//   K8  grouped_gemm_dw: dW[g] = X[rows of g]^T . dY[rows of g]
// Group g is rows [offs[g], offs[g + 1]) of X, offs (E + 1,) int32 read
// from device memory: no host read sizes a grid.  K7's grid is bounded
// by the shapes alone: ceil(M / BM) + min(E, M) row tiles, which cover
// sum_g ceil(|g| / BM) whatever the split; a block finds its group and
// rows with a warp scan of the offsets, and the blocks past the last
// tile exit.  K8's grid is (N tiles, K tiles, E); a block walks its
// group's rows as the reduction, and an empty group's block writes its
// zeros (the output comes from torch.empty).
//
// Bound.  One product of dbrx-132b's prefill (d 6144, f 10752, E 16,
// k 4, T = 4 x 384, so M = 6144 rows) is 812 GFLOP, 0.82 ms at the 989
// TFLOP/s of the bf16 tensor cores, against 2.11 GB of weights (0.63 ms
// at 3.35 TB/s): it is bound by its operations.  A decode step's product
// (M = 32 rows over ~14 of 16 experts) and every product of
// deepseek-v3-671b (d 7168, f 2048, E 256, k 8; its prefill's 12288 rows
// reach all 256 experts, 7.52 GB, 2.24 ms) are bound by the weights they
// read: each expert a row reaches is read once, an expert no row reaches
// not at all.
//
// Design (simple and right first; wgmma and TMA are later work):
//   * bf16: 128 x 128 output tiles, 8 warps of 64 x 32, mma.sync
//     m16n8k16 with float32 accumulators, a 3-stage cp.async ring of
//     32-deep reduction slices.  Tiles are staged as they lie in device
//     memory (rows of the contiguous dimension, padded by 16 bytes, so
//     that ldmatrix reads 8 rows on 8 distinct bank groups): a tile whose
//     reduction runs along its rows (X in K7, W^T for dX) is read by
//     ldmatrix, one whose reduction runs across them (W in K7, X and dY
//     in K8) by ldmatrix.trans.  Rows past a group's end, or past M, are
//     staged as zeros (cp.async with a source size of 0) and not stored.
//     The contiguous extents (K, N) are multiples of 8, so a 16-byte
//     chunk is wholly in or wholly out.
//   * float32 runs in full float32 on the CUDA cores (not TF32): 64 x 64
//     tiles, 16-deep slices staged through shared memory, 4 x 4 outputs a
//     thread, any strides.
//   * No atomics and no split of the reduction over blocks: each output
//     tile belongs to one block, which sums its reduction in one fixed
//     order, so a call repeats bit for bit.
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns the launch's CUDA error (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
// bf16 tensor-core tiles
constexpr int kBM = 128;       // output rows a block
constexpr int kBN = 128;       // output columns a block
constexpr int kBK = 32;        // reduction a stage
constexpr int kStages = 3;
constexpr int kPad = 8;        // bf16 elements of padding a staged row
constexpr int kRedRow = kBK + kPad;    // a row of a tile staged [outer][red]
constexpr int kOutRow = kBN + kPad;    // a row of a tile staged [red][outer]
constexpr int kTileElems = kBM * kRedRow;
static_assert(kBM == kBN && kBK * kOutRow <= kTileElems,
              "both staged layouts fit one tile slot");
constexpr int kSmemBytes = kStages * 2 * kTileElems * 2;
// float32 CUDA-core tiles
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

// element (o, r) of an operand: p + o * so + r * sr; o runs along the
// output (rows of Y, or its columns for the B operand), r along the
// reduction
struct Operand {
  const void* p;
  long long so, sr;
};

// what a block computes: group g, output rows from ot (valid below ohi),
// the reduction over [r0, r1)
struct Tile {
  int g, ot, ohi, r0, r1;
};

__device__ __forceinline__ int clamp_row(int v, int M) {
  return min(max(v, 0), M);
}

// K7 (group_red false): row tile blockIdx.y of the groups' tiles in
// order, found by a warp scan of the offsets; false for a block past the
// last tile.  K8 (group_red true): group blockIdx.z, whose rows are the
// reduction.  Called by every thread of the block.
template <int BM>
__device__ bool schedule(const int* __restrict__ offs, int E, int M, int O,
                         int R, bool group_red, Tile& t) {
  if (group_red) {
    const int g = blockIdx.z;
    const int a = clamp_row(offs[g], M), b = clamp_row(offs[g + 1], M);
    t = Tile{g, static_cast<int>(blockIdx.y) * BM, O, a, max(a, b)};
    return true;
  }
  __shared__ int found[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32;
    const int lo = min(E, lane * per), hi = min(E, lo + per);
    int count = 0;
    for (int g = lo; g < hi; ++g) {
      const int a = clamp_row(offs[g], M), b = clamp_row(offs[g + 1], M);
      count += b > a ? (b - a + BM - 1) / BM : 0;
    }
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int y = blockIdx.y;
    if (lane == 0) found[0] = -1;
    __syncwarp();
    if (y >= incl - count && y < incl) {
      int first = incl - count;
      for (int g = lo; g < hi; ++g) {
        const int a = clamp_row(offs[g], M), b = clamp_row(offs[g + 1], M);
        const int n = b > a ? (b - a + BM - 1) / BM : 0;
        if (y < first + n) {
          found[0] = g;
          found[1] = a + (y - first) * BM;
          found[2] = min(b, found[1] + BM);
          break;
        }
        first += n;
      }
    }
  }
  __syncthreads();
  if (found[0] < 0) return false;
  t = Tile{found[0], found[1], found[2], 0, R};
  return true;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage a 128 (outer) x 32 (reduction) slice of an operand, outer from
// ob (valid below ohi), reduction from rb (valid below rhi), by 16-byte
// chunks of its contiguous dimension.  RC: the reduction is contiguous,
// staged [outer][red]; else the outer index is, staged [red][outer].
template <bool RC>
__device__ __forceinline__ void stage(bf16* s, const bf16* g, long long so,
                                      long long sr, int ob, int ohi, int rb,
                                      int rhi, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    const int ol = RC ? c >> 2 : (c & 15) * 8;
    const int rl = RC ? (c & 3) * 8 : c >> 4;
    const int o = ob + ol, r = rb + rl;
    const bool ok = o < ohi && r < rhi;
    const bf16* src = ok ? g + o * so + r * sr : g;
    cp_async16(RC ? s + ol * kRedRow + rl : s + rl * kOutRow + ol, src, ok);
  }
}

// The A fragment of a 16 x 16 product at outer row o, reduction k.
template <bool RC>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* t, int o,
                                       int k, int lane) {
  if (RC) {
    ldmatrix_x4(f, t + (o + (lane & 15)) * kRedRow + k + (lane >> 4) * 8);
  } else {
    const int m = lane >> 3, rr = lane & 7;
    ldmatrix_x4_trans(f, t + (k + rr + (m >> 1) * 8) * kOutRow + o +
                             (m & 1) * 8);
  }
}

// The B fragments of two 16 x 8 products at outer column n, reduction k:
// f[0], f[1] for columns n..n+7, f[2], f[3] for n+8..n+15.
template <bool RC>
__device__ __forceinline__ void frag_b(uint32_t (&f)[4], const bf16* t, int n,
                                       int k, int lane) {
  const int m = lane >> 3, rr = lane & 7;
  if (RC)
    ldmatrix_x4(f, t + (n + rr + (m >> 1) * 8) * kRedRow + k + (m & 1) * 8);
  else
    ldmatrix_x4_trans(f, t + (k + rr + (m & 1) * 8) * kOutRow + n +
                             (m >> 1) * 8);
}

// Y(o, c) = sum_r A(o, r) B_g(r, c); B_g = B + g * sb_e (K7) or B (K8);
// Y + g * sy_e (K8) or Y (K7), row stride sy_o, columns contiguous.
template <bool GROUP_RED, bool A_RC, bool B_RC>
__global__ void __launch_bounds__(kThreads)
    gg_bf16_kernel(Operand A, Operand B, long long sb_e, bf16* __restrict__ Y,
                   long long sy_o, long long sy_e,
                   const int* __restrict__ offs, int M, int R, int C, int O,
                   int E) {
  Tile t;
  if (!schedule<kBM>(offs, E, M, O, R, GROUP_RED, t)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const sA = reinterpret_cast<bf16*>(smem);
  bf16* const sB = sA + kStages * kTileElems;
  const bf16* const a = static_cast<const bf16*>(A.p);
  const bf16* const b =
      static_cast<const bf16*>(B.p) + (GROUP_RED ? 0 : t.g * sb_e);
  const int c0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int nk = (t.r1 - t.r0 + kBK - 1) / kBK;

  auto load = [&](int slot, int kt) {
    const int rb = t.r0 + kt * kBK;
    stage<A_RC>(sA + slot * kTileElems, a, A.so, A.sr, t.ot, t.ohi, rb, t.r1,
                tid);
    stage<B_RC>(sB + slot * kTileElems, b, B.so, B.sr, c0, C, rb, t.r1, tid);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    const bf16* const tA = sA + (kt % kStages) * kTileElems;
    const bf16* const tB = sB + (kt % kStages) * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        frag_a<A_RC>(af[i], tA, wm * 64 + i * 16, kk, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        frag_b<B_RC>(bfr[jp], tB, wn * 32 + jp * 16, kk, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                   bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  bf16* const y = Y + (GROUP_RED ? t.g * sy_e : 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = t.ot + wm * 64 + i * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + wn * 32 + j * 8 + (lane & 3) * 2;
      if (c >= C) continue;
      if (o < t.ohi)
        *reinterpret_cast<__nv_bfloat162*>(y + o * sy_o + c) =
            __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      if (o + 8 < t.ohi)
        *reinterpret_cast<__nv_bfloat162*>(y + (o + 8) * sy_o + c) =
            __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

template <bool GROUP_RED>
__global__ void __launch_bounds__(kThreads)
    gg_f32_kernel(Operand A, Operand B, long long sb_e, float* __restrict__ Y,
                  long long sy_o, long long sy_e,
                  const int* __restrict__ offs, int M, int R, int C, int O,
                  int E) {
  Tile t;
  if (!schedule<kFM>(offs, E, M, O, R, GROUP_RED, t)) return;
  __shared__ float sA[kFK][kFM + 1];
  __shared__ float sB[kFK][kFN + 1];
  const float* const a = static_cast<const float*>(A.p);
  const float* const b =
      static_cast<const float*>(B.p) + (GROUP_RED ? 0 : t.g * sb_e);
  const int c0 = blockIdx.x * kFN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int rb = t.r0; rb < t.r1; rb += kFK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // neighbouring threads on neighbouring addresses
      const int e = tid + q * kThreads;
      int ol = A.sr == 1 ? e >> 4 : e & 63, rl = A.sr == 1 ? e & 15 : e >> 6;
      int o = t.ot + ol, r = rb + rl;
      sA[rl][ol] = o < t.ohi && r < t.r1 ? a[o * A.so + r * A.sr] : 0.f;
      ol = B.sr == 1 ? e >> 4 : e & 63;
      rl = B.sr == 1 ? e & 15 : e >> 6;
      o = c0 + ol;
      r = rb + rl;
      sB[rl][ol] = o < C && r < t.r1 ? b[o * B.so + r * B.sr] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* const y = Y + (GROUP_RED ? t.g * sy_e : 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = t.ot + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (o < t.ohi && c < C) y[o * sy_o + c] = acc[i][j];
    }
  }
}

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

template <bool GROUP_RED, bool A_RC, bool B_RC>
int launch_bf16(dim3 grid, const Operand& A, const Operand& B, long long sb_e,
                void* y, long long sy_o, long long sy_e, const int* offs, int M,
                int R, int C, int O, int E, cudaStream_t s) {
  auto kernel = gg_bf16_kernel<GROUP_RED, A_RC, B_RC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(A, B, sb_e, static_cast<bf16*>(y),
                                            sy_o, sy_e, offs, M, R, C, O, E);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// K7: y (M, C) = x (M, R) . w[g], row i of x in group g when offs[g] <= i
// < offs[g + 1]; w[g](r, c) at w + g * sw_e + r * sw_r + c * sw_c, one of
// sw_r, sw_c 1 (1 == sw_c: y = x . W[g]; 1 == sw_r: y = x . W[g]^T).  x's
// and y's rows are contiguous, row strides sx and sy.
extern "C" int grouped_gemm(const void* x, const void* w, const int* offs,
                            void* y, int M, int R, int C, int E, int is_f32,
                            long long sx, long long sw_e, long long sw_r,
                            long long sw_c, long long sy, void* stream) {
  if (M < 0 || R <= 0 || C <= 0 || E <= 0 || (sw_r != 1 && sw_c != 1))
    return kInvalid;
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand A{x, sx, 1}, B{w, sw_c, sw_r};
  // every group adds at most one partial tile; at most min(E, M) groups
  // hold a row
  const int partial = E < M ? E : M;
  if (is_f32) {
    const dim3 grid(cdiv(C, kFN), cdiv(M, kFM) + partial);
    if (grid.y > 65535) return kInvalid;
    gg_f32_kernel<false><<<grid, kThreads, 0, s>>>(
        A, B, sw_e, static_cast<float*>(y), sy, 0, offs, M, R, C, M, E);
    return static_cast<int>(cudaGetLastError());
  }
  if (R % 8 || C % 8) return kInvalid;
  const dim3 grid(cdiv(C, kBN), cdiv(M, kBM) + partial);
  if (grid.y > 65535) return kInvalid;
  return sw_c == 1
             ? launch_bf16<false, true, false>(grid, A, B, sw_e, y, sy, 0,
                                               offs, M, R, C, M, E, s)
             : launch_bf16<false, true, true>(grid, A, B, sw_e, y, sy, 0,
                                              offs, M, R, C, M, E, s);
}

// K8: dw[g] (K, N) = x[rows of g]^T . dy[rows of g], dw contiguous (E, K,
// N); x (M, K) and dy (M, N) with contiguous rows, row strides sx, sdy.
// An empty group's dw[g] is written zero.
extern "C" int grouped_gemm_dw(const void* x, const void* dy, const int* offs,
                               void* dw, int M, int K, int N, int E,
                               int is_f32, long long sx, long long sdy,
                               void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535) return kInvalid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand A{x, 1, sx}, B{dy, 1, sdy};
  const long long per = (long long)K * N;
  if (is_f32) {
    const dim3 grid(cdiv(N, kFN), cdiv(K, kFM), E);
    if (grid.y > 65535) return kInvalid;
    gg_f32_kernel<true><<<grid, kThreads, 0, s>>>(
        A, B, 0, static_cast<float*>(dw), N, per, offs, M, M, N, K, E);
    return static_cast<int>(cudaGetLastError());
  }
  if (K % 8 || N % 8) return kInvalid;
  const dim3 grid(cdiv(N, kBN), cdiv(K, kBM), E);
  if (grid.y > 65535) return kInvalid;
  return launch_bf16<true, false, false>(grid, A, B, 0, dw, N, per, offs, M,
                                         M, N, K, E, s);
}
