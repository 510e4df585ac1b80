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
// from device memory: no host read sizes a grid.
//
// Bound.  One product of dbrx-132b's prefill (d 6144, f 10752, E 16,
// k 4, T = 4 x 384, so M = 6144 rows) is 812 GFLOP, 0.82 ms at the 989
// TFLOP/s of the bf16 tensor cores, against ~2.3 GB of unique bytes (X,
// Y and 16 experts' weights; 0.69 ms at 3.35 TB/s): it is bound by its
// operations, and a second read of the weights from device memory would
// cost as much as the arithmetic.  K8 at dbrx's training shape (M =
// 16384) is 2165 GFLOP, 2.19 ms.  A decode step's product (M = 32 rows
// over ~14 of 16 experts) and every product of deepseek-v3-671b (d 7168,
// f 2048, E 256, k 8) are bound by the weights they read: each expert a
// row reaches is read once, an expert no row reaches not at all.
//
// Design (bf16): the shape of a Hopper GEMM, for three operand layouts.
//   * Output tiles of kBM x kBN = 128 x 256.  A block is three
//     warpgroups: a producer and two consumers of 64 rows each.
//     setmaxnreg hands the producer's registers to the consumers (40 and
//     232 a thread), which hold their 64 x 256 float32 sums (128 a
//     thread) in registers.
//   * One producer thread copies both operands by TMA
//     (cp.async.bulk.tensor, tensor maps made on the host for each call)
//     into a ring of kStages = 4 stages, each kBK = 64 deep in the
//     reduction: 128-byte rows, 128-byte swizzled as wgmma reads them,
//     16 KB of A and 32 KB of B a stage, 192 KB in all.  mbarriers hand
//     each stage over: full when its bytes have landed, empty when both
//     consumers are done with it.  Operands are read as they lie in
//     device memory; wgmma's transpose bits stand in for a transposing
//     copy:
//       K7 forward  X (K-major A) . W[g] (MN-major B: N contiguous)
//       dX          dY (K-major A) . W[g]^T (K-major B, the same weights
//                   through a map with W's two matrix axes swapped)
//       K8          X^T (MN-major A) . dY (MN-major B)
//     A K-major operand is one box of 64 reduction columns x its rows; an
//     MN-major one boxes of 64 contiguous outer columns x 64 reduction
//     rows, one 8 KB block a 64 columns (the wgmma descriptor's leading
//     offset steps over them).
//   * Each consumer runs wgmma.mma_async m64n256k16 with both operands in
//     shared memory, four a stage, and keeps one stage's products in
//     flight (wait_group 1) while it waits for the next stage: it frees a
//     stage once the products after it are issued.
//   * Persistent: one block an SM (the SM count from
//     cudaDeviceGetAttribute), walking tile indices blockIdx.x, + grid,
//     ...  A tile index is (group, column tile, row tile), groups in
//     order and row tiles fastest within a column tile, so the tiles in
//     flight together share W[g]'s column tile and X[g]'s rows in L2.
//     K7 builds the prefix of the groups' tile counts once a block in
//     shared memory (a warp scan of the device offsets, E <= kMaxGroups)
//     and finds a tile's group by binary search; K8's groups all have
//     ceil(K / 128) x ceil(N / 256) tiles.  The grid depends on the
//     shapes alone.  The producer runs up to four stages ahead, into the
//     next tile, so one tile's epilogue overlaps the next tile's loads.
//   * Group edges.  K7 reduces along K: rows of the next group in a
//     128-row box cost wasted products and are not stored; a consumer
//     whose 64 rows hold none of the tile's (decode: a few rows a group)
//     skips its products.  K8 reduces over a group's rows: a stage's box
//     starts at the group's row and its last stage may hold the next
//     group's rows, which the consumers zero (whole 128-byte rows of the
//     Xt and dY stages, so the swizzle does not matter) and fence to the
//     async proxy before wgmma reads them.  Rows past M and columns past
//     an operand's extent are zero-filled by the copy.  An empty group's
//     K8 tiles load nothing and write zeros.
//   * No atomics and no split of the reduction over blocks: each output
//     tile belongs to one block, which sums its reduction in one fixed
//     order, so a call repeats bit for bit.
//   * The epilogue stores bf16 pairs from the accumulator registers.
//   * The decode shapes keep the same tiles: their few rows a group waste
//     products (one consumer's, the other skipping), but they are bound
//     by the weights' bytes, which swapping A and B would not reduce.
// Reached (chip_smoke.py, H100 80GB HBM3 at 700 W): K7 at dbrx's prefill
// product 1575 us warm, 515 TFLOP/s, 1.09 x torch._grouped_mm (the
// mma.sync body it replaced: 3314 us); K8 at dbrx's training shape 4429
// us, 489 TFLOP/s, 1.37 x torch._grouped_mm's 2-D form; the decode and
// deepseek shapes 1.11-1.31 x their bytes bound, 0.93-1.13 x
// torch._grouped_mm.  Each tile streams (128 + 256) rows of 128 bytes a
// stage from L2 for 2 x 128 x 256 x 64 operations (85 a byte), so at the
// card's peak the 132 SMs would read ~11.6 TB/s from L2; sharing a stage
// between the blocks of a cluster (multicast) is the next step.
// float32 runs in full float32 on the CUDA cores (not TF32), for the
// float32 checks only: 64 x 64 tiles, 16-deep slices staged through
// shared memory, 4 x 4 outputs a thread, any strides, one tile a block.
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns the launch's CUDA error (0 on success).

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link: the
                   // encoder is fetched through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// bf16 tensor-core tiles
constexpr int kBM = 128;      // output rows a tile, 64 a consumer
constexpr int kBN = 256;      // output columns a tile
constexpr int kBK = 64;       // reduction a stage: 128-byte rows
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kBlock = 64 * 128;  // bytes of a 64-row, 128-byte-row block
constexpr int kATile = kBM * kBK * 2;
constexpr int kBTile = kBK * kBN * 2;
constexpr int kRing = kStages * (kATile + kBTile);
constexpr int kMaxGroups = 2048;  // K7's groups a call (the prefix)
// float32 CUDA-core tiles
constexpr int kFThreads = 256;
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

__device__ __forceinline__ int clamp_row(int v, int M) {
  return min(max(v, 0), M);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread arms `bar` for `bytes` of copies and arrives on it; the copies'
// completion finishes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// A TMA copy of the box at (c0, c1, c2) of a 3-D tensor map into shared
// memory, completing on `bar`; elements past the map's extents are zeros
// and count in the bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching a register that an in-flight wgmma
// reads or writes before the wait (it sees the asm as done at once).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (the
// layout the copies write): start address, the leading byte offset (lbo)
// and the stride byte offset (sbo), in 16-byte units.  K-major operands
// step over 8-row groups 1024 bytes apart (sbo; a 16-deep k-step stays
// inside one 128-byte row, so lbo is not read); MN-major ones step over
// 8-row groups along the reduction (sbo) and over their 64-column blocks
// along M or N (lbo, kBlock).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo = 1024,
                                               uint32_t sbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (m64n256, f32) += A (64x16, smem) * B (16x256, smem); TA / TB: the
// operand is MN-major (wgmma's transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// What a tile computes: group g, output rows from ot (valid below ohi),
// output columns from c0, the reduction over [r0, r1).
struct Work {
  int g, ot, ohi, c0, r0, r1;
};

// The tile at index t.  K7 (GROUP_RED false): group g has ceil(|g| / kBM)
// row tiles x nc column tiles from prefix[g] on (pre: the prefix,
// lo: the clamped offsets, both in shared memory), row tiles fastest.
// K8: every group has ceil(O / kBM) x nc tiles, the same order, and its
// rows are the reduction.
template <bool GROUP_RED>
__device__ __forceinline__ Work work_at(int t, const int* __restrict__ offs,
                                        const int* pre, const int* lo, int E,
                                        int M, int O, int R, int nc) {
  Work w;
  if (GROUP_RED) {
    const int rt = (O + kBM - 1) / kBM, per = rt * nc;
    w.g = t / per;
    const int l = t - w.g * per;
    w.ot = (l % rt) * kBM;
    w.ohi = O;
    w.c0 = (l / rt) * kBN;
    w.r0 = clamp_row(offs[w.g], M);
    w.r1 = max(w.r0, clamp_row(offs[w.g + 1], M));
    return w;
  }
  // the group whose tiles hold t: the first g with pre[g + 1] > t
  int a = 0, b = E - 1;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (pre[mid + 1] > t)
      b = mid;
    else
      a = mid + 1;
  }
  const int l = t - pre[a];
  const int rt = (lo[a + 1] - lo[a] + kBM - 1) / kBM;
  w.g = a;
  w.ot = lo[a] + (l % rt) * kBM;
  w.ohi = min(lo[a + 1], w.ot + kBM);
  w.c0 = (l / rt) * kBN;
  w.r0 = 0;
  w.r1 = R;
  return w;
}

// Y(o, c) = sum_r A(o, r) B_g(r, c) over the tiles this block walks.  A_MN
// / B_MN: the operand's outer index is contiguous (its map's first axis),
// else its reduction index is.  Y + g * sy_e (K8) or Y (K7), row stride
// sy_o, columns contiguous.
template <bool GROUP_RED, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kThreads, 1)
    gg_bf16_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   bf16* __restrict__ Y, long long sy_o, long long sy_e,
                   const int* __restrict__ offs, int M, int R, int C, int O,
                   int E) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* const gbase = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(gbase);
  const uint32_t sA = base, sB = base + kStages * kATile;
  const uint32_t bar = base + kRing;  // full[kStages], empty[kStages]
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  int* const pre = reinterpret_cast<int*>(gbase + kRing + 16 * kStages);
  int* const lo = pre + (E + 1);
  const int nc = (C + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);  // the producer's expect_tx
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int total;
  if (GROUP_RED) {
    total = E * ((O + kBM - 1) / kBM) * nc;
  } else {
    // the prefix of the groups' tile counts, by warp 0: each lane a run of
    // groups, a scan over the lanes
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int per = (E + 31) / 32;
      const int g0 = min(E, lane * per), g1 = min(E, g0 + per);
      int count = 0;
      for (int g = g0; g < g1; ++g) {
        const int a = clamp_row(offs[g], M);
        const int b = max(a, clamp_row(offs[g + 1], M));
        count += (b - a + kBM - 1) / kBM * nc;
      }
      int incl = count;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      int run = incl - count;
      for (int g = g0; g < g1; ++g) {
        const int a = clamp_row(offs[g], M);
        const int b = max(a, clamp_row(offs[g + 1], M));
        pre[g] = run;
        lo[g] = a;
        run += (b - a + kBM - 1) / kBM * nc;
      }
      if (lane == 31) {
        pre[E] = incl;
        lo[E] = clamp_row(offs[E], M);
      }
    }
  }
  __syncthreads();
  if (!GROUP_RED) total = pre[E];

  // the warpgroup, broadcast from lane 0 so the compiler sees it uniform
  // (setmaxnreg needs the roles' paths to be provably warp-uniform)
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: one thread starts every copy ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;  // stages through the ring so far
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Work w = work_at<GROUP_RED>(t, offs, pre, lo, E, M, O, R, nc);
        const int nk = (w.r1 - w.r0 + kBK - 1) / kBK;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages, ph = (it / kStages) & 1;
          mbar_wait(empty(s), ph ^ 1);  // the first round passes
          mbar_expect_tx(full(s), kATile + kBTile);
          const int r = w.r0 + kt * kBK;
          const uint32_t a = sA + s * kATile, b = sB + s * kBTile;
          if (A_MN) {  // Xt: 64 rows of the reduction x 64 columns a block
            tma_load(a, &tm_a, full(s), w.ot, r, 0);
            tma_load(a + kBlock, &tm_a, full(s), w.ot + 64, r, 0);
          } else {  // 128 rows x 64 columns of the reduction
            tma_load(a, &tm_a, full(s), r, w.ot, 0);
          }
          if (B_MN) {  // 64 rows of the reduction x 64 columns a block
#pragma unroll
            for (int j = 0; j < kBN / 64; ++j)
              tma_load(b + j * kBlock, &tm_b, full(s), w.c0 + 64 * j, r,
                       GROUP_RED ? 0 : w.g);
          } else {  // 256 rows x 64 columns of the reduction
            tma_load(b, &tm_b, full(s), r, w.c0, w.g);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of each tile each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    float acc[128];
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Work w = work_at<GROUP_RED>(t, offs, pre, lo, E, M, O, R, nc);
      const int nk = (w.r1 - w.r0 + kBK - 1) / kBK;
      // K7: a consumer with none of the tile's rows only passes the stages
      // (broadcast from lane 0: a branch around wgmma that the compiler
      // cannot see is uniform makes it serialise every wgmma)
      const bool active = __shfl_sync(
          0xffffffffu, GROUP_RED || w.ot + 64 * c < w.ohi, 0);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages, ph = (it / kStages) & 1;
        mbar_wait(full(s), ph);
        const uint32_t a = sA + s * kATile + c * kBlock;
        const uint32_t b = sB + s * kBTile;
        if (GROUP_RED && kt == nk - 1) {
          // the last stage may hold the next group's rows: zero the
          // reduction rows from v on, in this consumer's Xt block and in
          // half of the dY blocks (the other consumer zeroes the rest)
          const int v = w.r1 - (w.r0 + kt * kBK);
          if (v < kBK) {
            const int chunks = (kBK - v) * 8;  // 16-byte chunks a block
            for (int i = tid; i < 3 * chunks; i += 128) {
              const int blk = i / chunks, q = i % chunks;
              const uint32_t off =
                  (blk == 0 ? s * kATile + c * kBlock
                            : kStages * kATile + s * kBTile +
                                  (2 * c + blk - 1) * kBlock) +
                  (v + q / 8) * 128 + (q % 8) * 16;
              *reinterpret_cast<uint4*>(gbase + off) = make_uint4(0, 0, 0, 0);
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync 1, 256;\n" ::: "memory");
          }
        }
        if (active) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            const uint64_t da = A_MN ? desc_sw128(a + kk * 2048, kBlock)
                                     : desc_sw128(a + kk * 32);
            const uint64_t db = B_MN ? desc_sw128(b + kk * 2048, kBlock)
                                     : desc_sw128(b + kk * 32);
            wgmma_n256<A_MN, B_MN>(acc, da, db);
          }
          wgmma_commit();
        }
        wgmma_wait<1>();  // the stage before this one is read
        fence_regs(acc);
        if (kt > 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (nk > 0) mbar_arrive(empty(prev));
      if (!active) continue;

      // this thread's rows: row and row + 8; columns 8 n + 2 (lane % 4)
      // (+1) of every 8-column chunk n
      bf16* const y = Y + (GROUP_RED ? w.g * sy_e : 0);
      const int row = w.ot + 64 * c + 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = row + 8 * i;
        if (o >= w.ohi) continue;
        bf16* const yrow = y + o * sy_o + w.c0 + 2 * (lane % 4);
#pragma unroll
        for (int n = 0; n < 32; ++n)
          if (w.c0 + 8 * n < C)
            *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * n) =
                __floats2bfloat162_rn(acc[4 * n + 2 * i],
                                      acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a libcuda function, through the runtime (the
// library links cudart only).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map of bf16 over (n0, n1, n2), n0 contiguous, element strides s1
// and s2, boxes of 64 x rows x 1, 128-byte swizzled; elements past the
// extents read as zeros.  An empty axis is given one row (never read).
bool make_map(CUtensorMap* map, const void* base, long long n0, long long n1,
              long long n2, long long s1, long long s2, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  n1 = n1 > 0 ? n1 : 1;
  if (n2 <= 1) {
    n2 = 1;
    s2 = s1 * n1;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1) * 2,
                                 static_cast<cuuint64_t>(s2) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The driver's tensor-map encoder needs the device's context current on
// the calling thread, which a thread that has made no runtime call yet
// (autograd's backward thread) may lack: cudaSetDevice makes it current.
int bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return static_cast<int>(err);
}

// A bf16 block's shared memory: the ring, its barriers and, for K7, the
// groups' row prefix, E <= kMaxGroups (checked before the launch).
constexpr int kMaxSmem = 227 * 1024;  // a block's most, with the opt-in
constexpr int kBf16SmemBytes =
    1024 + kRing + 16 * kStages + 8 * (kMaxGroups + 1);
static_assert(kBf16SmemBytes <= kMaxSmem, "over a block's shared memory");

// Persistent: min(tiles, SMs) blocks, `tiles` a bound from the shapes.
template <bool GROUP_RED, bool A_MN, bool B_MN>
int launch_bf16(const CUtensorMap& ta, const CUtensorMap& tb, void* y,
                long long sy_o, long long sy_e, const int* offs, int M, int R,
                int C, int O, int E, long long tiles, cudaStream_t s) {
  auto kernel = gg_bf16_kernel<GROUP_RED, A_MN, B_MN>;
  const int bytes =
      1024 + kRing + 16 * kStages + (GROUP_RED ? 0 : 8 * (E + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  if (grid <= 0) return 0;
  kernel<<<grid, kThreads, bytes, s>>>(ta, tb, static_cast<bf16*>(y), sy_o,
                                       sy_e, offs, M, R, C, O, E);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

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

// K7 (group_red false): row tile blockIdx.y of the groups' tiles in
// order, found by a warp scan of the offsets; false for a block past the
// last tile.  K8 (group_red true): group blockIdx.z, whose rows are the
// reduction.  Called by every thread of the block.
__device__ bool schedule(const int* __restrict__ offs, int E, int M, int O,
                         int R, bool group_red, Tile& t) {
  if (group_red) {
    const int g = blockIdx.z;
    const int a = clamp_row(offs[g], M), b = clamp_row(offs[g + 1], M);
    t = Tile{g, static_cast<int>(blockIdx.y) * kFM, O, a, max(a, b)};
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
      count += b > a ? (b - a + kFM - 1) / kFM : 0;
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
        const int n = b > a ? (b - a + kFM - 1) / kFM : 0;
        if (y < first + n) {
          found[0] = g;
          found[1] = a + (y - first) * kFM;
          found[2] = min(b, found[1] + kFM);
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

template <bool GROUP_RED>
__global__ void __launch_bounds__(kFThreads)
    gg_f32_kernel(Operand A, Operand B, long long sb_e, float* __restrict__ Y,
                  long long sy_o, long long sy_e,
                  const int* __restrict__ offs, int M, int R, int C, int O,
                  int E) {
  Tile t;
  if (!schedule(offs, E, M, O, R, GROUP_RED, t)) return;
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
      const int e = tid + q * kFThreads;
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

}  // namespace

// K7: y (M, C) = x (M, R) . w[g], row i of x in group g when offs[g] <= i
// < offs[g + 1]; w[g](r, c) at w + g * sw_e + r * sw_r + c * sw_c, one of
// sw_r, sw_c 1 (1 == sw_c: y = x . W[g]; 1 == sw_r: y = x . W[g]^T).  x's
// and y's rows are contiguous, row strides sx and sy.  In bf16 E <=
// kMaxGroups.
extern "C" int grouped_gemm(const void* x, const void* w, const int* offs,
                            void* y, int M, int R, int C, int E, int is_f32,
                            long long sx, long long sw_e, long long sw_r,
                            long long sw_c, long long sy, void* stream) {
  if (M < 0 || R <= 0 || C <= 0 || E <= 0 || (sw_r != 1 && sw_c != 1))
    return kInvalid;
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every group adds at most one partial row tile; at most min(E, M)
  // groups hold a row
  const int partial = E < M ? E : M;
  if (is_f32) {
    const Operand A{x, sx, 1}, B{w, sw_c, sw_r};
    const dim3 grid(cdiv(C, kFN), cdiv(M, kFM) + partial);
    if (grid.y > 65535) return kInvalid;
    gg_f32_kernel<false><<<grid, kFThreads, 0, s>>>(
        A, B, sw_e, static_cast<float*>(y), sy, 0, offs, M, R, C, M, E);
    return static_cast<int>(cudaGetLastError());
  }
  if (R % 8 || C % 8 || E > kMaxGroups) return kInvalid;
  if (const int err = bind_context()) return err;
  const long long tiles =
      static_cast<long long>(cdiv(M, kBM) + partial) * cdiv(C, kBN);
  CUtensorMap ta, tb;
  if (!make_map(&ta, x, R, M, 1, sx, 0, kBM)) return kInvalid;
  if (sw_c == 1) {  // W[g] (R, C), C contiguous: MN-major B
    if (!make_map(&tb, w, C, R, E, sw_r, sw_e, kBK)) return kInvalid;
    return launch_bf16<false, false, true>(ta, tb, y, sy, 0, offs, M, R, C,
                                           M, E, tiles, s);
  }
  // W[g]^T: the reduction contiguous, K-major B
  if (!make_map(&tb, w, R, C, E, sw_c, sw_e, kBN)) return kInvalid;
  return launch_bf16<false, false, false>(ta, tb, y, sy, 0, offs, M, R, C, M,
                                          E, tiles, s);
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
  const long long per = (long long)K * N;
  if (is_f32) {
    const Operand A{x, 1, sx}, B{dy, 1, sdy};
    const dim3 grid(cdiv(N, kFN), cdiv(K, kFM), E);
    if (grid.y > 65535) return kInvalid;
    gg_f32_kernel<true><<<grid, kFThreads, 0, s>>>(
        A, B, 0, static_cast<float*>(dw), N, per, offs, M, M, N, K, E);
    return static_cast<int>(cudaGetLastError());
  }
  if (K % 8 || N % 8) return kInvalid;
  if (const int err = bind_context()) return err;
  const long long tiles =
      static_cast<long long>(E) * cdiv(K, kBM) * cdiv(N, kBN);
  if (tiles >= (1LL << 31)) return kInvalid;
  CUtensorMap ta, tb;
  if (!make_map(&ta, x, K, M, 1, sx, 0, 64) ||
      !make_map(&tb, dy, N, M, 1, sdy, 0, kBK))
    return kInvalid;
  return launch_bf16<true, true, true>(ta, tb, dw, N, per, offs, M, M, N, K,
                                       E, tiles, s);
}
