// Flash attention for Hopper (sm_90a): blocked online-softmax GQA
// attention over a whole sequence, causal or not -- the no-cache forward
// of a transformer layer (training-time evaluation, full-sequence
// scoring).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, body _flash_kernel; wrapper
// src/repro/kernels/ops.py::flash_attention).  Same function:
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D))
//                  * v[b, j, h / G]
// with, under `causal`, the scores of j > i set to -1e30 (positions by
// index from 0 for both q and kv, as the reference's mask), f32 scores,
// f32 softmax state and accumulation, normalised by max(l, 1e-30), out
// in bf16.
//
// Bound.  At the training shape (B=4, S=1024, H=Hkv=40, D=128, causal) a
// call must read Q, K, V and write O once: 4 x 41.9 MB / 3.35 TB/s =
// 50.1 us; it does 4 * B * H * D * S(S+1)/2 = 43.0 GFLOP, 43.5 us at the
// 989 TFLOP/s of the bf16 tensor cores.  The two are close, so the kernel
// must keep both the tensor cores and the memory busy, and only wgmma
// reaches the tensor cores' full rate.  What the design does about it:
//   * Work items of 128 query rows of one head: a persistent grid, one
//     block an SM, each block walking its share of the items.  Items run
//     head by head, so that the q tiles reading one head's K and V run at
//     about the same time and read them from L2 after the first (K and V
//     are 84 MB at the training shape, more than the 50 MB of L2); within a
//     head the longest rows come first.  A loop over 128-row kv tiles takes
//     the place of the TPU's sequential kv grid axis.  Under `causal` the
//     loop stops at the diagonal tile (tiles past it would add exactly 0)
//     and only tiles that cross the diagonal or the end of the sequence are
//     masked.
//   * A block is three warpgroups: a producer and two consumers of 64 query
//     rows each.  One producer thread starts TMA copies (4-D tensor maps
//     over (D, heads, S, B), boxes of 64 columns x 128 rows, rows past the
//     sequence zero-filled, 128-byte swizzled as wgmma reads them) of Q
//     into a double buffer (the next item's Q lands while this one runs)
//     and of K and V into a 2-stage ring.  mbarriers hand each tile over:
//     full when its bytes have landed, empty when both consumers are done
//     with it.  Q, K and V are read in place in the model's (B, S, H, D)
//     layout through strides: no transpose and no GQA copy; query head h
//     reads kv head h / G.
//   * Each consumer warpgroup computes S = Q K^T by wgmma m64n128k16 with
//     both operands in shared memory, runs the online softmax on the
//     accumulator registers (a row's max and sum reduce over the 4 lanes
//     that hold it; exp2 on the special-function units), rounds P to bf16
//     in registers -- the accumulator's fragment is the A fragment of the
//     next product -- and accumulates O += P V by wgmma m64nDk16 with A
//     from registers and V from shared memory (B transposed: V is
//     kv-major).  Tile j's Q K^T is started before tile j - 1's P V, so the
//     softmax of tile j runs while the tensor cores do the P V; and the
//     two consumers take turns to start their products (named barriers),
//     so one's softmax runs while the other's products run.
//   * setmaxnreg hands the producer's registers to the consumers (40 and
//     232 a thread), which hold S (64 floats), O (D / 2) and P (32 words).
//   * At D = 128: Q 2 x 32 KB, K and V 2 x 32 KB each, 192 KB of shared
//     memory, one block an SM.
//
// Plain C interface (bound with ctypes), launched on the caller's stream.
// The function returns the CUDA error of the launch (0 on success).

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link: the
                   // encoder is fetched through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 128;  // query rows a block, 64 a consumer
constexpr int kBlockN = 128;  // kv rows a tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kAtom = kBlockN * 128;  // one 64-column block of a tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kTile = kBlockN * D * 2;  // bytes; Q's too
  static constexpr int kK = 2 * kTile;           // after Q's two buffers
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // 12 barriers, and 1 KB to align the tiles to the swizzle's 1024 bytes
  static constexpr int kBytes = kBar + 128 + 1024;
};

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

// Wait until the barrier's phase differs from `parity`.  (No bounded wait
// that traps: a trap block shared by the producer's and the consumers' code
// makes ptxas allocate both at the launch's 168 registers, which spills the
// consumers and serializes their wgmma.)
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

// A TMA copy of the box at (d0, head, row0, batch) of a 4-D tensor map over
// (D, heads, S, B) into shared memory, completing on `bar`.  Rows past the
// sequence are filled with zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head),
      "r"(row0), "r"(batch)
      : "memory");
}

// 128 rows from row0 of one head into a tile: columns 64 c .. 64 c + 63 in
// block c (kAtom bytes), each box 128-byte swizzled by the copy (the
// 16-byte chunk j of row r at chunk j ^ (r % 8)), as wgmma reads it.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap* map,
                                         uint32_t bar, int head, int row0,
                                         int batch) {
  mbar_expect_tx(bar, kBlockN * D * 2);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(tile + c * kAtom, map, bar, 64 * c, head, row0, batch);
}

// The two consumer warpgroups take turns to start their products (named
// barriers 1 and 2; 0 is __syncthreads): one's softmax runs while the
// other's products occupy the tensor cores.  A turn is a sync on one's own
// barrier and, once the products are started, an arrive on the other's (256
// threads each: 128 wait, 128 arrive).
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching a register that an in-flight wgmma
// reads or writes before the wait (it sees the asm as done at once).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (the
// layout tma_tile writes): start address, the leading byte offset (lbo)
// and the stride byte offset (sbo), in 16-byte units.  K-major operands (Q,
// K) step over 8-row groups 1024 bytes apart (sbo; a 16-column k-step stays
// inside one 128-byte row, so lbo is not read); the MN-major V steps over
// them along K (sbo) and over its 64-column blocks along N (lbo, kAtom).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo = 1024,
                                               uint32_t sbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x by the special-function unit (ex2.approx, flush to zero: 2^-1e30 is
// 0, as the masked scores need).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d (m64n128, f32) (+)= A (64x16, smem) * B (16x128, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n64, f32) += A (64x16, registers) * B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += A (64x16, registers) * B (16x128, smem, MN-major);
// d0 holds columns 0..63 and d1 columns 64..127 of the accumulator.
__device__ __forceinline__ void wgmma_rs_n128(float (&d0)[32], float (&d1)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]),
        "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]),
        "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]),
        "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]),
        "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]),
        "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// P in bf16 from the float P of one tile: chunks 2 t and 2 t + 1 of the
// accumulator are k-step t's A fragment (rows g and g + 8, columns 2 t4,
// 2 t4 + 1 and + 8).
__device__ __forceinline__ void pack_p(uint32_t (&pf)[8][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pf[t][e] = pack_bf16(sc[8 * t + 2 * e], sc[8 * t + 2 * e + 1]);
}

// S = Q K^T for one kv tile, started and committed, not waited for: the 64
// rows of this warpgroup (q_rows) against the tile's 128 rows (kt), D / 16
// k-steps of 16 columns (4 a 128-byte row, then the next 64-column block).
template <int D>
__device__ __forceinline__ void start_qk(float (&sc)[64], uint32_t q_rows,
                                         uint32_t kt) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 4) * kAtom + (ks % 4) * 32;
    wgmma_ss_n128(sc, desc_sw128(q_rows + off), desc_sw128(kt + off), ks > 0);
  }
  wgmma_commit();
}

// O += P V for one kv tile, started and committed: 8 k-steps of 16 kv rows
// (2048 bytes of the tile each); at D = 128 one product spans both 64-column
// blocks of V (kAtom bytes apart).
template <int D>
__device__ __forceinline__ void start_pv(float (&acc)[D / 64][32],
                                         const uint32_t (&pf)[8][4],
                                         uint32_t vt) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if constexpr (D == 128)
      wgmma_rs_n128(acc[0], acc[1], pf[t], desc_sw128(vt + t * 2048, kAtom));
    else
      wgmma_rs_n64(acc[0], pf[t], desc_sw128(vt + t * 2048));
  }
  wgmma_commit();
}

// The online softmax of one tile's scores, in place: sc becomes P (float),
// m and l (this thread's rows, row_a and row_a + 8; l is the partial sum
// over its columns) move on, and alpha is the factor of the older sums.
// The mask applies where the tile crosses the diagonal (causal) or the
// sequence's end.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int kv0, int Skv, int causal,
                                             int row_w, int row_a, int lane,
                                             float scale_log2) {
  const bool masked =
      kv0 + kBlockN > Skv || (causal && kv0 + kBlockN - 1 > row_w);
  // the max over raw scores (scale_log2 > 0); a masked score is -inf, whose
  // exp2 is 0: the -1e30 of the reference after the row's first valid
  // score, which every row has in its first tile
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int col = kv0 + 8 * n + 2 * (lane % 4) + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        if (col >= Skv || (causal && col > row)) sc[4 * n + e] = -CUDART_INF_F;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
    }
  }
  float rs[2] = {0.f, 0.f}, neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    alpha[i] = exp2_approx(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
  }
#pragma unroll
  for (int n = 0; n < 64; ++n) {
    const float p = exp2_approx(fmaf(sc[n], scale_log2, neg_m[(n >> 1) & 1]));
    sc[n] = p;
    rs[(n >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// The q tile, head and batch of work item `item`: items run head by head
// (the q tiles of a head, and the heads of a kv head, next to each other,
// so that a head's K and V are read from device memory about once and then
// from L2), within a head the longest rows first.
struct Item {
  int q0, h, b, n_kt;
};

__device__ __forceinline__ Item item_at(int item, int n_qt, int H, int Skv,
                                        int causal) {
  const int hb = item / n_qt, rank = item % n_qt;
  Item it;
  it.q0 = (n_qt - 1 - rank) * kBlockM;
  it.h = hb % H;
  it.b = hb / H;
  // kv tiles this q tile sees: under `causal`, up to its last row
  const int kv_end = causal ? min(Skv, it.q0 + kBlockM) : Skv;
  it.n_kt = (kv_end + kBlockN - 1) / kBlockN;
  return it;
}

// The r-th item of this block: rounds of gridDim.x items, the block's place
// in a round reversed every other round (a snake), so that each block's
// share of long and short items evens out (at the training shape the
// busiest block has 45 kv tiles to the mean's 43.6).
__device__ __forceinline__ int block_item(int r) {
  const int g = gridDim.x, k = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - k : k);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ o, int B, int H, int Sq, int Skv,
                       int G, int causal, int64_t o_sb, int64_t o_ss,
                       int64_t o_sh, float scale_log2) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + S::kK, sV = base + S::kV;
  // barriers, two of each: Q full, Q empty (its buffer, one a work item,
  // alternating), K full, V full, K empty, V empty (the ring's stages)
  const uint32_t bar = base + S::kBar;
  auto bar_q_full = [&](int s) { return bar + 8 * s; };
  auto bar_q_empty = [&](int s) { return bar + 8 * (2 + s); };
  auto bar_k_full = [&](int s) { return bar + 8 * (4 + s); };
  auto bar_v_full = [&](int s) { return bar + 8 * (6 + s); };
  auto bar_k_empty = [&](int s) { return bar + 8 * (8 + s); };
  auto bar_v_empty = [&](int s) { return bar + 8 * (10 + s); };

  const int n_qt = (Sq + kBlockM - 1) / kBlockM;
  const int n_items = n_qt * H * B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_q_full(s), 1);  // the producer's expect_tx
      mbar_init(bar_q_empty(s), 256);
      mbar_init(bar_k_full(s), 1);
      mbar_init(bar_v_full(s), 1);
      mbar_init(bar_k_empty(s), 256);
      mbar_init(bar_v_empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so the compiler sees it uniform
  // (setmaxnreg needs the roles' paths to be provably warp-uniform)
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: per item Q, then its K and V tiles through the ring --
    // One thread starts every copy; the others only give up registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int t = 0;  // tiles through the ring so far
      for (int r = 0;; ++r) {
        const int item = block_item(r);
        if (item >= n_items) break;
        const Item w = item_at(item, n_qt, H, Skv, causal);
        const int qs = r & 1, hk = w.h / G;
        mbar_wait(bar_q_empty(qs), ((r >> 1) & 1) ^ 1);  // rounds 0, 1 pass
        tma_tile<D>(sQ + qs * S::kTile, &tm_q, bar_q_full(qs), w.h, w.q0,
                    w.b);
        for (int j = 0; j < w.n_kt; ++j, ++t) {
          const int s = t % kStages, ph = (t / kStages) & 1;
          mbar_wait(bar_k_empty(s), ph ^ 1);  // the first round passes
          tma_tile<D>(sK + s * S::kTile, &tm_k, bar_k_full(s), hk,
                      j * kBlockN, w.b);
          mbar_wait(bar_v_empty(s), ph ^ 1);
          tma_tile<D>(sV + s * S::kTile, &tm_v, bar_v_full(s), hk,
                      j * kBlockN, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows of each item each ---------------------
    // Tile j's S = Q K^T is started before tile j - 1's O += P V, so the
    // softmax of tile j runs while the tensor cores do tile j - 1's P V.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int kDBlocks = D / 64;
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    float acc[kDBlocks][32];
    float sc[64];
    uint32_t pf[8][4];
    int t = 0;  // tiles through the ring so far
    if (c == 1) turn_pass(c);  // the first turn is consumer 0's
    for (int r = 0;; ++r) {
      const int item = block_item(r);
      if (item >= n_items) break;
      const Item w = item_at(item, n_qt, H, Skv, causal);
      const int qs = r & 1;
      // this thread's rows: row_a and row_a + 8; columns 8 n + 2 (lane % 4)
      // (+1) of every 8-column chunk n of an accumulator
      const int row_w = w.q0 + 64 * c;
      const int row_a = row_w + 16 * warp + lane / 4;
      const uint32_t q_rows = sQ + qs * S::kTile + c * 64 * 128;
#pragma unroll
      for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[db][i] = 0.f;
      float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, alpha[2];
      mbar_wait(bar_q_full(qs), (r >> 1) & 1);

      // tile 0: S, its softmax (O is still 0), P
      int s = t % kStages, ph = (t / kStages) & 1;
      mbar_wait(bar_k_full(s), ph);
      turn_wait(c);
      start_qk<D>(sc, q_rows, sK + s * S::kTile);
      turn_pass(c);
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(bar_k_empty(s));
      softmax_tile(sc, m_r, l_r, alpha, 0, Skv, causal, row_w, row_a, lane,
                   scale_log2);
      pack_p(pf, sc);
      for (int j = 1; j < w.n_kt; ++j) {
        const int sp = s, php = ph;  // tile j - 1's stage
        ++t;
        s = t % kStages;
        ph = (t / kStages) & 1;
        mbar_wait(bar_k_full(s), ph);
        mbar_wait(bar_v_full(sp), php);
          turn_wait(c);
        start_qk<D>(sc, q_rows, sK + s * S::kTile);
        start_pv<D>(acc, pf, sV + sp * S::kTile);
        turn_pass(c);
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(sc);  // S of tile j is in; P V of tile j - 1 runs on
        mbar_arrive(bar_k_empty(s));
        softmax_tile(sc, m_r, l_r, alpha, j * kBlockN, Skv, causal, row_w,
                     row_a, lane, scale_log2);
        wgmma_wait_all();  // tile j - 1's P V is done: its V and P are free
#pragma unroll
        for (int db = 0; db < kDBlocks; ++db) fence_regs(acc[db]);
        fence_regs(pf);
        mbar_arrive(bar_v_empty(sp));
#pragma unroll
        for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
          for (int n = 0; n < 32; ++n) acc[db][n] *= alpha[(n >> 1) & 1];
        pack_p(pf, sc);
      }
      // the last tile's P V; then Q's buffer is free for the item after next
      mbar_wait(bar_v_full(s), ph);
      turn_wait(c);
      start_pv<D>(acc, pf, sV + s * S::kTile);
      turn_pass(c);
      wgmma_wait_all();
#pragma unroll
      for (int db = 0; db < kDBlocks; ++db) fence_regs(acc[db]);
      fence_regs(pf);
      mbar_arrive(bar_v_empty(s));
      mbar_arrive(bar_q_empty(qs));
      ++t;

      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
        inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
      }
      bf16* ob = o + w.b * o_sb + w.h * o_sh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_a + i * 8;
        if (row < Sq) {
          bf16* orow = ob + row * o_ss + 2 * (lane % 4);
#pragma unroll
          for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
            for (int n = 0; n < 8; ++n)
              *reinterpret_cast<uint32_t*>(orow + db * 64 + 8 * n) =
                  pack_bf16(acc[db][4 * n + 2 * i] * inv[i],
                            acc[db][4 * n + 2 * i + 1] * inv[i]);
        }
      }
    }
    if (c == 0) turn_wait(c);  // consumer 1's last pass
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

// A 4-D map over (D, heads, S, B) of bf16 with the given element strides
// (seq, head, batch), boxes of 64 columns x 1 head x 128 rows x 1 batch,
// 128-byte swizzled; rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* base, int D, int heads, int S,
              int B, int64_t s_seq, int64_t s_head, int64_t s_batch) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_seq) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, 1, kBlockN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Skv, int causal, const int64_t* st,
           float scale_log2, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, D, H, Sq, B, st[1], st[2], st[0]) ||
      !make_map(&tm_k, k, D, Hkv, Skv, B, st[4], st[5], st[3]) ||
      !make_map(&tm_v, v, D, Hkv, Skv, B, st[7], st[8], st[6]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Smem<D>::kBytes;
  // above 48 KB only as opted-in dynamic shared memory; set at every
  // launch (the attribute is per device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block an SM, each walking its share of the items
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t n_items =
      static_cast<int64_t>((Sq + kBlockM - 1) / kBlockM) * H * B;
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), B, H, Sq, Skv, H / Hkv,
      causal, st[9], st[10], st[11], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), o (B, Sq, H, D), bf16, unit last
// stride, rows 16-byte aligned; strides in elements: q, k, v, o each
// (batch, seq, head).
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Skv, int D, int causal, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0 ||
      static_cast<int64_t>((Sq + kBlockM - 1) / kBlockM) * H * B >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, st,
                       scale_log2, s);
  if (D == 64)
    return launch<64>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, st,
                      scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
