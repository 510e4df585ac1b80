// Fused dense-retrieval score + top-k for Hopper (sm_90a): the score tiles
// on the tensor cores (wgmma) with float32 accuracy, one launch with the
// merge fused.
//
// Replaces the TPU kernel src/repro/kernels/dense_topk.py
// (_dense_topk_padded; body _dense_topk_kernel, merge _merge_topk).  Same
// function: for each query q, the k docs d of the largest
// s[q, d] = q[q, :] . docs[d, :] in float32, scores descending, exact
// score ties to the lower doc id (lax.top_k order).  The (Q, D) score
// matrix never exists in device memory.
//
// Bound: the corpus is read once, D * E * 4 bytes over 3.35 TB/s; the
// products, 2 Q D E flops three times over (three TF32 products per
// float32 product, below) on the 495 TFLOP/s TF32 tensor cores, take
// less (Q = 64, E = 256: 20.5 MB, 6.13 us against 3.97 us at D = 20,000;
// 1.07 GB, 320.5 us against 208 us at D = 1,048,576).  So the call is
// bound by its bytes.  What the design does:
//   * Products on the tensor cores with float32 accuracy (3xTF32): each
//     float32 operand x is split into hi = x with the low 13 mantissa
//     bits cleared (a TF32 value) and lo = the TF32 truncation of x - hi
//     (x - hi is exact); q . d is the sum of the TF32 products lo_q hi_d,
//     hi_q lo_d and hi_q hi_d, smallest first, by wgmma m64n64k8 with the
//     64 queries (A) in registers and the 64 docs (B) in shared memory.
//     Each 32-column chunk of the embedding is summed in a fresh
//     tensor-core accumulator and added to the running float32 sum with
//     an ordinary add, so at most 12 products are ever summed inside the
//     tensor core (it rounds toward zero).  Emulated on the host
//     (tests/test_torch_dense_topk.py) this holds 1e-5 of float64 at E =
//     256 and 768 by a wide margin.  Every doc goes through the same
//     instructions in the same order, so equal doc rows give bitwise-equal
//     scores wherever they sit, and an exact tie goes to the lower id.
//   * One block per (64-query tile, slice of the doc axis), one per SM:
//     the doc axis is cut into 64-doc tiles and each slice takes a
//     contiguous run of them, the runs differing by at most one tile.
//     The block stages its query tile once, as float32 rows.  Two
//     warpgroups (one where shared memory holds only one ring: large E)
//     take the slice's tiles in turn, each with its own ring of cp.async
//     stages, its own running lists and named barriers, so that one's
//     selection overlaps the other's copies and products.  A stage is 64
//     docs x 64 columns for k <= 16 where two rings of 3 fit (half the
//     stages, waits and barriers a byte; the registers of k > 16 do not
//     allow the wider query fragments), else 64 x 32, up to 10 in
//     flight; 128-byte rows swizzled as wgmma reads them.  A stage's
//     products are started at the top of its pass of the loop and read
//     at its end; meanwhile the next stage is waited for and split once,
//     in place into hi and into one of two lo buffers.  (Products started
//     in one pass and read in the next, or behind a branch that depends
//     on the thread, made ptxas serialize or wait on them.)  The query
//     fragments are split in registers as ldmatrix reads them.  The three
//     products read a stage three times, so shared memory moves about 8
//     bytes for every corpus byte: with the tensor cores' time, a floor of
//     this design above the byte bound.
//   * Warp w of a warpgroup owns queries 16 w .. 16 w + 15 and every doc
//     of a tile (the wgmma accumulator layout): the four lanes of a quad
//     hold all 64 scores of two queries, 16 each.  The running top-k of
//     each query lives in the quad's registers, sorted by the total order
//     (score desc, id asc): entry p in lane p % 4, register p / 4, kSlots
//     = 16, 32 or 64 entries for k <= 16, 32, 64.  A tile's score is
//     offered only if it beats entry k - 1.  When the survivors of every
//     query of a warp are few they are inserted one by one (a quad count
//     and a one-place shift); otherwise the tile's 64 candidates are sorted
//     in registers by a bitonic network (in-register steps, two quad
//     shuffle steps) and folded into the list by one bitonic merge.  The
//     two queries of a quad take turns through one copy of this code
//     (two at once spilled registers).
//   * The merge is fused: the warpgroups' lists are folded in the block,
//     every block writes its lists, the grid meets at a barrier (a
//     cooperative launch, so all blocks are resident; two counters the
//     last block leaves at zero; a wait past about a second traps rather
//     than hangs), and then query j of a query tile is merged by slice
//     j % S: its S lists are staged in shared memory, each quad folds a
//     share, the quads of a warp merge by butterfly shuffles and the warps
//     in a tree.  The result is the top k of the same set of entries under
//     a total order, so it does not depend on which block finished first.
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns cudaGetLastError() after the one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math_constants.h>

#include <climits>

namespace {

constexpr int kWG = 128;                 // threads a warpgroup
constexpr int kQT = 16 * kWG / 32;       // queries a block: 16 a warp
constexpr int kDT = 64;                  // docs a tile
constexpr int kAtom = 32;  // columns of a 128-byte swizzle atom row
constexpr int kMaxStages = 10;          // a warpgroup's ring
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;
  const float* docs;
  float* list_s;  // every block's lists: (q tile, slice, kQT, kSlots + 4)
  int* list_i;
  int* bar;       // the grid barrier's two counters, zero between launches
  float* out_s;
  int* out_i;
  int Q, D, E, k;
  int S;          // slices of the doc axis a query tile
  int qs;         // floats a staged query row
  int stages;     // ring stages a warpgroup
  int smem;       // dynamic shared memory bytes
  int n_wg;       // warpgroups a block: 1 or 2
};

__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
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
// Waits until at most n (0 .. kMaxStages - 2) groups are in flight.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    default: cp_async_wait<9>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// Shared-memory descriptor of a K-major, 128-byte-swizzled operand: 8-row
// groups 1024 bytes apart (sbo); an 8-column TF32 k-step (32 bytes) stays
// inside one 128-byte row, so the leading offset is not read.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (m64n64, f32) (+)= A (64 x 8 TF32, registers) * B (64 x 8 TF32, smem,
// K-major); d is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// hi keeps the top 10 mantissa bits of x (a TF32 value); lo is the TF32
// truncation of x - hi, which is exact in float32.
__device__ __forceinline__ uint32_t tf32_hi(uint32_t x) {
  return x & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_lo(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) -
                         __uint_as_float(tf32_hi(x))) &
         0xffffe000u;
}

// Columns e0 .. e0 + kCC - 1 of docs d0 .. d0 + 63 into a ring stage:
// kCC / 32 swizzle atoms of 64 rows, row r of an atom at r * 128 bytes,
// its 16-byte piece c at piece c ^ (r % 8) (wgmma's 128-byte swizzle).
// Rows past D are left as they are (their scores are never offered);
// columns past E are zeroed, so that every chunk runs the same k-steps.
template <int kCC>
__device__ __forceinline__ void stage_docs(float* buf,
                                           const float* __restrict__ docs,
                                           int D, int E, int d0, int e0,
                                           int t) {
  constexpr int kP = kCC / 4;  // 16-byte pieces a row
  const int w = min(kCC, E - e0);
#pragma unroll
  for (int l = 0; l < kDT * kP / kWG; ++l) {
    const int i = t + l * kWG, r = i / kP, c = i % kP;
    if (4 * c < w && d0 + r < D)
      cp_async16(buf + (c >> 3) * kDT * kAtom + r * kAtom +
                     4 * ((c & 7) ^ (r & 7)),
                 docs + (int64_t)(d0 + r) * E + e0 + 4 * c);
  }
  if (w < kCC)  // the chunk past E is zero (so is the query tile's)
    for (int i = t; i < kDT * (kCC - w) / 4; i += kWG) {
      const int r = i / ((kCC - w) / 4), c = w / 4 + i % ((kCC - w) / 4);
      *reinterpret_cast<float4*>(buf + (c >> 3) * kDT * kAtom + r * kAtom +
                                 4 * ((c & 7) ^ (r & 7))) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// Barrier of one warpgroup (named barrier 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWG) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block of the grid (resident together: a cooperative launch)
// waits here until all have arrived; what each wrote before is visible
// to all after.  bar[1] counts the blocks past the barrier, and the last
// of them sets both counters back to zero for the next launch.
__device__ __forceinline__ void grid_barrier(int* bar, int n_blocks) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(bar, 1);
    // a cooperative launch cannot leave a block waiting; a broken one
    // fails after about a second instead of hanging the card
    for (int spin = 0; ld_acquire(bar) < n_blocks; ++spin) {
      if (spin > (1 << 24)) __trap();
      __nanosleep(64);
    }
    if (atomicAdd(bar + 1, 1) == n_blocks - 1) {
      bar[0] = 0;
      bar[1] = 0;
    }
  }
  __syncthreads();
  __threadfence();
}

__device__ __forceinline__ void swap_entry(float& as, int& ai, float& bs,
                                           int& bi) {
  const float s = as;
  const int i = ai;
  as = bs;
  ai = bi;
  bs = s;
  bi = i;
}

// Compare-exchange: afterwards (a, b) are in the total order's order if
// desc, reversed otherwise.  Entries are distinct but for the empty entry,
// and two empty entries swapped are the same, so one comparison does.
__device__ __forceinline__ void cex(float& as, int& ai, float& bs, int& bi,
                                    bool desc) {
  const bool sw = better(bs, bi, as, ai) == desc;
  const float ts = sw ? bs : as;
  const int ti = sw ? bi : ai;
  bs = sw ? as : bs;
  bi = sw ? ai : bi;
  as = ts;
  ai = ti;
}

// One step across lanes: this lane and lane ^ x hold a pair of positions
// in the same registers; this lane keeps the better entry of each pair
// when keep_better, the worse otherwise.
template <int N>
__device__ __forceinline__ void quad_step(float (&s)[N], int (&i)[N], int x,
                                          bool keep_better) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float os = __shfl_xor_sync(kFull, s[r], x);
    const int oi = __shfl_xor_sync(kFull, i[r], x);
    if (better(os, oi, s[r], i[r]) == keep_better) {
      s[r] = os;
      i[r] = oi;
    }
  }
}

// Sorts the quad's 64 entries descending; entry p = 16 qd + r is register
// r of lane qd.  Steps within 16 positions stay in registers; the three
// steps across 16 and 32 positions are quad shuffles.
__device__ __forceinline__ void sort64(float (&s)[16], int (&i)[16],
                                       int qd) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      if (d >= 16) {
        const int x = d >> 4;
        const bool desc = ((16 * qd) & size) == 0;
        quad_step<16>(s, i, x, ((qd & x) == 0) == desc);
      } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (r & d) continue;
          cex(s[r], i[r], s[r | d], i[r | d], ((16 * qd + r) & size) == 0);
        }
      }
    }
  }
}

// Folds C into the quad's list (entry p = 4 r + qd in register r): given
// c[r] = C[kSlots - 1 - p] of a list C sorted descending, keeps the top
// kSlots of both, sorted (one elementwise pick, then a bitonic merge).
template <int kR>
__device__ __forceinline__ void merge_rev(float (&ls)[kR], int (&li)[kR],
                                          const float (&cs)[kR],
                                          const int (&ci)[kR], int qd) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (better(cs[r], ci[r], ls[r], li[r])) {
      ls[r] = cs[r];
      li[r] = ci[r];
    }
#pragma unroll
  for (int dr = kR >> 1; dr > 0; dr >>= 1)
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (!(r & dr)) cex(ls[r], li[r], ls[r | dr], li[r | dr], true);
  quad_step<kR>(ls, li, 2, (qd & 2) == 0);
  quad_step<kR>(ls, li, 1, (qd & 1) == 0);
}

// Inserts x (the same in all four lanes of the quad) into the quad's
// sorted list when `active`; the last entry drops out.
template <int kR>
__device__ __forceinline__ void insert(float (&ls)[kR], int (&li)[kR],
                                       float xs, int xi, bool active,
                                       int lane) {
  const int qd = lane & 3;
  int pos = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) pos += better(ls[r], li[r], xs, xi);
  pos += __shfl_xor_sync(kFull, pos, 1);
  pos += __shfl_xor_sync(kFull, pos, 2);
  // entry p - 1 of each of this lane's entries p
  const int src = (lane & ~3) | ((qd + 3) & 3);
  float gs[kR];
  int gi[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    gs[r] = __shfl_sync(kFull, ls[r], src);
    gi[r] = __shfl_sync(kFull, li[r], src);
  }
  if (!active) return;
#pragma unroll
  for (int r = kR - 1; r >= 0; --r) {
    const int p = 4 * r + qd;
    const float ps = qd ? gs[r] : gs[r > 0 ? r - 1 : 0];
    const int pi = qd ? gi[r] : gi[r > 0 ? r - 1 : 0];
    if (p == pos) {
      ls[r] = xs;
      li[r] = xi;
    } else if (p > pos) {
      ls[r] = ps;
      li[r] = pi;
    }
  }
}

// Entry k - 1 of the quad's list, in all four lanes.
template <int kR>
__device__ __forceinline__ void kth(const float (&ls)[kR], const int (&li)[kR],
                                    int k, int lane, float& ts, int& ti) {
  const int r = (k - 1) >> 2;
  float v = ls[0];
  int w = li[0];
#pragma unroll
  for (int j = 1; j < kR; ++j)
    if (r == j) {
      v = ls[j];
      w = li[j];
    }
  const int src = (lane & ~3) | ((k - 1) & 3);
  ts = __shfl_sync(kFull, v, src);
  ti = __shfl_sync(kFull, w, src);
}

// Doc column of register r of this lane's 16 scores of a query (the
// accumulator layout: n8 block r / 2, column 2 qd + r % 2).
__device__ __forceinline__ int col_of(int r, int qd) {
  return 8 * (r >> 1) + 2 * qd + (r & 1);
}

// Offers one query's 16 scores `c` (this lane's part of a 64-doc tile at
// d0) to its list.  Warp-uniform: every lane calls it for the same h.
template <int kSlots>
__device__ __forceinline__ void offer_tile(float (&ls)[kSlots / 4],
                                           int (&li)[kSlots / 4], float& ts,
                                           int& ti, const float (&c)[16],
                                           bool qvalid, int d0, int D, int k,
                                           int lane) {
  constexpr int kR = kSlots / 4;
  constexpr int kSparse = kSlots == 64 ? 6 : 10;  // one-by-one up to this
  const int qd = lane & 3;
  unsigned m = 0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int id = d0 + col_of(r, qd);
    if (qvalid && id < D && better(c[r], id, ts, ti)) m |= 1u << r;
  }
  int n = __popc(m);
  n += __shfl_xor_sync(kFull, n, 1);
  n += __shfl_xor_sync(kFull, n, 2);
  const unsigned most = __reduce_max_sync(kFull, static_cast<unsigned>(n));
  if (most == 0) return;
  if (most > kSparse) {
    float s[16];
    int ix[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const bool on = (m >> r) & 1u;
      s[r] = on ? c[r] : -CUDART_INF_F;
      ix[r] = on ? d0 + col_of(r, qd) : INT_MAX;
    }
    sort64(s, ix, qd);
    // the top kSlots, reversed, into the list's layout: entry
    // q = kSlots - 1 - (4 r + qd) is register q % 16 of lane q / 16
    float cs[kR];
    int ci[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      cs[r] = -CUDART_INF_F;
      ci[r] = INT_MAX;
    }
    const int base = lane & ~3;
#pragma unroll
    for (int sl = 0; sl < kSlots / 16; ++sl)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float v = __shfl_sync(kFull, s[j], base | sl);
        const int w = __shfl_sync(kFull, ix[j], base | sl);
        if (qd == 3 - (j & 3)) {
          cs[kR - 1 - 4 * sl - (j >> 2)] = v;
          ci[kR - 1 - 4 * sl - (j >> 2)] = w;
        }
      }
    merge_rev<kR>(ls, li, cs, ci, qd);
    kth<kR>(ls, li, k, lane, ts, ti);
    return;
  }
  while (true) {
    const unsigned have = __ballot_sync(kFull, m != 0);
    if (!have) break;
    const unsigned quad = (have >> (lane & ~3)) & 0xfu;
    const int src = quad ? __ffs(quad) - 1 : 0;
    float xs = 0.f;
    int xi = 0;
    if (m) {
      const int r = __ffs(m) - 1;
      xs = c[0];
#pragma unroll
      for (int j = 1; j < 16; ++j)
        if (r == j) xs = c[j];
      xi = d0 + col_of(r, qd);
    }
    xs = __shfl_sync(kFull, xs, (lane & ~3) | src);
    xi = __shfl_sync(kFull, xi, (lane & ~3) | src);
    if (quad && qd == src) m &= m - 1;
    insert<kR>(ls, li, xs, xi, quad != 0, lane);
    kth<kR>(ls, li, k, lane, ts, ti);
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (((m >> r) & 1u) && !better(c[r], d0 + col_of(r, qd), ts, ti))
        m &= ~(1u << r);
  }
}

template <int kSlots, int kCC>
__global__ void __launch_bounds__(2 * kWG, 1)
dense_topk_kernel(const Params p) {
  constexpr int kStageFloats = kDT * kCC;
  constexpr int kR = kSlots / 4;
  constexpr int kLS = kSlots + 4;  // floats a stored list row (padded)
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_wg = blockDim.x / kWG, wg = tid / kWG, t = tid % kWG;
  const int warp = t >> 5;  // within the warpgroup: queries 16 warp ..
  const int g = lane >> 2, qd = lane & 3;
  const int slice = blockIdx.x, qt = blockIdx.y;
  const int q0 = qt * kQT;
  // [kQT][qs] query tile, then (1024-byte aligned) each warpgroup's ring
  // of stages and the lo copy of its stage in use
  float* const Qs = smem;
  const uint32_t qs_end = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + kQT * p.qs));
  float* const rings =
      smem + kQT * p.qs + ((1024 - (qs_end & 1023)) & 1023) / 4;
  float* const ring = rings + wg * (p.stages + 2) * kStageFloats;
  float* const lo_buf = ring + p.stages * kStageFloats;  // two, in turn
  // the slice's tiles t0 .. t1 - 1, warpgroup wg taking every n_wg-th
  const int n_tiles = (p.D + kDT - 1) / kDT;
  const int t0 = static_cast<int>((int64_t)slice * n_tiles / p.S);
  const int t1 = static_cast<int>((int64_t)(slice + 1) * n_tiles / p.S);
  const int n_ec = (p.E + kCC - 1) / kCC;
  const int steps = max(0, (t1 - t0 - wg + n_wg - 1) / n_wg) * n_ec;
  const auto doc0 = [&](int it) { return (t0 + wg + it / n_ec * n_wg) * kDT; };

  // the query tile, rows past Q and the columns past E of the last chunk
  // zero
  {
    const int e4 = p.E / 4;
    for (int i = tid; i < kQT * e4; i += blockDim.x) {
      const int r = i / e4, c = 4 * (i % e4);
      float* const dst = Qs + r * p.qs + c;
      if (q0 + r < p.Q)
        cp_async16(dst, p.q + (int64_t)(q0 + r) * p.E + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int pad4 = (n_ec * kCC - p.E) / 4;
    for (int i = tid; i < kQT * pad4; i += blockDim.x)
      *reinterpret_cast<float4*>(Qs + (i / pad4) * p.qs + p.E +
                                 4 * (i % pad4)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    cp_async_commit();
  }
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < steps)
      stage_docs<kCC>(ring + s * kStageFloats, p.docs, p.D, p.E, doc0(s),
                      (s % n_ec) * kCC, t);
    cp_async_commit();
  }

  float ls[2][kR], ts[2];
  int li[2][kR], ti[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      ls[h][r] = -CUDART_INF_F;
      li[h][r] = INT_MAX;
    }
    ts[h] = -CUDART_INF_F;
    ti[h] = INT_MAX;
  }
  const float* const qrow =
      Qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * p.qs +
      4 * (lane >> 4);
  // Stage i: hi in place in ring slot i % stages, lo in lo[i % 2].
  const auto split_stage = [&](int i) {
    float* const buf = ring + (i % p.stages) * kStageFloats;
    float* const lo = lo_buf + (i & 1) * kStageFloats;
    constexpr int kN = kStageFloats / 4 / kWG;
    uint4 x[kN];
#pragma unroll
    for (int l = 0; l < kN; ++l)
      x[l] = reinterpret_cast<const uint4*>(buf)[t + l * kWG];
#pragma unroll
    for (int l = 0; l < kN; ++l) {
      reinterpret_cast<uint4*>(lo)[t + l * kWG] =
          make_uint4(tf32_lo(x[l].x), tf32_lo(x[l].y), tf32_lo(x[l].z),
                     tf32_lo(x[l].w));
      reinterpret_cast<uint4*>(buf)[t + l * kWG] =
          make_uint4(tf32_hi(x[l].x), tf32_hi(x[l].y), tf32_hi(x[l].z),
                     tf32_hi(x[l].w));
    }
  };
  // the query fragments of stage i's chunk, split in registers
  uint32_t ahi[kCC / 8][4], alo[kCC / 8][4];
  const auto load_a = [&](int i) {
    const int e0 = (i % n_ec) * kCC;
#pragma unroll
    for (int ks = 0; ks < kCC / 8; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, qrow + e0 + 8 * ks);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ahi[ks][c] = tf32_hi(a[c]);
        alo[ks][c] = tf32_lo(a[c]);
      }
    }
  };
  float acc[32], run[32];
  // stage i's products into acc, started and left running
  const auto start_products = [&](int i) {
    const uint32_t hi_addr = static_cast<uint32_t>(
        __cvta_generic_to_shared(ring + (i % p.stages) * kStageFloats));
    const uint32_t lo_addr = static_cast<uint32_t>(
        __cvta_generic_to_shared(lo_buf + (i & 1) * kStageFloats));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kCC / 8; ++ks) {
      // k-step ks: atom ks / 4, 32 bytes a k-step within its rows
      const uint32_t off = (ks >> 2) * kDT * kAtom * 4 + 32 * (ks & 3);
      wgmma_tf32(acc, alo[ks], desc_sw128(hi_addr + off), ks > 0);
      wgmma_tf32(acc, ahi[ks], desc_sw128(lo_addr + off), 1);
      wgmma_tf32(acc, ahi[ks], desc_sw128(hi_addr + off), 1);
    }
    wgmma_commit();
  };

  cp_async_wait_dyn(p.stages - 2);  // the query tile and stage 0 landed
  __syncthreads();
  if (steps > 0) {
    split_stage(0);
    load_a(0);
    // generic-proxy stores, read next by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);
  }
  for (int it = 0; it < steps; ++it) {
    // stage it's products run while the next stage is copied and split;
    // they are started and read in the same pass of the loop
    start_products(it);
    {
      const int nx = it + p.stages - 1;  // into the slot stage it - 1 left
      if (nx < steps)
        stage_docs<kCC>(ring + (nx % p.stages) * kStageFloats, p.docs, p.D,
                        p.E, doc0(nx), (nx % n_ec) * kCC, t);
      cp_async_commit();
    }
    const bool more = it + 1 < steps;
    if (more) {
      cp_async_wait_dyn(p.stages - 2);
      wg_sync(wg);  // stage it + 1 landed, every thread's copies
      split_stage(it + 1);
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);
    const int chunk = it % n_ec;
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j) run[j] = acc[j];
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) run[j] += acc[j];
    }
    if (chunk == n_ec - 1) {
      // the tile's scores, offered to the lists of the warp's two
      // queries; one copy of the code, the second query's state swapped in
      const int d0 = doc0(it);
      float c[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 16; ++r)
          c[h][r] = run[4 * (r >> 1) + 2 * h + (r & 1)];
      bool qvalid[2] = {q0 + 16 * warp + g < p.Q,
                        q0 + 16 * warp + g + 8 < p.Q};
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        offer_tile<kSlots>(ls[0], li[0], ts[0], ti[0], c[0], qvalid[0], d0,
                           p.D, p.k, lane);
#pragma unroll
        for (int r = 0; r < kR; ++r)
          swap_entry(ls[0][r], li[0][r], ls[1][r], li[1][r]);
        swap_entry(ts[0], ti[0], ts[1], ti[1]);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float x = c[0][r];
          c[0][r] = c[1][r];
          c[1][r] = x;
        }
        const bool v = qvalid[0];
        qvalid[0] = qvalid[1];
        qvalid[1] = v;
      }
    }
    if (more) {
      load_a(it + 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free from here

  if (n_wg == 2) {  // warpgroup 1's lists folded into warpgroup 0's
    float* const x_s = rings;  // [kQT][kSlots]
    int* const x_i = reinterpret_cast<int*>(rings + kQT * kSlots);
    if (wg == 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int at = (16 * warp + g + 8 * h) * kSlots + 4 * r + qd;
          x_s[at] = ls[h][r];
          x_i[at] = li[h][r];
        }
    __syncthreads();
    if (wg == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cs[kR];
        int ci[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int at =
              (16 * warp + g + 8 * h) * kSlots + kSlots - 1 - (4 * r + qd);
          cs[r] = x_s[at];
          ci[r] = x_i[at];
        }
        merge_rev<kR>(ls[h], li[h], cs, ci, qd);
      }
  }

  if (p.S == 1) {  // the block saw the whole doc axis
    if (wg == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = q0 + 16 * warp + g + 8 * h;
        if (qi >= p.Q) continue;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int pos = 4 * r + qd;
          if (pos < p.k) {
            p.out_s[(int64_t)qi * p.k + pos] = ls[h][r];
            p.out_i[(int64_t)qi * p.k + pos] = li[h][r];
          }
        }
      }
    return;
  }

  // the fused merge: every block's lists out, then one block a query
  if (wg == 0) {
    const int64_t slot = (int64_t)qt * p.S + slice;
    float* const Ls = p.list_s + slot * kQT * kLS;
    int* const Li = p.list_i + slot * kQT * kLS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (16 * warp + g + 8 * h) * kLS;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        Ls[row + 4 * r + qd] = ls[h][r];
        Li[row + 4 * r + qd] = li[h][r];
      }
    }
  }
  grid_barrier(p.bar, p.S * gridDim.y);

  const int n_quads = blockDim.x / 4, n_warps = blockDim.x / 32;
  const int quad = tid >> 2, bwarp = tid >> 5;
  float* const st_s = smem;  // [S][kLS]: the padding spreads the banks
  int* const st_i = reinterpret_cast<int*>(st_s + p.S * kLS);
  float* const wl_s = st_s + 2 * p.S * kLS;  // [n_warps / 2][kSlots]
  int* const wl_i = reinterpret_cast<int*>(wl_s + n_warps / 2 * kSlots);
  for (int j = slice; j < kQT && q0 + j < p.Q; j += p.S) {
    for (int v = tid; v < p.S * (kSlots / 4); v += blockDim.x) {
      const int s = v / (kSlots / 4), c = 4 * (v % (kSlots / 4));
      const int64_t src = (((int64_t)qt * p.S + s) * kQT + j) * kLS + c;
      cp_async16(st_s + s * kLS + c, p.list_s + src);
      cp_async16(st_i + s * kLS + c, p.list_i + src);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // quad c folds lists c, c + n_quads, ..., the quads of a warp merge by
    // butterfly, then the warps in a tree
    float ms[kR], cs[kR];
    int mi[kR], ci[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      ms[r] = -CUDART_INF_F;
      mi[r] = INT_MAX;
    }
    for (int s0 = 0; s0 < p.S; s0 += n_quads) {  // warp-uniform
      const int s = s0 + quad;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        cs[r] = s < p.S ? st_s[s * kLS + kSlots - 1 - (4 * r + qd)]
                        : -CUDART_INF_F;
        ci[r] = s < p.S ? st_i[s * kLS + kSlots - 1 - (4 * r + qd)]
                        : INT_MAX;
      }
      merge_rev<kR>(ms, mi, cs, ci, qd);
    }
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        cs[r] = __shfl_xor_sync(kFull, ms[kR - 1 - r], x | 3);
        ci[r] = __shfl_xor_sync(kFull, mi[kR - 1 - r], x | 3);
      }
      merge_rev<kR>(ms, mi, cs, ci, qd);
    }
    for (int half = n_warps / 2; half > 0; half >>= 1) {
      if (bwarp >= half && bwarp < 2 * half && g == 0)
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          wl_s[(bwarp - half) * kSlots + 4 * r + qd] = ms[r];
          wl_i[(bwarp - half) * kSlots + 4 * r + qd] = mi[r];
        }
      __syncthreads();
      if (bwarp < half) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          cs[r] = wl_s[bwarp * kSlots + kSlots - 1 - (4 * r + qd)];
          ci[r] = wl_i[bwarp * kSlots + kSlots - 1 - (4 * r + qd)];
        }
        merge_rev<kR>(ms, mi, cs, ci, qd);
      }
      __syncthreads();
    }
    if (bwarp == 0 && g == 0)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int pos = 4 * r + qd;
        if (pos < p.k) {
          p.out_s[(int64_t)(q0 + j) * p.k + pos] = ms[r];
          p.out_i[(int64_t)(q0 + j) * p.k + pos] = mi[r];
        }
      }
  }
}

template <int kSlots, int kCC>
int launch(const Params& p, int q_tiles, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      dense_topk_kernel<kSlots, kCC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.S, q_tiles);
  if (p.S == 1) {
    dense_topk_kernel<kSlots, kCC><<<grid, kWG * p.n_wg, p.smem, s>>>(p);
  } else {
    Params arg = p;
    void* args[] = {&arg};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(dense_topk_kernel<kSlots, kCC>), grid,
        dim3(kWG * p.n_wg), args, p.smem, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (Q, E), docs (D, E): contiguous float32, E % 4 == 0, 16-byte aligned.
// 1 <= k <= min(64, D).  The doc axis is cut into ceil(D / 64) tiles and
// those into S slices (1 <= S <= tiles), one block per (64-query tile,
// slice), all resident at once when S > 1 (a cooperative launch).  With
// S > 1, list_s / list_i hold ceil(Q / 64) * S * 64 * (kSlots + 4)
// entries each (kSlots = 16, 32 or 64 for k <= 16, 32, 64) and bar two
// int32 zeros, left zero by the launch.  out_s / out_i: (Q, k).
extern "C" int dense_topk_f32(const void* q, const void* docs, void* list_s,
                              void* list_i, void* bar, void* out_s,
                              void* out_i, int Q, int D, int E, int k, int S,
                              void* stream) {
  const int n_tiles = (D + kDT - 1) / kDT;
  const int q_tiles = (Q + kQT - 1) / kQT;
  if (Q <= 0 || D <= 0 || E <= 0 || E % 4 != 0 || k < 1 || k > 64 ||
      k > D || S < 1 || S > n_tiles || q_tiles > 65535 ||
      (S > 1 && (list_s == nullptr || list_i == nullptr || bar == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = k <= 16 ? 16 : k <= 32 ? 32 : 64;
  // a stage of 64 columns (half the stages, waits and barriers a byte)
  // where the registers allow it, k <= 16, and two warpgroups of at least
  // 3 stages fit; else 32 columns
  int cc = 64, n_wg = 2, stages = 0, qs = 0;
  for (;; cc = 32) {
    qs = ((E + cc - 1) & ~(cc - 1)) + 4;  // an odd count of 16-byte pieces
    // the query tile and 1024 bytes of alignment slack (64 bytes are left
    // for the static shared memory), then each warpgroup's ring of stages
    // and its two lo buffers
    const int room = optin - 64 - kQT * qs * 4 - 1024;
    const int stage_bytes = kDT * cc * 4;
    n_wg = 2;
    stages = room / (2 * stage_bytes) - 2;
    if (stages >= 3 && (cc == 32 || slots == 16)) break;
    if (cc == 32) {
      n_wg = 1;
      stages = room / stage_bytes - 2;
      break;
    }
  }
  if (stages > kMaxStages) stages = kMaxStages;
  const int merge_bytes = (2 * S * (slots + 4) + 2 * 2 * n_wg * slots) * 4;
  int smem = kQT * qs * 4 + 1024 + n_wg * (stages + 2) * kDT * cc * 4;
  if (smem < merge_bytes) smem = merge_bytes;
  if (stages < 2 || smem > optin - 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(docs),
                 static_cast<float*>(list_s), static_cast<int*>(list_i),
                 static_cast<int*>(bar), static_cast<float*>(out_s),
                 static_cast<int*>(out_i), Q, D, E, k, S, qs, stages, smem,
                 n_wg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots == 16)
    return cc == 64 ? launch<16, 64>(p, q_tiles, s)
                    : launch<16, 32>(p, q_tiles, s);
  if (slots == 32) return launch<32, 32>(p, q_tiles, s);
  return launch<64, 32>(p, q_tiles, s);
}
