// Flash-decode for Hopper (sm_90a): single-query GQA attention over the
// dense slot cache, one query per slot.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_pallas, body _flash_decode_kernel).  Same function:
// out[b, h] = softmax(q[b, h] . K[b, :n_b, h / G]^T / sqrt(D)) V[b, :n_b, h / G]
// with n_b = clamp(lengths[b], 1, L); positions >= n_b never contribute.
//
// Bound: the K/V bytes.  A decode step reads every valid cache row once,
// sum_b n_b * Hkv * D * 2 (K and V) * 2 bytes, against about G flops a
// byte -- far under the card's ops:byte balance, so the floor is those
// bytes over the 3.35 TB/s of HBM.  At the served shapes that is
// 1.5-10 us, so a launch lives on how soon every SM has rows in flight
// and how little each row costs the SM once it lands.  What the design
// does about it:
//   * The G query heads of a kv head on the tensor cores: for a tile of
//     16 K rows, the scores S = Q_j K^T take 2 D / 16 mma.sync m16n8k16
//     (bf16 in, float32 sums) with the G <= 8 heads as the rows of A
//     (rows G..15 zero), and P V 2 D / 8 more: P straight from the score
//     fragments (the C fragment of S is the A fragment of P V: no
//     shuffle), as two bf16 parts hi + lo, each its own product, so that
//     P V keeps float32's accuracy (the products have room: the kernel
//     waits on memory).  The online softmax runs per head in float32
//     (log2 domain): a tile costs two shuffles and four exp2 a lane,
//     whatever G, where a CUDA-core body pays a dot product, a shuffle
//     tree and two exp per head per row.
//   * K/V tiles staged ahead: each warp walks every kWarps-th tile of
//     its block's rows through its own ring of kStages tiles in shared
//     memory, filled by cp.async (16 bytes a lane, zero-filled past n_b:
//     rows past the slot's length are never read) kStages - 1 tiles ahead
//     of the one it multiplies.  The warps run apart; no block barrier in
//     the loop.  Tiles are stored with the 16-byte chunk index XORed by
//     the row (mod 8) (at D = 96 in padded rows, below), so the ldmatrix
//     reads that build the fragments are free of bank conflicts.
//   * One block a (kv head, slot) and, for a slot longer than the
//     wrapper's run (512 rows), a run: each (slot, kv head) is cut into
//     `parts` runs of `part_rows` rows (a multiple of the tile), one block
//     each, grid (Hkv, B, parts).  The wrapper picks the count from shapes
//     alone (L, B, Hkv and the SM count), never from `lengths`, so the
//     decode chunk needs no host sync.  Short slots are not split even
//     when the grid leaves SMs idle: the merge costs more than it saves.
//     A run that starts at or past n_b returns at once: it reads nothing,
//     takes no ticket and contributes the empty state (the merge never
//     looks at it).
//   * Block width from the grid: wide blocks (kWideWarps) where the
//     grid has a block an SM or fewer or walks split runs, so more warps
//     share a block's tiles; narrow ones (kNarrowWarps) where blocks
//     outnumber the SMs, so that three fit an SM at once.
//   * Head dim 256 (gemma3) takes the same body with three changes, all
//     of shape alone.  Registers: a 16 x 8 accumulator is four floats a
//     lane, two of them rows 8..15 of the tile, which G <= 8 never uses;
//     at D = 256 those would make o 128 registers.  So there the products
//     feed rows 8..15's C operands from zero and drop their outputs (the
//     two-register mma): o is 64 registers, as at D = 128.  The Q
//     fragments (32 registers at D = 256) are read from Q_j's rows in
//     shared memory at each product instead of kept: with them the body
//     took 255 registers and spilled; without, 190 and no spill.  Shared
//     memory: a 16-row K + V tile is 16 KB, a warp's 2-stage ring 32 KB,
//     so only narrow blocks fit (128 KB; wide ones would need 256 KB of
//     the 227 KB a block may have), one block an SM.  D = 64 and 128
//     compile to the body they had.
//   * Head dim 96 (phi-3-vision) takes the D = 128 body: 6 k-steps of
//     Q K^T and 12 n-tiles of P V, 12 16-byte chunks a row, 6 cp.async a
//     lane a tile.  Only the shared rows change.  The XOR swizzle needs a
//     power-of-two count of chunks a row (c ^ (r & 7) maps chunks 8..11
//     past the row's 12), so a row is padded to 13 chunks (208 bytes)
//     instead: 8 consecutive rows at one chunk index then fall at 13 r + c
//     = 5 r + c (mod 8) 16-byte bank groups, all different, and each
//     8-row phase of an ldmatrix reads every bank once.  The pad is in
//     shared memory only: K/V stay in the executor's (B, L, Hkv, 96)
//     layout, read in place.  A tile is 3.25 KB of K and as much of V, so
//     wide blocks fit (104 KB).
//   * K/V are read in place in the executor's (B, L, Hkv, D) layout
//     through strides: no per-call transpose (the TPU wrapper transposes
//     to kv-head-major on every call), no padded tail, no expanded GQA
//     copy.
//   * The warps merge through shared memory; the runs of a (slot, kv
//     head) merge in the same launch: each block writes its (m, l, acc)
//     to a float32 scratch, and the last block of the slot's nonempty
//     runs to take a ticket (an atomic counter) merges them online in run
//     order -- the result does not depend on which block came last --
//     then resets the ticket to 0 for the next launch.  A slot with one
//     nonempty run writes its output directly.
//
// Plain C interface (bound with ctypes), launched on the caller's stream.
// The function returns cudaGetLastError() after the launch.

#include "decode_attention.cuh"

namespace {

using decode_attention::bf16;
using decode_attention::kNegInf;

constexpr int kNarrowWarps = 4;  // a block's warps (the wrapper picks)
constexpr int kWideWarps = 8;
constexpr int kStages = 2;      // tiles in each warp's ring
constexpr int kTile = 16;       // K/V rows a product takes
constexpr int kMaxGroup = 8;    // query heads a kv head (rows of A used)
constexpr int kMaxParts = 256;  // the last block's merge walks them all
constexpr int kDefaultSmemLimit = 48 * 1024;  // without the attribute
constexpr int kMaxSmem = 227 * 1024;          // a block's most, with it
constexpr float kLog2e = 1.4426950408889634f;

// floats a lane keeps of a 16 x 8 product: all four at D <= 128; at D =
// 256 only rows 0..7's two (the two-register mma), so that o fits the
// register file
template <int D>
constexpr int kAcc = D > 128 ? 2 : 4;
// where the score products' Q fragments live: registers at D <= 128; at
// D = 256 shared memory, as the 32 registers they would take there push
// the body past 255 and into spills
template <int D>
constexpr bool kQShared = D > 128;
constexpr int kQPad = 8;  // bf16 a shared Q row is padded by: rows 4 banks
                          // apart, so a fragment's reads do not conflict

// 16-byte chunks a shared K/V row takes: D / 8, swizzled, where that is
// a power of two; else one more, a pad chunk that spreads the rows over
// the banks (D = 96: 13)
__host__ __device__ constexpr bool swizzled(int D) {
  return ((D / 8) & (D / 8 - 1)) == 0;
}
__host__ __device__ constexpr int row_chunks(int D) {
  return swizzled(D) ? D / 8 : D / 8 + 1;
}

// the warps' K/V rings: kStages tiles of 16 K and 16 V rows a warp
__host__ __device__ constexpr int ring_bytes(int D, int warps) {
  return warps * kStages * 2 * kTile * row_chunks(D) * 16;
}

template <int D, int kWarps>
struct Layout {
  // whole 16-dim k-steps, and a tile's chunks spread evenly over a warp
  static_assert(D % 16 == 0 && kTile * (D / 8) % 32 == 0, "D");
  static constexpr int kChunks = D / 8;             // 16-byte chunks a row
  static constexpr int kTileBytes = kTile * row_chunks(D) * 16;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kRing = ring_bytes(D, kWarps);
  // Q_j's rows (kMaxGroup, rows G.. zero), past the ring, if kQShared
  static constexpr int kQRow = D + kQPad;
  static constexpr int kQBytes = kQShared<D> ? 2 * kMaxGroup * kQRow : 0;
  // after the loop: each warp's (m, l, acc) for the merge of the warps
  static constexpr int kMerge = sizeof(float) * kWarps * kMaxGroup * (D + 2);
  static constexpr int kSmem =
      kRing + kQBytes > kMerge ? kRing + kQBytes : kMerge;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* lengths;
  bf16* out;
  float* part;   // (B, Hkv, parts, G, D + 2): acc, then m and l
  int* tickets;  // (B, Hkv), 0 between launches
  int G, L, parts, part_rows;
  int64_t q_sb, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sh;
  float scale;  // 1 / sqrt(D)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or 16 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// d += a b on m16n8k16; A's rows 8..15 are zero (a[1] = a[3] = 0)
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// the same for rows 0..7 only: rows 8..15's C operands are zero and their
// D outputs are dropped, so the accumulator is two registers
__device__ __forceinline__ void mma(float (&d)[2], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "{\n.reg .f32 drop<2>;\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, drop0, drop1}, {%2, %3, %4, %5}, {%6, %7}, "
      "{%0, %1, %8, %8};\n}\n"
      : "+f"(d[0]), "+f"(d[1])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (x0, x1) as two packed bf16 pairs, hi + lo, exact to 2^-16 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}
// byte offset of 16-byte chunk c of row r in a tile: swizzled (chunk
// index XOR the row mod 8) or, at a row of row_chunks(D) padded chunks,
// in place
template <int D>
__device__ __forceinline__ int chunk_offset(int r, int c) {
  if constexpr (swizzled(D))
    return (r * (D / 8) + (c ^ (r & 7))) * 16;
  else
    return (r * row_chunks(D) + c) * 16;
}

template <int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    flash_decode_kernel(const Params p) {
  using Lay = Layout<D, kWarps>;
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int Hkv = gridDim.x, G = p.G;
  const int j = blockIdx.x, b = blockIdx.y, part = blockIdx.z;
  const int n = max(1, min(p.lengths[b], p.L));
  const int lo = part * p.part_rows;
  if (lo >= n) return;  // the empty state: no rows, no ticket
  const int hi = min(n, lo + p.part_rows);
  const int nparts = (n + p.part_rows - 1) / p.part_rows;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;  // fragment row, lane in its quad

  // Q_j as the A fragments of the score products, one per 16 dims: row
  // g is query head j * G + g, rows G..15 zero; in registers, or (at D =
  // 256) read from Q_j's rows in shared memory at each product
  constexpr bool kQs = kQShared<D>;
  [[maybe_unused]] uint32_t qa[kQs ? 1 : D / 16][2];
  if constexpr (kQs) {
    bf16* const qs = reinterpret_cast<bf16*>(smem + Lay::kRing);
    for (int t = threadIdx.x; t < kMaxGroup * Lay::kChunks; t += kThreads) {
      const int r = t / Lay::kChunks, c = t % Lay::kChunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < G)
        val = *reinterpret_cast<const uint4*>(
            p.q + b * p.q_sb + (int64_t)(j * G + r) * p.q_sh + c * 8);
      *reinterpret_cast<uint4*>(qs + r * Lay::kQRow + c * 8) = val;
    }
    __syncthreads();
  } else {
    const bf16* const qg = p.q + b * p.q_sb + (int64_t)(j * G + g) * p.q_sh;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(
                              qg + ks * 16 + 2 * qd)
                        : 0u;
      qa[ks][1] = g < G ? *reinterpret_cast<const uint32_t*>(
                              qg + ks * 16 + 8 + 2 * qd)
                        : 0u;
    }
  }

  // this warp's tiles: warp, warp + kWarps, ... of the run's
  const int ntiles = (hi - lo + kTile - 1) / kTile;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  const bf16* const kb = p.k + b * p.k_sb + j * p.k_sh;
  const bf16* const vb = p.v + b * p.v_sb + j * p.v_sh;
  unsigned char* const ring = smem + warp * Lay::kWarpBytes;
  auto issue = [&](int i) {
    if (i < mine) {
      const int r0 = lo + (warp + i * kWarps) * kTile;
      const unsigned st = smem_addr(ring + (i % kStages) * Lay::kStageBytes);
#pragma unroll
      for (int t = 0; t < kTile * Lay::kChunks / 32; ++t) {
        const int e = lane + 32 * t;
        const int r = e / Lay::kChunks, c = e % Lay::kChunks;
        const bool ok = r0 + r < hi;
        const int pos = ok ? r0 + r : lo;
        const unsigned dst = st + chunk_offset<D>(r, c);
        cp_async16(dst, kb + pos * p.k_sl + c * 8, ok);
        cp_async16(dst + Lay::kTileBytes, vb + pos * p.v_sl + c * 8, ok);
      }
    }
    cp_async_commit();
  };

  // per head g (this lane's fragment row): running max m and sum l in
  // the log2 domain (l partial to this lane until the end), o[nt] the
  // head's dims nt * 8 + 2 qd, + 1 (entries 2, 3, where kept: the zero
  // rows 8..15)
  constexpr int kA = kAcc<D>;
  const float sl2 = p.scale * kLog2e;
  float m = kNegInf, l = 0.f;
  float o[D / 8][kA];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < kA; ++e) o[nt][e] = 0.f;

  // lane's ldmatrix row address within a tile, for K (B of S: rows
  // 0-7 | 8-15 by matrix bit 1, dims lo | hi 8 by bit 0) and for V (B of
  // P V, transposed: rows 0-7 | 8-15 by bit 0, dim chunk by bit 1)
  const int mi = lane / 8, mr = lane % 8;
  const int k_row = mr + 8 * (mi >> 1), k_half = mi & 1;
  const int v_row = mr + 8 * (mi & 1), v_half = mi >> 1;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();  // this lane's copies of tile i landed
    __syncwarp();                  // and every other lane's
    const unsigned st = smem_addr(ring + (i % kStages) * Lay::kStageBytes);

    // the even and the odd 16-dim steps in separate sums, so that each
    // chain of dependent products is half as long
    float s[4][kA] = {};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kf[4];
      ldsm_x4(kf, st + chunk_offset<D>(k_row, 2 * ks + k_half));
      uint32_t a0, a2;
      if constexpr (kQs) {
        const bf16* const qr = reinterpret_cast<const bf16*>(
            smem + Lay::kRing) + g * Lay::kQRow + ks * 16 + 2 * qd;
        a0 = *reinterpret_cast<const uint32_t*>(qr);
        a2 = *reinterpret_cast<const uint32_t*>(qr + 8);
      } else {
        a0 = qa[ks][0];
        a2 = qa[ks][1];
      }
      mma(s[2 * (ks & 1)], a0, a2, kf[0], kf[1]);
      mma(s[2 * (ks & 1) + 1], a0, a2, kf[2], kf[3]);
    }
#pragma unroll
    for (int e = 0; e < kA; ++e) {
      s[0][e] += s[2][e];
      s[1][e] += s[3][e];
    }
    // lane holds head g's scores of tile rows 2 qd, 2 qd + 1 (s[0]) and
    // 8 + 2 qd, 9 + 2 qd (s[1]); rows past hi are masked
    const int r0 = lo + (warp + i * kWarps) * kTile;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e >> 1) * 8 + 2 * qd + (e & 1);
      x[e] = r0 + r < hi ? s[e >> 1][e & 1] * sl2 : kNegInf;
    }
    float mt = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = exp2f(m - m_new);
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pr[e] = exp2f(x[e] - m_new);
    l = l * alpha + (pr[0] + pr[1]) + (pr[2] + pr[3]);
    m = m_new;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha;
      o[nt][1] *= alpha;
    }
    uint32_t ph0, pl0, ph2, pl2;
    split_bf16(pr[0], pr[1], ph0, pl0);
    split_bf16(pr[2], pr[3], ph2, pl2);
    const unsigned vt = st + Lay::kTileBytes;
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, vt + chunk_offset<D>(v_row, nt + v_half));
      mma(o[nt], ph0, ph2, vf[0], vf[1]);
      mma(o[nt + 1], ph0, ph2, vf[2], vf[3]);
      mma(o[nt], pl0, pl2, vf[0], vf[1]);
      mma(o[nt + 1], pl0, pl2, vf[2], vf[3]);
    }
    __syncwarp();  // every lane has read the stage before it is refilled
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // merge the warps through shared memory (the ring is drained)
  float* const s_m = reinterpret_cast<float*>(smem);  // [w][g]
  float* const s_l = s_m + kWarps * kMaxGroup;
  float* const s_o = s_l + kWarps * kMaxGroup;         // [w][g][D]
  __syncthreads();
  if (g < G) {
    if (qd == 0) {
      s_m[warp * kMaxGroup + g] = m;
      s_l[warp * kMaxGroup + g] = l;
    }
    float* const row = s_o + (warp * kMaxGroup + g) * D + 2 * qd;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(row + nt * 8) = make_float2(o[nt][0],
                                                             o[nt][1]);
  }
  __syncthreads();
  bf16* const ob = p.out + b * p.o_sb + (int64_t)j * G * p.o_sh;
  const int pstride = G * (D + 2);
  float* const all = p.part + ((int64_t)b * Hkv + j) * p.parts * pstride;
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int gg = t / D, d = t % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * kMaxGroup + gg]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(s_m[w * kMaxGroup + gg] - mx);
      den += s_l[w * kMaxGroup + gg] * c;
      num += s_o[(w * kMaxGroup + gg) * D + d] * c;
    }
    if (nparts == 1) {
      ob[gg * p.o_sh + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      float* const e = all + part * pstride + gg * (D + 2);
      e[d] = num;
      if (d == 0) {
        e[D] = mx;
        e[D + 1] = den;
      }
    }
  }
  if (nparts == 1) return;

  // the last nonempty run of this (slot, kv head) to finish merges them
  __threadfence();
  __syncthreads();
  int* const ticket = p.tickets + b * Hkv + j;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == nparts - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // one pass a (head, dim), in run order: every run's (m, l, acc) read
  // together from L2, merged online
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int gg = t / D, d = t % D;
    const float* e = all + gg * (D + 2);
    float mx = kNegInf, den = 0.f, num = 0.f;
#pragma unroll 4
    for (int k = 0; k < nparts; ++k, e += pstride) {
      const float m_k = __ldcg(e + D), l_k = __ldcg(e + D + 1);
      const float a_k = __ldcg(e + d);
      const float m_new = fmaxf(mx, m_k);
      const float c_old = exp2f(mx - m_new), c_k = exp2f(m_k - m_new);
      den = den * c_old + l_k * c_k;
      num = num * c_old + a_k * c_k;
      mx = m_new;
    }
    ob[gg * p.o_sh + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int D, int kWarps>
int launch_blocks(dim3 grid, cudaStream_t s, const Params& p) {
  constexpr int smem = Layout<D, kWarps>::kSmem;
  const auto kernel = flash_decode_kernel<D, kWarps>;
  if (smem > kDefaultSmemLimit)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  kernel<<<grid, kWarps * 32, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(dim3 grid, cudaStream_t s, const Params& p, bool wide) {
  static_assert(Layout<D, kNarrowWarps>::kSmem <= kMaxSmem, "narrow block");
  if constexpr (ring_bytes(D, kWideWarps) <= kMaxSmem) {
    if (wide) return launch_blocks<D, kWideWarps>(grid, s, p);
  } else {
    if (wide) return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_blocks<D, kNarrowWarps>(grid, s, p);
}

}  // namespace

// q (B, H, D) strides (q_sb, q_sh); k/v (B, L, Hkv, D) strides
// (sb, sl, sh); out (B, H, D) strides (o_sb, o_sh); every last dim
// contiguous, every row 16-byte aligned; lengths (B,) int32.  parts runs
// of part_rows rows (a multiple of 16) cover the slot
// ((parts - 1) * part_rows < L <= parts * part_rows); with parts > 1,
// part holds B * Hkv * parts * (H / Hkv) * (D + 2) float32 and tickets
// B * Hkv int32 zeros, left zero by the launch.  wide: blocks of
// kWideWarps warps, else kNarrowWarps; D = 256 takes narrow blocks only.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, void* part,
                                 void* tickets, int B, int H, int Hkv, int L,
                                 int D, int parts, int part_rows, int wide,
                                 long long q_sb, long long q_sh,
                                 long long k_sb, long long k_sl,
                                 long long k_sh, long long v_sb,
                                 long long v_sl, long long v_sh,
                                 long long o_sb, long long o_sh, float scale,
                                 void* stream) {
  if (B <= 0 || Hkv <= 0 || L <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup ||
      B > 65535 || parts <= 0 || parts > kMaxParts || parts > 65535 ||
      part_rows <= 0 || part_rows % kTile != 0 ||
      (long long)(parts - 1) * part_rows >= L ||
      (long long)parts * part_rows < L ||
      (parts > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const bf16*>(q),
                 static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),
                 static_cast<const int*>(lengths),
                 static_cast<bf16*>(out),
                 static_cast<float*>(part),
                 static_cast<int*>(tickets),
                 H / Hkv, L, parts, part_rows,
                 q_sb, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sh,
                 scale};
  const dim3 grid(Hkv, B, parts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(grid, s, p, wide);
  if (D == 64) return launch<64>(grid, s, p, wide);
  if (D == 256) return launch<256>(grid, s, p, wide);
  if (D == 96) return launch<96>(grid, s, p, wide);
  return static_cast<int>(cudaErrorInvalidValue);
}
