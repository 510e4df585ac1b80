// Paged flash-decode for Hopper (sm_90a): single-query GQA attention
// through a per-slot block table into a global page pool.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (paged_flash_decode_pallas, body _paged_flash_decode_kernel; wrapper
// ops.py paged_flash_decode).  Same function:
// out[b, h] = softmax(q[b, h] . K[b, :n_b, h / G]^T / sqrt(D)) V[b, :n_b, h / G]
// K[b, p]   = k_pages[table[b, p / ps], p % ps]
// with n_b = clamp(lengths[b], 1, max_blocks * ps) and every table entry
// clamped into [0, num_pages - 1].
//
// Bound: the K/V bytes -- sum_b n_b * Hkv * D * 2 (K and V) * 2 bytes
// over the 3.35 TB/s of HBM, plus 4 bytes of table a page; about 4 flops
// a byte, far under the card's balance.  Here each row's address would
// also wait on its table entry, and the longest slot's block would set
// the kernel's time (at the GQA shape the grid is only B * Hkv = 64
// blocks).  So this kernel has a body of its own, apart from the dense
// kernel's (K1, flash_decode.cu); its helpers are in
// decode_attention.cuh:
//   * Split slots (flash-decoding): each (kv head, slot) is cut into
//     `parts` partitions of `part_pages` pages, one block each, grid
//     (Hkv, B, parts).  The wrapper picks the count from shapes alone
//     (max_blocks * ps, B, Hkv and the SM count), never from `lengths`,
//     so choosing it needs no host sync; a partition past n_b reads
//     nothing and writes an empty softmax state.
//   * Longest first: block i serves the i-th (slot, partition, kv head)
//     item in the order of the slots' lengths, read on the card, so the
//     blocks the card starts together carry comparable work.
//   * The partition's table entries are loaded into shared memory once,
//     clamped, together with the scaled queries and without waiting on
//     the length: no row address waits on a global table load.
//   * Whole pages in flight: each thread copies the 16-byte K and V
//     pieces it will itself read, with cp.async, into its own slots of a
//     ring of kStages stages in shared memory (a stage is the rows one
//     pass of the block consumes: 16 at D = 128 and 96, 32 at D = 64, 8
//     at D = 256, where a row takes a whole warp), kStages - 1 stages
//     ahead of the one it uses.  Its own cp.async.wait_group orders each copy
//     before its read, so the loop has no block barrier: warps run apart,
//     as in K1, with kStages - 1 row pairs in flight a stream.
//   * Each thread owns 8 dims of one row of a stage; every (warp, row)
//     stream runs an online softmax (m, l, acc in float32 registers) for
//     all G query heads of the kv head, so a K/V row is read once for G
//     heads (the queries in registers for G <= 2; in shared memory above,
//     which keeps G <= 8 within two blocks an SM's registers); the streams
//     merge by shuffles, then across warps through shared memory (reusing
//     the drained ring).
//   * Head dim 96 (phi-3-vision): a row is 12 pieces of 16 bytes, which
//     do not divide a warp.  A row takes 16 lanes, 4 of them idle (no
//     copy, no load, zero K and V, so they add nothing to the shuffled
//     sums), rather than 8 lanes of 12 dims each (a 16-byte and an 8-byte
//     copy a lane): the body, its shuffle trees over a power of two of
//     lanes and each thread's own 16-byte ring slots stay as they are.
//     The kernel waits on the bytes of the rows, not on its lanes, and
//     those bytes are the same either way.
//   * The merge of the partitions runs in the same launch: each block
//     writes its (m, l, acc) to a float32 scratch, and the last block of
//     a (slot, kv head) to take a ticket (an atomic counter) merges all
//     partials in partition order -- the result does not depend on which
//     block came last -- then resets the ticket to 0 for the next launch.
//     No second kernel and no memset.  With one partition the block
//     writes the output directly.
//   * The pools are read in place in the executor's (num_pages, ps, Hkv,
//     D) layout through strides; the TPU wrapper transposes the whole
//     pool to kv-head-major on every call.  An idle slot parks its
//     position at max_blocks * ps, so its length is max_blocks * ps + 1:
//     n_b is clamped to max_blocks * ps, as the TPU grid never walks past
//     max_blocks pages.  Entries past a slot's allocation are zeros or
//     stale page ids: they are clamped and never dereferenced unclamped;
//     rows past n_b are never read at all.
//
// Plain C interface (bound with ctypes), launched on the caller's stream.
// The function returns cudaGetLastError() after the launch.

#include "decode_attention.cuh"

namespace {

using decode_attention::bf16;
using decode_attention::kNegInf;
using decode_attention::kThreads;
using decode_attention::kWarps;
using decode_attention::load8;

constexpr int kStages = 4;
constexpr int kMaxParts = 256;  // the last block's weights fit the ring
constexpr int kDefaultSmemLimit = 48 * 1024;  // without the attribute

// lanes a row takes: its D / 8 16-byte pieces, rounded up to a power of
// two that divides the warp (D = 96: 12 pieces on 16 lanes, 4 idle)
__host__ __device__ constexpr int lanes_per_row(int pieces) {
  return pieces <= 8 ? 8 : (pieces <= 16 ? 16 : 32);
}

template <int D>
struct Layout {
  static constexpr int kPieces = D / 8;            // 16-byte pieces a row
  static constexpr int kLanesPerRow = lanes_per_row(kPieces);
  static constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  static constexpr int kStageRows = kWarps * kRowsPerWarp;
  // a thread owns 8 dims of one row: a row fills a warp or a part of it
  static_assert(D % 8 == 0 && kPieces <= kLanesPerRow, "D");
};

// The ring: kStages slots of one K and one V piece a thread (8 KB a
// slot); after the loop the same bytes hold the cross-warp merge.
template <int D, int MAXG>
__host__ __device__ constexpr size_t body_bytes() {
  constexpr size_t ring = sizeof(bf16) * kStages * 2 * kThreads * 8;
  constexpr size_t merge = sizeof(float) * kWarps * MAXG * (D + 2);
  return ring > merge ? ring : merge;
}

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* lengths;
  bf16* out;
  float* part;   // (B, Hkv, parts, G, D + 2): acc, then m and l
  int* tickets;  // (B, Hkv), 0 between launches
  int G, ps, num_pages, max_blocks, parts, part_pages;
  int64_t q_sb, q_sh, k_sp, k_so, k_sh, v_sp, v_so, v_sh, t_sb, o_sb, o_sh;
  float scale;
};

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

template <int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
    paged_flash_decode_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const ring = reinterpret_cast<bf16*>(smem);
  float* const s_m = reinterpret_cast<float*>(smem);  // after the ring
  float* const s_l = s_m + kWarps * MAXG;
  float* const s_acc = s_l + kWarps * MAXG;            // [w][g][D]
  float* const s_q = reinterpret_cast<float*>(smem + body_bytes<D, MAXG>());
  int* const tab = reinterpret_cast<int*>(s_q + MAXG * D);
  __shared__ int s_last;

  // Block i of the grid serves the i-th work item, items ordered by
  // their slot's length, longest first (then partition, then kv head):
  // the blocks the card starts together carry comparable work, so no SM
  // is left with several of the longest slots.  Read on the card: no host
  // sync.  Past kThreads slots the grid's own order is kept.
  const int Hkv = gridDim.x, B = gridDim.y, G = p.G, ps = p.ps;
  const int item = blockIdx.x + Hkv * (blockIdx.y + B * blockIdx.z);
  const int per_slot = Hkv * gridDim.z;
  const int j = item % Hkv, part = item % per_slot / Hkv;
  const int rank = item / per_slot;
  __shared__ int s_slot;
  if (B > kThreads) {
    if (threadIdx.x == 0) s_slot = rank;
  } else if (threadIdx.x < B) {
    const int cap = p.max_blocks * ps;
    const int mine = max(1, min(p.lengths[threadIdx.x], cap));
    int r = 0;
    for (int o = 0; o < B; ++o) {
      const int other = max(1, min(p.lengths[o], cap));
      r += other > mine || (other == mine && o < (int)threadIdx.x);
    }
    if (r == rank) s_slot = threadIdx.x;
  }
  __syncthreads();
  const int b = s_slot;
  const int page0 = part * p.part_pages;
  // the partition's table entries, clamped, and the scaled queries: read
  // once, before any row, and without waiting on the length
  const int* const trow = p.table + b * p.t_sb + page0;
  const int tpages = min(p.part_pages, p.max_blocks - page0);
  for (int i = threadIdx.x; i < tpages; i += kThreads) {
    const int pg = trow[i];
    tab[i] = pg < 0 ? 0 : (pg >= p.num_pages ? p.num_pages - 1 : pg);
  }
  const bf16* const qb = p.q + b * p.q_sb + (int64_t)j * G * p.q_sh;
  for (int i = threadIdx.x; i < G * D / 8; i += kThreads) {
    const int g = i / (D / 8), d = (i % (D / 8)) * 8;
    float f[8];
    load8(qb + g * p.q_sh + d, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s_q[g * D + d + e] = f[e] * p.scale;
  }
  int n = p.lengths[b];
  n = max(1, min(n, p.max_blocks * ps));
  const int lo = page0 * ps;
  const int hi = min(n, (page0 + tpages) * ps);
  const int nstages = (max(hi - lo, 0) + L::kStageRows - 1) / L::kStageRows;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / L::kLanesPerRow;  // row of this warp's share
  // 8-wide piece of the head dim; a lane past the row's pieces (D = 96)
  // is idle: it copies and reads nothing, holds zero K and V, and takes
  // piece 0's addresses so that none points past a row
  const bool live = lane % L::kLanesPerRow < L::kPieces;
  const int dl = live ? lane % L::kLanesPerRow : 0;
  const int row = warp * L::kRowsPerWarp + sub;  // row within a stage

  // Each thread copies the K and V pieces it will read itself into its
  // own slots of the ring, kStages - 1 stages ahead: its own
  // cp.async.wait_group orders the copies before its reads, so the loop
  // has no block barrier and the warps run apart.
  const bf16* const kj = p.k + j * p.k_sh + dl * 8;
  const bf16* const vj = p.v + j * p.v_sh + dl * 8;
  bf16* const slot0 = ring + threadIdx.x * 8;
  auto issue = [&](int st) {
    const int pos = lo + st * L::kStageRows + row;
    if (st < nstages && pos < hi && live) {
      const int page = tab[(pos - lo) / ps], off = pos % ps;
      bf16* const slot = slot0 + (st % kStages) * 2 * kThreads * 8;
      cp_async16(slot, kj + page * p.k_sp + off * p.k_so);
      cp_async16(slot + kThreads * 8, vj + page * p.v_sp + off * p.v_so);
    }
    cp_async_commit();
  };

  constexpr bool kQRegs = MAXG <= 2;
  float qr[kQRegs ? MAXG : 1][8];
  if constexpr (kQRegs) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[g][i] = s_q[g * D + dl * 8 + i];
  }
  float m[MAXG], l[MAXG], acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  for (int st = 0; st < nstages; ++st) {
    issue(st + kStages - 1);
    cp_async_wait<kStages - 1>();  // this thread's stage st has landed
    const bf16* const slot = slot0 + (st % kStages) * 2 * kThreads * 8;
    const bool valid = lo + st * L::kStageRows + row < hi;
    float kf[8] = {}, vf[8] = {};
    if (valid && live) {
      load8(slot, kf);
      load8(slot + kThreads * 8, vf);
    }
    // every lane of a warp runs the shuffles; only valid rows update
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float s = 0.f;
        if constexpr (kQRegs) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s += qr[g][i] * kf[i];
        } else {
          const float4 q0 =
              *reinterpret_cast<const float4*>(s_q + g * D + dl * 8);
          const float4 q1 =
              *reinterpret_cast<const float4*>(s_q + g * D + dl * 8 + 4);
          s = q0.x * kf[0] + q0.y * kf[1] + q0.z * kf[2] + q0.w * kf[3] +
              q1.x * kf[4] + q1.y * kf[5] + q1.z * kf[6] + q1.w * kf[7];
        }
#pragma unroll
        for (int off = L::kLanesPerRow / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid) {
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float pr = expf(s - m_new);
          l[g] = l[g] * alpha + pr;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = acc[g][i] * alpha + pr * vf[i];
          m[g] = m_new;
        }
      }
    }
  }
  cp_async_wait<0>();

  // merge the rows of a warp: lanes kLanesPerRow apart hold the same dims
#pragma unroll
  for (int off = L::kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float m_new = fmaxf(m[g], m_o);
        const float a = expf(m[g] - m_new);
        const float c = expf(m_o - m_new);
        l[g] = l[g] * a + l_o * c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
          acc[g][i] = acc[g][i] * a + acc_o * c;
        }
        m[g] = m_new;
      }
    }
  }

  // merge the warps through shared memory (the ring is drained)
  __syncthreads();
  if (sub == 0 && live) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          s_acc[(warp * MAXG + g) * D + dl * 8 + i] = acc[g][i];
        if (dl == 0) {
          s_m[warp * MAXG + g] = m[g];
          s_l[warp * MAXG + g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  bf16* const ob = p.out + b * p.o_sb + (int64_t)j * G * p.o_sh;
  const int pstride = G * (D + 2);
  float* const all = p.part + ((int64_t)b * Hkv + j) * p.parts * pstride;
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * MAXG + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w * MAXG + g] - mx);
      den += s_l[w * MAXG + g] * c;
      num += s_acc[(w * MAXG + g) * D + d] * c;
    }
    if (p.parts == 1) {
      ob[g * p.o_sh + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      float* const e = all + part * pstride + g * (D + 2);
      e[d] = num;
      if (d == 0) {
        e[D] = mx;
        e[D + 1] = den;
      }
    }
  }
  if (p.parts == 1) return;

  // the last partition of this (slot, kv head) to finish merges them all
  __threadfence();
  __syncthreads();
  int* const ticket = p.tickets + b * Hkv + j;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == p.parts - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each partition's (m, l), then each head's max, weights and sum
  float* const w_m = reinterpret_cast<float*>(smem);  // [k][g]
  float* const w_l = w_m + p.parts * G;
  float* const w_den = w_l + p.parts * G;               // [g]
  for (int i = threadIdx.x; i < p.parts * G; i += kThreads) {
    const int k = i / G, g = i % G;
    w_m[i] = __ldcg(all + k * pstride + g * (D + 2) + D);
    w_l[i] = __ldcg(all + k * pstride + g * (D + 2) + D + 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float mx = kNegInf;
    for (int k = 0; k < p.parts; ++k) mx = fmaxf(mx, w_m[k * G + g]);
    float den = 0.f;
    for (int k = 0; k < p.parts; ++k) {
      const float c = expf(w_m[k * G + g] - mx);
      w_m[k * G + g] = c;
      den += w_l[k * G + g] * c;
    }
    w_den[g] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float num = 0.f;
    for (int k = 0; k < p.parts; ++k)
      num += __ldcg(all + k * pstride + g * (D + 2) + d) * w_m[k * G + g];
    ob[g * p.o_sh + d] = __float2bfloat16(num / w_den[g]);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

struct Launch {
  dim3 grid;
  cudaStream_t s;
  const Params& p;

  template <int D, int MAXG>
  void run() const {
    const size_t smem = body_bytes<D, MAXG>() + sizeof(float) * MAXG * D +
                        sizeof(int) * p.part_pages;
    if (smem > kDefaultSmemLimit)
      cudaFuncSetAttribute(paged_flash_decode_kernel<D, MAXG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    paged_flash_decode_kernel<D, MAXG><<<grid, kThreads, smem, s>>>(p);
  }
};

}  // namespace

// q (B, H, D) strides (q_sb, q_sh); k/v pages (num_pages, ps, Hkv, D)
// strides (sp, so, sh); table (B, max_blocks) int32, row stride t_sb,
// unit stride along blocks; lengths (B,) int32; out (B, H, D) strides
// (o_sb, o_sh).  Every last dim contiguous, every row 16-byte aligned.
// parts partitions of part_pages pages cover the table
// ((parts - 1) * part_pages < max_blocks <= parts * part_pages); with
// parts > 1, part holds B * Hkv * parts * (H / Hkv) * (D + 2) float32 and
// tickets B * Hkv int32 zeros, left zero by the launch.
extern "C" int paged_flash_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lengths, void* out, void* part,
    void* tickets, int B, int H, int Hkv, int num_pages, int ps,
    int max_blocks, int D, int parts, int part_pages, long long q_sb,
    long long q_sh, long long k_sp, long long k_so, long long k_sh,
    long long v_sp, long long v_so, long long v_sh, long long t_sb,
    long long o_sb, long long o_sh, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || num_pages <= 0 || ps <= 0 || max_blocks <= 0 ||
      H % Hkv != 0 || B > 65535 || parts <= 0 || parts > kMaxParts ||
      part_pages <= 0 || (long long)(parts - 1) * part_pages >= max_blocks ||
      (long long)parts * part_pages < max_blocks ||
      (parts > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const bf16*>(q),
                 static_cast<const bf16*>(k_pages),
                 static_cast<const bf16*>(v_pages),
                 static_cast<const int*>(table),
                 static_cast<const int*>(lengths),
                 static_cast<bf16*>(out),
                 static_cast<float*>(part),
                 static_cast<int*>(tickets),
                 H / Hkv, ps, num_pages, max_blocks, parts, part_pages,
                 q_sb, q_sh, k_sp, k_so, k_sh, v_sp, v_so, v_sh, t_sb, o_sb,
                 o_sh, scale};
  const Launch launch{dim3(Hkv, B, parts), static_cast<cudaStream_t>(stream),
                      p};
  return decode_attention::dispatch(D, H / Hkv, launch);
}
