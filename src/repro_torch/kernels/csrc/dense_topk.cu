// Fused dense-retrieval score + top-k for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/dense_topk.py
// (_dense_topk_padded; body _dense_topk_kernel, merge _merge_topk).  Same
// function: for each query q, the k docs d of the largest
// s[q, d] = q[q, :] . docs[d, :] in float32, scores descending, exact
// score ties to the lower doc id (lax.top_k order).  The (Q, D) score
// matrix never exists in device memory.
//
// Bound: max(docs bytes / 3.35 TB/s, 2 Q D E flops / 67 TFLOP/s) -- the
// corpus is read once, and the float32 FMAs on CUDA cores take about as
// long (Q = 64, E = 256: 1.07 GB and 34.4 GFLOP at D = 1,048,576).  What
// the design does about it:
//   * One block holds a tile of 64 queries in shared memory (transposed,
//     E * 256 bytes) and streams its share of the corpus past it in
//     64-doc tiles, 16-byte coalesced loads, so the corpus is read once
//     per 64 queries, not once per query.  The next chunk of docs is
//     loaded into registers while the current one is multiplied.
//   * The doc axis is split over S blocks (about two per SM) instead of
//     the TPU's sequential grid: block (query tile, split) folds each
//     64 x 64 score tile into a running top-k per query and writes its
//     partial top-k to a (Q, S, k) scratch tensor that the wrapper
//     allocates.  A second kernel merges the S * k candidates of each
//     query.  No atomics: the result does not depend on block order.
//   * Each running top-k is held by one warp in registers, entry i in
//     lane i (k <= 32), sorted by the total order (score desc, id asc).
//     A candidate is offered only if it beats entry k-1; it is inserted
//     by a ballot (its position) and one shuffle (the shift).  Empty
//     entries are (-inf, INT_MAX), so a split with fewer than k docs
//     merges correctly.
//   * Exact float32: fmaf on CUDA cores, every dot product summed over E
//     in ascending order (fp32_tile.cuh); no TF32, no tensor cores.
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns cudaGetLastError() after the two launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math_constants.h>

#include <climits>

#include "fp32_tile.cuh"

namespace {

using fp32_tile::kChunk;
using fp32_tile::kStride;
using fp32_tile::kThreads;
using fp32_tile::kTile;

constexpr int kWarps = kThreads / 32;
constexpr int kQueriesPerWarp = kTile / kWarps;  // 8
constexpr int kScoreStride = kTile + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

// Offer one candidate per lane (valid lanes only) to the warp's running
// top-k (bs, bi): entry `lane` of a list sorted by (score desc, id asc).
// Warp-uniform control flow; k in [1, 32].
__device__ __forceinline__ void offer(float& bs, int& bi, float cs, int ci,
                                      bool valid, int k) {
  const int lane = threadIdx.x & 31;
  float ts = __shfl_sync(kFull, bs, k - 1);
  int ti = __shfl_sync(kFull, bi, k - 1);
  unsigned m = __ballot_sync(kFull, valid && better(cs, ci, ts, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    const float xs = __shfl_sync(kFull, cs, src);
    const int xi = __shfl_sync(kFull, ci, src);
    // entries better than x are lanes [0, pos): x goes to lane pos
    const int pos =
        __popc(__ballot_sync(kFull, lane < k && better(bs, bi, xs, xi)));
    const float us = __shfl_up_sync(kFull, bs, 1);
    const int ui = __shfl_up_sync(kFull, bi, 1);
    if (lane == pos) {
      bs = xs;
      bi = xi;
    } else if (lane > pos && lane < k) {
      bs = us;
      bi = ui;
    }
    ts = __shfl_sync(kFull, bs, k - 1);
    ti = __shfl_sync(kFull, bi, k - 1);
    m &= m - 1;
    m &= __ballot_sync(kFull, valid && better(cs, ci, ts, ti));
  }
}

constexpr int kC4 = kChunk / 4;               // float4 columns of a chunk
constexpr int kRowsPerLoad = kThreads / kC4;  // 32
constexpr int kLoads = kTile / kRowsPerLoad;  // float4 per thread

// Chunk `it` of this split (tile it / n_ec, embedding columns
// (it % n_ec) * kChunk ..) into registers: thread t holds column t % 8 of
// rows t / 8 + 32 l, so a warp reads 4 rows x 128 contiguous bytes.
__device__ __forceinline__ void fetch_docs(const float* __restrict__ docs,
                                           int D, int E, int tile0, int n_ec,
                                           int it, float4 (&v)[kLoads]) {
  const int d0 = (tile0 + it / n_ec) * kTile, e0 = (it % n_ec) * kChunk;
  const int c = threadIdx.x % kC4, r0 = threadIdx.x / kC4;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int r = r0 + kRowsPerLoad * l;
    v[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e0 + 4 * c < E && d0 + r < D)
      v[l] = *reinterpret_cast<const float4*>(docs + (int64_t)(d0 + r) * E +
                                              e0 + 4 * c);
  }
}

__global__ void __launch_bounds__(kThreads)
dense_topk_partial(const float* __restrict__ q, const float* __restrict__ docs,
                   float* __restrict__ part_s, int* __restrict__ part_i,
                   int Q, int D, int E, int k, int tiles_per_split, int S) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [E][kTile]
  float* Ds = Qs + E * kTile;                   // [kChunk][kStride]
  float* Sc = Ds + kChunk * kStride;            // [kTile][kScoreStride]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tr = t >> 4, tc = t & 15;
  const int q0 = blockIdx.x * kTile, split = blockIdx.y;
  const int e4 = E / 4;

  // the query tile, transposed (neighbouring threads on neighbouring
  // rows, so the stores do not collide on a bank); rows past Q are zeros
  for (int idx = t; idx < kTile * e4; idx += kThreads) {
    const int r = idx % kTile, c = idx / kTile;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Q)
      v = reinterpret_cast<const float4*>(q + (int64_t)(q0 + r) * E)[c];
    Qs[(4 * c + 0) * kTile + r] = v.x;
    Qs[(4 * c + 1) * kTile + r] = v.y;
    Qs[(4 * c + 2) * kTile + r] = v.z;
    Qs[(4 * c + 3) * kTile + r] = v.w;
  }

  float bs[kQueriesPerWarp];
  int bi[kQueriesPerWarp];
#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    bs[j] = -CUDART_INF_F;
    bi[j] = INT_MAX;
  }

  // one step per (tile, embedding chunk) of this split; the next step's
  // rows are loaded into registers while this step's FMAs run
  const int n_tiles = (D + kTile - 1) / kTile;
  const int tile0 = split * tiles_per_split;
  const int n_ec = (E + kChunk - 1) / kChunk;
  const int n_it = (min(tile0 + tiles_per_split, n_tiles) - tile0) * n_ec;
  const int sc = t % kC4, sr = t / kC4;
  float4 nxt[kLoads];
  fetch_docs(docs, D, E, tile0, n_ec, 0, nxt);
  fp32_tile::Acc acc;
  acc.zero();
  for (int it = 0; it < n_it; ++it) {
    const int ei = it % n_ec, e0 = ei * kChunk;
    __syncthreads();  // Ds and Sc free again (the Qs stores, first time)
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int r = sr + kRowsPerLoad * l;
      Ds[(4 * sc + 0) * kStride + r] = nxt[l].x;
      Ds[(4 * sc + 1) * kStride + r] = nxt[l].y;
      Ds[(4 * sc + 2) * kStride + r] = nxt[l].z;
      Ds[(4 * sc + 3) * kStride + r] = nxt[l].w;
    }
    __syncthreads();
    if (it + 1 < n_it) fetch_docs(docs, D, E, tile0, n_ec, it + 1, nxt);
    fp32_tile::fma_chunk(Qs + e0 * kTile, kTile, Ds, kStride,
                         min(kChunk, E - e0), tr, tc, acc);
    if (ei != n_ec - 1) continue;

    // the tile's 64 x 64 scores, folded into the running top-k lists
    const int d0 = (tile0 + it / n_ec) * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Sc[(4 * tr + i) * kScoreStride + 4 * tc + j] = acc.v[i][j];
    acc.zero();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQueriesPerWarp; ++j) {
      const int r = warp + kWarps * j;
      if (q0 + r >= Q) continue;  // warp-uniform
#pragma unroll
      for (int h = 0; h < kTile / 32; ++h) {
        const int c = lane + 32 * h;
        offer(bs[j], bi[j], Sc[r * kScoreStride + c], d0 + c, d0 + c < D, k);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    const int qi = q0 + warp + kWarps * j;
    if (qi < Q && lane < k) {
      const int64_t o = ((int64_t)qi * S + split) * k + lane;
      part_s[o] = bs[j];
      part_i[o] = bi[j];
    }
  }
}

// One warp per query: fold the S * k partial candidates into the top-k.
__global__ void __launch_bounds__(kThreads)
dense_topk_merge(const float* __restrict__ part_s,
                 const int* __restrict__ part_i, float* __restrict__ out_s,
                 int* __restrict__ out_i, int Q, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qi >= Q) return;  // whole warp
  const float* s = part_s + (int64_t)qi * n;
  const int* ids = part_i + (int64_t)qi * n;
  float bs = -CUDART_INF_F;
  int bi = INT_MAX;
  constexpr int kUnroll = 4;  // loads in flight before the first offer
  for (int c0 = 0; c0 < n; c0 += 32 * kUnroll) {
    float cs[kUnroll];
    int ci[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u + lane;
      cs[u] = c < n ? s[c] : -CUDART_INF_F;
      ci[u] = c < n ? ids[c] : INT_MAX;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      offer(bs, bi, cs[u], ci[u], c0 + 32 * u + lane < n, k);
  }
  if (lane < k) {
    out_s[(int64_t)qi * k + lane] = bs;
    out_i[(int64_t)qi * k + lane] = bi;
  }
}

// Dynamic shared memory of the partial kernel for embedding width E.
int dense_topk_smem_bytes(int E) {
  return (E * kTile + kChunk * kStride + kTile * kScoreStride) *
         static_cast<int>(sizeof(float));
}

}  // namespace

// q (Q, E), docs (D, E): contiguous float32, E % 4 == 0, 16-byte aligned.
// part_s / part_i: (Q, S, k) scratch; out_s / out_i: (Q, k).
// The doc axis is cut into 64-doc tiles, tiles_per_split to a block;
// S = ceil(ceil(D / 64) / tiles_per_split).  1 <= k <= min(32, D).
extern "C" int dense_topk_f32(const void* q, const void* docs, void* part_s,
                              void* part_i, void* out_s, void* out_i, int Q,
                              int D, int E, int k, int tiles_per_split, int S,
                              void* stream) {
  const int n_tiles = (D + kTile - 1) / kTile;
  if (Q <= 0 || D <= 0 || E <= 0 || E % 4 != 0 || k < 1 || k > 32 ||
      k > D || tiles_per_split < 1 || S < 1 ||
      (long long)(S - 1) * tiles_per_split >= n_tiles ||
      (long long)S * tiles_per_split < n_tiles || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = dense_topk_smem_bytes(E);
  // The attribute is per device, so it is set at every launch (cheap).
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dense_topk_partial<<<dim3((Q + kTile - 1) / kTile, S), kThreads, smem,
                       s>>>(
      static_cast<const float*>(q), static_cast<const float*>(docs),
      static_cast<float*>(part_s), static_cast<int*>(part_i), Q, D, E, k,
      tiles_per_split, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_topk_merge<<<(Q + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), Q, S * k, k);
  return static_cast<int>(cudaGetLastError());
}
