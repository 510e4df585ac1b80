// BM25 scoring for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/bm25.py (bm25_pallas; body
// _bm25_kernel).  Same function, on the wrapper's prepared inputs:
//   out[q, d] = sum_v wq[q, v] * tf[d, v] * (k1 + 1) / (tf[d, v] + norm[d])
// with wq = query_tf * idf and norm[d] = k1 * (1 - b + b * len_d / avg)
// computed beforehand in torch, as the reference's ops.bm25_scores does.
//
// Bound: max(bytes / 3.35 TB/s, ops / 67 TFLOP/s).  Bytes: tf once, wq
// once, the (Q, D) output once (Q = 64, D = 20,000, V = 4096: 327.7 MB of
// tf, 1 MB of wq, 5.1 MB out, about 100 us).  Ops: the contraction,
// 2 Q D V, plus the saturation, 3 D V (10.5 GFLOP, about 157 us): the
// float32 FMAs on CUDA cores are the floor.  What the design does:
//   * A tiled float32 product on CUDA cores (fp32_tile.cuh): one block per
//     64 x 64 (query, doc) output tile, the vocab contraction staged in
//     chunks of 32 and summed in registers; no scratch in device memory,
//     no second pass.
//   * The saturation is applied as each tf chunk is staged into shared
//     memory, so every (d, v) is saturated once per 64-query tile and the
//     inner loop is pure FMA; a zero tf (most of them) skips the division.
//   * The next chunk of wq and tf is loaded into registers while the
//     current chunk is multiplied.
//   * Every axis is masked in the kernel: any Q, D and V, no padding
//     (the reference's wrapper falls back to whole-axis blocks).
//   * Exact float32: fmaf, IEEE division, no TF32, no tensor cores.
//   * Dense in V: tf is about 97% zeros on the synthetic corpus, and the
//     dense tile product reads and multiplies them all.  A sparse
//     (inverted-index) kernel would read only the nonzeros; later work.
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"

namespace {

using fp32_tile::kChunk;
using fp32_tile::kStride;
using fp32_tile::kThreads;
using fp32_tile::kTile;

constexpr int kRowsPerPass = kThreads / kChunk;        // 8
constexpr int kPasses = kTile / kRowsPerPass;          // 8

__global__ void __launch_bounds__(kThreads)
bm25_kernel(const float* __restrict__ wq, const float* __restrict__ tf,
            const float* __restrict__ norm, float* __restrict__ out, int Q,
            int D, int V, float k1p1) {
  __shared__ __align__(16) float As[kChunk * kStride];  // wq chunk [v][q]
  __shared__ __align__(16) float Bs[kChunk * kStride];  // saturated [v][d]
  const int t = threadIdx.x, tr = t >> 4, tc = t & 15;
  const int d0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  // staging: thread t loads column (t % 32) of rows t / 32 + 8 p, so each
  // warp reads 128 contiguous bytes of one row
  const int col = t % kChunk, row0 = t / kChunk;
  float nrm[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int d = d0 + row0 + kRowsPerPass * p;
    nrm[p] = d < D ? norm[d] : 1.f;
  }
  // the next chunk's raw values are loaded into registers while the
  // current chunk's FMAs run
  float a[kPasses], x[kPasses];
  auto fetch = [&](int v0) {
    const int v = v0 + col;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = row0 + kRowsPerPass * p;
      a[p] = v < V && q0 + r < Q ? wq[(int64_t)(q0 + r) * V + v] : 0.f;
      x[p] = v < V && d0 + r < D ? tf[(int64_t)(d0 + r) * V + v] : 0.f;
    }
  };
  fetch(0);
  fp32_tile::Acc acc;
  acc.zero();
  for (int v0 = 0; v0 < V; v0 += kChunk) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = row0 + kRowsPerPass * p;
      As[col * kStride + r] = a[p];
      // tf is mostly zeros, whose saturation is 0: skip the division
      Bs[col * kStride + r] =
          x[p] == 0.f ? 0.f : x[p] * k1p1 / (x[p] + nrm[p]);
    }
    __syncthreads();
    if (v0 + kChunk < V) fetch(v0 + kChunk);
    fp32_tile::fma_chunk(As, kStride, Bs, kStride, min(kChunk, V - v0), tr,
                         tc, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * tr + i;
    if (qi >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 4 * tc + j;
      if (d < D) out[(int64_t)qi * D + d] = acc.v[i][j];
    }
  }
}

}  // namespace

// wq (Q, V), tf (D, V), norm (D,), out (Q, D): contiguous float32;
// k1p1 = k1 + 1.
extern "C" int bm25_f32(const void* wq, const void* tf, const void* norm,
                        void* out, int Q, int D, int V, float k1p1,
                        void* stream) {
  if (Q <= 0 || D <= 0 || V <= 0 || (Q + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bm25_kernel<<<dim3((D + kTile - 1) / kTile, (Q + kTile - 1) / kTile),
                kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wq), static_cast<const float*>(tf),
      static_cast<const float*>(norm), static_cast<float*>(out), Q, D, V,
      k1p1);
  return static_cast<int>(cudaGetLastError());
}
