// The float32 tile product of dense top-k (dense_topk.cu, K3).
//
// A block of kThreads threads computes a kTile x kTile tile of
// A (rows, n) . B (cols, n)^T on CUDA cores, in exact float32 (fmaf, no
// TF32, no tensor cores).  Both operands are staged transposed in shared
// memory, contraction index major: A as As[e][row], B as Bs[e][col], so
// that a thread reads 4 neighbouring rows (or columns) in one 16-byte
// load.  Thread t owns rows 4 * (t / 16) .. +3 and columns
// 4 * (t % 16) .. +3 of the tile: 16 sums in registers, 16 FMAs for every
// two shared-memory loads.  Every sum runs over the contraction index in
// ascending order, so equal rows of B give bitwise-equal sums.

#pragma once

#include <cuda_runtime.h>

namespace fp32_tile {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows and columns of the output tile
constexpr int kChunk = 32;      // contraction indices staged per step
constexpr int kStride = kTile + 4;  // staged row stride (16-byte aligned)

struct Acc {
  float v[4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  }
};

// acc += As[e][4*tr .. 4*tr+3] (x) Bs[e][4*tc .. 4*tc+3] for e in [0, n).
// as / bs: row strides of the staged operands (multiples of 4 floats).
__device__ __forceinline__ void fma_chunk(const float* __restrict__ As,
                                          int as, const float* __restrict__ Bs,
                                          int bs, int n, int tr, int tc,
                                          Acc& acc) {
#pragma unroll 8
  for (int e = 0; e < n; ++e) {
    const float4 a = *reinterpret_cast<const float4*>(As + e * as + 4 * tr);
    const float4 b = *reinterpret_cast<const float4*>(Bs + e * bs + 4 * tc);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
  }
}

}  // namespace fp32_tile
