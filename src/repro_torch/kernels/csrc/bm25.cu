// BM25 scoring for Hopper (sm_90a), float32, over the nonzeros of tf.
//
// Replaces the TPU kernel src/repro/kernels/bm25.py (bm25_pallas; body
// _bm25_kernel).  Same function, on the wrapper's prepared inputs:
//   out[q, d] = sum_v wq[q, v] * tf[d, v] * (k1 + 1) / (tf[d, v] + norm[d])
// with wq = query_tf * idf and norm[d] = k1 * (1 - b + b * len_d / avg)
// computed beforehand in torch, as the reference's ops.bm25_scores does.
// tf comes as its nonzeros, row by row (kernels/bm25.py::BM25Csr: row_ptr,
// ascending cols, raw counts vals); the saturation is computed here, as in
// _bm25_kernel.  A zero tf adds +0 to every sum, so dropping the zeros
// changes nothing.
//
// Bound.  At the SQuAD-scale call (Q = 64, D = 20,000, V = 4096, 746,074
// nonzeros, 175,913 of them in the 82 terms the batch uses) the data needs
// cols (2.98 MB), row_ptr, norm and the used flags, vals and the weights of
// the used terms only (0.72 MB), and the (Q, D) output (5.12 MB): 8.99 MB,
// about 2.7 us of bytes at 3.35 TB/s.  The work is 2 Q + 3 operations a
// used nonzero, 23.0 MFLOP, 0.34 us at the float32 peak.  Bytes bound it;
// the dense tf it replaces is 327.7 MB (99.7 us) alone.  What the design
// does:
//   * One warp per document at a time, 8 warps a block, 32 documents a
//     block; each lane owns the queries lane + 32 i of the block's query
//     tile (64 a block), so one document's scores sit in the warp's
//     registers.
//   * The warp reads 32 of the document's nonzeros at once (coalesced
//     cols and vals), and each lane tests its term's used flag (used[v] =
//     any_q wq[q, v] != 0, read through the read-only cache): on the
//     synthetic corpus some three quarters of the nonzeros belong to terms
//     no query of the batch has, and are skipped.  Each lane saturates its
//     own nonzero once; a ballot then walks the used ones in ascending v,
//     broadcasting (v, saturation) by shuffle, and every lane multiplies it
//     into its queries' weights wqT[v, q] (wq transposed, a coalesced row
//     from L2).
//   * The sums run in ascending v with no atomics: the result does not
//     change from run to run, and it is the order of the dense sum with the
//     zeros left out.
//   * The block's (64 x 32) output tile is staged in shared memory and
//     written 32 documents wide, coalesced along d.
//   * Any Q, D and V; empty documents and zero query rows give 0; the
//     wrapper skips the launch for Q = 0 or D = 0 (an empty output).
//
// Plain C interface (bound with ctypes), launched on the caller's stream;
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDocs = 32;        // documents a block, kDocs / kWarps a warp
constexpr int kQPerLane = 2;
constexpr int kQTile = 32 * kQPerLane;  // queries a block
constexpr int kLd = kDocs + 1;          // padded smem row of the out tile

__global__ void __launch_bounds__(kThreads)
bm25_csr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ vals,
                const float* __restrict__ norm, const float* __restrict__ wqT,
                const unsigned char* __restrict__ used,
                float* __restrict__ out, int Q, int D, float k1p1) {
  __shared__ float tile[kQTile * kLd];  // [q][d] of this block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * kDocs, q0 = blockIdx.y * kQTile;
  for (int r = warp; r < kDocs; r += kWarps) {
    const int d = d0 + r;
    float acc[kQPerLane];
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) acc[i] = 0.f;
    if (d < D) {
      const int beg = row_ptr[d], end = row_ptr[d + 1];
      const float nrm = norm[d];
      for (int base = beg; base < end; base += 32) {
        const int p = base + lane;
        int v = 0;
        float sat = 0.f;
        bool live = false;
        if (p < end) {
          v = cols[p];
          live = __ldg(used + v) != 0;
          if (live) {
            const float x = vals[p];
            sat = x * k1p1 / (x + nrm);
          }
        }
        unsigned todo = __ballot_sync(0xffffffffu, live);
        while (todo) {  // ascending positions: ascending v
          const int j = __ffs(todo) - 1;
          todo &= todo - 1;
          const int vj = __shfl_sync(0xffffffffu, v, j);
          const float sj = __shfl_sync(0xffffffffu, sat, j);
          const float* w = wqT + static_cast<int64_t>(vj) * Q + q0 + lane;
#pragma unroll
          for (int i = 0; i < kQPerLane; ++i)
            if (q0 + lane + 32 * i < Q) acc[i] = fmaf(w[32 * i], sj, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) tile[(lane + 32 * i) * kLd + r] = acc[i];
  }
  __syncthreads();
  // out rows q0 .. q0 + 63, each kDocs documents wide
  for (int i = threadIdx.x; i < kQTile * kDocs; i += kThreads) {
    const int qi = i / kDocs, r = i % kDocs;
    const int q = q0 + qi, d = d0 + r;
    if (q < Q && d < D) out[static_cast<int64_t>(q) * D + d] = tile[qi * kLd + r];
  }
}

}  // namespace

// row_ptr (D + 1,) int32, cols (nnz,) int32, vals (nnz,) float32,
// norm (D,) float32, wqT (V, Q) float32, used (V,) bytes 0/1, out (Q, D)
// float32; all contiguous.  k1p1 = k1 + 1.
extern "C" int bm25_csr_f32(const void* row_ptr, const void* cols,
                            const void* vals, const void* norm,
                            const void* wqT, const void* used, void* out,
                            int Q, int D, float k1p1, void* stream) {
  if (Q <= 0 || D <= 0 || (Q + kQTile - 1) / kQTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bm25_csr_kernel<<<dim3((D + kDocs - 1) / kDocs, (Q + kQTile - 1) / kQTile),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(norm),
      static_cast<const float*>(wqT),
      static_cast<const unsigned char*>(used), static_cast<float*>(out), Q,
      D, k1p1);
  return static_cast<int>(cudaGetLastError());
}
