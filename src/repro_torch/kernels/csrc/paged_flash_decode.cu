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
// Bound: the K/V bytes, as for the dense kernel -- sum_b n_b * Hkv * D *
// 2 (K and V) * 2 bytes over the 3.35 TB/s of HBM; the table adds 4 bytes
// per page.  The design is the dense kernel's (decode_attention.cuh: one
// block per (kv head, slot) for all G query heads, 16-byte loads, the
// loop stops at n_b, online softmax merged by shuffles and shared memory);
// only the row address changes: one table lookup per row, which the L1
// serves for the ps rows of a page.  What that costs and guards:
//   * The pools are read in place in the executor's (num_pages, ps, Hkv,
//     D) layout through strides.  The TPU wrapper transposes the whole
//     pool to kv-head-major on every call; nothing is copied here.
//   * An idle slot parks its position at max_blocks * ps, so its length
//     is max_blocks * ps + 1: n_b is clamped to max_blocks * ps, as the
//     TPU grid never walks past max_blocks pages, and the table row is
//     never read out of bounds.
//   * Entries past a slot's allocation are zeros or stale page ids: they
//     are clamped into the pool and never dereferenced unclamped; rows
//     past n_b are never read at all.
//   * Shared prefix pages are only read here; copy-on-write lives in the
//     scheduler and the commit.
//
// Plain C interface (bound with ctypes), launched on the caller's stream.
// The function returns cudaGetLastError() after the launch.

#include "decode_attention.cuh"

namespace {

using decode_attention::bf16;
using decode_attention::kThreads;

// Row p of one slot, kv head j: page table[p / ps], offset p % ps.
struct PagedRows {
  const bf16* k;       // k_pages + j * k_sh
  const bf16* v;
  const int* table;    // this slot's table row, unit stride
  int ps, num_pages;
  int64_t k_sp, k_so, v_sp, v_so;
  __device__ __forceinline__ void operator()(int p, const bf16*& kr,
                                             const bf16*& vr) const {
    int page = __ldg(table + p / ps);
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const int o = p % ps;
    kr = k + page * k_sp + o * k_so;
    vr = v + page * v_sp + o * v_so;
  }
};

template <int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k_pages,
                          const bf16* __restrict__ v_pages,
                          const int* __restrict__ table,
                          const int* __restrict__ lengths,
                          bf16* __restrict__ out, int G, int ps,
                          int num_pages, int max_blocks, int64_t q_sb,
                          int64_t q_sh, int64_t k_sp, int64_t k_so,
                          int64_t k_sh, int64_t v_sp, int64_t v_so,
                          int64_t v_sh, int64_t t_sb, int64_t o_sb,
                          int64_t o_sh, float scale) {
  const int j = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int cap = max_blocks * ps;
  int n = lengths[b];
  n = n < 1 ? 1 : (n > cap ? cap : n);
  const PagedRows rows{k_pages + j * k_sh, v_pages + j * v_sh,
                       table + b * t_sb, ps, num_pages,
                       k_sp, k_so, v_sp, v_so};
  decode_attention::attend<D, MAXG>(
      q + b * q_sb + (int64_t)j * G * q_sh, q_sh,
      out + b * o_sb + (int64_t)j * G * o_sh, o_sh, rows, n, G, scale);
}

struct Launch {
  dim3 grid;
  cudaStream_t s;
  const void *q, *k, *v, *table, *lengths;
  void* out;
  int G, ps, num_pages, max_blocks;
  const long long* st;
  float scale;

  template <int D, int MAXG>
  void run() const {
    paged_flash_decode_kernel<D, MAXG><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(table),
        static_cast<const int*>(lengths), static_cast<bf16*>(out), G, ps,
        num_pages, max_blocks, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], scale);
  }
};

}  // namespace

// q (B, H, D) strides (q_sb, q_sh); k/v pages (num_pages, ps, Hkv, D)
// strides (sp, so, sh); table (B, max_blocks) int32, row stride t_sb,
// unit stride along blocks; lengths (B,) int32; out (B, H, D) strides
// (o_sb, o_sh).  Every last dim contiguous, every row 16-byte aligned.
extern "C" int paged_flash_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lengths, void* out, int B, int H, int Hkv,
    int num_pages, int ps, int max_blocks, int D, long long q_sb,
    long long q_sh, long long k_sp, long long k_so, long long k_sh,
    long long v_sp, long long v_so, long long v_sh, long long t_sb,
    long long o_sb, long long o_sh, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || num_pages <= 0 || ps <= 0 || max_blocks <= 0 ||
      H % Hkv != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[11] = {q_sb, q_sh, k_sp, k_so, k_sh, v_sp,
                            v_so, v_sh, t_sb, o_sb, o_sh};
  const Launch launch{dim3(Hkv, B), static_cast<cudaStream_t>(stream),
                      q, k_pages, v_pages, table, lengths, out, H / Hkv, ps,
                      num_pages, max_blocks, st, scale};
  return decode_attention::dispatch(D, H / Hkv, launch);
}
