// Flash-decode for Hopper (sm_90a): single-query GQA attention over the
// dense slot cache, one query per slot.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_pallas, body _flash_decode_kernel).  Same function:
// out[b, h] = softmax(q[b, h] . K[b, :n_b, h / G]^T / sqrt(D)) V[b, :n_b, h / G]
// with n_b = clamp(lengths[b], 1, L); positions >= n_b never contribute.
//
// Bound: the K/V bytes.  A decode step reads every valid cache row once,
// sum_b n_b * Hkv * D * 2 (K and V) * 2 bytes, against ~4 flops per byte
// -- two orders of magnitude under the card's ops:byte balance, so the
// floor is those bytes over the 3.35 TB/s of HBM.  What the design does
// about it:
//   * K/V are read in place in the executor's (B, L, Hkv, D) layout
//     through strides: no per-call transpose (the TPU wrapper transposes
//     to kv-head-major on every call), no padded tail, no expanded GQA
//     copy.
//   * The loop stops at n_b: the masked tail is never read.
//   * One block per (kv head j, slot b) handles all G query heads of
//     that kv head, so each K/V row is fetched once for G heads.
//   * 16-byte loads and an online softmax merged by shuffles and shared
//     memory: the body in decode_attention.cuh, shared with the paged
//     kernel.
//
// Plain C interface (bound with ctypes), launched on the caller's stream.
// The function returns cudaGetLastError() after the launch.

#include "decode_attention.cuh"

namespace {

using decode_attention::bf16;
using decode_attention::kThreads;

// Row p of slot b, kv head j: k + b * k_sb + p * k_sl + j * k_sh.
struct DenseRows {
  const bf16* k;
  const bf16* v;
  int64_t k_sl, v_sl;
  __device__ __forceinline__ void operator()(int p, const bf16*& kr,
                                             const bf16*& vr) const {
    kr = k + p * k_sl;
    vr = v + p * v_sl;
  }
};

template <int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    int G, int L, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                    int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
                    int64_t v_sh, int64_t o_sb, int64_t o_sh, float scale) {
  const int j = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  int n = lengths[b];
  n = n < 1 ? 1 : (n > L ? L : n);
  const DenseRows rows{k + b * k_sb + j * k_sh, v + b * v_sb + j * v_sh,
                       k_sl, v_sl};
  decode_attention::attend<D, MAXG>(
      q + b * q_sb + (int64_t)j * G * q_sh, q_sh,
      out + b * o_sb + (int64_t)j * G * o_sh, o_sh, rows, n, G, scale);
}

struct Launch {
  dim3 grid;
  cudaStream_t s;
  const void *q, *k, *v, *lengths;
  void* out;
  int G, L;
  const long long* st;
  float scale;

  template <int D, int MAXG>
  void run() const {
    flash_decode_kernel<D, MAXG><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(lengths),
        static_cast<bf16*>(out), G, L, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], scale);
  }
};

}  // namespace

// q (B, H, D) strides (q_sb, q_sh); k/v (B, L, Hkv, D) strides
// (sb, sl, sh); out (B, H, D) strides (o_sb, o_sh); every last dim
// contiguous, every row 16-byte aligned; lengths (B,) int32.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, int B, int H,
                                 int Hkv, int L, int D, long long q_sb,
                                 long long q_sh, long long k_sb, long long k_sl,
                                 long long k_sh, long long v_sb, long long v_sl,
                                 long long v_sh, long long o_sb, long long o_sh,
                                 float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || L <= 0 || H % Hkv != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[10] = {q_sb, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sh};
  const Launch launch{dim3(Hkv, B), static_cast<cudaStream_t>(stream),
                      q, k, v, lengths, out, H / Hkv, L, st, scale};
  return decode_attention::dispatch(D, H / Hkv, launch);
}
