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
//   * Each thread loads 16 contiguous bytes (8 bf16); a row of D values
//     is read by D/8 neighbouring lanes, so a warp covers 32*8/D rows per
//     iteration in fully coalesced 16-byte loads, and the next
//     iteration's rows are fetched before the current ones are used.
//   * Every (warp, row-in-warp) pair runs its own online softmax
//     (m, l, acc in fp32 registers) over a strided share of the
//     positions; the states merge by shuffles inside the warp, then
//     across warps through shared memory.  No scratch in device memory
//     and no second pass.
//
// Plain C interface (bound with ctypes), launched on the caller's stream.
// The function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// D: head dim (64 or 128).  MAXG: query heads per kv head, rounded up to
// the instantiated bucket; the runtime G <= MAXG guards the unrolled loops.
template <int D, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int G, int L,
                    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sl,
                    int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh,
                    int64_t o_sb, int64_t o_sh, float scale) {
  constexpr int kLanesPerRow = D / 8;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStreams = kWarps * kRowsPerWarp;

  __shared__ float s_m[kWarps][MAXG];
  __shared__ float s_l[kWarps][MAXG];
  __shared__ float s_acc[kWarps][MAXG][D];

  const int j = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / kLanesPerRow;  // row of this warp's iteration
  const int dl = lane % kLanesPerRow;   // 8-wide chunk of the head dim

  int n = lengths[b];
  n = n < 1 ? 1 : (n > L ? L : n);

  float qf[MAXG][8];
  float m[MAXG], l[MAXG], acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
    if (g < G) {
      load8(q + b * q_sb + (int64_t)(j * G + g) * q_sh + dl * 8, qf[g]);
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
    }
  }

  const __nv_bfloat16* kb = k + b * k_sb + j * k_sh + dl * 8;
  const __nv_bfloat16* vb = v + b * v_sb + j * v_sh + dl * 8;

  // every lane of a warp runs the same trip count (the shuffles below
  // need the full warp); rows past n are loaded as nothing and skipped
  int p = warp * kRowsPerWarp + sub;
  float kf[8] = {}, vf[8] = {};
  if (p < n) {
    load8(kb + p * k_sl, kf);
    load8(vb + p * v_sl, vf);
  }
  for (int base = warp * kRowsPerWarp; base < n; base += kStreams) {
    const bool valid = p < n;
    const int pn = p + kStreams;
    float kn[8] = {}, vn[8] = {};
    if (pn < n) {
      load8(kb + pn * k_sl, kn);
      load8(vb + pn * v_sl, vn);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += qf[g][i] * kf[i];
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid) {
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float pr = expf(s - m_new);
          l[g] = l[g] * alpha + pr;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = acc[g][i] * alpha + pr * vf[i];
          m[g] = m_new;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      kf[i] = kn[i];
      vf[i] = vn[i];
    }
    p = pn;
  }

  // merge the rows of a warp: lanes kLanesPerRow apart hold the same dims
#pragma unroll
  for (int off = kLanesPerRow; off < 32; off <<= 1) {
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

  // merge the warps through shared memory
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s_acc[warp][g][dl * 8 + i] = acc[g][i];
        if (dl == 0) {
          s_m[warp][g] = m[g];
          s_l[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += blockDim.x) {
    const int g = t / D, d = t % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - mx);
      den += s_l[w][g] * c;
      num += s_acc[w][g][d] * c;
    }
    out[b * o_sb + (int64_t)(j * G + g) * o_sh + d] =
        __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <int D, int MAXG>
void launch(dim3 grid, cudaStream_t s, const void* q, const void* k,
            const void* v, const void* lengths, void* out, int G, int L,
            const long long* st, float scale) {
  flash_decode_kernel<D, MAXG><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), G, L, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], scale);
}

template <int D>
int launch_d(dim3 grid, cudaStream_t s, const void* q, const void* k,
             const void* v, const void* lengths, void* out, int G, int L,
             const long long* st, float scale) {
  if (G == 1)
    launch<D, 1>(grid, s, q, k, v, lengths, out, G, L, st, scale);
  else if (G == 2)
    launch<D, 2>(grid, s, q, k, v, lengths, out, G, L, st, scale);
  else if (G <= 4)
    launch<D, 4>(grid, s, q, k, v, lengths, out, G, L, st, scale);
  else if (G <= 8)
    launch<D, 8>(grid, s, q, k, v, lengths, out, G, L, st, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

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
  const int G = H / Hkv;
  const long long st[10] = {q_sb, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sh};
  const dim3 grid(Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_d<128>(grid, s, q, k, v, lengths, out, G, L, st, scale);
  if (D == 64) return launch_d<64>(grid, s, q, k, v, lengths, out, G, L, st, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
