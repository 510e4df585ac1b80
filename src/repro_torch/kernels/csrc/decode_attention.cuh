// Single-query GQA attention for Hopper (sm_90a): the body of the dense
// flash-decode kernel (flash_decode.cu, K1), which passes where position
// p's K/V row lies as a `Rows` functor.  The paged kernel
// (paged_flash_decode.cu, K2) has a body of its own and takes only the
// helpers here (load8, the (D, G) dispatch).
//
// One block of kThreads threads serves one (kv head, slot) pair and all G
// query heads of that kv head:
//   * each thread loads 16 contiguous bytes (8 bf16) of a row; a row of D
//     values is read by D/8 neighbouring lanes, so a warp covers 32*8/D
//     rows per iteration in fully coalesced 16-byte loads, and the next
//     iteration's rows are fetched before the current ones are used;
//   * the loop stops at the slot's length n: the masked tail is never read;
//   * every (warp, row-in-warp) pair runs its own online softmax (m, l, acc
//     in fp32 registers) over a strided share of the positions; the states
//     merge by shuffles inside the warp, then across warps through shared
//     memory.  No scratch in device memory and no second pass.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attention {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// q: query head j*G of this slot (heads j*G .. j*G+G-1 lie q_sh apart);
// out: the same for the output.  rows(p, k, v) sets k and v to the start
// of position p's row of this block's kv head; it is called only for
// p < n.  D: head dim (64 or 128).  MAXG: query heads per kv head,
// rounded up to the instantiated bucket; the runtime G <= MAXG guards
// the unrolled loops.
template <int D, int MAXG, class Rows>
__device__ __forceinline__ void attend(const bf16* __restrict__ q,
                                       int64_t q_sh, bf16* __restrict__ out,
                                       int64_t o_sh, const Rows& rows, int n,
                                       int G, float scale) {
  constexpr int kLanesPerRow = D / 8;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStreams = kWarps * kRowsPerWarp;

  __shared__ float s_m[kWarps][MAXG];
  __shared__ float s_l[kWarps][MAXG];
  __shared__ float s_acc[kWarps][MAXG][D];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / kLanesPerRow;  // row of this warp's iteration
  const int dl = lane % kLanesPerRow;   // 8-wide chunk of the head dim

  float qf[MAXG][8];
  float m[MAXG], l[MAXG], acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
    if (g < G) {
      load8(q + g * q_sh + dl * 8, qf[g]);
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
    }
  }

  // every lane of a warp runs the same trip count (the shuffles below
  // need the full warp); rows past n are loaded as nothing and skipped
  const bf16* kr;
  const bf16* vr;
  int p = warp * kRowsPerWarp + sub;
  float kf[8] = {}, vf[8] = {};
  if (p < n) {
    rows(p, kr, vr);
    load8(kr + dl * 8, kf);
    load8(vr + dl * 8, vf);
  }
  for (int base = warp * kRowsPerWarp; base < n; base += kStreams) {
    const bool valid = p < n;
    const int pn = p + kStreams;
    float kn[8] = {}, vn[8] = {};
    if (pn < n) {
      rows(pn, kr, vr);
      load8(kr + dl * 8, kn);
      load8(vr + dl * 8, vn);
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
    out[g * o_sh + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

// Calls f.template run<D, MAXG>() for the instantiated bucket of (D, G)
// and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a (D, G) no bucket covers.
template <int D, class F>
int dispatch_group(int G, const F& f) {
  if (G == 1)
    f.template run<D, 1>();
  else if (G == 2)
    f.template run<D, 2>();
  else if (G <= 4)
    f.template run<D, 4>();
  else if (G <= 8)
    f.template run<D, 8>();
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int dispatch(int D, int G, const F& f) {
  if (D == 128) return dispatch_group<128>(G, f);
  if (D == 64) return dispatch_group<64>(G, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode_attention
