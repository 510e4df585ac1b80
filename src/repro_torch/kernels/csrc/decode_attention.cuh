// Helpers of the paged flash-decode kernel (paged_flash_decode.cu, K2) for
// Hopper (sm_90a): its block shape, the 16-byte bf16 row load and the
// (D, G) dispatch over its instantiations.  The dense kernel
// (flash_decode.cu, K1) takes only the types and the masked-score value.

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
  if (D == 256) return dispatch_group<256>(G, f);
  if (D == 96) return dispatch_group<96>(G, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode_attention
