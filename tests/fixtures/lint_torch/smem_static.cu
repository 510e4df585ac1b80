// RPL004 fixture: static shared memory.  Parsed, never compiled.
#include <cuda_bf16.h>

constexpr int kRows = 32;
constexpr int kCols = 64;
constexpr int kLd = kCols + 1;  // padded row
typedef float f32;

// 16 ints: counted once in each kernel that calls it
__device__ int helper_slots(int i) {
  __shared__ int slots[16];
  slots[i % 16] = i;
  return slots[0];
}

// a 2-D padded float tile, 32 x 65 floats = 8320 B, a flag of 8 B and
// the helper's 64 B: 8392 B
__global__ void padded_tile_kernel(float* out) {
  __shared__ f32 tile[kRows][kLd];
  __shared__ unsigned long long flag;
  out[0] = tile[0][0] + helper_slots(threadIdx.x) + flag;
}

// 2 D bytes of bf16 and 4 * 32 * kWarps of float
template <int D, int kWarps>
__global__ void templ_kernel(float* out) {
  constexpr int kThreads = kWarps * 32;
  __shared__ __nv_bfloat16 q[D];
  __shared__ float red[kThreads];
  out[0] = red[0] + __bfloat162float(q[0]);
}

// 3200 float4 = 51200 B, over the 49152 B without the opt-in
__global__ void big_kernel(float* out) {
  __shared__ float4 big[kRows * 100];
  out[0] = big[0].x;
}
