// RPL004 fixture: suppressions in a CUDA source.
// repro: allow[RPL004] fixture: a preceding-line suppression
__global__ void allowed_kernel(float* out) {
  __shared__ float big[16384];
  out[0] = big[0];
}

__global__ void bare_kernel(float* out) {  // repro: allow[RPL004]
  __shared__ float big[16384];
  out[0] = big[0] + time.time();
}
