// RPL004 fixture: dynamic shared memory opted in, its bytes unbounded.
__global__ void unbounded_kernel(float* out) {
  extern __shared__ float smem[];
  out[0] = smem[0];
}

int launch(float* out, int n) {
  const int bytes = n * 4;
  cudaFuncSetAttribute(unbounded_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  unbounded_kernel<<<1, 32, bytes>>>(out);
  return 0;
}
