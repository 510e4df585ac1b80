// RPL004 fixture: a host check against the device's opt-in maximum.
__global__ void checked_kernel(float* out) {
  extern __shared__ float smem[];
  out[0] = smem[0];
}

int launch(float* out, int n) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int bytes = n * 4;
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(checked_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  checked_kernel<<<1, 32, bytes>>>(out);
  return 0;
}
