// RPL004 fixture: a size the estimator cannot bound.
__global__ void unbound_kernel(float* out) {
  __shared__ float buf[kMystery];
  out[0] = buf[0];
}
