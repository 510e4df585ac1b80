// RPL004 fixture: both opt-in routes and a static_assert bound.
constexpr int kMaxSmem = 227 * 1024;

template <int D>
struct Cfg {
  static constexpr int kBytes = 512 * D;
};
static_assert(Cfg<256>::kBytes <= kMaxSmem, "over a block's shared memory");

template <int D>
__global__ void local_kernel(float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  out[0] = smem[0];
}

__global__ void param_kernel(float* out) {
  extern __shared__ float smem2[];
  out[0] = smem2[0];
}

// opted in through a local the kernel was assigned to
template <int D>
int launch_local(float* out) {
  const auto kernel = local_kernel<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Cfg<D>::kBytes);
  kernel<<<1, 32, Cfg<D>::kBytes>>>(out);
  return 0;
}

// opted in through a parameter of the launching function
template <class K>
int launch_one(K kernel, float* out, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  kernel<<<1, 32, bytes>>>(out);
  return 0;
}

int launch(float* out) {
  launch_local<256>(out);
  return launch_one(param_kernel, out, Cfg<128>::kBytes);
}
