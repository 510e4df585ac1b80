// RPL004 fixture: dynamic shared memory bounded but never opted in.
constexpr int kMaxSmem = 227 * 1024;
constexpr int kSmemBytes = 64 * 1024;
static_assert(kSmemBytes <= kMaxSmem, "over a block's shared memory");

__global__ void no_optin_kernel(float* out) {
  extern __shared__ float smem[];
  out[0] = smem[0];
}

int launch(float* out) {
  no_optin_kernel<<<1, 32, kSmemBytes>>>(out);
  return 0;
}
