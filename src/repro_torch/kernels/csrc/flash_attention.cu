// Flash attention for Hopper (sm_90a): blocked online-softmax GQA
// attention over a whole sequence, causal or not -- the no-cache forward
// of a transformer layer (training-time evaluation, full-sequence
// scoring).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, body _flash_kernel; wrapper
// src/repro/kernels/ops.py::flash_attention).  Same function:
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D))
//                  * v[b, j, h / G]
// with, under `causal`, the scores of j > i set to -1e30 (positions by
// index from 0 for both q and kv, as the reference's mask), f32 scores,
// f32 softmax state and accumulation, normalised by max(l, 1e-30), out
// in bf16.
//
// Bound.  At the training shape (B=4, S=1024, H=Hkv=40, D=128, causal) a
// call must read Q, K, V and write O once: 4 x 41.9 MB / 3.35 TB/s =
// 50.1 us; it does 4 * B * H * D * S(S+1)/2 = 43.0 GFLOP, 43.5 us at the
// 989 TFLOP/s of the bf16 tensor cores.  The two are close, so the kernel
// must keep both the tensor cores and the memory busy.  What the design
// does about it:
//   * Q, K and V are read in place in the model's (B, S, H, D) layout
//     through strides: no transpose to (B*H, S, D) and no GQA copy (the
//     TPU wrapper does both with jnp.repeat); query head h reads kv head
//     h / G.
//   * One block of 4 warps per (q tile of 64 rows, head, batch); a loop
//     over 64-row kv tiles takes the place of the TPU's sequential kv grid
//     axis.  Under `causal` the loop stops at the diagonal tile: tiles past
//     it are fully masked and would add exactly 0.  Blocks start with the
//     last q tiles, the longest rows, so the short ones fill the tail.
//   * Both products on the tensor cores through mma.sync m16n8k16
//     (bf16 in, f32 accumulate): S = Q K^T with Q held in registers for
//     the whole loop, then O += P V with P rounded to bf16 from the
//     registers that hold S.  Each warp owns 16 query rows, so the row max
//     and sum need only shuffles within a quad of lanes.
//   * K and V tiles are staged in shared memory by cp.async (rows past the
//     sequence zero-filled), padded by 16 bytes a row so ldmatrix reads
//     are free of bank conflicts; V's load overlaps S's product and the
//     next K's load overlaps the P V product.
// A simple kernel that is right first: wgmma, TMA and warp specialisation
// are later work.
//
// Plain C interface (bound with ctypes), launched on the caller's stream.
// The function returns the CUDA error of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kLd = D + 8;  // padded smem row, in bf16
  static constexpr int kTile = kBlockN * kLd;
  static constexpr int kBytes = (kBlockM * kLd + 2 * kTile) * 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows row0 .. row0+63 of one head (row r at base + r * row_stride) into a
// padded smem tile; rows >= n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(kBlockN * kChunks % kThreads == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < kBlockN * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const bf16* src = base + (valid ? row : 0) * row_stride + c * 8;
    cp_async16(tile + r * Layout<D>::kLd + c * 8, src, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t): A holds rows g and
// g + 8, columns 2t, 2t + 1 (+ 8); B holds column g, rows 2t, 2t + 1
// (+ 8); C holds rows g and g + 8, columns 2t, 2t + 1.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int Sq, int Skv, int G, int causal, int64_t q_sb,
                       int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                       int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh,
                       float scale_log2) {
  constexpr int kLd = Layout<D>::kLd;
  constexpr int kDChunks = D / 16;     // k-steps of S = Q K^T
  constexpr int kDTiles = D / 8;       // n-tiles of O
  constexpr int kNTiles = kBlockN / 8; // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBlockM * kLd;
  bf16* sV = sK + Layout<D>::kTile;

  const int n_qt = (Sq + kBlockM - 1) / kBlockM;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + (h / G) * k_sh;
  const bf16* vb = v + b * v_sb + (h / G) * v_sh;

  // kv tiles this q tile sees: under `causal`, up to its last row
  const int kv_end = causal ? min(Skv, q0 + kBlockM) : Skv;
  const int n_kt = (kv_end + kBlockN - 1) / kBlockN;

  load_tile<D>(sQ, qb, q_ss, q0, Sq);
  load_tile<D>(sK, kb, k_ss, 0, Skv);
  cp_async_commit();

  uint32_t qf[kDChunks][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // this lane's rows: warp * 16 + g and + 8; l is the lane's partial sum
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;

  for (int j = 0; j < n_kt; ++j) {
    const int kv0 = j * kBlockN;
    load_tile<D>(sV, vb, v_ss, kv0, Skv);
    cp_async_commit();
    cp_async_wait<1>();  // Q (first pass) and this K tile have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < kDChunks; ++kc)
        ldsm_x4(qf[kc], sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * kLd + kc * 16 + (lane >> 4) * 8);
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 kv rows
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kDChunks; ++kc) {
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd
                        + kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // mask, then the online softmax in the log2 domain
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + 2 * t + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        const bool ok = col < Skv && (!causal || col <= row);
        const float x = ok ? s[n][e] * scale_log2 : kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_r[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rs[i];
#pragma unroll
    for (int d = 0; d < kDTiles; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    __syncthreads();  // every warp is done with this K tile
    if (j + 1 < n_kt) load_tile<D>(sK, kb, k_ss, kv0 + kBlockN, Skv);
    cp_async_commit();   // (possibly empty) group: keeps the count uniform
    cp_async_wait<1>();  // this V tile has landed
    __syncthreads();

    // O += P V, P from the S registers (C layout = A layout, in pairs)
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pf[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pf[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pf[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, sV + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                   * kLd + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this V tile
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
  bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    if (row < Sq) {
      bf16* orow = ob + row * o_ss + 2 * t;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
        *reinterpret_cast<uint32_t*>(orow + d * 8) =
            pack_bf16(acc[d][2 * i] * inv[i], acc[d][2 * i + 1] * inv[i]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int G, int Sq, int Skv, int causal, const int64_t* st,
           float scale_log2, cudaStream_t stream) {
  const int bytes = Layout<D>::kBytes;
  // above 48 KB only as opted-in dynamic shared memory; set at every
  // launch (the attribute is per device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, G, causal,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), o (B, Sq, H, D), bf16, unit last
// stride; strides in elements: q, k, v, o each (batch, seq, head).
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Skv, int D, int causal, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, B, H, H / Hkv, Sq, Skv, causal, st,
                       scale_log2, s);
  if (D == 64)
    return launch<64>(q, k, v, o, B, H, H / Hkv, Sq, Skv, causal, st,
                      scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
