// K1: the CoCoA local SCD solve, all K workers in one launch.
//
// Replaces the TPU kernel `_scd_kernel` / `scd_pallas` in
// src/repro/kernels/scd.py (pallas_call at :137). Each CTA is one worker;
// it runs that worker's H sequential coordinate steps in a loop inside
// the block, which takes the place of the TPU's sequential grid.
//
// Per step s, with j = idx[k, s] and c = column j (contiguous, because the
// data is stored column-major as A_T of shape (K, n_pad, m)):
//   z~  = (sigma*||c||^2 * a_j - rho . c) / (sigma*||c||^2 + lam*eta)
//   z   = sign(z~) * max(|z~| - lam*(1-eta)/denom, 0); z = a_j for a zero column
//   rho += sigma*(z - a_j) * c;  alpha_j = z
// and at the end delta_v = (rho - w) / sigma.
//
// What bounds it on an H100: not bytes (a round reads the visited columns,
// about 1.3 GB at m = 16384, H = 4096, K = 8, i.e. ~0.4 ms at 3.35 TB/s)
// but the serial dependency between steps: every step needs the previous
// step's rho, so each step is a column load followed by a block-wide
// reduction and two barriers, 4096 times over, on only K of the 132 SMs.
// What the design does about it: the column is loaded once per step into
// registers (coalesced: thread t reads elements t, t+1024, ...) and reused
// for the rho update; rho and the worker's alpha block stay in shared
// memory for the whole round, so no step touches device memory except for
// its column; the reduction is warp shuffles plus one 32-slot exchange.
// Prefetching the next column and spreading rho over a thread-block
// cluster to use more SMs are left for later work.
//
// Compiled with -fmad=false: the f32 arithmetic is the plain version's,
// except that the dot product is summed in another order (hence the
// rtol 1e-4, atol 1e-5 contract).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads, 1)
scd_kernel(const float* __restrict__ A_T, const float* __restrict__ col_sq,
           const float* __restrict__ alpha_in, const float* __restrict__ w,
           const int32_t* __restrict__ idx, float* __restrict__ alpha_out,
           float* __restrict__ delta_v, int n_pad, int m, int H,
           float sigma, float lam_eta, float lam_l1) {
  extern __shared__ float smem[];
  float* rho = smem;               // m: the worker's local residual
  float* alpha = rho + m;          // n_pad: the worker's alpha block
  float* red = alpha + n_pad;      // kWarps: per-warp partial dots
  float* move = red + kWarps;      // 1: the step's sigma*(z - a)

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* A_k = A_T + (size_t)k * n_pad * m;
  const float* csq_k = col_sq + (size_t)k * n_pad;
  const int32_t* idx_k = idx + (size_t)k * H;

  for (int i = tid; i < m; i += kThreads) rho[i] = w[i];
  for (int i = tid; i < n_pad; i += kThreads)
    alpha[i] = alpha_in[(size_t)k * n_pad + i];
  __syncthreads();

  for (int s = 0; s < H; ++s) {
    const int j = idx_k[s];
    if (j < 0 || j >= n_pad) __trap();   // an index outside the block
    const float* col = A_k + (size_t)j * m;
    float c[ITEMS];
    float part = 0.f;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * kThreads;
      c[it] = (i < m) ? col[i] : 0.f;
      if (i < m) part += rho[i] * c[it];
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (warp == 0) {
      const float dot = warp_sum(red[lane]);
      if (lane == 0) {
        const float csq = csq_k[j];
        const float a = alpha[j];
        const float scsq = sigma * csq;
        const float denom = scsq + lam_eta;
        const float z_tilde = (scsq * a - dot) / denom;
        const float sgn = z_tilde > 0.f ? 1.f : (z_tilde < 0.f ? -1.f : 0.f);
        float z = sgn * fmaxf(fabsf(z_tilde) - lam_l1 / denom, 0.f);
        z = csq > 0.f ? z : a;           // zero (padded) column: no-op
        alpha[j] = z;
        move[0] = sigma * (z - a);
      }
    }
    __syncthreads();
    const float mv = move[0];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * kThreads;
      if (i < m) rho[i] = rho[i] + mv * c[it];
    }
  }
  __syncthreads();
  for (int i = tid; i < n_pad; i += kThreads)
    alpha_out[(size_t)k * n_pad + i] = alpha[i];
  for (int i = tid; i < m; i += kThreads)
    delta_v[(size_t)k * m + i] = (rho[i] - w[i]) / sigma;
}

template <int ITEMS>
cudaError_t launch(const float* A_T, const float* col_sq,
                   const float* alpha_in, const float* w, const int32_t* idx,
                   float* alpha_out, float* delta_v, int K, int n_pad, int m,
                   int H, float sigma, float lam_eta, float lam_l1,
                   size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      scd_kernel<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  scd_kernel<ITEMS><<<K, kThreads, smem, stream>>>(
      A_T, col_sq, alpha_in, w, idx, alpha_out, delta_v, n_pad, m, H, sigma,
      lam_eta, lam_l1);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one CTA needs: rho, alpha, the reduction slots
// and the broadcast slot. The wrapper checks it against the 227 KB a
// block may use before it launches.
extern "C" long long scd_shared_bytes(int m, int n_pad) {
  return (long long)sizeof(float) * ((long long)m + n_pad + kWarps + 1);
}

extern "C" int scd_launch(const float* A_T, const float* col_sq,
                          const float* alpha_in, const float* w,
                          const int32_t* idx, float* alpha_out,
                          float* delta_v, int K, int n_pad, int m, int H,
                          float sigma, float lam_eta, float lam_l1,
                          void* stream) {
  const size_t smem = (size_t)scd_shared_bytes(m, n_pad);
  const int items = (m + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SCD_CASE(N)                                                        \
  if (items <= N)                                                          \
    return (int)launch<N>(A_T, col_sq, alpha_in, w, idx, alpha_out,        \
                          delta_v, K, n_pad, m, H, sigma, lam_eta, lam_l1, \
                          smem, st);
  SCD_CASE(1)
  SCD_CASE(2)
  SCD_CASE(4)
  SCD_CASE(8)
  SCD_CASE(16)
  SCD_CASE(32)
  SCD_CASE(64)
#undef SCD_CASE
  return (int)cudaErrorInvalidValue;
}
