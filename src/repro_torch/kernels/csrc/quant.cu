// K2: int8 absmax quantize of the (K, L) update stack, one CTA per row.
//
// Replaces the TPU kernel `_quant_int8_kernel` / `quantize_pack_int8` in
// src/repro/kernels/quant.py (pallas_call at :90), which the reference
// vmaps over workers; here the K rows are batched into one launch.
//
//   pass 1: absmax = max |x|           (fabsf/fmaxf: exact in any order)
//   scale  = absmax/127 + 1e-30, or 1 for an all-zero row
//   pass 2: q = (int8) clip(rint(x / scale), -127, 127)
//
// Bit-identical to Int8Codec.encode_ref (src/repro/comm/codec.py:309-314,
// _absmax_scale at :178-184): the division is IEEE (__fdiv_rn), the
// scale is a divide then an add in f32 (__fdiv_rn, __fadd_rn), rintf
// rounds half to even like jnp.round, and the clip comes before the
// cast. Built with -fmad=false and never with --use_fast_math.
//
// What bounds it on an H100: bytes, K*(5L + 4) of them (0.66 MB at
// K = 8, L = 16384, ~0.2 us at 3.35 TB/s); at that size the launch
// latency dominates. The design reads the row twice (the second read
// hits L1/L2) rather than holding it, which keeps the kernel simple.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
quant_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, int L) {
  __shared__ float red[kThreads / 32];
  __shared__ float row_scale;
  const int k = blockIdx.x;
  const float* xk = x + (size_t)k * L;
  int8_t* qk = q + (size_t)k * L;

  float amax = 0.f;
  for (int i = threadIdx.x; i < L; i += kThreads) amax = fmaxf(amax, fabsf(xk[i]));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    amax = warp_max(red[threadIdx.x]);
    if (threadIdx.x == 0) {
      // (float)1e-30 rounds the double literal to f32, as the reference
      // rounds its Python float
      const float s = amax > 0.f
          ? __fadd_rn(__fdiv_rn(amax, 127.0f), (float)1e-30) : 1.0f;
      row_scale = s;
      scales[k] = s;
    }
  }
  __syncthreads();
  const float s = row_scale;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const float r = rintf(__fdiv_rn(xk[i], s));
    qk[i] = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
  }
}

}  // namespace

extern "C" int quant_int8_launch(const float* x, int8_t* q, float* scales,
                                 int K, int L, void* stream) {
  quant_int8_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, scales, L);
  return (int)cudaGetLastError();
}
