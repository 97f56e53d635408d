// K3: int8 decode + reduce of the gathered (K, L) payload.
//
// Replaces the TPU kernel `_dec8_kernel` / `decode_reduce_int8` in
// src/repro/kernels/dequant.py (pallas_call at :123).
//
// A 1-D grid over L; each thread owns one element and walks the workers
// in order:  acc = q[0]*s[0];  acc = acc + q[k]*s[k] for k = 1..K-1;
// the mean multiplies by the f32-rounded 1/K. That is the op sequence of
// decode_reduce_ref (src/repro/comm/codec.py:247-260), so the result is
// bit-identical to it. The reference walls each product off from the add
// with _no_fma (dequant.py:60-77); here __fmul_rn/__fadd_rn and
// -fmad=false keep nvcc from contracting acc + q*s into an FMA.
//
// What bounds it on an H100: bytes, K*(L + 4) + 4L of them (0.2 MB at
// K = 8, L = 16384); at that size the launch latency dominates. Each
// thread reads its K codes with coalesced byte loads; no (K, L) f32 stack
// ever exists.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dequant_int8_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int K, int L, int mean, float inv_k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  float acc = __fmul_rn((float)q[i], scales[0]);
  for (int k = 1; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn((float)q[(size_t)k * L + i], scales[k]));
  if (mean) acc = __fmul_rn(acc, inv_k);
  out[i] = acc;
}

}  // namespace

extern "C" int dequant_int8_launch(const int8_t* q, const float* scales,
                                   float* out, int K, int L, int mean,
                                   float inv_k, void* stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  dequant_int8_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, scales, out, K, L, mean, inv_k);
  return (int)cudaGetLastError();
}

// The CUDA runtime's name for an error code returned by any launcher.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
