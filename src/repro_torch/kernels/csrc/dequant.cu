// K3: decode + reduce of the gathered (K, wire) payload of the int8,
// int4 and int2 codecs.
//
// Replaces the TPU kernels of src/repro/kernels/dequant.py:
//   int8  `_dec8_kernel` / `decode_reduce_int8` (pallas_call at :123)
//   int4  `_dec4_kernel` / `decode_reduce_int4` (pallas_call at :144)
//   int2  `_dec2_kernel` / `decode_reduce_int2` (pallas_call at :165)
//
// A 1-D grid over the payload's bytes; each thread owns one byte
// position j, i.e. one element (int8), two (int4: j and j + half) or four
// (int2: j + r*quarter, r = 0..3), and walks the workers in order:
//   acc = (c[0] - bias)*s[0];  acc = acc + (c[k] - bias)*s[k], k = 1..K-1
// the mean multiplies by the f32-rounded 1/K. That is the op sequence of
// decode_reduce_ref (src/repro/comm/codec.py:247-260), so the result is
// bit-identical to it. The reference walls each product off from the add
// with _no_fma (dequant.py:60-77); here __fmul_rn/__fadd_rn and
// -fmad=false keep nvcc from contracting acc + c*s into an FMA. An
// element at index >= L is the codec's zero pad and is not written.
//
// What bounds it on an H100: bytes, K*(payload + 4) + 4L of them (0.2 /
// 0.13 / 0.10 MB for int8 / int4 / int2 at K = 8, L = 16384); at that
// size the launch latency dominates. Each thread reads its K bytes with
// coalesced byte loads and holds 1, 2 or 4 f32 sums in registers; no
// (K, L) f32 stack ever exists.
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

// BITS-bit codes, kPer = 8/BITS of them to a byte, biased by
// 2^(BITS-1); the code in bits [BITS*r, BITS*(r+1)) of byte j is element
// j + r*W, W = ceil(L/kPer) the payload's row length.
template <int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_packed_kernel(const uint8_t* __restrict__ p,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int K, int W, int L, int mean,
                      float inv_k) {
  constexpr int kPer = 8 / BITS;
  constexpr int kMask = (1 << BITS) - 1;
  constexpr int kBias = 1 << (BITS - 1);
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W) return;
  float acc[kPer];
  int byte = p[j];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    acc[r] = __fmul_rn((float)(((byte >> (BITS * r)) & kMask) - kBias),
                       scales[0]);
  for (int k = 1; k < K; ++k) {
    byte = p[(size_t)k * W + j];
    const float s = scales[k];
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      acc[r] = __fadd_rn(acc[r], __fmul_rn(
          (float)(((byte >> (BITS * r)) & kMask) - kBias), s));
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = j + r * W;
    if (i < L) out[i] = mean ? __fmul_rn(acc[r], inv_k) : acc[r];
  }
}

template <int BITS>
int dequant_packed_launch(const uint8_t* p, const float* scales, float* out,
                          int K, int L, int mean, float inv_k, void* stream) {
  constexpr int kPer = 8 / BITS;
  const int W = (L + kPer - 1) / kPer;
  const int blocks = (W + kThreads - 1) / kThreads;
  dequant_packed_kernel<BITS><<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      p, scales, out, K, W, L, mean, inv_k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dequant_int4_launch(const uint8_t* p, const float* scales,
                                   float* out, int K, int L, int mean,
                                   float inv_k, void* stream) {
  return dequant_packed_launch<4>(p, scales, out, K, L, mean, inv_k, stream);
}

extern "C" int dequant_int2_launch(const uint8_t* p, const float* scales,
                                   float* out, int K, int L, int mean,
                                   float inv_k, void* stream) {
  return dequant_packed_launch<2>(p, scales, out, K, L, mean, inv_k, stream);
}

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
