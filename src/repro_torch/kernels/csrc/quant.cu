// K2: absmax quantize of the (K, L) update stack, one CTA per row, for
// the int8, int4 and int2 codecs.
//
// Replaces the TPU kernels of src/repro/kernels/quant.py, which the
// reference vmaps over workers; here the K rows go in one launch:
//   int8  `_quant_int8_kernel` / `quantize_pack_int8` (pallas_call at :90)
//   int4  `_quant_int4_kernel` / `quantize_pack_int4` (pallas_call at :110)
//   int2  `_quant_int2_kernel` / `quantize_pack_int2` (pallas_call at :130)
//
//   pass 1: absmax = max |x| over the L real elements (fabsf/fmaxf: exact
//           in any order); the block reduction is shared by all three
//   scale  int8: absmax/127 + 1e-30   int4: absmax/7.5   int2: absmax*f32(2/3)
//          (1 for an all-zero row)
//   pass 2: c = clip(rint(x / scale), -Q, Q)
//           int8: q[i] = (int8) c
//           int4: byte j = (c(x[j]) + 8) | (c(x[j + half]) + 8) << 4,
//                 half = ceil(L/2)                    (split-half pairing)
//           int2: byte j = OR over r = 0..3 of (c(x[j + r*quarter]) + 2) << 2r,
//                 quarter = ceil(L/4)              (split-quarter pairing)
//           an index >= L is the codec's zero pad: it quantizes to the
//           biased zero code (nibble 8, 2-bit code 2), which is part of
//           the byte the reference packs (_split_halves/_split_quarters,
//           src/repro/comm/codec.py:187-203).
//
// Bit-identical to Int{8,4,2}Codec.encode_ref (src/repro/comm/codec.py:
// 309-314, 340-349, 385-394; _absmax_scale at :178-184) in eager mode:
// the divisions are IEEE (__fdiv_rn), the int2 scale is one f32 multiply
// (__fmul_rn) like INT2_SCALE_MUL, rintf rounds half to even like
// jnp.round, and the clip comes before the cast. The reference's int4
// `+ 0.0` changes no positive scale, so it is left out. Built with
// -fmad=false and never with --use_fast_math.
//
// What bounds it on an H100: bytes, K*(4L + payload + 4) of them (0.66 /
// 0.59 / 0.56 MB for int8 / int4 / int2 at K = 8, L = 16384, ~0.2 us at
// 3.35 TB/s); at that size the launch latency dominates. The design
// reads the row twice (the second read hits L1/L2) rather than holding
// it, which keeps the kernel simple; each thread of pass 2 writes whole
// bytes, so no two threads share an output byte.
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

// The absmax of one row, reduced over the block; every thread returns it.
__device__ float row_absmax(const float* __restrict__ xk, int L) {
  __shared__ float red[kThreads / 32];
  __shared__ float row_amax;
  float amax = 0.f;
  for (int i = threadIdx.x; i < L; i += kThreads) amax = fmaxf(amax, fabsf(xk[i]));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    amax = warp_max(red[threadIdx.x]);
    if (threadIdx.x == 0) row_amax = amax;
  }
  __syncthreads();
  return row_amax;
}

// clip(rint(v / s), -qmax, qmax), as a float
__device__ __forceinline__ float code(float v, float s, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -qmax), qmax);
}

__global__ void __launch_bounds__(kThreads)
quant_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, int L) {
  const int k = blockIdx.x;
  const float* xk = x + (size_t)k * L;
  int8_t* qk = q + (size_t)k * L;
  const float amax = row_absmax(xk, L);
  // (float)1e-30 rounds the double literal to f32, as the reference
  // rounds its Python float
  const float s = amax > 0.f
      ? __fadd_rn(__fdiv_rn(amax, 127.0f), (float)1e-30) : 1.0f;
  if (threadIdx.x == 0) scales[k] = s;
  for (int i = threadIdx.x; i < L; i += kThreads)
    qk[i] = (int8_t)code(xk[i], s, 127.0f);
}

__global__ void __launch_bounds__(kThreads)
quant_int4_kernel(const float* __restrict__ x, uint8_t* __restrict__ p,
                  float* __restrict__ scales, int L) {
  const int k = blockIdx.x;
  const int half = (L + 1) / 2;
  const float* xk = x + (size_t)k * L;
  uint8_t* pk = p + (size_t)k * half;
  const float amax = row_absmax(xk, L);
  const float s = amax > 0.f ? __fdiv_rn(amax, 7.5f) : 1.0f;
  if (threadIdx.x == 0) scales[k] = s;
  for (int j = threadIdx.x; j < half; j += kThreads) {
    const int lo = (int)code(xk[j], s, 7.0f) + 8;
    const int hi = j + half < L ? (int)code(xk[j + half], s, 7.0f) + 8 : 8;
    pk[j] = (uint8_t)(lo | (hi << 4));
  }
}

__global__ void __launch_bounds__(kThreads)
quant_int2_kernel(const float* __restrict__ x, uint8_t* __restrict__ p,
                  float* __restrict__ scales, int L) {
  const int k = blockIdx.x;
  const int quarter = (L + 3) / 4;
  const float* xk = x + (size_t)k * L;
  uint8_t* pk = p + (size_t)k * quarter;
  const float amax = row_absmax(xk, L);
  // (float)(2.0 / 3.0) is INT2_SCALE_MUL rounded to f32, as the
  // reference rounds its Python float
  const float s = amax > 0.f ? __fmul_rn(amax, (float)(2.0 / 3.0)) : 1.0f;
  if (threadIdx.x == 0) scales[k] = s;
  for (int j = threadIdx.x; j < quarter; j += kThreads) {
    int byte = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = j + r * quarter;
      const int c = i < L ? (int)code(xk[i], s, 1.0f) + 2 : 2;
      byte |= c << (2 * r);
    }
    pk[j] = (uint8_t)byte;
  }
}

}  // namespace

extern "C" int quant_int8_launch(const float* x, int8_t* q, float* scales,
                                 int K, int L, void* stream) {
  quant_int8_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, scales, L);
  return (int)cudaGetLastError();
}

extern "C" int quant_int4_launch(const float* x, uint8_t* p, float* scales,
                                 int K, int L, void* stream) {
  quant_int4_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, p, scales, L);
  return (int)cudaGetLastError();
}

extern "C" int quant_int2_launch(const float* x, uint8_t* p, float* scales,
                                 int K, int L, void* stream) {
  quant_int2_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, p, scales, L);
  return (int)cudaGetLastError();
}
