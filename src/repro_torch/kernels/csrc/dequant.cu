// K3: decode + reduce of the gathered (K, wire) payload of the int8,
// int4 and int2 codecs.
//
// Replaces the TPU kernels of src/repro/kernels/dequant.py:
//   int8  `_dec8_kernel` / `decode_reduce_int8` (pallas_call at :123)
//   int4  `_dec4_kernel` / `decode_reduce_int4` (pallas_call at :144)
//   int2  `_dec2_kernel` / `decode_reduce_int2` (pallas_call at :165)
//
// Each output element walks the workers in order:
//   acc = (c[0] - bias)*s[0];  acc = acc + (c[k] - bias)*s[k], k = 1..K-1
// and the mean multiplies by the f32-rounded 1/K. That is the op sequence
// of decode_reduce_ref (src/repro/comm/codec.py:247-260), so the result
// is bit-identical to it. The reference walls each product off from the
// add with _no_fma (dequant.py:60-77); here __fmul_rn/__fadd_rn and
// -fmad=false keep nvcc from contracting acc + c*s into an FMA. Byte j of
// a row of W = ceil(L / (8/BITS)) bytes holds element j (int8), j and
// j + W (int4: low and high nibble), or j + r*W, r = 0..3 (int2: bits
// 2r..2r+1); an element at index >= L is the codec's zero pad and is not
// written.
//
// What bounds it on an H100: bytes, K*(W + 4) + 4L of them (0.2 / 0.13 /
// 0.10 MB for int8 / int4 / int2 at K = 8, L = 16384; 4.2 / 2.8 / 2.1 MB
// at L = 350,000). The first design (a thread a payload byte, byte
// loads, ceil(W/256) CTAs) spent 1.9-2.0 us on the device at the main
// shape, 33-68x its bound, and 2.6-3.7 us at L = 350,000 (PERF.md).
//
// The design: a thread owns OUT outputs of every width, the kV = OUT /
// (8 / BITS) consecutive payload bytes that pack them, so the threads a
// row needs do not fall with the width. Rows long enough to give every
// SM a 64-thread CTA at OUT = 16 (L = 350,000) take 16 outputs a thread
// (16, 8, 4 payload bytes for int8, int4, int2); shorter rows (the main
// shape, L = 16384) take 4 in 32-thread CTAs, so that their 4096
// threads spread over 128 SMs: 16 outputs a thread left the main
// shape's 1024 threads on 16 SMs and took 2.57 us against the first
// design's 1.97 (int8; PERF.md). (A thread of
// 16 payload bytes, 64 outputs for int2, left the main shape's 256 int2
// threads 3,200 dependent instructions each and took 7.3 us; PERF.md.)
// A thread loads the kV bytes of 8 rows at a time, all 8 in flight
// before the adds, as one kV-byte ld.global.nc each when W is a multiple
// of kV (and the payload aligned to it), as 4-byte loads when kV >= 4
// and W is a multiple of 4, byte by byte otherwise and on a row's ragged
// last group; the 8 rows' scales ride in registers beside them. Its
// outputs lie in groups of kV consecutive elements (j.., and j+W.. for
// the packed widths), stored as float4 where kV is a multiple of 4 and a
// group lies whole and 16-byte aligned. The grid covers the groups once,
// capped at 16 CTAs an SM, with a grid-stride loop beyond. No (K, L) f32
// stack ever exists, and no atomics: two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;              // rows whose loads are in flight at once
constexpr int kBlocksPerSM = 16;      // grid cap, then a grid-stride loop
constexpr int kMaxDevices = 64;
// the two forms: outputs a thread and threads a CTA
constexpr int kLongOut = 16, kLongThreads = 64;
constexpr int kShortOut = 4, kShortThreads = 32;

// The n (<= V) payload bytes at byte j of `row` as (V + 3) / 4 words
// (bytes past n read as 0): one V-byte load (mode V), V/4 4-byte loads
// (mode 4, V >= 4) or n byte loads.
template <int V>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ row,
                                           int j, int n, int mode,
                                           uint32_t (&b)[(V + 3) / 4]) {
  if (n == V && mode == V) {
    if constexpr (V == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j));
      b[0] = v.x;
      b[1] = v.y;
      b[2] = v.z;
      b[3] = v.w;
    } else if constexpr (V == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + j));
      b[0] = v.x;
      b[1] = v.y;
    } else if constexpr (V == 4) {
      b[0] = __ldg(reinterpret_cast<const unsigned int*>(row + j));
    } else if constexpr (V == 2) {
      b[0] = __ldg(reinterpret_cast<const unsigned short*>(row + j));
    } else {
      b[0] = __ldg(row + j);
    }
    return;
  }
  if constexpr (V >= 4) {
    if (n == V && mode == 4) {
#pragma unroll
      for (int w = 0; w < V / 4; ++w)
        b[w] = __ldg(reinterpret_cast<const unsigned int*>(row + j + 4 * w));
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < (V + 3) / 4; ++w) b[w] = 0u;
  for (int e = 0; e < n; ++e)
    b[e >> 2] |= (uint32_t)__ldg(row + j + e) << (8 * (e & 3));
}

// The code of element part r of a byte, as the float the reference
// multiplies: the signed byte (int8), or the biased BITS-bit field minus
// its bias.
template <int BITS>
__device__ __forceinline__ float code(uint32_t byte, int r) {
  if (BITS == 8) return (float)(int8_t)(uint8_t)byte;
  constexpr int kMask = (1 << BITS) - 1;
  constexpr int kBias = 1 << (BITS - 1);
  return (float)((int)((byte >> (BITS * r)) & kMask) - kBias);
}

template <int BITS, int OUT>
__global__ void __launch_bounds__(kLongThreads)
dequant_kernel(const uint8_t* __restrict__ p,
               const float* __restrict__ scales, float* __restrict__ out,
               int K, int W, int L, int mean, float inv_k, int mode) {
  constexpr int kPer = 8 / BITS;
  constexpr int kV = OUT / kPer;              // payload bytes a thread
  constexpr int kWords = (kV + 3) / 4;
  const int groups = (W + kV - 1) / kV;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const int j = kV * (int)g;
    const int n = min(kV, W - j);
    float acc[kPer][kV];
    for (int k0 = 0; k0 < K; k0 += kRows) {
      uint32_t b[kRows][kWords];
      float s[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (k0 + u < K) {
          load_bytes<kV>(p + (size_t)(k0 + u) * W, j, n, mode, b[u]);
          s[u] = __ldg(scales + k0 + u);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (k0 + u >= K) break;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const uint32_t byte = (b[u][e >> 2] >> (8 * (e & 3))) & 0xFFu;
#pragma unroll
          for (int r = 0; r < kPer; ++r) {
            const float prod = __fmul_rn(code<BITS>(byte, r), s[u]);
            acc[r][e] = (k0 + u == 0) ? prod : __fadd_rn(acc[r][e], prod);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      float v[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e)
        v[e] = mean ? __fmul_rn(acc[r][e], inv_k) : acc[r][e];
      const long long i0 = (long long)r * W + j;   // element of byte j
      if (kV % 4 == 0 && n == kV && (r == 0 || W % 4 == 0) &&
          i0 + kV <= L) {
        float4* o = reinterpret_cast<float4*>(out + i0);
#pragma unroll
        for (int q = 0; q < kV / 4; ++q)
          o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                             v[4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e)
          if (e < n && i0 + e < L) out[i0 + e] = v[e];
      }
    }
  }
}

int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

// The form's launch: the widest loads every row's groups allow, and a
// grid that covers the groups once, capped at kBlocksPerSM CTAs an SM.
template <int BITS, int OUT>
int launch_form(const uint8_t* p, const float* scales, float* out, int K,
                int W, int L, int mean, float inv_k, int threads,
                cudaStream_t stream) {
  constexpr int kV = OUT / (8 / BITS);
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int mode = (W % kV == 0 && a % kV == 0) ? kV
                   : (kV >= 4 && W % 4 == 0 && a % 4 == 0) ? 4 : 1;
  const long long groups = ((long long)W + kV - 1) / kV;
  const long long need = (groups + threads - 1) / threads;
  const long long cap = (long long)kBlocksPerSM * sm_count();
  dequant_kernel<BITS, OUT><<<(int)(need < cap ? need : cap), threads, 0,
                              stream>>>(p, scales, out, K, W, L, mean, inv_k,
                                        mode);
  return (int)cudaGetLastError();
}

// 16 outputs a thread where their groups give every SM a 64-thread CTA,
// else 4 a thread in 32-thread CTAs.
template <int BITS>
int dequant_launch(const uint8_t* p, const float* scales, float* out, int K,
                   int L, int mean, float inv_k, void* stream) {
  constexpr int kPer = 8 / BITS;
  if (K < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int W = (int)(((long long)L + kPer - 1) / kPer);
  const long long long_groups =
      ((long long)W + kLongOut / kPer - 1) / (kLongOut / kPer);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (long_groups >= (long long)kLongThreads * sm_count())
    return launch_form<BITS, kLongOut>(p, scales, out, K, W, L, mean, inv_k,
                                       kLongThreads, st);
  return launch_form<BITS, kShortOut>(p, scales, out, K, W, L, mean, inv_k,
                                      kShortThreads, st);
}

}  // namespace

extern "C" int dequant_int8_launch(const int8_t* q, const float* scales,
                                   float* out, int K, int L, int mean,
                                   float inv_k, void* stream) {
  return dequant_launch<8>(reinterpret_cast<const uint8_t*>(q), scales, out,
                           K, L, mean, inv_k, stream);
}

extern "C" int dequant_int4_launch(const uint8_t* p, const float* scales,
                                   float* out, int K, int L, int mean,
                                   float inv_k, void* stream) {
  return dequant_launch<4>(p, scales, out, K, L, mean, inv_k, stream);
}

extern "C" int dequant_int2_launch(const uint8_t* p, const float* scales,
                                   float* out, int K, int L, int mean,
                                   float inv_k, void* stream) {
  return dequant_launch<2>(p, scales, out, K, L, mean, inv_k, stream);
}

// The CUDA runtime's name for an error code returned by any launcher.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
