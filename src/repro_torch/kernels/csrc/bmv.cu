// Batched matrix-vector products with a summation order fixed per worker:
//
//   rows form  y[k, i]   = sum_j M[k, i, j] * x[k, j]    (M (K, r, c))
//   cols form  out[k, j] = sum_i y[k, i] * M[k, i, j]
//
// Mini-batch SCD's A_T w and Delta v, and mini-batch SGD's A_s alpha and
// resid^T A_s, run through them on both drivers. The reference computes
// them as XLA dots (src/repro/core/solvers.py:97,
// src/repro/core/baselines.py:112-113); no pallas_call.
//
// The contract is that an output's bits do not depend on K: a worker's
// block reduced alone (the sharded driver, K = 1) gives what it gives in
// the virtual driver's (K, r, c) stack, which a library's batched product
// does not promise (its kernel choice, and a split of the reduction,
// follow the batch). So every output is reduced in an order fixed by r
// and c alone:
//   rows form: one warp a row; lane l takes the groups of 4 consecutive
//     elements q = l, l + 32, ... in order, adding each group's products
//     in element order, then the 32 lane sums meet in an xor tree
//     (offsets 16, 8, 4, 2, 1);
//   cols form: a group of 4 consecutive columns; rows in 8 slices of
//     ceil(r / 8), each slice added in row order, then the 8 slice sums
//     in slice order.
// Float4 loads are taken where the row stride and the pointers allow
// them, element loads elsewhere; the order is the same either way.
// Each product is rounded before its add (__fmul_rn, __fadd_rn; the
// library is built with -fmad=false), no atomics: two launches give the
// same bits.
//
// What bounds it on an H100: bytes, the 4*K*r*c of M read once (2.1 GB
// at mini-batch SCD's (8, 4096, 16384), 0.64 ms at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;        // rows a CTA in the rows form
constexpr int kColGroups = 32;      // column groups a CTA in the cols form
constexpr int kSlices = 8;          // row slices a CTA in the cols form

__device__ __forceinline__ float madd(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__global__ void __launch_bounds__(kRowWarps * 32)
    bmv_rows_kernel(const float* __restrict__ M, const float* __restrict__ x,
                    float* __restrict__ y, long long rows, int r, int c,
                    long long x_stride, int vec) {
  const long long row = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const float* m = M + row * (long long)c;
  const float* xv = x + (row / r) * x_stride;
  const int groups = c / 4;
  float acc = 0.0f;
  if (vec) {
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* x4 = reinterpret_cast<const float4*>(xv);
#pragma unroll 4
    for (int q = lane; q < groups; q += 32) {
      const float4 a = __ldg(m4 + q);
      const float4 b = __ldg(x4 + q);
      acc = madd(acc, a.x, b.x);
      acc = madd(acc, a.y, b.y);
      acc = madd(acc, a.z, b.z);
      acc = madd(acc, a.w, b.w);
    }
  } else {
#pragma unroll 4
    for (int q = lane; q < groups; q += 32) {
      const int j = 4 * q;
      acc = madd(acc, __ldg(m + j), __ldg(xv + j));
      acc = madd(acc, __ldg(m + j + 1), __ldg(xv + j + 1));
      acc = madd(acc, __ldg(m + j + 2), __ldg(xv + j + 2));
      acc = madd(acc, __ldg(m + j + 3), __ldg(xv + j + 3));
    }
  }
  // the ragged last group (c % 4 elements) belongs to lane groups % 32
  if (lane == groups % 32)
    for (int j = 4 * groups; j < c; ++j) acc = madd(acc, __ldg(m + j),
                                                    __ldg(xv + j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) y[row] = acc;
}

// A CTA owns kColGroups groups of 4 columns of one worker; warp s of its
// kSlices adds rows [s*chunk, (s+1)*chunk) in order, chunk = ceil(r /
// kSlices), one lane a group, then warp 0 adds the slices' sums in order
// s = 0..kSlices-1. The slices give the card 8x the threads of one thread
// a group (32,768 of them at mini-batch SCD's (8, 4096, 16384) left each
// with 4096 dependent loads and the kernel at 1.56x its bound), and the
// order still depends on r alone.
__global__ void __launch_bounds__(kColGroups * kSlices)
    bmv_cols_kernel(const float* __restrict__ y, const float* __restrict__ M,
                    float* __restrict__ out, int r, int c, long long y_stride,
                    int vec) {
  __shared__ float4 part[kSlices][kColGroups];
  const int k = blockIdx.y;
  const int lane = threadIdx.x % kColGroups, slice = threadIdx.x / kColGroups;
  const long long j = 4 * ((long long)blockIdx.x * kColGroups + lane);
  const int chunk = (r + kSlices - 1) / kSlices;
  const int lo = slice * chunk, hi = min(r, lo + chunk);
  const float* m = M + (long long)k * r * c + j;
  const float* yv = y + k * y_stride;
  const int n = j >= c ? 0 : c - j < 4 ? (int)(c - j) : 4;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec && n == 4) {  // every group whole and 16-byte aligned
#pragma unroll 8
    for (int i = lo; i < hi; ++i) {
      const float s = __ldg(yv + i);
      const float4 a = __ldg(reinterpret_cast<const float4*>(
          m + (long long)i * c));
      acc.x = madd(acc.x, s, a.x);
      acc.y = madd(acc.y, s, a.y);
      acc.z = madd(acc.z, s, a.z);
      acc.w = madd(acc.w, s, a.w);
    }
  } else if (n > 0) {
    float e4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int i = lo; i < hi; ++i) {
      const float s = __ldg(yv + i);
      const float* row = m + (long long)i * c;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) e4[e] = madd(e4[e], s, __ldg(row + e));
    }
    acc = make_float4(e4[0], e4[1], e4[2], e4[3]);
  }
  part[slice][lane] = acc;
  __syncthreads();
  if (slice != 0 || n == 0) return;
  float4 sum = part[0][lane];
#pragma unroll
  for (int t = 1; t < kSlices; ++t) {
    const float4 p = part[t][lane];
    sum.x = __fadd_rn(sum.x, p.x);
    sum.y = __fadd_rn(sum.y, p.y);
    sum.z = __fadd_rn(sum.z, p.z);
    sum.w = __fadd_rn(sum.w, p.w);
  }
  float* o = out + (long long)k * c + j;
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(o) = sum;
  } else {
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
    for (int e = 0; e < n; ++e) o[e] = v[e];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y (K, r) = M (K, r, c) x; x's row k starts x_stride floats after row
// k - 1 (0: one vector for every worker).
extern "C" int bmv_rows_launch(const float* M, const float* x, float* y,
                               int K, int r, int c, long long x_stride,
                               void* stream) {
  if (K < 1 || r < 1 || c < 1 || x_stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)K * r;
  const int vec = c % 4 == 0 && x_stride % 4 == 0 && aligned16(M) &&
                  aligned16(x);
  const long long grid = (rows + kRowWarps - 1) / kRowWarps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bmv_rows_kernel<<<(unsigned)grid, kRowWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(M, x, y, rows, r, c,
                                                         x_stride, vec);
  return (int)cudaGetLastError();
}

// out (K, c) = y (K, r) M (K, r, c); y's row k starts y_stride floats
// after row k - 1.
extern "C" int bmv_cols_launch(const float* y, const float* M, float* out,
                               int K, int r, int c, long long y_stride,
                               void* stream) {
  if (K < 1 || r < 1 || c < 1 || y_stride < 0 || K > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = c % 4 == 0 && aligned16(M) && aligned16(out);
  const long long groups = ((long long)c + 3) / 4;
  const dim3 grid((unsigned)((groups + kColGroups - 1) / kColGroups),
                  (unsigned)K);
  bmv_cols_kernel<<<grid, kColGroups * kSlices, 0,
                    static_cast<cudaStream_t>(stream)>>>(y, M, out, r, c,
                                                         y_stride, vec);
  return (int)cudaGetLastError();
}
