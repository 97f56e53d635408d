// K2: absmax quantize of the (K, L) update stack for the int8, int4 and
// int2 codecs, one thread-block cluster per row, or for long rows two
// grids of many CTAs a row (the grid form, below quant_launch's helpers).
//
// Replaces the TPU kernels of src/repro/kernels/quant.py, which the
// reference vmaps over workers; here the K rows go in one launch:
//   int8  `_quant_int8_kernel` / `quantize_pack_int8` (pallas_call at :90)
//   int4  `_quant_int4_kernel` / `quantize_pack_int4` (pallas_call at :110)
//   int2  `_quant_int2_kernel` / `quantize_pack_int2` (pallas_call at :130)
//
//   absmax = max |x| over the L real elements (fabsf/fmaxf: exact in any
//            order)
//   scale  int8: absmax/127 + 1e-30   int4: absmax/7.5   int2: absmax*f32(2/3)
//          (1 for an all-zero row)
//   c = clip(rint(x / scale), -Q, Q)
//          int8: q[i] = (int8) c
//          int4: byte j = (c(x[j]) + 8) | (c(x[j + W]) + 8) << 4,
//                W = ceil(L/2)                        (split-half pairing)
//          int2: byte j = OR over r = 0..3 of (c(x[j + r*W]) + 2) << 2r,
//                W = ceil(L/4)                     (split-quarter pairing)
//          an index >= L is the codec's zero pad: it quantizes to the
//          biased zero code (nibble 8, 2-bit code 2), which is part of
//          the byte the reference packs (_split_halves/_split_quarters,
//          src/repro/comm/codec.py:187-203).
//
// Bit-identical to Int{8,4,2}Codec.encode_ref (src/repro/comm/codec.py:
// 309-314, 340-349, 385-394; _absmax_scale at :178-184) in eager mode:
// the divisions are IEEE (__fdiv_rn), the int2 scale is one f32 multiply
// (__fmul_rn) like INT2_SCALE_MUL, rintf rounds half to even like
// jnp.round, and the clip comes before the cast. The reference's int4
// `+ 0.0` changes no positive scale, so it is left out. Built with
// -fmad=false and never with --use_fast_math.
//
// What bounds it on an H100: bytes, K*(4L + W + 4) of them (0.66 / 0.59 /
// 0.56 MB for int8 / int4 / int2 at K = 8, L = 16384, ~0.2 us at
// 3.35 TB/s). At that size it is latency: the one-CTA-a-row design read
// its 64 KB row twice through one SM and took 4.5-4.7 us on the device
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 5).
//
// The design: a cluster of C CTAs per row (cudaLaunchKernelEx, grid K*C;
// kernels/quant.py::quant_plan picks C). CTA rank r owns the output bytes
// [min(r*S, W), min((r+1)*S, W)), S a multiple of 4, and reads exactly the
// elements those bytes pack (for int4 and int2 also the partners W, 2W,
// 3W further on), so no byte is shared between CTAs. It
//   1. loads them once into registers, as 16-byte loads when L is a
//      multiple of 4 * (8 / bits) and x is 16-byte aligned (every part
//      starts on 16 bytes), element by element otherwise;
//   2. reduces its absmax over the block;
//   3. sends it to every CTA of the cluster with st.async (4 bytes into
//      slot r of each peer's shared memory, completed on the peer's
//      mbarrier) and waits on its own mbarrier for the C values, so the
//      row's absmax costs one push and one local wait, not a barrier
//      round trip and remote reads. The cluster barrier that publishes
//      the mbarriers' initialisation is split: arrived at before the
//      load, waited for after it;
//   4. computes the scale with the reference's formula (the same bits in
//      every CTA), quantizes from registers and stores whole bytes, four
//      at a time where the loads were 16-byte ones; rank 0 writes the
//      row's scale.
// A CTA whose range is empty still sends its absmax (0) and waits for the
// others'. No CTA leaves while a peer may still store into it: its
// mbarrier completes only when all C values have landed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxFloats = 128;       // registers of x a thread may hold

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// clip(rint(v / s), -qmax, qmax), as an int
__device__ __forceinline__ int code(float v, float s, float qmax) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -qmax), qmax);
}

// The group of four output bytes at byte j of a row (j a multiple of 4,
// j < b1): the 4*PER elements they pack, element j + e + r*W in v[r][e],
// the zero pad (an index >= L) and bytes at or past b1 read as 0.
template <int PER>
__device__ __forceinline__ void load_group(const float* __restrict__ xk,
                                           int j, int W, int L, int b1,
                                           int vec, float (&v)[PER][4]) {
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const float* part = xk + (size_t)r * W;
    if (vec) {
      const float4 f = *reinterpret_cast<const float4*>(part + j);
      v[r][0] = f.x;
      v[r][1] = f.y;
      v[r][2] = f.z;
      v[r][3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i = (long long)r * W + j + e;
        v[r][e] = (j + e < b1 && i < L) ? part[j + e] : 0.f;
      }
    }
  }
}

// Quantize a group and store its bytes (a 4-byte word where the loads
// were 16-byte ones, else byte by byte up to b1).
template <int PER>
__device__ __forceinline__ void store_group(uint8_t* __restrict__ ok, int j,
                                            int b1, int vec,
                                            const float (&v)[PER][4],
                                            float s, float qmax, int bias) {
  constexpr int kBits = 8 / PER;
  uint32_t word = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t byte = 0u;
#pragma unroll
    for (int r = 0; r < PER; ++r)
      byte |= ((uint32_t)(code(v[r][e], s, qmax) + bias) & 0xFFu)
              << (kBits * r);
    word |= byte << (8 * e);
  }
  if (vec) {
    *reinterpret_cast<uint32_t*>(ok + j) = word;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j + e < b1) ok[j + e] = (uint8_t)(word >> (8 * e));
  }
}

// The row's scale from its absmax, the largest code and the code's bias.
template <int PER>
__device__ __forceinline__ void row_scale(float row, float& s, float& qmax,
                                          int& bias) {
  if (PER == 1) {
    // (float)1e-30 rounds the double literal to f32, as the reference
    // rounds its Python float
    s = row > 0.f ? __fadd_rn(__fdiv_rn(row, 127.0f), (float)1e-30) : 1.0f;
    qmax = 127.0f;
    bias = 0;
  } else if (PER == 2) {
    s = row > 0.f ? __fdiv_rn(row, 7.5f) : 1.0f;
    qmax = 7.0f;
    bias = 8;
  } else {
    // (float)(2.0 / 3.0) is INT2_SCALE_MUL rounded to f32, as the
    // reference rounds its Python float
    s = row > 0.f ? __fmul_rn(row, (float)(2.0 / 3.0)) : 1.0f;
    qmax = 1.0f;
    bias = 2;
  }
}

// PER elements to a byte (1: int8, 2: int4, 4: int2); ITEMS groups of
// four output bytes a thread held in registers, or 0: the CTA's range
// streamed twice, an absmax pass and a quantize pass that reads the
// elements again (an L2 hit), for a range past kMaxFloats elements a
// thread.
template <int PER, int ITEMS>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
             float* __restrict__ scales, int L, int span, int vec) {
  __shared__ float warp_amax[kWarps];
  __shared__ uint32_t peer_amax[kMaxCluster];   // slot r: rank r's absmax
  __shared__ __align__(8) uint64_t got;         // completes when all C land

  const uint32_t C = cluster::size();
  const uint32_t rank = cluster::rank();
  const int k = blockIdx.x / C;
  const int W = (int)(((long long)L + PER - 1) / PER);   // bytes of a row
  const int b0 = (int)min((long long)rank * span, (long long)W);
  const int b1 = (int)min((long long)b0 + span, (long long)W);
  const float* xk = x + (size_t)k * L;
  uint8_t* ok = out + (size_t)k * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kStep = 4 * kThreads;               // bytes a CTA pass

  // the mbarrier the peers' absmax values complete on; the rendezvous
  // that makes it visible to them is waited for only after the load
  if (threadIdx.x == 0) {
    cluster::mbar_init(&got, 1);
    cluster::fence_mbar_init();
  }
  cluster::arrive();

  // -- 1. one read of this CTA's elements -------------------------------
  constexpr int kGroups = ITEMS > 0 ? ITEMS : 1;
  float v[kGroups][PER][4];
  float amax = 0.f;
  if constexpr (ITEMS > 0) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int j = b0 + 4 * ((int)threadIdx.x + it * kThreads);
      if (j < b1) {
        load_group<PER>(xk, j, W, L, b1, vec, v[it]);
      } else {
#pragma unroll
        for (int r = 0; r < PER; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[it][r][e] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < PER; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[it][r][e]));
    }
  } else {
    for (long long j = b0 + 4LL * threadIdx.x; j < b1; j += kStep) {
      load_group<PER>(xk, (int)j, W, L, b1, vec, v[0]);
#pragma unroll
      for (int r = 0; r < PER; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[0][r][e]));
    }
  }

  // -- 2. the CTA's absmax ----------------------------------------------
  amax = warp_max(amax);
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();

  // -- 3. the row's absmax: each CTA sends its own to every peer --------
  cluster::wait();                 // every peer's mbarrier is initialised
  if (warp == 0) {
    amax = warp_max(lane < kWarps ? warp_amax[lane] : 0.f);
    if (lane < (int)C)
      cluster::st_async(cluster::peer_addr(&peer_amax[rank], lane),
                        __float_as_uint(amax),
                        cluster::peer_addr(&got, lane));
    if (lane == 0) cluster::mbar_arrive_expect(&got, 4u * C);
  }
  cluster::mbar_wait<true>(&got, 0u);
  float row = 0.f;
  for (uint32_t q = 0; q < C; ++q)
    row = fmaxf(row, __uint_as_float(peer_amax[q]));

  // -- 4. the scale, the codes, whole bytes ------------------------------
  float s, qmax;
  int bias;
  row_scale<PER>(row, s, qmax, bias);
  if constexpr (ITEMS > 0) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int j = b0 + 4 * ((int)threadIdx.x + it * kThreads);
      if (j < b1) store_group<PER>(ok, j, b1, vec, v[it], s, qmax, bias);
    }
  } else {
    for (long long j = b0 + 4LL * threadIdx.x; j < b1; j += kStep) {
      load_group<PER>(xk, (int)j, W, L, b1, vec, v[0]);
      store_group<PER>(ok, (int)j, b1, vec, v[0], s, qmax, bias);
    }
  }
  if (rank == 0 && threadIdx.x == 0) scales[k] = s;
  // no barrier before leaving: a CTA's mbarrier completed only when all
  // C values had landed, so no peer stores into it any more, and each
  // peer waits for this CTA's value before it leaves
}

template <int PER, int ITEMS>
cudaError_t launch(const float* x, uint8_t* out, float* scales, int K,
                   int L, int C, int span, int vec, cudaStream_t stream) {
  cudaError_t e = cluster::allow<quant_kernel<PER, ITEMS>>(0);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster::config(K * C, kThreads, C, 0, stream, attr);
  e = cudaLaunchKernelEx(&cfg, quant_kernel<PER, ITEMS>, x, out, scales, L,
                         span, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ITEMS groups of four bytes a thread, rounded up to a power of two;
// a span past kMaxFloats elements a thread takes the streaming form
// (`stream`, which the plan sets and this side checks).
template <int PER>
cudaError_t dispatch(const float* x, uint8_t* out, float* scales, int K,
                     int L, int C, int span, int stream, int vec,
                     cudaStream_t st) {
  const int items = (span / 4 + kThreads - 1) / kThreads;
  if (stream != (items * PER * 4 > kMaxFloats)) return cudaErrorInvalidValue;
  if (stream)
    return launch<PER, 0>(x, out, scales, K, L, C, span, vec, st);
#define QUANT_CASE(N)                                                      \
  if constexpr (N * PER * 4 <= kMaxFloats) {                               \
    if (items <= N)                                                        \
      return launch<PER, N>(x, out, scales, K, L, C, span, vec, st);      \
  }
  QUANT_CASE(1)
  QUANT_CASE(2)
  QUANT_CASE(4)
  QUANT_CASE(8)
  QUANT_CASE(16)
  QUANT_CASE(32)
#undef QUANT_CASE
  return cudaErrorInvalidValue;
}

// The span a plan must give: ceil(W / C) bytes rounded up to 4.
int plan_span(int W, int C) {
  const long long s = ((long long)W + C - 1) / C;
  return (int)((s + 3) / 4 * 4);
}

// -- the grid form, for long rows --------------------------------------
// Two kernels over grids of G CTAs a row (grid (G, K)), each CTA taking
// tiles of 4096 elements (absmax) or 4096 output bytes (pack) in turn:
//   absmax  the |x| bit patterns' maximum over the CTA's tiles (a NaN
//           pattern counts as 0, as fmaxf leaves a NaN out above; -0.0 is
//           0; inf is the largest), combined per row by one integer
//           atomicMax a CTA: exact, in any order;
//   pack    the row's scale from that maximum (row_scale), then the codes
//           of the CTA's bytes exactly as the cluster form's step 4
//           (load_group / store_group: the same pairing, rules and IEEE
//           quotient); CTA 0 of the row writes the scale.
// x is read twice (an L2 miss each time at the transformer's leaves) and
// the payload written once. The row maxima live in a K-word scratch the
// wrapper gives, zeroed by quant_grid_init first.
constexpr int kGridTile = 4 * 4 * kThreads;    // elements / bytes a tile
constexpr int kGridCtas = 4224;                // a grid's CTAs in all

// G for n elements or bytes a row: the tiles, at most ~4,224 CTAs in all
int grid_ctas(int K, long long n) {
  const long long tiles = (n + kGridTile - 1) / kGridTile;
  const long long want = (kGridCtas + K - 1) / K;
  return (int)(tiles < want ? tiles : want);
}

__global__ void quant_grid_init(uint32_t* amax, int K) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) amax[i] = 0u;
}

__device__ __forceinline__ uint32_t mag(float v) {
  const uint32_t u = __float_as_uint(v) & 0x7FFFFFFFu;
  return u > 0x7F800000u ? 0u : u;
}

__global__ void __launch_bounds__(kThreads)
quant_grid_absmax(const float* __restrict__ x, uint32_t* __restrict__ amax,
                  int L) {
  __shared__ uint32_t warp_max[kWarps];
  const int row = blockIdx.y;
  const float* xr = x + (size_t)row * L;
  // a scalar head up to a 16-byte boundary, then 16-byte loads, then a
  // scalar tail: at most 3 + 3 elements, read by CTA 0
  const int head = (int)min((long long)L,
      (long long)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(xr) & 15u))
                   & 15u) / 4u));
  const long long nvec = ((long long)L - head) / 4;
  const int tail0 = head + (int)(4 * nvec);
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  uint32_t m = 0u;
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    if (t < head) m = mag(xr[t]);
    else if (t >= 4 && t - 4 < L - tail0) m = mag(xr[tail0 + t - 4]);
  }
  constexpr int kVec = kGridTile / 4;
  const long long tiles = (nvec + kVec - 1) / kVec;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    float4 f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long q = t * kVec + j * kThreads + threadIdx.x;
      f[j] = q < nvec ? xv[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m = max(m, max(max(mag(f[j].x), mag(f[j].y)),
                     max(mag(f[j].z), mag(f[j].w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = max(m, warp_max[w]);
    if (m) atomicMax(&amax[row], m);
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
quant_grid_pack(const float* __restrict__ x, uint8_t* __restrict__ out,
                float* __restrict__ scales,
                const uint32_t* __restrict__ amax, int L, int vec) {
  const int row = blockIdx.y;
  const int W = (int)(((long long)L + PER - 1) / PER);   // bytes of a row
  const float* xk = x + (size_t)row * L;
  uint8_t* ok = out + (size_t)row * W;
  float s, qmax;
  int bias;
  row_scale<PER>(__uint_as_float(__ldcg(&amax[row])), s, qmax, bias);
  const long long tiles = ((long long)W + kGridTile - 1) / kGridTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    float v[4][PER][4];
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const long long j = t * kGridTile + 4LL * (threadIdx.x + it * kThreads);
      if (j < W) load_group<PER>(xk, (int)j, W, L, W, vec, v[it]);
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const long long j = t * kGridTile + 4LL * (threadIdx.x + it * kThreads);
      if (j < W) store_group<PER>(ok, (int)j, W, vec, v[it], s, qmax, bias);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[row] = s;
}

template <int PER>
cudaError_t grid_launch(const float* x, uint8_t* out, float* scales,
                        uint32_t* amax, int K, int L, int g_abs, int g_pack,
                        int vec, cudaStream_t st) {
  quant_grid_init<<<1, kThreads, 0, st>>>(amax, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  quant_grid_absmax<<<dim3((unsigned)g_abs, (unsigned)K), kThreads, 0, st>>>(
      x, amax, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  quant_grid_pack<PER><<<dim3((unsigned)g_pack, (unsigned)K), kThreads, 0,
                         st>>>(x, out, scales, amax, L, vec);
  return cudaGetLastError();
}

}  // namespace

// One launch of K clusters of `cluster` CTAs, each CTA `span` output
// bytes of its row, held in registers or (`stream`) read twice. `span`
// and `stream` come from the Python plan (kernels/quant.py::quant_plan);
// a plan this side does not reproduce is refused with
// cudaErrorInvalidValue.
extern "C" int quant_launch(const float* x, void* out, float* scales,
                            int K, int L, int bits, int cluster, int span,
                            int stream, void* stream_ptr) {
  if (K < 1 || L < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 ||
      (bits != 8 && bits != 4 && bits != 2))
    return (int)cudaErrorInvalidValue;
  const int per = 8 / bits;
  const int W = (int)(((long long)L + per - 1) / per);
  if (span != plan_span(W, cluster)) return (int)cudaErrorInvalidValue;
  const int vec = (L % (4 * per) == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
  if (bits == 8)
    e = dispatch<1>(x, o, scales, K, L, cluster, span, stream, vec, st);
  else if (bits == 4)
    e = dispatch<2>(x, o, scales, K, L, cluster, span, stream, vec, st);
  else
    e = dispatch<4>(x, o, scales, K, L, cluster, span, stream, vec, st);
  return (int)e;
}

// The grid form on the caller's stream: quant_grid_init, quant_grid_absmax
// over `ctas_absmax` CTAs a row, quant_grid_pack over `ctas_pack`; both
// come from the Python plan (kernels/quant.py::quant_plan), and `amax` is
// its K-word scratch. A plan this side does not reproduce is refused with
// cudaErrorInvalidValue.
extern "C" int quant_grid_launch(const float* x, void* out, float* scales,
                                 void* amax, int K, int L, int bits,
                                 int ctas_absmax, int ctas_pack,
                                 void* stream_ptr) {
  if (K < 1 || K > 65535 || L < 1 || amax == nullptr ||
      (bits != 8 && bits != 4 && bits != 2))
    return (int)cudaErrorInvalidValue;
  const int per = 8 / bits;
  const int W = (int)(((long long)L + per - 1) / per);
  if (ctas_absmax != grid_ctas(K, L) || ctas_pack != grid_ctas(K, W))
    return (int)cudaErrorInvalidValue;
  const int vec = (L % (4 * per) == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  uint8_t* o = static_cast<uint8_t*>(out);
  uint32_t* m = static_cast<uint32_t*>(amax);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
  if (bits == 8)
    e = grid_launch<1>(x, o, scales, m, K, L, ctas_absmax, ctas_pack, vec, st);
  else if (bits == 4)
    e = grid_launch<2>(x, o, scales, m, K, L, ctas_absmax, ctas_pack, vec, st);
  else
    e = grid_launch<4>(x, o, scales, m, K, L, ctas_absmax, ctas_pack, vec, st);
  return (int)e;
}
