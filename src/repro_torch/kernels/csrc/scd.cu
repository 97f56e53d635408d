// K1: the CoCoA local SCD solve, all K workers in one launch.
//
// Replaces the TPU kernel `_scd_kernel` / `scd_pallas` in
// src/repro/kernels/scd.py (pallas_call at :137), which runs a worker's H
// sequential coordinate steps on a sequential grid.
//
// Per step s, with j = idx[k, s] and c = column j (contiguous, because the
// data is stored column-major as A_T of shape (K, n_pad, m)):
//   z~  = (sigma*||c||^2 * a_j - rho . c) / (sigma*||c||^2 + lam*eta)
//   z   = sign(z~) * max(|z~| - lam*(1-eta)/denom, 0); z = a_j for a zero column
//   rho += sigma*(z - a_j) * c;  alpha_j = z
// and at the end delta_v = (rho - w) / sigma.
//
// What bounds it on an H100: first the serial chain of steps (step s+1's
// dot needs step s's rho), then bytes (a round reads the visited columns,
// about 1.36 GB at m = 16384, H = 4096, K = 8, i.e. ~0.4 ms at 3.35 TB/s).
// With one CTA per worker, each step paid two or three device-memory
// latencies in series (index, column, column norm) and a 1024-thread
// reduction, on 8 of the 132 SMs.
//
// The design:
// - A thread-block cluster of C CTAs per worker (cudaLaunchKernelEx with a
//   cluster dimension of C, grid K*C; cluster k is worker k). CTA rank r
//   owns the rows [r*S, min((r+1)*S, m)) of the worker's residual rho, held
//   in its consumer threads' registers (thread t holds rows t, t+256, ...),
//   so a step's column is read by C SMs at once.
// - A prefetch ring. The index stream is known at launch, so one producer
//   warp per CTA runs ahead of the step: it loads 32 indices and their
//   column norms at a time, checks each index (an index outside the block
//   traps before any copy is issued), and copies the step's slab of the
//   column into one of P shared-memory stages, with a "full" and an "empty"
//   mbarrier per stage. The index and what depends on the column alone
//   (its norm, sigma*||c||^2, the denominator and the soft threshold, one
//   division per lane for 32 steps at once) ride in the stage, so the
//   step's chain holds one division.
//   alpha is never prefetched: it is read from shared memory at the step,
//   so a repeated index inside the ring window sees the latest value.
// - One rendezvous a step. Each CTA's 8 consumer warps reduce their
//   slab's dot (warp shuffles, then the warps' partials after one named
//   barrier); lanes 0..C-1 of warp 0 then send the CTA's partial to every
//   CTA of the cluster with st.async, which completes the bytes on the
//   peer's own mbarrier. The slots and barriers are double-buffered by step
//   parity. Every thread of every CTA sums the C partials in rank order
//   0..C-1 and computes the same z (bit-identical under -fmad=false), so
//   no second broadcast is needed.
// - alpha replicated: every CTA keeps the worker's whole alpha block in
//   shared memory and applies the same update; rank 0 writes alpha_out,
//   and each CTA writes its slab of delta_v.
//
// The variants for what does not fit that layout (kernels/scd.py::
// scd_plan takes them only where no C of it fits):
// - rho streamed (scd_kernel_streamed, a __global__ function of its own
//   built from device helpers; the register form keeps its own body), for
//   slabs past the 64 rows a consumer thread holds in registers
//   (m > 262,144 at C = 16; webspam's m = 350,000). The producer streams each step's column slab through
//   the ring twice, in stages of kStageRows rows: once for the dot,
//   which the consumers sum over the stages before the one rendezvous a
//   step, and once more for the update (from L2: the first pass copied it
//   a moment before), so both passes read the column from shared memory
//   and nothing on the step's path waits on a plain load. Thread t owns
//   the rows t, t+256, ... of the slab in both passes, as in the register
//   form, so no barrier orders rho's rows. rho's slab lives in shared
//   memory where it fits beside a ring of at least 2 stages (kRhoShared;
//   at m = 350,000 a slab of 43,752 rows at C = 8 takes 175 KB and
//   leaves 3 stages), else (kRhoDevice) in delta_v's own rows in device
//   memory, which are written with (rho - w) / sigma at the end.
// - alpha in device memory, for an alpha block past the shared memory
//   a CTA has left (n_pad >= 55,995 at m = 16,384). Every CTA already
//   applies the same alpha update, so each keeps a private copy in a
//   scratch block the wrapper allocates (K*C rows of n_pad); no CTA reads
//   another's copy, so nothing needs coherence across CTAs. Each warp
//   writes the step's z itself before it reads alpha again (as in shared
//   memory), and the consumers' named barrier orders the warps' writes.
//   Where alpha lives is a template parameter, so the shared copy stays
//   a shared-memory access.
//
// Alignment: the 1-D bulk copy (cp.async.bulk) needs 16-byte addresses and
// a size that is a multiple of 16 B. S is a multiple of 4 floats, so when
// m is a multiple of 4 (and A_T 16-byte aligned) every slab, the last
// ragged one included, starts and ends on 16 B. Otherwise the producer
// warp copies the slab with 4-byte cp.async, one element a lane at a time,
// and completes the stage through cp.async.mbarrier.arrive.
//
// Compiled with -fmad=false: the f32 arithmetic is the plain version's,
// except that the dot is summed per slab (per thread, per warp, per CTA)
// and then over the slabs in rank order; hence rtol 1e-4, atol 1e-5 against
// the plain version. No atomics: two launches with the same C give
// bit-identical outputs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

using cluster::mbar_arrive_expect;
using cluster::mbar_init;
using cluster::mbar_wait;
using cluster::smem_addr;
using cluster::st_async;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;       // + one producer warp
constexpr int kMaxCluster = 16;
constexpr int kMaxRing = 8;
constexpr int kMaxItems = 64;                   // slab <= 64 * kConsumers
constexpr int kStageRows = 4096;                // a streamed stage, at most

// where rho's slab lives
enum Rho { kRegisters = 0, kRhoShared = 1, kRhoDevice = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count includes this arrival).
__device__ __forceinline__ void copy4_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Shared memory of one CTA, in 4-byte words and then 8-byte mbarriers:
// P stages of `stage` rows, `n_alpha` floats of alpha (0 when alpha lives
// in device memory) and `n_rho` of rho (the slab when rho's slab lives in
// shared memory, else 0). scd_shared_bytes() and the Python plan compute
// the same total.
struct Layout {
  int ring, coef, red, slots, alpha, rho, jdx, bars;
  __host__ __device__ Layout(int stage, int P, int n_alpha, int n_rho) {
    ring = 0;                          // P * stage floats (16 B aligned)
    coef = ring + P * stage;           // P x (csq, sigma*csq, denom, thr)
    red = coef + 4 * P;                // 2 x kConsumerWarps partials
    slots = red + 2 * kConsumerWarps;  // 2 x kMaxCluster CTA partials
    alpha = slots + 2 * kMaxCluster;   // n_alpha floats
    rho = alpha + n_alpha;             // n_rho floats
    jdx = rho + n_rho;                 // P indices
    bars = (jdx + P + 1) / 2 * 2;      // 8 B aligned: full P, empty P, red 2
  }
  __host__ __device__ long long bytes(int P) const {
    return 4LL * bars + 8LL * (2 * P + 2);
  }
};

// The barriers and the worker's alpha block, before any peer uses them.
__device__ __forceinline__ void setup(uint64_t* full, uint64_t* empty,
                                      uint64_t* red_bar, float* alpha,
                                      const float* alpha_k, int n_pad,
                                      int P, int aligned, int tid) {
  if (tid == 0) {
    for (int st = 0; st < P; ++st) {
      mbar_init(&full[st], aligned ? 1 : 33);
      mbar_init(&empty[st], kConsumerWarps);
    }
    mbar_init(&red_bar[0], 1);
    mbar_init(&red_bar[1], 1);
    cluster::fence_mbar_init();
  }
  for (int i = tid; i < n_pad; i += kThreads) alpha[i] = alpha_k[i];
  cluster::sync();   // every CTA's barriers exist before any peer uses them
}

// What the step s = base + lane needs of its column alone, computed by
// the producer warp 32 steps at a time, off the step's chain: the index
// (an index outside the block traps before any copy is issued) and the
// column's norm, sigma*||c||^2, the denominator and the soft threshold.
struct Column {
  int j;
  float cs, scsq, denom, thr;
};

__device__ __forceinline__ Column column(const int32_t* idx_k,
                                         const float* csq_k, int s, int H,
                                         int n_pad, float sigma,
                                         float lam_eta, float lam_l1) {
  Column c;
  c.j = 0;
  c.cs = 0.f;
  if (s < H) {
    c.j = idx_k[s];
    if (c.j < 0 || c.j >= n_pad) __trap();
    c.cs = csq_k[c.j];
  }
  c.scsq = sigma * c.cs;
  c.denom = c.scsq + lam_eta;
  c.thr = lam_l1 / c.denom;
  return c;
}

// Lane u's index, and its scalars in `cf`, in every lane of the warp.
__device__ __forceinline__ int from_lane(const Column& c, int u,
                                         float4& cf) {
  cf.x = __shfl_sync(0xffffffffu, c.cs, u);
  cf.y = __shfl_sync(0xffffffffu, c.scsq, u);
  cf.z = __shfl_sync(0xffffffffu, c.denom, u);
  cf.w = __shfl_sync(0xffffffffu, c.thr, u);
  return __shfl_sync(0xffffffffu, c.j, u);
}

// The producer warp fills stage `st` with `len` floats of the column at
// `src` and the step's index and scalars, completing them on full[st].
__device__ __forceinline__ void fill(float* dst, const float* src, int len,
                                     int st, int jj, float4 cf, int aligned,
                                     int lane, uint64_t* full,
                                     int32_t* j_ring, float* coef_ring) {
  if (aligned) {
    if (lane == 0) {
      j_ring[st] = jj;
      reinterpret_cast<float4*>(coef_ring)[st] = cf;
      mbar_arrive_expect(&full[st], 4u * (uint32_t)len);
      if (len > 0) bulk_copy(dst, src, 4u * (uint32_t)len, &full[st]);
    }
  } else {
    for (int i = lane; i < len; i += 32) copy4(dst + i, src + i);
    copy4_arrive(&full[st]);
    if (lane == 0) {
      j_ring[st] = jj;
      reinterpret_cast<float4*>(coef_ring)[st] = cf;
      mbar_arrive(&full[st]);
    }
  }
  __syncwarp();
}

// Where lane q < C of warp 0 sends the CTA's partial: slot `rank` of the
// CTA of rank q, and its barrier, by step parity.
struct Peers {
  uint32_t slot0, slot1, bar0, bar1;
};

__device__ __forceinline__ Peers peers(float* slots, uint64_t* red_bar,
                                       uint32_t rank, uint32_t C, int warp,
                                       int lane) {
  Peers q = {0u, 0u, 0u, 0u};
  if (warp == 0 && lane < (int)C) {
    q.slot0 = cluster::peer_addr(&slots[rank], lane);
    q.slot1 = cluster::peer_addr(&slots[kMaxCluster + rank], lane);
    q.bar0 = cluster::peer_addr(&red_bar[0], lane);
    q.bar1 = cluster::peer_addr(&red_bar[1], lane);
  }
  return q;
}

// Step s's rendezvous: this thread's partial dot `part` summed over the
// warp, the CTA and then the cluster's CTAs in rank order, and the new
// alpha_j from it (a = the old one, cf the column's scalars). Every
// consumer thread of every CTA computes the same z.
__device__ __forceinline__ float step_z(float part, float a, float4 cf,
                                        int s, float* red, float* slots,
                                        uint64_t* red_bar, const Peers& q,
                                        uint32_t C, int warp, int lane) {
  const int p = s & 1;
  part = warp_sum(part);
  if (lane == 0) red[p * kConsumerWarps + warp] = part;
  consumers_sync();
  if (warp == 0) {
    // each group of 8 lanes sums the 8 warp partials in the same
    // butterfly order, so every sending lane holds the CTA's partial
    float v = red[p * kConsumerWarps + (lane & (kConsumerWarps - 1))];
#pragma unroll
    for (int o = kConsumerWarps / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane < (int)C)
      st_async(p ? q.slot1 : q.slot0, __float_as_uint(v),
               p ? q.bar1 : q.bar0);
    if (lane == 0) mbar_arrive_expect(&red_bar[p], 4u * C);
  }
  mbar_wait<true>(&red_bar[p], (uint32_t)((s >> 1) & 1));
  float dot = 0.f;
  for (uint32_t r = 0; r < C; ++r) dot += slots[p * kMaxCluster + r];
  const float z_tilde = (cf.y * a - dot) / cf.z;
  const float sgn = z_tilde > 0.f ? 1.f : (z_tilde < 0.f ? -1.f : 0.f);
  const float z = sgn * fmaxf(fabsf(z_tilde) - cf.w, 0.f);
  return cf.x > 0.f ? z : a;                  // zero (padded) column: no-op
}

// The register form: ITEMS rows of rho a consumer thread holds in
// registers, one ring stage a step holding the step's column slab; alpha
// in shared memory, or (ALPHA_DEV) this CTA's copy in alpha_priv. Its
// body is written out as it was before the streamed forms existed, not
// built from the helpers above, which only the streamed forms use.
template <int ITEMS, bool ALPHA_DEV>
__global__ void __launch_bounds__(kThreads, 1)
scd_kernel(const float* __restrict__ A_T, const float* __restrict__ col_sq,
           const float* __restrict__ alpha_in, const float* __restrict__ w,
           const int32_t* __restrict__ idx, float* __restrict__ alpha_out,
           float* __restrict__ delta_v, float* alpha_priv, int n_pad, int m,
           int H, int slab, int P, int aligned, float sigma, float lam_eta,
           float lam_l1) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(slab, P, ALPHA_DEV ? 0 : n_pad, 0);
  float* ring = smem + L.ring;
  // the worker's alpha block: in shared memory, or this CTA's own copy
  float* alpha = ALPHA_DEV ? alpha_priv + (size_t)blockIdx.x * n_pad
                           : smem + L.alpha;
  float* red = smem + L.red;
  float* slots = smem + L.slots;
  float* coef_ring = smem + L.coef;
  int32_t* j_ring = reinterpret_cast<int32_t*>(smem + L.jdx);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + P;
  uint64_t* red_bar = empty + P;

  const uint32_t C = cluster::size();
  const uint32_t rank = cluster::rank();
  const int k = blockIdx.x / C;
  const int lo = min((int)rank * slab, m);
  const int len = min(lo + slab, m) - lo;      // this CTA's rows, maybe 0
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* A_k = A_T + (size_t)k * n_pad * m;

  if (tid == 0) {
    for (int st = 0; st < P; ++st) {
      mbar_init(&full[st], aligned ? 1 : 33);
      mbar_init(&empty[st], kConsumerWarps);
    }
    mbar_init(&red_bar[0], 1);
    mbar_init(&red_bar[1], 1);
    cluster::fence_mbar_init();
  }
  for (int i = tid; i < n_pad; i += kThreads)
    alpha[i] = alpha_in[(size_t)k * n_pad + i];
  cluster::sync();   // every CTA's barriers exist before any peer uses them

  if (warp == kConsumerWarps) {
    // ---- producer warp: keep up to P steps of columns in flight --------
    const float* csq_k = col_sq + (size_t)k * n_pad;
    const int32_t* idx_k = idx + (size_t)k * H;
    for (int base = 0; base < H; base += 32) {
      const int s = base + lane;
      int j = 0;
      float cs = 0.f;
      if (s < H) {
        j = idx_k[s];
        if (j < 0 || j >= n_pad) __trap();   // an index outside the block
        cs = csq_k[j];
      }
      // the step's scalars that depend on the column alone, off the chain
      const float scsq = sigma * cs;
      const float denom = scsq + lam_eta;
      const float thr = lam_l1 / denom;
      const int n = min(32, H - base);
      for (int u = 0; u < n; ++u) {
        const int t = base + u;
        const int st = t % P;
        const int jj = __shfl_sync(0xffffffffu, j, u);
        float4 cf;
        cf.x = __shfl_sync(0xffffffffu, cs, u);
        cf.y = __shfl_sync(0xffffffffu, scsq, u);
        cf.z = __shfl_sync(0xffffffffu, denom, u);
        cf.w = __shfl_sync(0xffffffffu, thr, u);
        if (t >= P)
          mbar_wait<false>(&empty[st], (uint32_t)((t / P - 1) & 1));
        float* dst = ring + (size_t)st * slab;
        const float* src = A_k + (size_t)jj * m + lo;
        if (aligned) {
          if (lane == 0) {
            j_ring[st] = jj;
            reinterpret_cast<float4*>(coef_ring)[st] = cf;
            mbar_arrive_expect(&full[st], 4u * (uint32_t)len);
            if (len > 0) bulk_copy(dst, src, 4u * (uint32_t)len, &full[st]);
          }
        } else {
          for (int i = lane; i < len; i += 32) copy4(dst + i, src + i);
          copy4_arrive(&full[st]);
          if (lane == 0) {
            j_ring[st] = jj;
            reinterpret_cast<float4*>(coef_ring)[st] = cf;
            mbar_arrive(&full[st]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumer warps: the H steps -----------------------------------
    // lane q < C of warp 0 sends to the CTA of rank q, by step parity
    uint32_t slot0 = 0u, slot1 = 0u, bar0 = 0u, bar1 = 0u;
    if (warp == 0 && lane < (int)C) {
      slot0 = cluster::peer_addr(&slots[rank], lane);
      slot1 = cluster::peer_addr(&slots[kMaxCluster + rank], lane);
      bar0 = cluster::peer_addr(&red_bar[0], lane);
      bar1 = cluster::peer_addr(&red_bar[1], lane);
    }
    float r[ITEMS];                             // rho's rows of this thread
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * kConsumers;
      r[it] = (i < len) ? w[lo + i] : 0.f;
    }
    for (int s = 0; s < H; ++s) {
      const int st = s % P;
      const int p = s & 1;
      mbar_wait<false>(&full[st], (uint32_t)((s / P) & 1));
      const int j = j_ring[st];
      const float4 cf = reinterpret_cast<const float4*>(coef_ring)[st];
      const float* col = ring + (size_t)st * slab;
      float c[ITEMS];
      float part = 0.f;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = tid + it * kConsumers;
        c[it] = (i < len) ? col[i] : 0.f;
        part += r[it] * c[it];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);   // the stage is free again
      const float a = alpha[j];
      part = warp_sum(part);
      if (lane == 0) red[p * kConsumerWarps + warp] = part;
      consumers_sync();
      if (warp == 0) {
        // each group of 8 lanes sums the 8 warp partials in the same
        // butterfly order, so every sending lane holds the CTA's partial
        float v = red[p * kConsumerWarps + (lane & (kConsumerWarps - 1))];
#pragma unroll
        for (int o = kConsumerWarps / 2; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane < (int)C)
          st_async(p ? slot1 : slot0, __float_as_uint(v), p ? bar1 : bar0);
        if (lane == 0) mbar_arrive_expect(&red_bar[p], 4u * C);
      }
      mbar_wait<true>(&red_bar[p], (uint32_t)((s >> 1) & 1));
      float dot = 0.f;
      for (uint32_t q = 0; q < C; ++q) dot += slots[p * kMaxCluster + q];
      const float z_tilde = (cf.y * a - dot) / cf.z;
      const float sgn = z_tilde > 0.f ? 1.f : (z_tilde < 0.f ? -1.f : 0.f);
      float z = sgn * fmaxf(fabsf(z_tilde) - cf.w, 0.f);
      z = cf.x > 0.f ? z : a;                   // zero (padded) column: no-op
      if (lane == 0) alpha[j] = z;              // same value in every warp
      __syncwarp();
      const float mv = sigma * (z - a);
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) r[it] = r[it] + mv * c[it];
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * kConsumers;
      if (i < len) delta_v[(size_t)k * m + lo + i] = (r[it] - w[lo + i]) / sigma;
    }
    consumers_sync();
    if (rank == 0)
      for (int i = tid; i < n_pad; i += kConsumers)
        alpha_out[(size_t)k * n_pad + i] = alpha[i];
  }
  cluster::sync();   // no CTA leaves while a peer may still store into it
}

// The streamed forms: rho's slab in shared memory (RHO == kRhoShared) or
// in delta_v's rows (kRhoDevice), each step's column slab passed through
// the ring twice in stages of `stage` rows; alpha as in scd_kernel.
template <int RHO, bool ALPHA_DEV>
__global__ void __launch_bounds__(kThreads, 1)
scd_kernel_streamed(const float* __restrict__ A_T,
                    const float* __restrict__ col_sq,
                    const float* __restrict__ alpha_in,
                    const float* __restrict__ w,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ alpha_out, float* delta_v,
                    float* alpha_priv, int n_pad, int m, int H, int slab,
                    int stage, int P, int aligned, float sigma,
                    float lam_eta, float lam_l1) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(stage, P, ALPHA_DEV ? 0 : n_pad,
                 RHO == kRhoShared ? slab : 0);
  float* ring = smem + L.ring;
  float* red = smem + L.red;
  float* slots = smem + L.slots;
  float* coef_ring = smem + L.coef;
  int32_t* j_ring = reinterpret_cast<int32_t*>(smem + L.jdx);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + P;
  uint64_t* red_bar = empty + P;
  float* alpha = ALPHA_DEV ? alpha_priv + (size_t)blockIdx.x * n_pad
                           : smem + L.alpha;

  const uint32_t C = cluster::size();
  const uint32_t rank = cluster::rank();
  const int k = blockIdx.x / C;
  const int lo = (int)min((long long)rank * slab, (long long)m);
  const int len = (int)min((long long)lo + slab, (long long)m) - lo;
  const int chunks = max(1, (len + stage - 1) / stage);   // stages a pass
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* A_k = A_T + (size_t)k * n_pad * m;

  setup(full, empty, red_bar, alpha, alpha_in + (size_t)k * n_pad, n_pad, P,
        aligned, tid);

  if (warp == kConsumerWarps) {
    // ---- producer warp: `chunks` stages a pass, two passes a step ------
    const float* csq_k = col_sq + (size_t)k * n_pad;
    const int32_t* idx_k = idx + (size_t)k * H;
    for (int base = 0; base < H; base += 32) {
      const Column col = column(idx_k, csq_k, base + lane, H, n_pad, sigma,
                                lam_eta, lam_l1);
      const int n = min(32, H - base);
      for (int u = 0; u < n; ++u) {
        const int t = base + u;
        float4 cf;
        const int jj = from_lane(col, u, cf);
        for (int c = 0; c < 2 * chunks; ++c) {
          const int g = 2 * t * chunks + c;
          const int st = g % P;
          const int clo = (c % chunks) * stage;
          if (g >= P)
            mbar_wait<false>(&empty[st], (uint32_t)((g / P - 1) & 1));
          fill(ring + (size_t)st * stage, A_k + (size_t)jj * m + lo + clo,
               max(0, min(stage, len - clo)), st, jj, cf, aligned, lane,
               full, j_ring, coef_ring);
        }
      }
    }
  } else {
    // ---- consumer warps: the H steps -----------------------------------
    const Peers q = peers(slots, red_bar, rank, C, warp, lane);
    float* rho = RHO == kRhoShared ? smem + L.rho
                                   : delta_v + (size_t)k * m + lo;
    for (int i = tid; i < len; i += kConsumers) rho[i] = w[lo + i];
    for (int s = 0; s < H; ++s) {
      int j = 0;
      float4 cf = make_float4(0.f, 0.f, 0.f, 0.f);
      float part = 0.f;
      // the dot pass: `chunks` stages, the dot goes on over them
      for (int ch = 0; ch < chunks; ++ch) {
        const int g = 2 * s * chunks + ch;
        const int st = g % P;
        mbar_wait<false>(&full[st], (uint32_t)((g / P) & 1));
        if (ch == 0) {
          j = j_ring[st];
          cf = reinterpret_cast<const float4*>(coef_ring)[st];
        }
        const float* col = ring + (size_t)st * stage;
        const int clo = ch * stage;
        const int clen = min(stage, len - clo);
        for (int i = tid; i < clen; i += kConsumers)
          part += rho[clo + i] * col[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
      const float a = alpha[j];
      const float z = step_z(part, a, cf, s, red, slots, red_bar, q, C,
                             warp, lane);
      if (lane == 0) alpha[j] = z;              // same value in every warp
      __syncwarp();
      const float mv = sigma * (z - a);
      // the update pass: the same stages of the column again
      for (int ch = 0; ch < chunks; ++ch) {
        const int g = (2 * s + 1) * chunks + ch;
        const int st = g % P;
        mbar_wait<false>(&full[st], (uint32_t)((g / P) & 1));
        const float* col = ring + (size_t)st * stage;
        const int clo = ch * stage;
        const int clen = min(stage, len - clo);
        for (int i = tid; i < clen; i += kConsumers)
          rho[clo + i] = rho[clo + i] + mv * col[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    }
    float* dv = delta_v + (size_t)k * m + lo;
    for (int i = tid; i < len; i += kConsumers)
      dv[i] = (rho[i] - w[lo + i]) / sigma;
    consumers_sync();
    if (rank == 0)
      for (int i = tid; i < n_pad; i += kConsumers)
        alpha_out[(size_t)k * n_pad + i] = alpha[i];
  }
  cluster::sync();   // no CTA leaves while a peer may still store into it
}

template <auto Kernel>
cudaError_t configure(int cluster, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(Kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              cluster > 8 ? 1 : 0);
}

cudaLaunchConfig_t config(int K, int cluster, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  return cluster::config(K * cluster, kThreads, cluster, smem, stream, attr);
}

template <auto Kernel, typename... Args>
cudaError_t launch(int K, int cluster, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t e = configure<Kernel>(cluster, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(K, cluster, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <auto Kernel>
cudaError_t occupancy(int cluster, size_t smem, int* out) {
  cudaError_t e = configure<Kernel>(cluster, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(1, cluster, smem, 0, attr);
  return cudaOccupancyMaxActiveClusters(out, Kernel, &cfg);
}

// The slab a plan must give: ceil(m / cluster) rounded up to 4 floats.
int plan_slab(int m, int cluster) {
  const long long s = ((long long)m + cluster - 1) / cluster;
  return (int)((s + 3) / 4 * 4);
}

// The stage a plan must give: the slab when rho is in registers (which
// holds at most kMaxItems rows a consumer thread); streamed, at most
// kStageRows rows of it.
bool plan_ok(int m, int n_pad, int cluster, int slab, int stage, int ring,
             int rho) {
  const bool stage_ok =
      rho == kRegisters
          ? (stage == slab && slab <= kMaxItems * kConsumers)
          : (rho == kRhoShared || rho == kRhoDevice) &&
                stage == min(slab, kStageRows);
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
          cluster == 16) && slab == plan_slab(m, cluster) && stage_ok &&
         ring >= 2 && ring <= kMaxRing && n_pad >= 1;
}

// The kernel instance for the plan: the streamed form for rho in shared
// or device memory, else the register form with the rows a thread rounded
// up to a power of two.
template <bool ALPHA_DEV>
cudaError_t dispatch(const float* A_T, const float* col_sq,
                     const float* alpha_in, const float* w,
                     const int32_t* idx, float* alpha_out, float* delta_v,
                     float* alpha_priv, int K, int n_pad, int m, int H,
                     int cluster, int slab, int stage, int ring, int rho,
                     int aligned, float sigma, float lam_eta, float lam_l1,
                     size_t smem, cudaStream_t st) {
#define SCD_ARGS                                                            \
  K, cluster, smem, st, A_T, col_sq, alpha_in, w, idx, alpha_out, delta_v, \
      alpha_priv, n_pad, m, H, slab
  if (rho == kRhoShared)
    return launch<scd_kernel_streamed<kRhoShared, ALPHA_DEV>>(
        SCD_ARGS, stage, ring, aligned, sigma, lam_eta, lam_l1);
  if (rho == kRhoDevice)
    return launch<scd_kernel_streamed<kRhoDevice, ALPHA_DEV>>(
        SCD_ARGS, stage, ring, aligned, sigma, lam_eta, lam_l1);
  const int items = (slab + kConsumers - 1) / kConsumers;
#define SCD_CASE(N)                                                         \
  if (items <= N)                                                           \
    return launch<scd_kernel<N, ALPHA_DEV>>(SCD_ARGS, ring, aligned, sigma, \
                                            lam_eta, lam_l1);
  SCD_CASE(1)
  SCD_CASE(2)
  SCD_CASE(4)
  SCD_CASE(8)
  SCD_CASE(16)
  SCD_CASE(32)
  SCD_CASE(64)
#undef SCD_CASE
#undef SCD_ARGS
  return cudaErrorInvalidValue;
}

template <bool ALPHA_DEV>
cudaError_t occupancy_of(int cluster, int slab, int rho, size_t smem,
                         int* out) {
  if (rho == kRhoShared)
    return occupancy<scd_kernel_streamed<kRhoShared, ALPHA_DEV>>(cluster,
                                                                 smem, out);
  if (rho == kRhoDevice)
    return occupancy<scd_kernel_streamed<kRhoDevice, ALPHA_DEV>>(cluster,
                                                                 smem, out);
  const int items = (slab + kConsumers - 1) / kConsumers;
#define SCD_OCC(N) \
  if (items <= N)  \
    return occupancy<scd_kernel<N, ALPHA_DEV>>(cluster, smem, out);
  SCD_OCC(1)
  SCD_OCC(2)
  SCD_OCC(4)
  SCD_OCC(8)
  SCD_OCC(16)
  SCD_OCC(32)
  SCD_OCC(64)
#undef SCD_OCC
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory one CTA needs: the ring of `ring` stages of
// `stage` rows, `n_alpha` floats of alpha (the worker's block, or 0 when
// alpha lives in device memory), `n_rho` of rho (the slab when it lives in
// shared memory, else 0), the partials, the stage scalars and the
// mbarriers. kernels/scd.py computes the same number.
extern "C" long long scd_shared_bytes(int stage, int ring, int n_alpha,
                                      int n_rho) {
  return Layout(stage, ring, n_alpha, n_rho).bytes(ring);
}

// How many clusters of `cluster` CTAs with `smem` bytes each can be
// resident on this device at once (cudaOccupancyMaxActiveClusters), for
// the kernel that holds a slab of `slab` rows where `rho` says (0
// registers, 1 shared memory, 2 device memory) and alpha in shared or
// (`alpha_dev`) device memory.
extern "C" int scd_max_active_clusters(int cluster, int slab, int rho,
                                       int alpha_dev, long long smem,
                                       int* out) {
  const size_t sm = (size_t)smem;
  if (alpha_dev) return occupancy_of<true>(cluster, slab, rho, sm, out);
  return occupancy_of<false>(cluster, slab, rho, sm, out);
}

// One launch of K clusters of `cluster` CTAs. `slab`, `stage`, `ring`,
// `rho` and `smem` come from the Python plan, and `alpha_priv` is its
// scratch for alpha in device memory (K*cluster rows of n_pad) or null; a
// plan this side does not reproduce is refused with
// cudaErrorInvalidValue.
extern "C" int scd_launch(const float* A_T, const float* col_sq,
                          const float* alpha_in, const float* w,
                          const int32_t* idx, float* alpha_out,
                          float* delta_v, float* alpha_priv, int K,
                          int n_pad, int m, int H, int cluster, int slab,
                          int stage, int ring, int rho, long long smem,
                          float sigma, float lam_eta, float lam_l1,
                          void* stream) {
  if (K < 1 || m < 1 ||
      !plan_ok(m, n_pad, cluster, slab, stage, ring, rho) ||
      smem != scd_shared_bytes(stage, ring, alpha_priv ? 0 : n_pad,
                               rho == kRhoShared ? slab : 0))
    return (int)cudaErrorInvalidValue;
  const int aligned = (m % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(A_T) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (alpha_priv)
    return (int)dispatch<true>(A_T, col_sq, alpha_in, w, idx, alpha_out,
                               delta_v, alpha_priv, K, n_pad, m, H, cluster,
                               slab, stage, ring, rho, aligned, sigma,
                               lam_eta, lam_l1, (size_t)smem, st);
  return (int)dispatch<false>(A_T, col_sq, alpha_in, w, idx, alpha_out,
                              delta_v, alpha_priv, K, n_pad, m, H, cluster,
                              slab, stage, ring, rho, aligned, sigma,
                              lam_eta, lam_l1, (size_t)smem, st);
}
