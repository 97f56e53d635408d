// K4: top-k by magnitude of each row of the (K, L) update stack, one CTA
// per row, for the topk codec's encode.
//
// Replaces the TPU kernel `_topk_kernel` / `topk_select` in
// src/repro/kernels/topk.py (pallas_call at :83), which the reference
// vmaps over workers and which runs k argmax+mask sweeps over a row held
// in VMEM (O(k*L) work). Here the K rows go in one launch, and each CTA:
//
//   1. writes |x| of its row as uint32 bit patterns (sign bit cleared)
//      into shared memory: for non-negative floats integer order is float
//      order, and -0.0 becomes +0.0 as under jnp.abs;
//   2. finds the k-th largest pattern T by radix select: four 8-bit
//      passes, each a 256-bin shared histogram (warp-aggregated atomics)
//      of the patterns that match the digits chosen so far, and a block
//      scan of the bins from the top;
//   3. compacts in index order: every element whose pattern is > T, and
//      the first k - count(> T) elements whose pattern is == T (a
//      ballot/popc rank over 1024-element chunks), stored as 64-bit keys
//      (pattern << 32) | (0xFFFFFFFF - index);
//   4. sorts the k keys descending with a bitonic network in shared
//      memory, padded to a power of two with 0 (below every real key):
//      larger magnitude first and, between equal magnitudes, the lower
//      index first, which is lax.top_k's order;
//   5. writes x[index] read from device memory as it is (a -0.0 stays
//      -0.0), the index, and T as a float: the threshold mags[k-1].
//
// It selects and copies and does no arithmetic on the values, so it is
// bit-identical to TopKCodec.encode_ref (src/repro/comm/codec.py:450-455)
// and to the port's plain version (a stable descending torch.sort of |x|).
//
// Shared memory: 8*pow2(k) bytes of keys, 4L of patterns, 1 KB of
// histogram and a few counters: 197,776 B at L = k = 16384, so the kernel
// opts in above 48 KB. The wrapper refuses a row that needs more than the
// 227 KB one block may use.
//
// What bounds it on an H100: bytes, K*(4L + 8k + 4) of them (655,392 B at
// K = 8, L = 16384, k = 2048, ~0.2 us at 3.35 TB/s). In practice it is
// the barriers: 12 in the select, 2 per 1024-element chunk in the
// compaction and log2(kp)*(log2(kp)+1)/2 in the sort (66 at k = 2048), on
// only K of the 132 SMs. Spreading a row over a thread-block cluster, and
// a warp-level select for small k, are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

long long shared_bytes(int L, int k) {
  return 8LL * pow2_at_least(k) + 4LL * L + 4LL * (kBins + kWarps + 4);
}

__global__ void __launch_bounds__(kThreads, 1)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
            int32_t* __restrict__ idxs, float* __restrict__ thr, int L,
            int k, int kp) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                          // kp
  uint32_t* pat = reinterpret_cast<uint32_t*>(keys + kp);   // L
  uint32_t* hist = pat + L;                                 // kBins
  uint32_t* warp_tot = hist + kBins;                        // kWarps
  // misc[0]: the digits of T chosen so far; misc[1]: how many elements
  // equal to that prefix still have to be taken; misc[2]: keys written
  uint32_t* misc = warp_tot + kWarps;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xr = x + (size_t)row * L;

  for (int i = tid; i < L; i += kThreads)
    pat[i] = __float_as_uint(xr[i]) & 0x7FFFFFFFu;
  for (int j = k + tid; j < kp; j += kThreads) keys[j] = 0ull;
  if (tid == 0) {
    misc[0] = 0u;
    misc[1] = (uint32_t)k;
    misc[2] = 0u;
  }

  // -- 2. radix select of T, the k-th largest pattern ------------------
  uint32_t mask = 0u;          // the digits of the prefix fixed so far
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0u;
    __syncthreads();
    const uint32_t prefix = misc[0];
    const uint32_t need = misc[1];
    // the loop bound is the same for every thread, so whole warps
    // reach the match
    for (int base = 0; base < L; base += kThreads) {
      const int i = base + tid;
      int digit = -1;
      if (i < L && (pat[i] & mask) == prefix)
        digit = (int)((pat[i] >> shift) & 0xFFu);
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], (uint32_t)__popc(peers));
    }
    __syncthreads();
    // threads 0..255 take the bins from the top (thread t: digit 255-t)
    // and scan their counts; the thread whose running count first
    // reaches `need` holds the next digit of T
    uint32_t c = 0u, incl = 0u;
    if (tid < kBins) {
      c = hist[kBins - 1 - tid];
      incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) warp_tot[warp] = incl;
    }
    __syncthreads();
    if (tid < kBins) {
      for (int w = 0; w < warp; ++w) incl += warp_tot[w];
      if (incl >= need && incl - c < need) {
        misc[0] = prefix | ((uint32_t)(kBins - 1 - tid) << shift);
        misc[1] = need - (incl - c);
      }
    }
    mask |= 0xFFu << shift;
    __syncthreads();
  }
  const uint32_t T = misc[0];
  const uint32_t take_eq = misc[1];      // >= 1

  // -- 3. stable compaction of the k survivors -------------------------
  uint32_t eq_seen = 0u;                 // == T in earlier chunks
  for (int base = 0; base < L; base += kThreads) {
    const int i = base + tid;
    const uint32_t p = (i < L) ? pat[i] : 0u;
    const bool gt = i < L && p > T;
    const bool eq = i < L && p == T;
    const unsigned ball = __ballot_sync(kFull, eq);
    if (lane == 0) warp_tot[warp] = (uint32_t)__popc(ball);
    __syncthreads();
    uint32_t rank = eq_seen + (uint32_t)__popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t t = warp_tot[w];
      if (w < warp) rank += t;
      eq_seen += t;
    }
    if (gt || (eq && rank < take_eq)) {
      const uint32_t slot = atomicAdd(&misc[2], 1u);
      keys[slot] = ((unsigned long long)p << 32) | (0xFFFFFFFFu - (uint32_t)i);
    }
    __syncthreads();                     // before warp_tot is rewritten
  }

  // -- 4. bitonic sort of the keys, descending -------------------------
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = tid; j < (kp >> 1); j += kThreads) {
        const int lo = 2 * j - (j & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? (a < b) : (a > b)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // -- 5. read out -----------------------------------------------------
  for (int j = tid; j < k; j += kThreads) {
    const uint32_t i = 0xFFFFFFFFu - (uint32_t)(keys[j] & 0xFFFFFFFFull);
    vals[(size_t)row * k + j] = xr[i];
    idxs[(size_t)row * k + j] = (int32_t)i;
  }
  if (tid == 0) thr[row] = __uint_as_float(T);
}

}  // namespace

// Dynamic shared memory one CTA needs for a row of length L and k kept
// entries. The wrapper checks it against the 227 KB a block may use.
extern "C" long long topk_shared_bytes(int L, int k) {
  return shared_bytes(L, k);
}

extern "C" int topk_launch(const float* x, float* vals, int32_t* idxs,
                           float* thr, int K, int L, int k, void* stream) {
  if (K < 1 || L < 1 || k < 1 || k > L) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)shared_bytes(L, k);
  cudaError_t e = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  topk_kernel<<<K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, vals, idxs, thr, L, k, pow2_at_least(k));
  return (int)cudaGetLastError();
}
