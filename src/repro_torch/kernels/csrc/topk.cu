// K4: top-k by magnitude of each row of the (K, L) update stack, one
// thread-block cluster per row, for the topk codec's encode.
//
// Replaces the TPU kernel `_topk_kernel` / `topk_select` in
// src/repro/kernels/topk.py (pallas_call at :83), which the reference
// vmaps over workers and which runs k argmax+mask sweeps over a row held
// in VMEM (O(k*L) work). Here the K rows go in one launch.
//
// The order it must give: larger |x| first and, between equal magnitudes,
// the lower index first (lax.top_k's order). Every element is ranked by
// the 64-bit key (|x| bits << 32) | (0xFFFFFFFF - index): for
// non-negative floats integer order is float order, -0.0 has the pattern
// of +0.0 as under jnp.abs, and the keys of one row are all distinct. It
// selects and copies and does no arithmetic on the values, so it is
// bit-identical to TopKCodec.encode_ref (src/repro/comm/codec.py:450-455)
// and to the port's plain version (a stable descending torch.sort of |x|).
//
// What bounds it on an H100: bytes, K*(4L + 8k + 4) of them (655,392 B at
// K = 8, L = 16384, k = 2048, ~0.2 us at 3.35 TB/s). The one-CTA-a-row
// design ran the whole row on 8 of the 132 SMs through 12 barriers of
// radix select, 2 per 1024-element chunk of compaction and 66 stages of
// bitonic sort of all k keys, and took 55.7 us on the device (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py phase 5).
//
// The design: a cluster of C CTAs per row (cudaLaunchKernelEx, grid K*C;
// kernels/topk.py::topk_plan picks C, the slab S and the shared bytes).
// CTA rank r owns the elements [r*S, min((r+1)*S, L)) of its row, S a
// multiple of 4. Each CTA
//   1. loads its slab once (16-byte loads when L is a multiple of 4 and x
//      is 16-byte aligned) as |x| bit patterns into shared memory;
//   2. finds T, the k-th largest pattern of the row, by radix select over
//      the cluster: four 8-bit passes, each a 256-bin histogram of the
//      slab's patterns that match the digits chosen so far (plain shared
//      atomics, not warp-private copies: rows whose patterns spread over
//      all 256 top digits ran no faster than Gaussian rows, whose first
//      pass falls in one or two bins), sent to every CTA with 16-byte
//      st.async into slot r of the
//      peer's buffer of the pass's parity, completed on the peer's
//      mbarrier. Each CTA waits on its own mbarrier, sums the C slots of
//      each bin (integers: exact) and scans them from the top, so every
//      CTA picks the same digit with one push and one local wait a pass.
//      A buffer of one parity is written again only two passes later,
//      after its owner has sent the pass between, which it does only
//      once it has read the buffer. The same slots give each rank's count
//      above T (the bins above each pass's digit) and equal to T (the
//      last pass's bin of T), so every CTA knows every rank's survivors
//      without another exchange;
//   3. keeps the ties stable across CTAs: of the take_eq elements equal
//      to T that the row needs, rank r takes the first
//      min(eq_r, max(0, take_eq - sum of eq over ranks < r)), in index
//      order; inside the CTA the survivors are placed by a warp scan and a
//      block scan of packed (gt, eq) counts, four elements a thread, no
//      atomic counter;
//   4. sorts its survivors descending into a run in shared memory (up to
//      512 of them by counting, for each, the survivors above it; more by
//      a bitonic sort whose stages of stride below 64 stay inside one
//      warp's blocks and need only __syncwarp), so that a survivor's place
//      in its CTA's run is its rank there. After one rendezvous (its arrival
//      split from its wait) each CTA copies the row's k keys from its
//      peers' runs, in chunks of up to 4096, into its shared memory (over
//      the slab's patterns, which are no longer needed), and a thread per
//      (survivor, peer) pair binary-searches the peer's run for the keys
//      above the survivor's; integer shared atomics add the C counts to
//      the survivor's own rank. That is its output position: about
//      (k/C)·C·log2(k/C) steps a CTA where counting every pair took k^2/C
//      compares;
//   5. writes vals[pos] = x[index] read from device memory as it is (a
//      -0.0 stays -0.0) and idxs[pos] = index; rank 0 writes T as a float,
//      the threshold mags[k-1]. A last rendezvous, arrived at once the
//      peers' keys are copied and waited for at the end, keeps every CTA
//      alive until its peers have read its run.
// A CTA whose slab is empty still sends its (empty) histograms and meets
// every rendezvous.
//
// Shared memory a CTA: max(4S, 8*min(k, 4096) + 4*P) bytes for the
// patterns and later the gathered keys and the counts, 2 x 8*P of survivor
// keys (P the power of two at or above min(S, k)), 2*C KB of received
// histograms, 2 KB of its own and 512 B of scratch (topk_plan in
// kernels/topk.py computes the same).
//
// A row whose CTA needs more than the 227 KB a block may use (min(S, k)
// survivors past about 6k, or a slab past about 56k elements) takes the
// device-memory forms of the same kernel (the plan takes them only
// there, in this order):
// - survivors in device memory (`dev`): each CTA's survivors, its sorted
//   run and their counts live in a scratch block the wrapper allocates
//   (20*P bytes a CTA). The compaction writes the survivors into a
//   shared-memory tile of up to kTile keys when they fit it, and the sort
//   runs there as above; more survivors are sorted by the same bitonic
//   network over device memory, the strides of kTile and above as
//   CTA-wide passes over the scratch and the smaller ones a tile at a
//   time in shared memory. The rank is turned round: after the same
//   rendezvous (its release and acquire cover device memory, and the
//   writer fences first) each key of each peer's run is read once from
//   device memory and binary-searched among the CTA's own sorted keys,
//   kept in the tile, and marks a difference array whose prefix sums are
//   the survivors' output positions, with no gathered chunks and no loop
//   over (survivor, peer) pairs.
// - patterns in device memory as well (`pat_dev`): the slab's patterns
//   are not kept but read again from x on each of the five passes over
//   it (L2 hits after the first); the tile then sits where they would.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kGather = 4096;         // keys gathered at a time
constexpr int kReads = 8;             // peer keys a thread reads at a time
                                      // in the device forms' rank
constexpr int kTile = 8192;           // keys of the device form's sort tile
constexpr int kMaxCluster = 16;
constexpr int kMaxSurvivors = 1 << 30;   // a CTA's sort stays in int
constexpr int kMiscWords = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  int ocap, gcap, tile;               // own survivor keys, gathered keys,
                                      // the device forms' sort tile
  long long tiles, own, run, recv, hist, misc, total;   // byte offsets
  __host__ __device__ Layout(int slab, int k, int C, int dev, int pat_dev) {
    ocap = 2;                         // a power of two, for the sort
    while (ocap < min(slab, k)) ocap <<= 1;
    gcap = (min(k, kGather) + 1) / 2 * 2;
    tile = dev ? min(ocap, kTile) : 0;
    const long long ranks = 4LL * ((ocap + 3) / 4 * 4);
    // the patterns (none when they are read from x), overlaid later by
    // the gathered keys and the counts (in the device forms by the counts
    // of up to a tile of survivors); then the device forms' sort tile
    const long long pats = pat_dev ? 0 : 4LL * slab;
    const long long later =
        dev ? 4LL * ((tile + 3) / 4 * 4) : 8LL * gcap + ranks;
    long long a = pats > later ? pats : later;
    tiles = a;
    a += 8LL * tile;
    own = a;                          // the survivors as compacted
    run = own + (dev ? 0 : 8LL * ocap);   // the survivors sorted, for peers
    recv = run + (dev ? 0 : 8LL * ocap);  // 2 parities x C peers x kBins
    hist = recv + 4LL * 2 * C * kBins;
    misc = hist + 4LL * 2 * kBins;
    total = misc + 4LL * kMiscWords;
  }
  // 8-byte words of device scratch a CTA of the device forms: its
  // survivors, its sorted run (ocap keys each) and their counts
  __host__ __device__ long long scratch_words() const {
    return 2LL * ocap + ocap / 2;
  }
};

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// One stage of the descending bitonic network over n keys of `a` at
// stride `stride` inside merges of `size`; `base` is a[0]'s position in
// the whole sequence (the direction of a merge follows the position).
__device__ __forceinline__ void bitonic_stage(unsigned long long* a, int n,
                                              long long base, int size,
                                              int stride, int tid) {
  for (int j = tid; j < (n >> 1); j += kThreads) {
    const int p = 2 * j - (j & (stride - 1));
    const int q = p + stride;
    const unsigned long long kp = a[p], kq = a[q];
    if (((base + p) & size) == 0 ? kp < kq : kp > kq) {
      a[p] = kq;
      a[q] = kp;
    }
  }
}

// Sort a[0..n) descending in place in shared memory, padded to pw (a
// power of two at or above n) with 0, below every real key. A stage of
// stride < 64 pairs keys inside aligned blocks of 64, and pair j lies in
// block j / 32: with pairs dealt out to the warps 32 at a time, each warp
// keeps the same blocks over those stages and needs only __syncwarp
// between them; a wider stride takes the CTA.
__device__ __forceinline__ void sort_block(unsigned long long* a, int n,
                                           int pw, int tid) {
  for (int i = n + tid; i < pw; i += kThreads) a[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= pw; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      bitonic_stage(a, pw, 0, size, stride, tid);
      if (stride >= 64 || (stride == 1 && size * 2 <= pw && size * 2 > 64))
        __syncthreads();
      else
        __syncwarp();
    }
  }
  __syncthreads();
}

// The device form's sort of pw (a power of two above kTile) keys of `g`
// in device memory, descending: the stages of stride kTile and above
// over all of g, the smaller ones a tile at a time through `tile` in
// shared memory.
__device__ void bitonic_device(unsigned long long* g, int pw,
                               unsigned long long* tile, int tid) {
  for (int size = kTile; size <= pw; size <<= 1) {
    for (int stride = size >> 1; stride >= kTile; stride >>= 1) {
      bitonic_stage(g, pw, 0, size, stride, tid);
      __syncthreads();
    }
    for (int t0 = 0; t0 < pw; t0 += kTile) {
      for (int i = tid; i < kTile; i += kThreads) tile[i] = g[t0 + i];
      __syncthreads();
      // the first pass sorts each tile whole (merges of 2 .. kTile)
      for (int sz = size == kTile ? 2 : size; sz <= size; sz <<= 1) {
        for (int stride = min(sz, kTile) >> 1; stride > 0; stride >>= 1) {
          bitonic_stage(tile, kTile, t0, sz, stride, tid);
          __syncthreads();
        }
      }
      for (int i = tid; i < kTile; i += kThreads) g[t0 + i] = tile[i];
      __syncthreads();
    }
  }
}

// The device forms' ranks. Every key of every peer's run, read from its
// scratch block, finds by binary search pos, the number of this CTA's n
// sorted keys `mine` above it, and adds one to diff[pos]: the survivors
// from pos on lie below that key. So each survivor's output position is
// its own place plus the inclusive prefix sum of diff, which the CTA then
// leaves in diff. A thread reads up to kReads peer keys at a time, and
// neighbouring lanes search for neighbouring (sorted) keys.
__device__ __forceinline__ void rank_device(
    const unsigned long long* mine, uint32_t* diff, int n,
    const unsigned long long* scratch, long long words, int ocap, int row,
    int C, int rank, const uint32_t* offs, uint32_t* warp_tot, int tid) {
  for (int o = tid; o < n; o += kThreads) diff[o] = 0u;
  __syncthreads();
  cluster::wait();                    // every peer's run is written
  for (int q = 0; q < C && n > 0; ++q) {
    if (q == rank) continue;
    const int n_q = (int)(offs[q + 1] - offs[q]);
    const unsigned long long* peer =
        scratch + (size_t)(row * C + q) * words + ocap;
    for (int i0 = tid; i0 < n_q; i0 += kReads * kThreads) {
      unsigned long long v[kReads];
#pragma unroll
      for (int u = 0; u < kReads; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < n_q ? __ldcg(peer + i) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kReads; ++u) {
        if (i0 + u * kThreads >= n_q) break;
        int lo = 0, len = n;
        while (len > 0) {
          const int half = len >> 1;
          if (mine[lo + half] > v[u]) {
            lo += half + 1;
            len -= half + 1;
          } else {
            len = half;
          }
        }
        if (lo < n) atomicAdd(&diff[lo], 1u);
      }
    }
  }
  __syncthreads();
  cluster::arrive();                  // done with the peers' keys
  // the prefix sums, a contiguous range of the survivors a thread
  const int per = (n + kThreads - 1) / kThreads;
  const int b = min(tid * per, n);
  const int e = min(b + per, n);
  uint32_t sum = 0u;
  for (int i = b; i < e; ++i) sum += diff[i];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t incl = warp_incl_scan(sum, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  uint32_t acc = incl - sum;
  for (int w = 0; w < warp; ++w) acc += warp_tot[w];
  for (int i = b; i < e; ++i) {
    acc += diff[i];
    diff[i] = acc + (uint32_t)i;
  }
  __syncthreads();
}

// DEV: the survivors in device memory (`scratch`), the device forms; a
// template parameter, so that the shared form's buffers stay
// shared-memory accesses.
template <bool DEV>
__global__ void __launch_bounds__(kThreads, 1)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
            int32_t* __restrict__ idxs, float* __restrict__ thr, int L,
            int k, int slab, int vec, unsigned long long* scratch,
            int pat_dev) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t C = cluster::size();
  const uint32_t rank = cluster::rank();
  const Layout lay(slab, k, (int)C, DEV, pat_dev);
  uint32_t* pat = reinterpret_cast<uint32_t*>(smem);          // slab
  unsigned long long* gath = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* tile =                 // the device forms' sort tile
      reinterpret_cast<unsigned long long*>(smem + lay.tiles);
  uint32_t* recv = reinterpret_cast<uint32_t*>(smem + lay.recv);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + lay.hist);
  uint32_t* misc = reinterpret_cast<uint32_t*>(smem + lay.misc);
  uint32_t* wtot = misc;              // 2 x kWarps packed (gt, eq) counts
  uint32_t* stot = misc + 32;         // 8 warps' totals of the bin scan
  uint32_t* sown = misc + 40;         // the same for the CTA's own bins
  uint32_t* offs = misc + 48;         // kMaxCluster + 1 survivor offsets
  // st[0] the digits of T so far, st[1] how many == prefix still needed,
  // st[2] how many == T this CTA takes
  uint32_t* st = misc + 72;
  uint32_t* gtq = misc + 80;          // each rank's count above T
  uint64_t* got = reinterpret_cast<uint64_t*>(misc + 96);  // 2 parities
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = (int)min((long long)rank * slab, (long long)L);
  const int len = (int)min((long long)lo + slab, (long long)L) - lo;
  const float* xr = x + (size_t)row * L;
  // the survivors' keys as compacted (`own`), sorted (`run`, which the
  // peers read) and their output positions (`cnt`): in shared memory, or
  // in this CTA's scratch block
  unsigned long long* scr =
      scratch + (size_t)blockIdx.x * lay.scratch_words();   // DEV only
  unsigned long long* own =
      DEV ? scr : reinterpret_cast<unsigned long long*>(smem + lay.own);
  unsigned long long* run =
      DEV ? scr + lay.ocap
          : reinterpret_cast<unsigned long long*>(smem + lay.run);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem + 8LL * lay.gcap);
  // the slab's |x| pattern i: kept in shared memory, or read again
  auto pattern = [&](int i) -> uint32_t {
    return DEV && pat_dev ? __float_as_uint(xr[lo + i]) & 0x7FFFFFFFu
                          : pat[i];
  };

  // the mbarriers the peers' histograms complete on; the rendezvous that
  // makes them visible to the peers is waited for just before the first
  // send, so the load overlaps it
  if (tid == 0) {
    cluster::mbar_init(&got[0], 1);
    cluster::mbar_init(&got[1], 1);
    cluster::fence_mbar_init();
  }
  cluster::arrive();

  // -- 1. the slab's patterns -------------------------------------------
  if (DEV && pat_dev) {
    // read again on each pass
  } else if (vec) {
    const float4* src = reinterpret_cast<const float4*>(xr + lo);
    for (int i = tid; 4 * i < len; i += kThreads) {
      const float4 f = src[i];
      reinterpret_cast<uint4*>(pat)[i] =
          make_uint4(__float_as_uint(f.x) & 0x7FFFFFFFu,
                     __float_as_uint(f.y) & 0x7FFFFFFFu,
                     __float_as_uint(f.z) & 0x7FFFFFFFu,
                     __float_as_uint(f.w) & 0x7FFFFFFFu);
    }
  } else {
    for (int i = tid; i < len; i += kThreads)
      pat[i] = __float_as_uint(xr[lo + i]) & 0x7FFFFFFFu;
  }
  for (int b = tid; b < 2 * kBins; b += kThreads) hist[b] = 0u;
  if (tid < kMaxCluster) gtq[tid] = 0u;
  if (tid == 0) {
    st[0] = 0u;
    st[1] = (uint32_t)k;
  }
  __syncthreads();

  // -- 2. radix select of T over the cluster ----------------------------
  uint32_t mask = 0u;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const int p = pass & 1;
    uint32_t* h = hist + p * kBins;
    uint32_t* in = recv + p * (int)C * kBins;
    const uint32_t prefix = st[0];
    if (pass > 0) {
      // the ranks above T's digit of the last pass, in each peer's bins
      // (stable until this CTA sends this pass's histogram)
      const int dl = (int)((prefix >> (shift + 8)) & 0xFFu);
      if (warp < (int)C) {
        const uint32_t* b = recv + (p ^ 1) * (int)C * kBins + warp * kBins;
        uint32_t a = 0u;
#pragma unroll
        for (int j = 0; j < kBins / 32; ++j) {
          const int d = lane * (kBins / 32) + j;
          a += d > dl ? b[d] : 0u;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
        if (lane == 0) gtq[warp] += a;
      }
    }
    for (int i = tid; i < len; i += kThreads) {
      const uint32_t u = pattern(i);
      if ((u & mask) == prefix) atomicAdd(&h[(u >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (pass == 0) cluster::wait();   // every peer's mbarriers exist
    // send the histogram to every CTA (slot `rank` of its buffer of this
    // parity), 16 bytes at a time, completing on its mbarrier
    for (int t = tid; t < (int)C * (kBins / 4); t += kThreads) {
      const int q = t / (kBins / 4);
      const int c4 = t % (kBins / 4);
      const uint4 v = reinterpret_cast<const uint4*>(h)[c4];
      cluster::st_async(
          cluster::peer_addr(in + rank * kBins + 4 * c4, q), v,
          cluster::peer_addr(&got[p], q));
    }
    if (tid == 0) cluster::mbar_arrive_expect(&got[p], 4u * kBins * C);
    cluster::mbar_wait<true>(&got[p], (uint32_t)((pass >> 1) & 1));
    const uint32_t need = st[1];
    // threads 0..255 take the bins from the top (thread t: digit 255-t)
    const int d = kBins - 1 - tid;
    uint32_t c = 0u, co = 0u, incl = 0u, inco = 0u;
    if (tid < kBins) {
      uint32_t part[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        part[q] = q < (int)C ? in[q * kBins + d] : 0u;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) c += part[q];
      co = h[d];
      incl = warp_incl_scan(c, lane);
      inco = warp_incl_scan(co, lane);
      if (lane == 31) {
        stot[warp] = incl;
        sown[warp] = inco;
      }
      hist[(p ^ 1) * kBins + tid] = 0u;   // the next pass's histogram
    }
    __syncthreads();
    if (tid < kBins) {
      for (int w = 0; w < warp; ++w) {
        incl += stot[w];
        inco += sown[w];
      }
      // the bin where the running count from the top first reaches
      // `need` holds the next digit of T
      if (incl >= need && incl - c < need) {
        st[0] = prefix | ((uint32_t)d << shift);
        st[1] = need - (incl - c);
      }
    }
    mask |= 0xFFu << shift;
    __syncthreads();
  }
  const uint32_t T = st[0];
  const uint32_t take_eq = st[1];          // >= 1
  {
    // the ranks above T in the last pass (buffer 1: pass 3)
    const int dl = (int)(T & 0xFFu);
    if (warp < (int)C) {
      const uint32_t* b = recv + (int)C * kBins + warp * kBins;
      uint32_t a = 0u;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        const int d = lane * (kBins / 32) + j;
        a += d > dl ? b[d] : 0u;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
      if (lane == 0) gtq[warp] += a;
    }
  }
  __syncthreads();

  // -- 3. this CTA's share of the ties, and its survivors ---------------
  // every rank's count of == T is its last-pass bin of T's low digit;
  // lane q of warp 0 works out rank q's share of the ties and survivors,
  // and their offsets in the row's survivor list
  if (warp == 0) {
    uint32_t e = 0u, n = 0u;
    if (lane < (int)C) e = recv[(int)C * kBins + lane * kBins + (T & 0xFFu)];
    const uint32_t e_incl = warp_incl_scan(e, lane);
    const uint32_t before = e_incl - e;
    const uint32_t left = take_eq > before ? take_eq - before : 0u;
    const uint32_t take = e < left ? e : left;
    if (lane < (int)C) n = gtq[lane] + take;
    const uint32_t n_incl = warp_incl_scan(n, lane);
    if (lane < (int)C) {
      offs[lane + 1] = n_incl;
      if (lane == (int)rank) st[2] = take;
    }
    if (lane == 0) offs[0] = 0u;
  }
  __syncthreads();
  const uint32_t take_r = st[2];
  const uint32_t n_own = offs[rank + 1] - offs[rank];
  // the device form compacts into the shared tile when the survivors
  // fit it, and sorts them there
  const bool big = DEV && (int)n_own > lay.tile;
  unsigned long long* comp = DEV && !big ? tile : own;

  uint32_t run_gt = 0u, run_eq = 0u;
  for (int base = 0, par = 0; base < len;
       base += 4 * kThreads, par ^= 1) {
    const int i0 = base + 4 * tid;
    uint32_t u[4];
    uint32_t g = 0u, e = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[j] = i0 + j < len ? pattern(i0 + j) : 0u;
      g += (i0 + j < len && u[j] > T) ? 1u : 0u;
      e += (i0 + j < len && u[j] == T) ? 1u : 0u;
    }
    // (gt, eq) counts packed in one word: at most 4 * kThreads each
    const uint32_t mine = g | (e << 16);
    const uint32_t incl = warp_incl_scan(mine, lane);
    if (lane == 31) wtot[par * kWarps + warp] = incl;
    __syncthreads();
    uint32_t before = incl - mine, total = 0u;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t t = wtot[par * kWarps + w];
      if (w < warp) before += t;
      total += t;
    }
    uint32_t gb = run_gt + (before & 0xFFFFu);
    uint32_t eb = run_eq + (before >> 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j >= len) break;
      const unsigned long long key =
          ((unsigned long long)u[j] << 32) |
          (0xFFFFFFFFu - (uint32_t)(lo + i0 + j));
      if (u[j] > T) {
        comp[gb + (eb < take_r ? eb : take_r)] = key;
        ++gb;
      } else if (u[j] == T) {
        if (eb < take_r) comp[gb + eb] = key;
        ++eb;
      }
    }
    run_gt += total & 0xFFFFu;
    run_eq += total >> 16;
  }
  // sort the survivors descending into `run`, so that a survivor's place
  // in the CTA's run is its rank among the CTA's own survivors. Shared
  // form: up to kThreads of them, a thread a survivor counts the keys
  // above its own (n^2 compares of broadcast reads, no barrier); more
  // take a bitonic sort in place and a copy. Both give the same run: the
  // keys are distinct. Device forms: the bitonic sort in the tile, which
  // keeps the sorted keys for the searches below, and a copy to the run
  // in device memory that the peers read; more survivors than the tile
  // holds are sorted in device memory.
  __syncthreads();
  int pw = 2;
  while (pw < (int)n_own) pw <<= 1;
  if constexpr (!DEV) {
    if ((int)n_own <= kThreads) {
      if (tid < (int)n_own) {
        const unsigned long long key = own[tid];
        uint32_t above = 0u;
        int j = 0;
        for (; j + 8 <= (int)n_own; j += 8) {
#pragma unroll
          for (int u = 0; u < 8; ++u) above += own[j + u] > key ? 1u : 0u;
        }
        for (; j < (int)n_own; ++j) above += own[j] > key ? 1u : 0u;
        run[above] = key;
      }
    } else {
      sort_block(own, (int)n_own, pw, tid);
      for (int o = tid; o < (int)n_own; o += kThreads) run[o] = own[o];
    }
  } else if (!big) {
    sort_block(tile, (int)n_own, pw, tid);
    for (int o = tid; o < (int)n_own; o += kThreads) run[o] = tile[o];
  } else {
    for (int i = (int)n_own + tid; i < pw; i += kThreads) own[i] = 0ull;
    __syncthreads();
    bitonic_device(own, pw, tile, tid);
    for (int o = tid; o < (int)n_own; o += kThreads) run[o] = own[o];
  }
  __syncthreads();
  if (DEV) __threadfence();           // the run, in device memory
  cluster::arrive();                  // this CTA's sorted run is written

  // -- 4. rank against the other CTAs' sorted runs -----------------------
  if constexpr (!DEV) {
    // the patterns are read for good: their space takes the counts
    for (int o = tid; o < (int)n_own; o += kThreads) cnt[o] = (uint32_t)o;
    cluster::wait();
    for (int c0 = 0; c0 < k; c0 += lay.gcap) {
      const int n = min(lay.gcap, k - c0);
      // up to four remote reads in flight a thread
      for (int g0 = tid; g0 < n; g0 += 4 * kThreads) {
        unsigned long long v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int g = g0 + u * kThreads;
          v[u] = 0ull;
          if (g < n) {
            const uint32_t gg = (uint32_t)(c0 + g);
            int q = 0;
            while (q + 1 < (int)C && offs[q + 1] <= gg) ++q;
            v[u] = cluster::ld_u64(
                cluster::peer_addr(&run[gg - offs[q]], q));
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (g0 + u * kThreads < n) gath[g0 + u * kThreads] = v[u];
      }
      __syncthreads();
      if (c0 + lay.gcap >= k) cluster::arrive();   // done with the peers' keys
      // one (survivor, peer) pair a thread: a binary search for the number
      // of keys above the survivor's in the part of the peer's descending
      // run that this chunk holds
      for (int w = tid; w < (int)n_own * (int)C; w += kThreads) {
        const int o = w % (int)n_own;
        const int q = w / (int)n_own;
        if (q == (int)rank) continue;
        const int s0 = max((int)offs[q], c0) - c0;
        const int s1 = min((int)offs[q + 1], c0 + n) - c0;
        if (s0 >= s1) continue;
        const unsigned long long key = run[o];
        int lo = s0, len = s1 - s0;
        while (len > 0) {
          const int half = len >> 1;
          if (gath[lo + half] > key) {
            lo += half + 1;
            len -= half + 1;
          } else {
            len = half;
          }
        }
        if (lo > s0) atomicAdd(&cnt[o], (uint32_t)(lo - s0));
      }
      __syncthreads();
    }
  } else {
    // the positions come out in a shared-memory array over the dead
    // patterns, or with more survivors than the tile in the scratch block
    const long long words = lay.scratch_words();
    if (big) {
      cnt = reinterpret_cast<uint32_t*>(scr + 2 * lay.ocap);
      rank_device(run, cnt, (int)n_own, scratch, words, lay.ocap, row,
                  (int)C, (int)rank, offs, wtot, tid);
    } else {
      cnt = reinterpret_cast<uint32_t*>(smem);
      rank_device(tile, cnt, (int)n_own, scratch, words, lay.ocap, row,
                  (int)C, (int)rank, offs, wtot, tid);
    }
  }

  // -- 5. read out --------------------------------------------------------
  for (int o = tid; o < (int)n_own; o += kThreads) {
    const uint32_t pos = cnt[o];
    const uint32_t i = 0xFFFFFFFFu - (uint32_t)(run[o] & 0xFFFFFFFFull);
    vals[(size_t)row * k + pos] = xr[i];
    idxs[(size_t)row * k + pos] = (int32_t)i;
  }
  if (rank == 0 && tid == 0) thr[row] = __uint_as_float(T);
  cluster::wait();    // no CTA leaves while a peer may still read its keys
}

// The slab a plan must give: ceil(L / cluster) rounded up to 4.
int plan_slab(int L, int cluster) {
  const long long s = ((long long)L + cluster - 1) / cluster;
  return (int)((s + 3) / 4 * 4);
}

template <bool DEV>
cudaError_t occupancy(int cluster, size_t smem, int* out) {
  cudaError_t e = cluster::allow<topk_kernel<DEV>>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster::config(cluster, kThreads, cluster, smem, 0, attr);
  return cudaOccupancyMaxActiveClusters(out, topk_kernel<DEV>, &cfg);
}

}  // namespace

// How many clusters of `cluster` CTAs with `smem` bytes of shared memory
// each can be resident on this device at once
// (cudaOccupancyMaxActiveClusters), for the shared form or (`dev`) the
// device-memory forms.
extern "C" int topk_max_active_clusters(int cluster, int dev, long long smem,
                                        int* out) {
  if (cluster < 1 || cluster > kMaxCluster || smem < 0)
    return (int)cudaErrorInvalidValue;
  return (int)(dev ? occupancy<true>(cluster, (size_t)smem, out)
                   : occupancy<false>(cluster, (size_t)smem, out));
}

// One launch of K clusters of `cluster` CTAs. `slab`, `smem` and
// `pat_dev` come from the Python plan (kernels/topk.py::topk_plan), and
// `scratch` is its device-memory block for the survivors (K*cluster
// blocks of Layout::scratch_words() 8-byte words) or null; a plan this
// side does not reproduce is refused with cudaErrorInvalidValue.
extern "C" int topk_launch(const float* x, float* vals, int32_t* idxs,
                           float* thr, int K, int L, int k, int cluster,
                           int slab, long long smem, void* scratch,
                           int pat_dev, void* stream) {
  const int dev = scratch != nullptr;
  if (K < 1 || L < 1 || k < 1 || k > L || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      slab != plan_slab(L, cluster) || min(slab, k) > kMaxSurvivors ||
      (pat_dev && !dev) ||
      smem != Layout(slab, k, cluster, dev, pat_dev).total)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = dev ? cluster::allow<topk_kernel<true>>((size_t)smem)
                      : cluster::allow<topk_kernel<false>>((size_t)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (L % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster::config(K * cluster, kThreads, cluster, (size_t)smem,
                      static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, dev ? topk_kernel<true> : topk_kernel<false>,
                         x, vals, idxs, thr, L, k, slab, vec,
                         static_cast<unsigned long long*>(scratch), pat_dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
