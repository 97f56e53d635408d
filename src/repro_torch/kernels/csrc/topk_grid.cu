// K4's grid form: top-k by magnitude of each row of the (K, L) update
// stack over many CTAs a row, with the state across CTAs in device
// memory, for rows of 10^6 elements and more (the transformer's leaves:
// 253,755,392 elements, k = 2,537,554 under topk(r=0.01)).
//
// Replaces the same TPU kernel as csrc/topk.cu (`topk_select`, pallas_call
// at src/repro/kernels/topk.py:83) and gives the same bits: the order is
// that of the 64-bit key (|x| bits << 32) | (0xFFFFFFFF - index), larger
// first, so larger |x| first and ties to the lower index (lax.top_k's
// order); the values are copied as read (a -0.0 stays -0.0) and the
// threshold is the k-th largest |x|.
//
// What bounds it on an H100: bytes, K*(4L + 8k + 4) of them (1.236 ms at
// K = 4, L = 253,755,392, k = 2,537,554). The cluster forms ran one
// 16-CTA cluster a row there (64 CTAs on 132 SMs at K = 4, 16 at K = 1),
// read x on each of five passes and sorted ~159k survivors a CTA by a
// bitonic network over device memory: 116 ms at K = 4 (PERF.md).
//
// The design. Every pass over a row runs on a grid of G CTAs a row (grid
// (G, K), G from kernels/topk.py::topk_plan: about 4,224 CTAs in all, 4
// waves of 8 a SM), each CTA taking tiles of 4096 elements or keys in
// turn, x read with 16-byte loads after a scalar head that reaches a
// 16-byte boundary. The key of every element is ranked as a whole, so the
// selection is a radix select over the key's 63 bits in six digits, the
// pattern's 31 bits (11, 10, 10) and then the index's 32 (11, 11, 10):
//   hist     one pass over x: each CTA's shared histogram of the first
//            digit (2048 bins), added into the row's device histogram with
//            integer atomics (exact, in any order). A thread adds a run of
//            equal digits once, so a row of one magnitude does not
//            serialise on one shared bin.
//   select s the CTA of a row that finishes the pass before stage s last
//            (a ticket taken after a fence) picks the digit d_s where the
//            count from the top first reaches `need` (the keys still to
//            take); the keys above it are taken, `need` falls by their
//            count, and the keys equal to it are the next stage's
//            candidates. Where `need` equals their count, all of them are
//            taken and the selection ends (at the last digit at the
//            latest: keys are distinct).
//   refine s over this stage's candidates: a key whose digit is above d_s
//            (or equal to it at the last stage) is a survivor, written to
//            the row's survivor list (k keys); one equal to it is a
//            candidate of stage s + 1, counted in that stage's histogram
//            and written to a candidate buffer when there are at most
//            `cap` of them. Stage 0 reads x (the second and, for most
//            rows, last pass over it); a later stage reads the buffer, or,
//            past the cap, x again, keeping the keys whose digits above
//            this one are those chosen (so a row of one magnitude, such as
//            the all-zero row of a dropped worker, needs no L-element
//            buffer: it reads x once more for each of its digits). A tile
//            places its survivors and candidates by a block scan in a CTA's
//            shared staging, moved to the row's lists by one atomic add a
//            flush, so their order in the lists depends on the run, never
//            the set.
// The tie rule needs no pass of its own: among keys of one magnitude the
// index digits choose the lowest indices, which is the first `take_eq` by
// index of csrc/topk.cu:48-53 across the whole row.
//   tiles    the k survivors, 4096 keys a CTA, sorted descending in shared
//            memory by a bitonic network;
//   merge    log2(k/4096) rounds of merge path: each CTA finds where its
//            2048 outputs start and end in the two runs it merges (256-way
//            searches along the diagonals, `split_pair`), merges them in
//            shared memory and stores them; the last round (or the tiles,
//            for k <= 4096)
//            writes vals[pos] = x[index], idxs[pos] = index, and, at
//            pos = k - 1, the threshold.
// Every launch runs on the caller's stream; every size that depends on
// the data (the digits, the counts, the list lengths) stays in device
// memory, and a stage whose selection has ended returns at once. No host
// read: the launches are init, seven passes (the histogram and six
// refines), the tiles and ceil(log2(ceil(k/4096))) merge rounds.
//
// Scratch (the wrapper's, zeroed here by topk_grid_init): a row's state
// (64 words) and six 2048-bin histograms, then k survivor keys a row, then
// max(k, 2*cap) keys a row of work space (the two candidate buffers during
// the selection, the sort's second buffer after it); cap = min(L, 2^22).
// kernels/topk.py::grid_layout computes the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // the passes and the select
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                    // keys a thread a tile
constexpr int kTile = kThreads * kPer;      // 4096 keys or elements a tile
constexpr int kVec = kTile / 4;             // float4s a tile of x
constexpr int kBins = 2048;
constexpr int kStages = 6;
constexpr int kSortThreads = 512;
constexpr int kSortTile = 4096;             // keys a CTA sorts
constexpr int kMerge = 2048;                // keys a CTA merges
constexpr int kCapMax = 1 << 22;
constexpr int kGridCtas = 4224;             // a pass's CTAs in all
constexpr int kStateWords = 64;
constexpr int kRowWords = kStateWords + kStages * kBins;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// the state words of a row
enum : int {
  kNeed = 0,      // keys still to take
  kLast = 1,      // 1 + the stage at which the selection ended, 0 before
  kNsurv = 2,     // survivors written
  kDigit = 8,     // + s: the digit chosen at stage s
  kCount = 16,    // + s: candidates at stage s (s >= 1)
  kNcand = 24,    // + s: candidates of stage s written to its buffer
  kTicket = 32,   // + s: CTAs of the pass before stage s that are done
};

__host__ __device__ constexpr int stage_shift(int s) {
  return s == 0 ? 52 : s == 1 ? 42 : s == 2 ? 32 : s == 3 ? 21
       : s == 4 ? 10 : 0;
}
__host__ __device__ constexpr int stage_width(int s) {
  return s == 0 ? 11 : s == 1 ? 10 : s == 2 ? 10 : s == 3 ? 11
       : s == 4 ? 11 : 10;
}
__device__ __forceinline__ u64 key_of(uint32_t bits, uint32_t i) {
  return ((u64)(bits & 0x7FFFFFFFu) << 32) | (u64)(0xFFFFFFFFu - i);
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive scan of v over the CTA (kThreads threads) in thread order;
// `total` gets the sum. `sums` holds kWarps + 1 words of shared memory;
// the call ends with the CTA synchronised.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* sums,
                                               uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_scan(v, lane);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  uint32_t before = incl - v;
  total = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t t = sums[w];
    before += w < warp ? t : 0u;
    total += t;
  }
  __syncthreads();
  return before;
}

// What the plan gives: the CTAs of a pass a row, the candidate cap, the
// merge rounds, and the scratch's parts.
struct GridLayout {
  int ctas, cap, merges;
  long long meta, surv, work, total;      // byte offsets / sizes
  long long work_stride;                  // keys of work space a row
  __host__ GridLayout(int K, int L, int k) {
    const long long tiles = ((long long)L + kTile - 1) / kTile;
    const long long want = (kGridCtas + K - 1) / K;
    ctas = (int)(tiles < want ? tiles : want);
    cap = L < kCapMax ? L : kCapMax;
    merges = 0;
    for (long long w = kSortTile; w < k; w <<= 1) ++merges;
    work_stride = k > 2LL * cap ? k : 2LL * cap;
    auto up = [](long long b) { return (b + 255) / 256 * 256; };
    meta = 0;
    surv = up(4LL * K * kRowWords);
    work = surv + up(8LL * K * k);
    total = work + up(8LL * K * work_stride);
  }
};

// Zero every row's state and histograms.
__global__ void __launch_bounds__(kThreads)
topk_grid_init(uint4* meta, long long n16) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n16;
       i += (long long)gridDim.x * kThreads)
    meta[i] = make_uint4(0u, 0u, 0u, 0u);
}

// One stage's test of a key, and where it goes.
struct Stage {
  bool fin;       // this stage takes every key equal to its digit
  bool store;     // the next stage's candidates go to its buffer
  uint32_t d;     // this stage's digit
  int sh, nsh;    // this stage's and the next one's digit: shift and mask
  uint32_t msk, nmsk;
  u64 pmask, pfx; // keys read from x: the digits chosen above this one
};

// A warp's staging of its survivors (list 0) and candidates (list 1) in
// shared memory, moved to the row's lists by one atomic add a flush, so
// a pass neither waits on a device-memory atomic nor meets a CTA barrier
// at every tile.
constexpr int kWarpStage = 128;             // keys a warp stages a list
struct Lists {
  u64* stage[2];          // this warp's staging (shared)
  uint32_t n[2];          // keys staged (the same in every lane)
  uint32_t* slot[2];      // the row's counters (kNsurv, kNcand + s + 1)
  u64* dst[2];            // the row's lists
  uint32_t room[2];       // their lengths (k, cap)
};

// Move list l's staged keys to the row's list (the whole warp).
__device__ __forceinline__ void flush(Lists& ls, int l) {
  const int lane = threadIdx.x & 31;
  uint32_t base = 0u;
  if (lane == 0) base = atomicAdd(ls.slot[l], ls.n[l]);
  base = __shfl_sync(kFull, base, 0);
  __syncwarp();
  for (uint32_t i = lane; i < ls.n[l]; i += 32)
    if (base + i < ls.room[l]) ls.dst[l][base + i] = ls.stage[l][i];
  __syncwarp();
  ls.n[l] = 0u;
}

// A tile's keys through stage s (kPer a thread; key j where bit j of
// `valid` is set): a key whose digit is above d_s (or equal to it at the
// last stage) is a survivor; one equal to it a candidate of stage s + 1,
// its next digit counted in the shared histogram (a thread adds a run of
// one digit once, so a row of one magnitude does not serialise on a
// bin). A warp places its keys by a scan of its lanes' counts: in its
// staging (flushed first if they would not fit), or, more than the
// staging holds, straight into the list.
__device__ __forceinline__ void tile_keys(
    const Stage& st, const u64 (&key)[kPer], uint32_t valid, Lists& ls,
    uint32_t* hist, uint32_t& run_bin, uint32_t& run_n) {
  uint32_t bits[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!((valid >> j) & 1u) || (key[j] & st.pmask) != st.pfx) continue;
    const uint32_t dg = (uint32_t)(key[j] >> st.sh) & st.msk;
    if (dg > st.d || (st.fin && dg == st.d)) {
      bits[0] |= 1u << j;
    } else if (dg == st.d) {
      bits[1] |= 1u << j;
      const uint32_t b = (uint32_t)(key[j] >> st.nsh) & st.nmsk;
      if (b != run_bin) {
        if (run_n) atomicAdd(&hist[run_bin], run_n);
        run_bin = b;
        run_n = 0u;
      }
      ++run_n;
    }
  }
  if (!st.store) bits[1] = 0u;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const uint32_t c = (uint32_t)__popc(bits[l]);
    const uint32_t t = __reduce_add_sync(kFull, c);
    if (t == 0u) continue;
    const uint32_t before = warp_incl_scan(c, lane) - c;
    if (ls.n[l] + t > (uint32_t)kWarpStage) flush(ls, l);
    u64* to = ls.stage[l] + ls.n[l];
    uint32_t room = (uint32_t)kWarpStage;
    if (t > (uint32_t)kWarpStage) {       // past the staging: straight in
      uint32_t base = 0u;
      if (lane == 0) base = atomicAdd(ls.slot[l], t);
      base = __shfl_sync(kFull, base, 0);
      to = ls.dst[l] + base;
      room = base < ls.room[l] ? ls.room[l] - base : 0u;
    } else {
      ls.n[l] += t;
    }
    uint32_t p = before;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if ((bits[l] >> j) & 1u) {
        if (p < room) to[p] = key[j];
        ++p;
      }
    }
    __syncwarp();
  }
}

// Stage s's digit of a row, by the CTA that finished the pass before it
// last: thread t holds the eight bins 2047 - 8t .. 2040 - 8t, so an
// exclusive scan in thread order is each thread's count above its bins.
__device__ __forceinline__ void select_digit(int k, int s, uint32_t* state,
                                             uint32_t* sums) {
  const uint32_t need = s == 0 ? (uint32_t)k : state[kNeed];
  const uint32_t* h = state + kStateWords + (size_t)s * kBins;
  const int top = kBins - 1 - 8 * (int)threadIdx.x;
  uint32_t c[8], sum = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = __ldcg(h + top - j);
    sum += c[j];
  }
  uint32_t total;
  uint32_t above = block_scan(sum, sums, total);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (above < need && need <= above + c[j]) {
      const uint32_t left = need - above;
      state[kDigit + s] = (uint32_t)(top - j);
      state[kNeed] = left;
      state[kCount + s + 1] = c[j];
      if (left == c[j]) state[kLast] = (uint32_t)(s + 1);
    }
    above += c[j];
  }
}

// The end of a pass over a row: the CTA's histogram of the next stage's
// digit added into the row's (integer atomics: exact, in any order), and
// the CTA that finishes last picks that digit. Every other CTA's
// histogram is in device memory before its ticket (the fence), and the
// last one reads them from L2.
__device__ __forceinline__ void end_pass(int k, int next, uint32_t* state,
                                         const uint32_t* hist,
                                         uint32_t* sums) {
  __shared__ uint32_t last;
  uint32_t* g = state + kStateWords + (size_t)next * kBins;
  for (int b = threadIdx.x; b < kBins; b += kThreads)
    if (hist[b]) atomicAdd(&g[b], hist[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&state[kTicket + next], 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    select_digit(k, next, state, sums);
  }
}

// The row's first pass (grid (G, K)): the histogram of the first digit
// (the pattern's top 11 bits) over x, then stage 0's digit.
__global__ void __launch_bounds__(kThreads)
topk_grid_hist(const float* __restrict__ x, int L, int k,
               uint32_t* __restrict__ meta) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t sums[kWarps + 1];
  const int row = blockIdx.y;
  uint32_t* state = meta + (size_t)row * kRowWords;
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0u;
  __syncthreads();
  uint32_t run_bin = 0u, run_n = 0u;
  auto add = [&](uint32_t bits) {
    const uint32_t b = (bits & 0x7FFFFFFFu) >> 20;
    if (b != run_bin) {
      if (run_n) atomicAdd(&hist[run_bin], run_n);
      run_bin = b;
      run_n = 0u;
    }
    ++run_n;
  };
  const float* xr = x + (size_t)row * L;
  const int head = (int)min((long long)L,
      (long long)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(xr) & 15u))
                   & 15u) / 4u));
  const long long nvec = ((long long)L - head) / 4;
  const int tail0 = head + (int)(4 * nvec);
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  if (blockIdx.x == 0) {            // the scalar head and tail
    const int t = threadIdx.x;
    if (t < head)
      add(__float_as_uint(xr[t]));
    else if (t >= 4 && t - 4 < L - tail0)
      add(__float_as_uint(xr[tail0 + t - 4]));
  }
  const long long tiles = (nvec + kVec - 1) / kVec;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    float4 v[kPer / 4];
#pragma unroll
    for (int f = 0; f < kPer / 4; ++f) {
      const long long q = t * kVec + f * kThreads + threadIdx.x;
      v[f] = q < nvec ? xv[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int f = 0; f < kPer / 4; ++f) {
      if (t * kVec + f * kThreads + threadIdx.x >= nvec) continue;
      add(__float_as_uint(v[f].x));
      add(__float_as_uint(v[f].y));
      add(__float_as_uint(v[f].z));
      add(__float_as_uint(v[f].w));
    }
  }
  if (run_n) atomicAdd(&hist[run_bin], run_n);
  __syncthreads();
  end_pass(k, 0, state, hist, sums);
}

// The refine of stage s over a row (grid (G, K)): over x, or over stage
// s's candidate buffer; then, unless the selection ends here, stage
// s + 1's digit. Four CTAs a SM (at most 64 registers a thread, which
// it takes without spilling) keep more loads of x in flight than the
// three its unbounded 73 registers left room for.
__global__ void __launch_bounds__(kThreads, 4)
topk_grid_pass(const float* __restrict__ x, int L, int k, int s,
               uint32_t* __restrict__ meta, u64* __restrict__ survs,
               u64* __restrict__ work, long long work_stride, int cap) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t sums[kWarps + 1];
  __shared__ u64 staged[kWarps][2][kWarpStage];
  const int row = blockIdx.y;
  uint32_t* state = meta + (size_t)row * kRowWords;
  const uint32_t last = state[kLast];
  if (last != 0u && (int)last <= s) return;     // the selection has ended
  // the stage's constants, computed once: a digit's shift and mask read
  // per key in the unrolled loops would be a chain of selects on s there
  Stage st;
  st.fin = (int)last == s + 1;
  st.d = state[kDigit + s];
  st.sh = stage_shift(s);
  st.msk = (1u << stage_width(s)) - 1u;
  st.nsh = s + 1 < kStages ? stage_shift(s + 1) : 0;
  st.nmsk = s + 1 < kStages ? (1u << stage_width(s + 1)) - 1u : 0u;
  st.store = s + 1 < kStages && !st.fin &&
             state[kCount + s + 1] <= (uint32_t)cap;
  // stage 0 reads x; a later stage its buffer unless its candidates
  // passed the cap
  const bool from_x = s == 0 || state[kCount + s] > (uint32_t)cap;
  st.pmask = 0ull;
  st.pfx = 0ull;
  if (from_x && s > 0) {
    st.pmask = ~0ull << stage_shift(s - 1);
    for (int j = 0; j < s; ++j)
      st.pfx |= (u64)state[kDigit + j] << stage_shift(j);
  }
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0u;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  Lists ls;
  ls.stage[0] = staged[warp][0];
  ls.stage[1] = staged[warp][1];
  ls.n[0] = ls.n[1] = 0u;
  ls.slot[0] = &state[kNsurv];
  ls.slot[1] = &state[kNcand + (s + 1 < kStages ? s + 1 : s)];
  ls.dst[0] = survs + (size_t)row * k;
  ls.dst[1] = work + (size_t)row * work_stride + (size_t)((s + 1) & 1) * cap;
  ls.room[0] = (uint32_t)k;
  ls.room[1] = (uint32_t)cap;
  uint32_t run_bin = 0u, run_n = 0u;
  u64 key[kPer];
  if (from_x) {
    const float* xr = x + (size_t)row * L;
    const int head = (int)min((long long)L,
        (long long)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(xr) & 15u))
                     & 15u) / 4u));
    const long long nvec = ((long long)L - head) / 4;
    const int tail0 = head + (int)(4 * nvec);
    const float4* xv = reinterpret_cast<const float4*>(xr + head);
    // tiles of kTile elements (key 4f + e of a thread is component e of
    // float4 f * kThreads + tid of the tile); CTA 0 first takes the
    // scalar head and tail as a tile t = -1
    const long long tiles = (nvec + kVec - 1) / kVec;
    for (long long t = blockIdx.x == 0 ? -1LL : (long long)blockIdx.x;
         t < tiles; t = t < 0 ? 0 : t + gridDim.x) {
      uint32_t valid = 0u;
      if (t >= 0) {
#pragma unroll
        for (int f = 0; f < kPer / 4; ++f) {
          const long long q = t * kVec + f * kThreads + threadIdx.x;
          const float4 v = q < nvec ? xv[q]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          const uint32_t i = (uint32_t)(head + 4 * q);
          key[4 * f + 0] = key_of(__float_as_uint(v.x), i);
          key[4 * f + 1] = key_of(__float_as_uint(v.y), i + 1u);
          key[4 * f + 2] = key_of(__float_as_uint(v.z), i + 2u);
          key[4 * f + 3] = key_of(__float_as_uint(v.w), i + 3u);
          if (q < nvec) valid |= 0xFu << (4 * f);
        }
      } else {
        const int u = threadIdx.x;
        const int i = u < head ? u
                      : (u >= 4 && u - 4 < L - tail0) ? tail0 + u - 4 : -1;
#pragma unroll
        for (int j = 0; j < kPer; ++j) key[j] = 0ull;
        if (i >= 0) {
          key[0] = key_of(__float_as_uint(xr[i]), (uint32_t)i);
          valid = 1u;
        }
      }
      tile_keys(st, key, valid, ls, hist, run_bin, run_n);
    }
  } else {
    const uint32_t n = state[kCount + s];
    const u64* cur = work + (size_t)row * work_stride +
                     (size_t)(s & 1) * cap;
    const uint32_t tiles = (n + kTile - 1) / kTile;
    for (uint32_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      uint32_t valid = 0u;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const uint32_t q = t * kTile + j * kThreads + threadIdx.x;
        key[j] = q < n ? __ldcg(cur + q) : 0ull;
        if (q < n) valid |= 1u << j;
      }
      tile_keys(st, key, valid, ls, hist, run_bin, run_n);
    }
  }
  if (run_n) atomicAdd(&hist[run_bin], run_n);
  for (int l = 0; l < 2; ++l)
    if (ls.n[l]) flush(ls, l);
  __syncthreads();
  if (s + 1 < kStages && !st.fin) end_pass(k, s + 1, state, hist, sums);
}

// The output of sorted position `pos` of a row.
__device__ __forceinline__ void emit(u64 key, int pos, int row, int k,
                                     const float* __restrict__ x, int L,
                                     float* vals, int32_t* idxs, float* thr) {
  const uint32_t i = 0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull);
  vals[(size_t)row * k + pos] = x[(size_t)row * L + i];
  idxs[(size_t)row * k + pos] = (int32_t)i;
  if (pos == k - 1) thr[row] = __uint_as_float((uint32_t)(key >> 32));
}

// How many of the first d keys of the merge of descending runs a (na
// keys) and b (nb) come from a: the merge path's split on diagonal d.
__device__ __forceinline__ int split(const u64* a, int na, const u64* b,
                                     int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Sort each 4096-key tile of a row's survivors descending (grid
// (ceil(k/4096), K)); pad 0 lies below every key (index 0xFFFFFFFF is
// past any row). A thread sorts its 8 keys in registers (an odd-even
// transposition network), then nine rounds of merge path in shared
// memory double the runs to the tile: a thread finds its 8 outputs' start
// by `split` and merges them. Writes the sorted run to dst, or, when the
// tiles are the whole sort (k <= 4096), the outputs.
__global__ void __launch_bounds__(kSortThreads)
topk_grid_tiles(const u64* __restrict__ src, u64* __restrict__ dst,
                long long dst_stride, int k, int out,
                const float* __restrict__ x, int L, float* vals,
                int32_t* idxs, float* thr) {
  constexpr int kEach = kSortTile / kSortThreads;     // 8
  __shared__ u64 a[kSortTile];
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kSortTile;
  const int n = min(kSortTile, k - t0);
  const u64* in = src + (size_t)row * k + t0;
  for (int i = threadIdx.x; i < kSortTile; i += kSortThreads)
    a[i] = i < n ? __ldcg(in + i) : 0ull;
  __syncthreads();
  const int o = kEach * threadIdx.x;
  u64 r[kEach];
#pragma unroll
  for (int j = 0; j < kEach; ++j) r[j] = a[o + j];
#pragma unroll
  for (int pass = 0; pass < kEach; ++pass) {
#pragma unroll
    for (int j = pass & 1; j + 1 < kEach; j += 2) {
      const u64 hi = r[j] > r[j + 1] ? r[j] : r[j + 1];
      const u64 lo = r[j] > r[j + 1] ? r[j + 1] : r[j];
      r[j] = hi;
      r[j + 1] = lo;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kEach; ++j) a[o + j] = r[j];
  __syncthreads();
  for (int w = kEach; w < kSortTile; w <<= 1) {
    const int base = o / (2 * w) * (2 * w);
    const u64* A = a + base;
    const u64* B = A + w;
    int ia = split(A, w, B, w, o - base);
    int ib = o - base - ia;
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      const bool from_a = ib >= w || (ia < w && A[ia] > B[ib]);
      r[j] = from_a ? A[ia++] : B[ib++];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kEach; ++j) a[o + j] = r[j];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += kSortThreads) {
    if (out)
      emit(a[i], t0 + i, row, k, x, L, vals, idxs, thr);
    else
      dst[(size_t)row * dst_stride + t0 + i] = a[i];
  }
}

// The splits on diagonals d0 (into cut[0], by threads 0-255) and d1
// (cut[1], threads 256-511) of the same merge as `split`, in device
// memory: each round, each thread tests one point of its half's range
// (the test is true below the split, false from it on), the count of
// true points narrows the range 256-fold, and four rounds reach any
// split of a row of int32 keys; a handful of dependent reads instead of
// ~2 log2(k).
__device__ __forceinline__ void split_pair(const u64* a, int na,
                                           const u64* b, int nb, int d0,
                                           int d1, int* cut) {
  const int h = threadIdx.x >> 8, lane = threadIdx.x & 255;
  const int d = h ? d1 : d0;
  int lo = max(0, d - nb), hi = min(d, na);   // the split is in [lo, hi]
  for (int round = 0; round < 4; ++round) {
    const int len = hi - lo;
    const int step = (len + 255) / 256;
    if (lane == 0) cut[2 + h] = 0;
    __syncthreads();
    const int i = lo + lane * step;
    const bool p = len > 0 && i < hi && __ldcg(a + i) > __ldcg(b + d - 1 - i);
    const unsigned bal = __ballot_sync(kFull, p);
    if ((threadIdx.x & 31) == 0 && bal) atomicAdd(&cut[2 + h], __popc(bal));
    __syncthreads();
    const int c = cut[2 + h];
    if (len > 0) {
      if (step == 1) {
        lo += c;
        hi = lo;
      } else if (c == 0) {
        hi = lo;
      } else {
        hi = min(hi, lo + c * step);
        lo += (c - 1) * step + 1;
      }
    }
    __syncthreads();                  // the count is read before its reset
  }
  if (lane == 0) cut[h] = lo;
  __syncthreads();
}

// One round of merges (grid (ceil(k/2048), K)): the runs of width w in src
// (rows of src_stride keys) are merged in pairs into runs of 2w in dst,
// 2048 outputs a CTA; the last round writes the outputs instead.
__global__ void __launch_bounds__(kSortThreads)
topk_grid_merge(const u64* __restrict__ src, long long src_stride,
                u64* __restrict__ dst, long long dst_stride, int k, int w,
                int out, const float* __restrict__ x, int L, float* vals,
                int32_t* idxs, float* thr) {
  __shared__ u64 in[kMerge];
  __shared__ u64 res[kMerge];
  __shared__ int cut[4];              // the two splits, two counts
  const int row = blockIdx.y;
  const int o0 = blockIdx.x * kMerge;
  const long long pair = o0 / (2LL * w);
  const int base = (int)(pair * 2 * w);
  const u64* A = src + (size_t)row * src_stride + base;
  const int na = min(w, k - base);
  const u64* B = A + na;
  const int nb = max(0, min(w, k - base - w));
  const int d0 = o0 - base;
  const int d1 = min(d0 + kMerge, na + nb);
  split_pair(A, na, B, nb, d0, d1, cut);
  const int a0 = cut[0], a1 = cut[1];
  const int b0 = d0 - a0, b1 = d1 - a1;
  const int la = a1 - a0, lb = b1 - b0, n = d1 - d0;
  for (int i = threadIdx.x; i < n; i += kSortThreads)
    in[i] = i < la ? __ldcg(A + a0 + i) : __ldcg(B + b0 + i - la);
  __syncthreads();
  constexpr int kEach = kMerge / kSortThreads;
  const int dl = threadIdx.x * kEach;
  if (dl < n) {
    int ia = split(in, la, in + la, lb, dl);
    int ib = dl - ia;
    const int e = min(n, dl + kEach);
    for (int o = dl; o < e; ++o) {
      const bool from_a = ib >= lb || (ia < la && in[ia] > in[la + ib]);
      res[o] = from_a ? in[ia++] : in[la + ib++];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSortThreads) {
    if (out)
      emit(res[i], o0 + i, row, k, x, L, vals, idxs, thr);
    else
      dst[(size_t)row * dst_stride + o0 + i] = res[i];
  }
}

}  // namespace

// The grid form on the caller's stream: init, the histogram and the six
// refines (each pass selecting the next digit at its end), the tiles'
// sort and the merge rounds. `ctas` and
// `scratch_bytes` come from the Python plan (kernels/topk.py::topk_plan)
// and `scratch` is its block; a plan this side does not reproduce is
// refused with cudaErrorInvalidValue. Returns the first launch error.
extern "C" int topk_grid_launch(const float* x, float* vals, int32_t* idxs,
                                float* thr, int K, int L, int k, int ctas,
                                void* scratch, long long scratch_bytes,
                                void* stream_ptr) {
  if (K < 1 || K > 65535 || L < 1 || k < 1 || k > L || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const GridLayout lay(K, L, k);
  if (ctas != lay.ctas || scratch_bytes != lay.total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  uint32_t* meta = reinterpret_cast<uint32_t*>(base + lay.meta);
  u64* surv = reinterpret_cast<u64*>(base + lay.surv);
  u64* work = reinterpret_cast<u64*>(base + lay.work);
  const long long n16 = (long long)K * kRowWords / 4;
  topk_grid_init<<<64, kThreads, 0, st>>>(reinterpret_cast<uint4*>(meta),
                                          n16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)lay.ctas, (unsigned)K);
  topk_grid_hist<<<grid, kThreads, 0, st>>>(x, L, k, meta);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int s = 0; s < kStages; ++s) {
    topk_grid_pass<<<grid, kThreads, 0, st>>>(x, L, k, s, meta, surv, work,
                                             lay.work_stride, lay.cap);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  // the sort: tiles from the survivors into the work space, then the
  // rounds back and forth; the last step writes the outputs
  const dim3 tgrid((unsigned)((k + kSortTile - 1) / kSortTile), (unsigned)K);
  topk_grid_tiles<<<tgrid, kSortThreads, 0, st>>>(
      surv, work, lay.work_stride, k, lay.merges == 0, x, L, vals, idxs,
      thr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 mgrid((unsigned)((k + kMerge - 1) / kMerge), (unsigned)K);
  const u64* from = work;
  long long from_stride = lay.work_stride;
  u64* to = surv;
  long long to_stride = k;
  int w = kSortTile;
  for (int r = 1; r <= lay.merges; ++r, w <<= 1) {
    topk_grid_merge<<<mgrid, kSortThreads, 0, st>>>(
        from, from_stride, to, to_stride, k, w, r == lay.merges, x, L, vals,
        idxs, thr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const u64* f = to;
    const long long fs = to_stride;
    to = const_cast<u64*>(from);
    to_stride = from_stride;
    from = f;
    from_stride = fs;
  }
  return (int)cudaSuccess;
}
