// K3: exact top-k of each row of f32[Q, N], values descending, ties to the
// smallest index.
//
// Replaces the JAX package's topk_exact (searcharray_tpu/ops/kernels.py:
// 101-138), which XLA runs as a block-max selection sized for another
// machine.  That shape is not carried over: a selection per tile in shared
// memory (k up to 64) or a radix select over the row (larger k).
//
// The tie rule becomes a total order when every element is one 64-bit
// key: the float's bits mapped to an order-preserving u32 (the value key;
// -0.0 maps to the key of +0.0, so the two compare equal as floats do) in
// the high half and ~index in the low half.  The k largest keys of a row
// are the answer, and no two keys are equal.  Rows hold no NaN.
//
// Bound on the card: the rows read once (4 bytes an element) and 8 bytes
// written per result; the selection does no arithmetic to speak of.
//
// k <= ONE_PASS_CAP (64; the main path's k is 10): two launches, no
// memset, each element read from HBM once (sa_topk_select).
//
//   1. topk_tile_kernel, a block per SEL_TILE (16,384) elements of a row.
//      The block reads its tile once, with 16-byte loads (SEL_LOAD in
//      flight a thread), and stores the value keys in shared memory
//      (64 KB); each thread keeps its largest key, the block its least.
//      A first bound comes from those maxima: in each warp the need-th
//      largest of its 32 threads' maxima (a shuffle sort) has need keys
//      at or above it, so the largest of the warps' bounds the tile's
//      need-th key from below.  One pass over the shared keys then
//      gathers the keys at or above it (at most SHORT = 256 of them is
//      the common case: a few dozen at k = 10 on BM25 scores).  Where
//      more than SHORT lie there but fewer than need above the bound, or
//      the bound is the tile's least value and fewer than need keys lie
//      above that (a row of zeros, a rare term's scores), the bound is
//      one value shared by many: the keys above it and its first ties
//      by index (a warp scan over the tile in index order) are the
//      tile's k.  Otherwise (k above 32, or keys crowded in few threads)
//      a radix select over the shared tile (11 + 11 + 10 bits, as below)
//      narrows the bound.  The candidates' 64-bit keys are ranked
//      against each other in shared memory and the k largest written in
//      order: to the row's values and indices when the row is one tile
//      (the candidate axis, Kc <= SEL_TILE: one launch), else to a
//      [Q, tiles, k] scratch, padded with 0 (below every key) where a
//      tile holds fewer than k elements.  The union of the tiles' k
//      largest keys holds the row's k largest, so ties need no pass of
//      their own.  64 KB of keys and 8 KB of histogram or candidates a
//      block: three blocks an SM, so one block's select overlaps
//      another's loads.  (A 1-D bulk copy of the tile (TMA) in place of
//      the register loads was no faster; a first design that built the
//      first digit's histogram during the loads was slower: contended
//      shared atomics, and more passes over the tile.)
//   2. topk_merge_kernel, a block per row.  Each tile's k-th key bounds
//      the row's k-th from below, so the keys at or above the largest of
//      them (k at least) are ranked against each other; where more than
//      MERGE_CAND are, the row's tiles * k keys are sorted in shared
//      memory (bitonic, MERGE_KEYS at a time, the best k kept between
//      rounds).  The first k are written as values and indices.
//
// The fused ranking pass (sa_rank_rows, k <= ONE_PASS_CAP): the same two
// kernels over rows whose scores are never stored.  On the batch driver's
// ranked groups it replaces K10 (similarity.cu) writing a [rows, n] score
// block, after a gather of the tf pool's rows into it, that pass 1 then
// reads again: rank_tile_kernel reads each element's tf from its source
// row (a tf pool row by its slot, or a row of a group's K5 / K6 freqs)
// and the doc's length, and scores it with similarity.cuh's sim::score,
// the function K10 runs, before it maps the score to its value key;
// rank_merge_kernel scores the k winners the same way.  So the answers
// and their tie order are K10's then K3's, bit for bit.  Bound: bytes, 4
// of tf an element read once, and the doc lengths, which every row reads:
// the blocks run tile-major (the blocks of one tile across the rows side
// by side), so a tile's lengths come from HBM once and from L2 for the
// other rows, and tf comes in by streaming loads that do not push them
// out.  The similarity's IEEE divisions (two an element in the BM25
// forms) are the price of not storing the scores, and they bound the pass
// where every element pays them: a ranked row is mostly docs without its
// term, so where a tf of 0 scores alike in every doc (flat_zero_tf: the
// BM25 forms at the usual k1 and b) its key is computed once a row and a
// zero costs a compare (on an H100, a 99-row wave of 2M docs: 0.82 ->
// 0.51 ms).
// The kind is a template argument, so no element branches on it.
//
// Larger k (sa_topk), up to N: nine kernels, the row read two to four
// times.
//
//   1. up to three histogram passes over the value key, 11 + 11 + 10 bits
//      from the top (topk_hist_kernel, one block per 16384-element tile
//      of a row, a shared-memory histogram added into the row's global
//      one), each followed by topk_select_kernel (one block per row),
//      which finds the digit that holds the k-th key.  A row is done as
//      soon as the keys at or above the digit's lower bound number at
//      most `cap` (k itself above SORT_CAP, SORT_CAP below): later passes
//      return at once for it.
//   2. A row whose k-th VALUE is shared by more elements than may be kept
//      is a tie row: topk_tiescan_kernel walks it from index 0 and stops
//      at the index of the last tie to keep.
//   3. topk_filter_kernel reads the row once more and writes every key
//      at or above the threshold (between k and cap of them) to the row's
//      candidates, in no order.
//   4. topk_sort_kernel (k <= SORT_CAP) sorts a row's candidates in shared
//      memory (bitonic, 64-bit keys) and writes the first k as values and
//      indices.  Above SORT_CAP the filter leaves exactly k keys a row;
//      the caller orders those [Q, k] keys and topk_unpack_kernel turns
//      them into values and indices.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "device_guard.cuh"
#include "similarity.cuh"

namespace {

constexpr int BINS = 2048;         // 11-bit digits
constexpr int THREADS = 256;
constexpr int TILE = THREADS * 64; // elements of a row per block
constexpr int SORT_CAP = 2048;     // keys the sort kernel takes per row
constexpr int SORT_THREADS = 1024;
constexpr int SCAN_THREADS = 1024;
constexpr int LEVELS = 3;
constexpr unsigned FULL = 0xffffffffu;

// the two-launch path (k <= ONE_PASS_CAP)
constexpr int SEL_THREADS = 256;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_TILE = 16384;      // elements of a row per block
constexpr int SEL_LOAD = 4;          // loads in flight a thread
constexpr int SHORT = SEL_THREADS;   // candidates ranked against each other
constexpr int ONE_PASS_CAP = 64;     // k of this path
constexpr int SEL_SMEM = (SEL_TILE + BINS) * 4;  // keys, then histogram
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_KEYS = 4096;     // keys a merge round sorts (32 KB)
constexpr int MERGE_CAND = 512;      // keys pass 2 ranks against each other
static_assert(SHORT * 8 <= BINS * 4, "the candidates reuse the histogram");
static_assert(ONE_PASS_CAP <= SHORT && 2 * ONE_PASS_CAP <= MERGE_KEYS,
              "k fits the candidates and a merge round");

__device__ __constant__ int SHIFT[LEVELS] = {21, 10, 0};
__device__ __constant__ int BITS[LEVELS] = {11, 11, 10};

struct RowState {
  uint32_t prefix;  // the value key's digits fixed so far, low bits zero
  uint32_t above;   // keys above the prefix's range (all of them kept)
  uint32_t done;    // the threshold is final
  uint32_t tie;     // keep keys above prefix and the first `need` equal
  uint32_t need;    // ties to keep
  uint32_t istar;   // index of the last tie to keep
  uint32_t count;   // the filter's cursor
  uint32_t m;       // keys the filter writes
};

// Order-preserving u32 of a float's bits; -0.0 as +0.0.
__device__ __forceinline__ uint32_t value_key(uint32_t b) {
  if (b == 0x80000000u) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Sorts s[0, P) descending, P a power of two; every thread of a block of
// NT threads calls it.
template <int NT>
__device__ __forceinline__ void bitonic_desc(uint64_t* s, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < P / 2; t += NT) {
        const int a = 2 * t - (t & (stride - 1)), b = a + stride;
        const uint64_t u = s[a], v = s[b];
        if ((u < v) == ((a & size) == 0)) {
          s[a] = v;
          s[b] = u;
        }
      }
    }
  }
  __syncthreads();
}

// f(index in the row, float bits) over the block's tile of its row.
template <typename F>
__device__ __forceinline__ void for_tile(const float* __restrict__ row,
                                         int64_t n, int tile, bool vec, F f) {
  const int64_t lo = static_cast<int64_t>(tile) * TILE;
  const int64_t hi = lo + TILE < n ? lo + TILE : n;
  if (vec) {  // 16-byte aligned rows, n a multiple of 4
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int64_t i = lo / 4 + threadIdx.x; i < hi / 4; i += THREADS) {
      const uint4 v = __ldg(r4 + i);
      f(4 * i, v.x);
      f(4 * i + 1, v.y);
      f(4 * i + 2, v.z);
      f(4 * i + 3, v.w);
    }
  } else {
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x; i < hi; i += THREADS) {
      f(i, __float_as_uint(__ldg(row + i)));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
topk_hist_kernel(const float* __restrict__ x, int64_t n, int tiles, int level,
                 bool vec, const RowState* __restrict__ state,
                 uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[BINS];
  const int64_t row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  if (state[row].done) return;
  for (int i = threadIdx.x; i < BINS; i += THREADS) sh[i] = 0;
  __syncthreads();
  const int shift = SHIFT[level];
  const uint32_t mask = (1u << BITS[level]) - 1;
  const int up = shift + BITS[level];  // 32 at level 0: every key counts
  const uint32_t want = level ? state[row].prefix >> up : 0;
  // a thread adds a run of equal digits at once: a row of zeros costs it
  // one shared atomic, not one per element
  uint32_t last = 0, run = 0;
  for_tile(x + row * n, n, tile, vec, [&](int64_t, uint32_t b) {
    const uint32_t key = value_key(b);
    if (level && (key >> up) != want) return;
    const uint32_t d = (key >> shift) & mask;
    if (d == last) {
      ++run;
    } else {
      if (run) atomicAdd(&sh[last], run);
      last = d;
      run = 1;
    }
  });
  if (run) atomicAdd(&sh[last], run);
  __syncthreads();
  uint32_t* g = hist + row * BINS;
  for (int i = threadIdx.x; i < BINS; i += THREADS) {
    const uint32_t c = sh[i];
    if (c) atomicAdd(g + i, c);
  }
}

// One block per row: the digit of this level that holds the k-th key.
__global__ void __launch_bounds__(THREADS)
topk_select_kernel(uint32_t* __restrict__ hist, RowState* __restrict__ state,
                   int level, uint32_t k, uint32_t cap) {
  constexpr int PER = BINS / THREADS;
  __shared__ uint32_t sums[THREADS];
  RowState* st = state + blockIdx.x;
  const uint32_t done = st->done, above = st->above, prefix = st->prefix;
  if (done) return;
  uint32_t* g = hist + static_cast<int64_t>(blockIdx.x) * BINS;
  const int t = threadIdx.x;
  uint32_t c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = g[t * PER + j];
    g[t * PER + j] = 0;  // for the next level
    sum += c[j];
  }
  // inclusive suffix sums over the threads: keys in this and higher bins
  sums[t] = sum;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const uint32_t v = t + off < THREADS ? sums[t + off] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  const uint32_t incl = sums[t], excl = incl - sum;
  const uint32_t need = k - above;  // keys still to find in the prefix
  if (excl < need && need <= incl) {
    uint32_t acc = excl;
    int j = PER - 1;
    while (acc + c[j] < need) acc += c[j--];
    const uint32_t digit = t * PER + j;
    const uint32_t at_or_above = above + acc + c[j];
    st->prefix = prefix | (digit << SHIFT[level]);
    if (at_or_above <= cap) {
      st->done = 1;
      st->m = at_or_above;
    } else if (level == LEVELS - 1) {
      st->done = 1;
      st->tie = 1;
      st->need = need - acc;
      st->m = k;
    } else {
      st->above = above + acc;
    }
  }
}

// One block per tie row: the index of the `need`-th element whose value
// key equals the threshold, walking from index 0.
__global__ void __launch_bounds__(SCAN_THREADS)
topk_tiescan_kernel(const float* __restrict__ x, int64_t n,
                    RowState* __restrict__ state) {
  __shared__ uint32_t wsum[SCAN_THREADS / 32];
  RowState* st = state + blockIdx.x;
  if (!st->tie) return;
  const uint32_t thr = st->prefix, need = st->need;
  const float* row = x + static_cast<int64_t>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t seen = 0;
  for (int64_t base = 0; base < n && seen < need; base += SCAN_THREADS) {
    const int64_t i = base + threadIdx.x;
    const bool f = i < n && value_key(__float_as_uint(row[i])) == thr;
    const unsigned b = __ballot_sync(FULL, f);
    if (lane == 0) wsum[warp] = __popc(b);
    __syncthreads();
    uint32_t before = seen, total = 0;
    for (int w = 0; w < SCAN_THREADS / 32; ++w) {
      if (w < warp) before += wsum[w];
      total += wsum[w];
    }
    const uint32_t rank = before + __popc(b & ((1u << lane) - 1));
    if (f && rank + 1 == need) st->istar = static_cast<uint32_t>(i);
    seen += total;
    __syncthreads();
  }
}

// The next free candidate slot of a row, one atomic per warp's takers.
__device__ __forceinline__ uint32_t take_slot(uint32_t* counter) {
  const unsigned m = __activemask();
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(m, base, leader);
  return base + __popc(m & ((1u << lane) - 1));
}

__global__ void __launch_bounds__(THREADS)
topk_filter_kernel(const float* __restrict__ x, int64_t n, int tiles,
                   bool vec, RowState* __restrict__ state,
                   uint64_t* __restrict__ cand, int64_t cap) {
  const int64_t row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  RowState* st = state + row;
  const uint32_t thr = st->prefix, tie = st->tie, istar = st->istar;
  uint64_t* dst = cand + row * cap;
  for_tile(x + row * n, n, tile, vec, [&](int64_t i, uint32_t b) {
    const uint32_t key = value_key(b);
    const bool take = tie ? key > thr || (key == thr && i <= istar)
                          : key >= thr;
    if (take) {
      const uint32_t at = take_slot(&st->count);
      if (at < cap) {
        dst[at] = static_cast<uint64_t>(key) << 32 |
                  (0xffffffffu - static_cast<uint32_t>(i));
      }
    }
  });
}

// One block per row: its m <= SORT_CAP candidates sorted descending in
// shared memory, the first k written as values and indices.
__global__ void __launch_bounds__(SORT_THREADS)
topk_sort_kernel(const float* __restrict__ x, int64_t n,
                 const RowState* __restrict__ state,
                 const uint64_t* __restrict__ cand, int64_t cap, int64_t k,
                 float* __restrict__ vals, int32_t* __restrict__ idx) {
  __shared__ uint64_t s[SORT_CAP];
  const int64_t row = blockIdx.x;
  const int m = static_cast<int>(state[row].m);
  int P = 2;
  while (P < m) P <<= 1;
  for (int i = threadIdx.x; i < P; i += SORT_THREADS) {
    s[i] = i < m ? cand[row * cap + i] : 0;  // 0 is below every key
  }
  bitonic_desc<SORT_THREADS>(s, P);
  for (int i = threadIdx.x; i < k; i += SORT_THREADS) {
    const uint32_t id = 0xffffffffu - static_cast<uint32_t>(s[i]);
    idx[row * k + i] = static_cast<int32_t>(id);
    vals[row * k + i] = x[row * n + id];
  }
}

// Ordered keys (only their low half is read) -> values and indices.
__global__ void __launch_bounds__(THREADS)
topk_unpack_kernel(const float* __restrict__ x, int64_t n,
                   const uint64_t* __restrict__ keys, int64_t k,
                   int64_t total, float* __restrict__ vals,
                   int32_t* __restrict__ idx) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    const uint32_t id = 0xffffffffu - static_cast<uint32_t>(keys[i]);
    idx[i] = static_cast<int32_t>(id);
    vals[i] = x[(i / k) * n + id];
  }
}

// ---- the two-launch path ---------------------------------------------------

// f(index in the tile, value key) over the block's keys in shared memory,
// 16 bytes a read.
template <typename F>
__device__ __forceinline__ void for_keys(const uint32_t* keys, int len, F f) {
  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  for (int i = threadIdx.x; i < (len >> 2); i += SEL_THREADS) {
    const uint4 q = k4[i];
    f(4 * i, q.x);
    f(4 * i + 1, q.y);
    f(4 * i + 2, q.z);
    f(4 * i + 3, q.w);
  }
  for (int i = (len & ~3) + threadIdx.x; i < len; i += SEL_THREADS) {
    f(i, keys[i]);
  }
}

// The sum of one value from every thread of the block; ``w`` holds
// SEL_WARPS words that no thread reads again before the block's next
// barrier.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* w) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) w[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t total = 0;
#pragma unroll
  for (int i = 0; i < SEL_WARPS; ++i) total += w[i];
  return total;
}

// The 32 values of a warp's lanes sorted descending across the lanes
// (bitonic, by shuffles): lane j gets the (j + 1)-th largest.
__device__ __forceinline__ uint32_t warp_sort_desc(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t o = __shfl_xor_sync(FULL, v, stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      v = keep_max ? max(v, o) : min(v, o);
    }
  }
  return v;
}

// A slot in ``cand`` for each calling lane, one shared atomic per warp's
// callers; ``taken`` counts every call, slots past ``cap`` are dropped.
__device__ __forceinline__ void push_key(uint64_t* cand, uint32_t* taken,
                                         uint32_t cap, uint64_t key) {
  const unsigned m = __activemask();
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(taken, __popc(m));
  base = __shfl_sync(m, base, leader);
  const uint32_t at = base + __popc(m & ((1u << lane) - 1));
  if (at < cap) cand[at] = key;
}

// Over a histogram of BINS digits: the digit that holds the need-th key
// from the top (need between 1 and the histogram's total), the keys in
// higher digits and the keys in it.  Every thread of the block calls it;
// ``hist`` is not read after its first barrier.
__device__ __forceinline__ void find_digit(const uint32_t* hist, uint32_t need,
                                           uint32_t* wtot, uint32_t* ctl,
                                           uint32_t& digit, uint32_t& higher,
                                           uint32_t& in) {
  constexpr int PER = BINS / SEL_THREADS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = hist[t * PER + j];
    sum += c[j];
  }
  // inclusive suffix sums: the keys in this thread's digits and above
  uint32_t incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += v;
  }
  if (lane == 0) wtot[warp] = incl;
  __syncthreads();
  for (int w = warp + 1; w < SEL_WARPS; ++w) incl += wtot[w];
  const uint32_t excl = incl - sum;
  if (excl < need && need <= incl) {
    uint32_t acc = excl;
    bool found = false;
#pragma unroll
    for (int j = PER - 1; j >= 0; --j) {
      if (!found) {
        if (acc + c[j] >= need) {
          found = true;
          ctl[0] = t * PER + j;
          ctl[1] = acc;
          ctl[2] = c[j];
        } else {
          acc += c[j];
        }
      }
    }
  }
  __syncthreads();
  digit = ctl[0];
  higher = ctl[1];
  in = ctl[2];
}

// ---- the rows the two-launch path reads ------------------------------------
//
// A row view: one row's elements loaded 16 bytes at a time (load4, the
// j-th 16 bytes of a 16-byte aligned row) or one at a time (load1), their
// value keys (keys4, key1), and the value of the element at an index
// (value), which the kernels write out with its index.

// A row of f32 [n_rows, n]: K3.
struct PlainRow {
  const float* x;
  using Raw4 = uint4;
  using Raw1 = uint32_t;
  __device__ __forceinline__ Raw4 load4(int64_t j) const {
    return __ldg(reinterpret_cast<const uint4*>(x) + j);
  }
  __device__ __forceinline__ Raw1 load1(int64_t i) const {
    return __float_as_uint(__ldg(x + i));
  }
  __device__ __forceinline__ uint4 keys4(const Raw4& v) const {
    return make_uint4(value_key(v.x), value_key(v.y), value_key(v.z),
                      value_key(v.w));
  }
  __device__ __forceinline__ uint32_t key1(Raw1 v) const {
    return value_key(v);
  }
  __device__ __forceinline__ float value(int64_t i) const { return x[i]; }
};

// What the rows of one fused ranking launch share.
struct RankArgs {
  const float* src;       // f32 rows of n, row stride ``stride``
  int64_t stride;
  const int64_t* slots;   // the source row of each ranked row, or null
  const float* doc_lens;  // f32 [n]
  const float* idfs;      // f32, one a ranked row
  sim::Params p;
  // a tf of +0 scores alike in every doc of a row, so the row's key of it
  // is computed once (flat_zero_tf)
  bool flat;
};

// Whether a tf of +0 scores the same in every doc of a row, whatever its
// length (a count, >= 0): in the BM25 forms where k1 > 0 and 0 < b < 1,
// the length norm fma(b, dl / avgdl, 1 - b) is at least 1 - b (+inf where
// the quotient overflows), so the denominator k1 * norm + 0 is positive
// (at least FLT_MIN by the last condition), 0 / it is +0, and the score
// is +0 times the idf (bm25, bm25_legacy) or +0 (bm25_impact).  Classic
// divides by the length's root, which may be 0; b = 0 times an overflowed
// quotient is NaN.
inline bool flat_zero_tf(int kind, const sim::Params& p) {
  return kind != sim::CLASSIC && p.k1 > 0.0f && p.k1 <= FLT_MAX &&
         p.b > 0.0f && p.b < 1.0f && p.avgdl > 0.0f && p.avgdl <= FLT_MAX &&
         static_cast<double>(p.k1) * p.one_minus_b >= FLT_MIN;
}

// A ranked row of the fused pass: its scores, sim::score of kind KIND,
// computed from its source row's tf and the doc lengths as they load.
template <int KIND>
struct ScoredRow {
  const float* tf;
  const float* dl;
  float idf;
  sim::Params p;
  bool flat;      // the row's tf of +0 keys as ``zero`` in every doc
  uint32_t zero;
  struct Raw4 {
    float4 tf, dl;
  };
  struct Raw1 {
    float tf, dl;
  };
  __device__ __forceinline__ static ScoredRow of(const RankArgs& a,
                                                 int64_t row) {
    const int64_t at = a.slots ? a.slots[row] : row;
    const float idf = a.idfs[row];
    return ScoredRow{a.src + at * a.stride, a.doc_lens, idf, a.p, a.flat,
                     value_key(__float_as_uint(
                         sim::score<KIND>(a.p, 0.0f, 1.0f, idf)))};
  }
  __device__ __forceinline__ float score(float t, float d) const {
    return sim::score<KIND>(p, t, d, idf);
  }
  // most of a ranked row's docs lack its term: their key is the row's
  // zero, and they cost no division
  __device__ __forceinline__ uint32_t key(float t, float d) const {
    if (flat && __float_as_uint(t) == 0u) return zero;
    return value_key(__float_as_uint(score(t, d)));
  }
  // tf streams past (read once); the lengths stay in L2 for the next row
  __device__ __forceinline__ Raw4 load4(int64_t j) const {
    return Raw4{__ldcs(reinterpret_cast<const float4*>(tf) + j),
                __ldg(reinterpret_cast<const float4*>(dl) + j)};
  }
  __device__ __forceinline__ Raw1 load1(int64_t i) const {
    return Raw1{__ldcs(tf + i), __ldg(dl + i)};
  }
  __device__ __forceinline__ uint4 keys4(const Raw4& v) const {
    return make_uint4(key(v.tf.x, v.dl.x), key(v.tf.y, v.dl.y),
                      key(v.tf.z, v.dl.z), key(v.tf.w, v.dl.w));
  }
  __device__ __forceinline__ uint32_t key1(const Raw1& v) const {
    return key(v.tf, v.dl);
  }
  __device__ __forceinline__ float value(int64_t i) const {
    return score(tf[i], dl[i]);
  }
};

// Pass 1: block b selects the k largest keys of tile b % tiles of row
// b / tiles (fewer where the tile is shorter than k) and writes them in
// order: to the row's values and indices when the row is one tile, else
// to part[row][tile][0, k), padded with 0.  The body of a pass-1 block
// over row ``row`` (a row view ``src``) and its tile ``tile``.
template <class Row>
__device__ __forceinline__ void tile_select(
    const Row& src, int64_t row, int tile, int64_t n, int tiles, int k,
    bool vec, uint64_t* __restrict__ part, float* __restrict__ vals,
    int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* keys = smem;             // the tile's value keys
  uint32_t* hist = smem + SEL_TILE;  // BINS digit counts, or
  uint64_t* cand = reinterpret_cast<uint64_t*>(hist);  // the candidates
  __shared__ uint32_t wtot[SEL_WARPS], wsum[SEL_WARPS], wcnt[SEL_WARPS];
  __shared__ uint32_t ctl[3], taken;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t lo = static_cast<int64_t>(tile) * SEL_TILE;
  const int len = static_cast<int>(n - lo < SEL_TILE ? n - lo : SEL_TILE);
  const uint32_t need = static_cast<uint32_t>(len < k ? len : k);
  const uint32_t id0 = 0xffffffffu - static_cast<uint32_t>(lo);
  auto key64 = [&](int i, uint32_t key) {
    return static_cast<uint64_t>(key) << 32 | (id0 - i);
  };
  if (t == 0) taken = 0;

  // The tile into shared memory as value keys, SEL_LOAD loads in flight a
  // thread; each thread's largest key and the tile's least on the way.
  uint32_t most = 0, least = 0xffffffffu;
  if (vec) {  // 16-byte aligned rows, n a multiple of 4
    const int64_t j0 = lo >> 2;
    uint4* k4 = reinterpret_cast<uint4*>(keys);
    const int n4 = len >> 2;
    for (int base = 0; base < n4; base += SEL_LOAD * SEL_THREADS) {
      typename Row::Raw4 v[SEL_LOAD];
#pragma unroll
      for (int u = 0; u < SEL_LOAD; ++u) {
        const int i = base + u * SEL_THREADS + t;
        if (i < n4) v[u] = src.load4(j0 + i);
      }
#pragma unroll
      for (int u = 0; u < SEL_LOAD; ++u) {
        const int i = base + u * SEL_THREADS + t;
        if (i < n4) {
          const uint4 q = src.keys4(v[u]);
          k4[i] = q;
          most = max(most, max(max(q.x, q.y), max(q.z, q.w)));
          least = min(least, min(min(q.x, q.y), min(q.z, q.w)));
        }
      }
    }
  } else {
    for (int base = 0; base < len; base += SEL_LOAD * SEL_THREADS) {
      typename Row::Raw1 v[SEL_LOAD];
#pragma unroll
      for (int u = 0; u < SEL_LOAD; ++u) {
        const int i = base + u * SEL_THREADS + t;
        if (i < len) v[u] = src.load1(lo + i);
      }
#pragma unroll
      for (int u = 0; u < SEL_LOAD; ++u) {
        const int i = base + u * SEL_THREADS + t;
        if (i < len) {
          const uint32_t key = src.key1(v[u]);
          keys[i] = key;
          most = max(most, key);
          least = min(least, key);
        }
      }
    }
  }
  // A first bound: in each warp, the need-th largest of its threads'
  // largest keys (0, below every key, where fewer threads hold one) has
  // need keys at or above it, so the largest of those bounds the tile's
  // need-th key from below.
  uint32_t low = 0;
  if (need <= 32) low = __shfl_sync(FULL, warp_sort_desc(most), need - 1);
  least = __reduce_min_sync(FULL, least);
  if (lane == 0) {
    wtot[warp] = low;
    wsum[warp] = least;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < SEL_WARPS; ++w) {
    low = max(low, wtot[w]);
    least = min(least, wsum[w]);
  }

  // The candidates: every key >= bound (m of them, at most SHORT), or,
  // with tie, the keys > bound (above of them) and the first need - above
  // keys equal to it by index.
  uint32_t above = 0, bound = 0, m = 0;
  bool tie = false, gathered = false;
  if (low != 0 && low != least) {
    // the keys >= low, kept while they fit; those > low counted too
    uint32_t ge = 0, gt = 0;
    for_keys(keys, len, [&](int i, uint32_t key) {
      if (key >= low) {
        ++ge;
        gt += key != low;
        push_key(cand, &taken, SHORT, key64(i, key));
      }
    });
    const uint32_t sums = block_sum(ge << 16 | gt, wcnt);  // each <= 2^14
    ge = sums >> 16;
    gt = sums & 0xffffu;
    if (ge <= SHORT) {
      bound = low;
      m = ge;
      gathered = true;
    } else if (gt < need) {
      bound = low;
      above = gt;
      tie = true;
    }
  } else if (low != 0) {  // the least value may hold the need-th place
    const uint32_t over = block_sum(
        [&] {
          uint32_t c = 0;
          for_keys(keys, len, [&](int, uint32_t key) { c += key != least; });
          return c;
        }(),
        wcnt);
    if (over < need) {
      bound = least;
      above = over;
      tie = true;
    }
  }

  if (!gathered && !tie) {
    // The radix select over the shared tile, 11 + 11 + 10 bits, until at
    // most SHORT keys lie at or above the digit's lower bound or one value
    // holds more.  A thread adds a run of equal digits at once.
    uint32_t prefix = 0;  // the value-key digits fixed so far
    for (int level = 0;; ++level) {
      const int shift = SHIFT[level], up = shift + BITS[level];
      const uint32_t want = level ? prefix >> up : 0;
      const uint32_t mask = (1u << BITS[level]) - 1;
      for (int i = t; i < BINS; i += SEL_THREADS) hist[i] = 0;
      __syncthreads();
      uint32_t last = 0, run = 0;
      for_keys(keys, len, [&](int, uint32_t key) {
        if (level && (key >> up) != want) return;
        const uint32_t d = (key >> shift) & mask;
        if (d == last) {
          ++run;
        } else {
          if (run) atomicAdd(&hist[last], run);
          last = d;
          run = 1;
        }
      });
      if (run) atomicAdd(&hist[last], run);
      __syncthreads();
      uint32_t digit, higher, in;
      find_digit(hist, need - above, wtot, ctl, digit, higher, in);
      const uint32_t lower = prefix | (digit << shift);
      if (above + higher + in <= SHORT) {
        bound = lower;
        m = above + higher + in;
        break;
      }
      above += higher;
      if (shift == 0) {  // one value holds more keys than may be taken
        bound = lower;
        tie = true;
        break;
      }
      prefix = lower;
    }
  }

  // The candidates as 64-bit keys, in no order, unless the first bound
  // gathered them (the histogram is read no more: every thread is past
  // find_digit's barriers, or block_sum's)
  if (!gathered) {
    if (t == 0) taken = 0;
    __syncthreads();
    if (!tie) {
      for_keys(keys, len, [&](int i, uint32_t key) {
        if (key >= bound) push_key(cand, &taken, SHORT, key64(i, key));
      });
    } else {
      for_keys(keys, len, [&](int i, uint32_t key) {
        if (key > bound) push_key(cand, &taken, SHORT, key64(i, key));
      });
      // the first need - above ties by index: each warp counts them in
      // its run of the tile, then walks its run until the quota is met
      constexpr int SEG = SEL_TILE / SEL_WARPS;
      const uint32_t quota = need - above;
      const int s0 = warp * SEG, s1 = s0 + SEG < len ? s0 + SEG : len;
      uint32_t mine = 0;
      for (int i = s0 + lane; i < s1; i += 32) mine += keys[i] == bound;
      mine = __reduce_add_sync(FULL, mine);
      if (lane == 0) wtot[warp] = mine;
      __syncthreads();
      uint32_t seen = 0;
      for (int w = 0; w < warp; ++w) seen += wtot[w];
      for (int b = s0; b < s1 && seen < quota; b += 32) {
        const int i = b + lane;
        const bool f = i < s1 && keys[i] == bound;
        const unsigned bal = __ballot_sync(FULL, f);
        if (f && seen + __popc(bal & ((1u << lane) - 1)) < quota) {
          push_key(cand, &taken, SHORT, key64(i, bound));
        }
        seen += __popc(bal);
      }
      m = need;
    }
  }
  __syncthreads();

  // Each candidate's rank among them; the first need written in order
  if (t < static_cast<int>(m)) {
    const uint64_t c = cand[t];
    uint32_t r = 0;
#pragma unroll 8
    for (uint32_t j = 0; j < m; ++j) r += cand[j] > c;
    if (r < need) {
      if (tiles == 1) {
        const uint32_t id = 0xffffffffu - static_cast<uint32_t>(c);
        idx[row * k + r] = static_cast<int32_t>(id);
        vals[row * k + r] = src.value(id);
      } else {
        part[(row * tiles + tile) * k + r] = c;
      }
    }
  }
  if (tiles > 1) {
    for (int r = static_cast<int>(need) + t; r < k; r += SEL_THREADS) {
      part[(row * tiles + tile) * k + r] = 0;  // below every key
    }
  }
}

// Pass 1 of K3: block b, tile b % tiles of row b / tiles.
__global__ void __launch_bounds__(SEL_THREADS, 3)
topk_tile_kernel(const float* __restrict__ x, int64_t n, int tiles, int k,
                 bool vec, uint64_t* __restrict__ part,
                 float* __restrict__ vals, int32_t* __restrict__ idx) {
  const int64_t row = blockIdx.x / tiles;
  tile_select(PlainRow{x + row * n}, row, blockIdx.x % tiles, n, tiles, k,
              vec, part, vals, idx);
}

// Pass 1 of the fused pass, tile-major: block b, tile b / rows of row
// b % rows, so the blocks of one tile (and its doc lengths) run together.
template <int KIND>
__global__ void __launch_bounds__(SEL_THREADS, 3)
rank_tile_kernel(const RankArgs a, int64_t rows, int64_t n, int tiles, int k,
                 bool vec, uint64_t* __restrict__ part,
                 float* __restrict__ vals, int32_t* __restrict__ idx) {
  const int64_t row = blockIdx.x % rows;
  tile_select(ScoredRow<KIND>::of(a, row), row,
              static_cast<int>(blockIdx.x / rows), n, tiles, k, vec, part,
              vals, idx);
}

// Pass 2, one block per row: the k largest of the row's m = tiles * k
// keys.  Each tile's k-th key bounds the row's k-th from below, so the
// keys at or above the largest of them (k at least, a few more where
// tiles are close) are ranked against each other; where more than
// MERGE_CAND are, or the keys do not fit in shared memory, they are
// sorted (bitonic, MERGE_KEYS at a time, the best k kept between rounds).
// The body of a pass-2 block over row ``row`` (a row view ``src``).
template <class Row>
__device__ __forceinline__ void merge_tiles(
    const Row& src, int64_t row, const uint64_t* __restrict__ part,
    int64_t m, int k, float* __restrict__ vals, int32_t* __restrict__ idx) {
  __shared__ uint64_t s[MERGE_KEYS];
  __shared__ uint64_t cand[MERGE_CAND];
  __shared__ uint64_t wmax[MERGE_THREADS / 32];
  __shared__ uint32_t taken;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint64_t* keys = part + row * m;
  if (m <= MERGE_KEYS) {
    if (t == 0) taken = 0;
    uint64_t low = 0;
    for (int i = t; i < m; i += MERGE_THREADS) {
      const uint64_t key = keys[i];
      s[i] = key;
      if (i % k == k - 1 && key > low) low = key;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const uint64_t o = __shfl_xor_sync(FULL, low, off);
      low = o > low ? o : low;
    }
    if (lane == 0) wmax[warp] = low;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < MERGE_THREADS / 32; ++w) {
      low = wmax[w] > low ? wmax[w] : low;
    }
    for (int i = t; i < m; i += MERGE_THREADS) {
      if (s[i] >= low) push_key(cand, &taken, MERGE_CAND, s[i]);
    }
    __syncthreads();
    const uint32_t c = taken;
    if (c <= MERGE_CAND) {
      for (uint32_t i = t; i < c; i += MERGE_THREADS) {
        const uint64_t key = cand[i];
        uint32_t r = 0;
#pragma unroll 8
        for (uint32_t j = 0; j < c; ++j) r += cand[j] > key;
        if (r < static_cast<uint32_t>(k)) {
          const uint32_t id = 0xffffffffu - static_cast<uint32_t>(key);
          idx[row * k + r] = static_cast<int32_t>(id);
          vals[row * k + r] = src.value(id);
        }
      }
      return;
    }
  }
  int kept = 0;
  for (int64_t base = 0; base < m;) {
    const int take = static_cast<int>(
        m - base < MERGE_KEYS - kept ? m - base : MERGE_KEYS - kept);
    int P = 2;
    while (P < kept + take) P <<= 1;
    __syncthreads();
    for (int i = kept + t; i < P; i += MERGE_THREADS) {
      s[i] = i - kept < take ? keys[base + i - kept] : 0;
    }
    bitonic_desc<MERGE_THREADS>(s, P);
    kept = k;
    base += take;
  }
  for (int i = t; i < k; i += MERGE_THREADS) {
    const uint32_t id = 0xffffffffu - static_cast<uint32_t>(s[i]);
    idx[row * k + i] = static_cast<int32_t>(id);
    vals[row * k + i] = src.value(id);
  }
}

// Pass 2 of K3.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ x, int64_t n,
                  const uint64_t* __restrict__ part, int64_t m, int k,
                  float* __restrict__ vals, int32_t* __restrict__ idx) {
  merge_tiles(PlainRow{x + blockIdx.x * n}, blockIdx.x, part, m, k, vals,
              idx);
}

// Pass 2 of the fused pass.
template <int KIND>
__global__ void __launch_bounds__(MERGE_THREADS)
rank_merge_kernel(const RankArgs a, const uint64_t* __restrict__ part,
                  int64_t m, int k, float* __restrict__ vals,
                  int32_t* __restrict__ idx) {
  merge_tiles(ScoredRow<KIND>::of(a, blockIdx.x), blockIdx.x, part, m, k,
              vals, idx);
}

}  // namespace

// The keys the in-kernel sort takes per row: the wrapper orders the
// survivors itself above it.
extern "C" int sa_topk_sort_cap() { return SORT_CAP; }

// Bytes of scratch per row: its histogram and its state.
extern "C" int sa_topk_row_scratch_bytes() {
  return BINS * 4 + static_cast<int>(sizeof(RowState));
}

// Plain C entry for ctypes.  ``x`` is f32 [n_rows, n], rows contiguous;
// ``scratch`` holds n_rows * sa_topk_row_scratch_bytes() bytes; ``cand``
// is u64 [n_rows, cap] with cap = max(k, SORT_CAP).  With k <= SORT_CAP
// the values f32 [n_rows, k] and indices i32 [n_rows, k] are written;
// above it ``cand`` is left holding each row's k keys in no order, for
// sa_topk_unpack after the caller has ordered them.  Everything runs on
// ``stream``; nothing here synchronises.  Returns cudaGetLastError().
extern "C" int sa_topk(const void* x, int64_t n_rows, int64_t n, int64_t k,
                       void* scratch, void* cand, int64_t cap, void* vals,
                       void* idx, int device, void* stream) {
  if (k < 1 || k > n || cap < k || (k <= SORT_CAP && cap != SORT_CAP) ||
      (k > SORT_CAP && cap != k)) {
    return cudaErrorInvalidValue;
  }
  const DeviceGuard guard(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  uint32_t* hist = static_cast<uint32_t*>(scratch);
  RowState* state = reinterpret_cast<RowState*>(hist + n_rows * BINS);
  uint64_t* cd = static_cast<uint64_t*>(cand);
  cudaMemsetAsync(scratch, 0,
                  n_rows * (BINS * 4 + sizeof(RowState)), st);
  const int tiles = static_cast<int>((n + TILE - 1) / TILE);
  const unsigned blocks = static_cast<unsigned>(n_rows * tiles);
  const unsigned rows = static_cast<unsigned>(n_rows);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int level = 0; level < LEVELS; ++level) {
    topk_hist_kernel<<<blocks, THREADS, 0, st>>>(xf, n, tiles, level, vec,
                                                 state, hist);
    topk_select_kernel<<<rows, THREADS, 0, st>>>(
        hist, state, level, static_cast<uint32_t>(k),
        static_cast<uint32_t>(cap));
  }
  topk_tiescan_kernel<<<rows, SCAN_THREADS, 0, st>>>(xf, n, state);
  topk_filter_kernel<<<blocks, THREADS, 0, st>>>(xf, n, tiles, vec, state, cd,
                                                 cap);
  if (k <= SORT_CAP) {
    topk_sort_kernel<<<rows, SORT_THREADS, 0, st>>>(
        xf, n, state, cd, cap, k, static_cast<float*>(vals),
        static_cast<int32_t*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}

// Ordered keys u64 [n_rows, k] -> values f32 and indices i32 [n_rows, k].
extern "C" int sa_topk_unpack(const void* x, int64_t n_rows, int64_t n,
                              const void* keys, int64_t k, void* vals,
                              void* idx, int device, void* stream) {
  const DeviceGuard guard(device);
  const int64_t total = n_rows * k;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;
  topk_unpack_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const uint64_t*>(keys), k,
      total, static_cast<float*>(vals), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

// Elements of a row per pass-1 block of the two-launch path: tiles start
// at multiples of it.
extern "C" int sa_topk_tile() { return SEL_TILE; }

// The largest k the two-launch path takes (sa_topk_select).
extern "C" int sa_topk_one_pass_cap() { return ONE_PASS_CAP; }

// Plain C entry for ctypes, k <= sa_topk_one_pass_cap().  ``x`` is f32
// [n_rows, n], rows contiguous; ``part`` is u64 [n_rows, tiles, k] with
// tiles = ceil(n / sa_topk_tile()) (unused, and may be null, when tiles is
// 1); values f32 [n_rows, k] and indices i32 [n_rows, k] are written.  One
// kernel when a row is one tile, else two; both on ``stream``, nothing
// here synchronises.  Returns the first CUDA error.
extern "C" int sa_topk_select(const void* x, int64_t n_rows, int64_t n,
                              int64_t k, void* part, void* vals, void* idx,
                              int device, void* stream) {
  const int64_t tiles = (n + SEL_TILE - 1) / SEL_TILE;
  if (k < 1 || k > n || k > ONE_PASS_CAP || (tiles > 1 && part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const DeviceGuard guard(device);
  cudaError_t err = cudaFuncSetAttribute(
      topk_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SEL_SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(topk_tile_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  topk_tile_kernel<<<static_cast<unsigned>(n_rows * tiles), SEL_THREADS,
                     SEL_SMEM, st>>>(
      xf, n, static_cast<int>(tiles), static_cast<int>(k), vec,
      static_cast<uint64_t*>(part), static_cast<float*>(vals),
      static_cast<int32_t*>(idx));
  if (tiles > 1) {
    topk_merge_kernel<<<static_cast<unsigned>(n_rows), MERGE_THREADS, 0,
                        st>>>(xf, n, static_cast<const uint64_t*>(part),
                              tiles * k, static_cast<int>(k),
                              static_cast<float*>(vals),
                              static_cast<int32_t*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int KIND>
cudaError_t launch_rank(const RankArgs& a, int64_t rows, int64_t n,
                        int64_t tiles, int k, bool vec, uint64_t* part,
                        float* vals, int32_t* idx, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      rank_tile_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SEL_SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(rank_tile_kernel<KIND>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  rank_tile_kernel<KIND>
      <<<static_cast<unsigned>(rows * tiles), SEL_THREADS, SEL_SMEM, st>>>(
          a, rows, n, static_cast<int>(tiles), k, vec, part, vals, idx);
  if (tiles > 1) {
    rank_merge_kernel<KIND><<<static_cast<unsigned>(rows), MERGE_THREADS, 0,
                              st>>>(a, part, tiles * k, k, vals, idx);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes, k <= sa_topk_one_pass_cap(): the fused
// ranking pass.  Ranked row r's scores are sim::score of kind ``kind`` (a
// sim:: code) of its source row of ``src`` (f32, n columns, row stride
// ``stride``; row ``slots[r]`` of int64 ``slots``, or row r where
// ``slots`` is null), the f32 [n] ``doc_lens`` (counts, >= 0) and its
// idf ``idfs[r]`` (f32 [rows]); their k largest are written as values f32
// [rows, k] and indices i32 [rows, k], exactly as sa_similarity then
// sa_topk_select write them.  ``part`` as in sa_topk_select.  One kernel where a row is
// one tile, else two, on ``stream``; nothing here synchronises.  Returns
// the first CUDA error.
extern "C" int sa_rank_rows(const void* src, int64_t stride,
                            const void* slots, int64_t rows, int64_t n,
                            const void* doc_lens, const void* idfs, int kind,
                            float avgdl, float k1, float b, int64_t k,
                            void* part, void* vals, void* idx, int device,
                            void* stream) {
  const int64_t tiles = (n + SEL_TILE - 1) / SEL_TILE;
  if (k < 1 || k > n || k > ONE_PASS_CAP || kind < sim::BM25 ||
      kind > sim::CLASSIC || (tiles > 1 && part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const DeviceGuard guard(device);
  if (rows <= 0) return 0;
  const sim::Params p = sim::params(kind, 0.0f, avgdl, k1, b);
  const RankArgs a{static_cast<const float*>(src), stride,
                   static_cast<const int64_t*>(slots),
                   static_cast<const float*>(doc_lens),
                   static_cast<const float*>(idfs), p,
                   flat_zero_tf(kind, p)};
  const bool vec = n % 4 == 0 && stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(doc_lens) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* pt = static_cast<uint64_t*>(part);
  float* vf = static_cast<float*>(vals);
  int32_t* ix = static_cast<int32_t*>(idx);
  const int kk = static_cast<int>(k);
  cudaError_t err;
  switch (kind) {
    case sim::BM25:
      err = launch_rank<sim::BM25>(a, rows, n, tiles, kk, vec, pt, vf, ix, st);
      break;
    case sim::BM25_IMPACT:
      err = launch_rank<sim::BM25_IMPACT>(a, rows, n, tiles, kk, vec, pt, vf,
                                          ix, st);
      break;
    case sim::BM25_LEGACY:
      err = launch_rank<sim::BM25_LEGACY>(a, rows, n, tiles, kk, vec, pt, vf,
                                          ix, st);
      break;
    default:
      err = launch_rank<sim::CLASSIC>(a, rows, n, tiles, kk, vec, pt, vf, ix,
                                      st);
  }
  return static_cast<int>(err);
}
