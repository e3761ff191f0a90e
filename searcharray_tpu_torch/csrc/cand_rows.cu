// K8a: candidate rows -- run-compaction of each query's doc-sorted posting
// slice into its candidate row table, and for a term query its tf per
// candidate.
//
// Replaces the JAX package's searcharray_tpu/search/candidates.py
// _compact_rows (:201) and the tf scatter of cterm_body (:227): first =
// (keys[1:] != keys[:-1]); cidx = cumsum(first) - 1; rows = full(Kc,
// N).at[cidx].set(keys); tf = zeros(Kc).at[cidx].add(popcount(pays)).  XLA
// runs that as a cumsum, then two scatters, per query of a vmap.  No caller
// reads cidx, so it stays in the registers here and is not stored.  Here one
// call takes a chunk of queries and enqueues two kernels over the tiles of
// ROWS_TILE words of all their slices, one block a tile:
//
//   * cand_rows_count_kernel counts the runs each tile begins (a word
//     whose doc key differs from the word before it in its slice; the
//     slice's first word always does) into the call's scratch, and writes
//     every row table to the sentinel N (and every tf row to 0);
//   * cand_rows_kernel gives each tile the runs begun by the tiles before
//     it in its slice (a sum over at most the slice's tiles), loads the
//     tile's doc keys to shared memory behind the key of the word before
//     the tile, and scans: each thread owns ROWS_ITEMS consecutive words,
//     counts the runs they begin, and a block scan of the counts gives
//     every word its candidate index (cidx); each run's first word writes
//     its key to rows[cidx];
//   * with tf, a thread sums the popcounts of its words per run and adds
//     each partial sum into tf[cidx] with one atomicAdd (a run that
//     crosses tiles gets one from each).  The sums are small integers,
//     exact in float32 in any order, so the result equals the plain
//     version bit for bit.
//
// Bound on the card: the 4 bytes of each header (and of each payload with
// tf) read, the row table (and tf row) written.  The counting pass reads the headers a second time; the tiles
// of every query run side by side, so a long slice does not walk its
// tiles one after another.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS_THREADS = 512;
constexpr int ROWS_ITEMS = 4;
constexpr int ROWS_TILE = ROWS_THREADS * ROWS_ITEMS;
constexpr int ROWS_WARPS = ROWS_THREADS / 32;
constexpr int64_t INIT_PER_BLOCK = 8 * ROWS_THREADS;  // table entries

// Inclusive scan of one int per thread over the block; ``total`` gets the
// block's sum.  Reads ``warp_sums`` after the scan's own barriers: the
// caller synchronises before the next call writes it again.
__device__ __forceinline__ int64_t block_scan(int64_t v, int64_t* warp_sums,
                                              int64_t& total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int64_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int64_t s = lane < ROWS_WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < ROWS_WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[ROWS_WARPS - 1];
  return x + (wid ? warp_sums[wid - 1] : 0);
}

// The query of tile ``b``: the last q with tile_start[q] <= b.
__device__ __forceinline__ int64_t query_of(const int64_t* tile_start,
                                            int64_t n_queries, int64_t b) {
  int64_t lo = 0, hi = n_queries;  // tile_start[lo] <= b < tile_start[hi]
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (tile_start[mid] <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// ``meta``: offsets [Q], lengths [Q], tile starts [Q + 1],
// then one scratch entry per tile for its run count.
__global__ void __launch_bounds__(ROWS_THREADS)
cand_rows_count_kernel(const int32_t* __restrict__ hdrs, int64_t* meta,
                       int64_t n_queries, int64_t kc, int32_t num_docs,
                       int blk_bits, int32_t* __restrict__ rows,
                       float* __restrict__ tf) {
  __shared__ int64_t warp_sums[ROWS_WARPS];

  const int64_t table = n_queries * kc;
  for (int64_t c = blockIdx.x * int64_t{ROWS_THREADS} + threadIdx.x;
       c < table; c += int64_t{gridDim.x} * ROWS_THREADS) {
    rows[c] = num_docs;
    if (tf) tf[c] = 0.0f;
  }
  const int64_t* tile_start = meta + 2 * n_queries;
  const int64_t b = blockIdx.x;
  if (b >= tile_start[n_queries]) return;  // the block only initialised
  const int64_t q = query_of(tile_start, n_queries, b);
  const int64_t off = meta[q];
  const int64_t n = meta[n_queries + q];
  const int64_t t0 = (b - tile_start[q]) * ROWS_TILE;
  const int64_t t1 = t0 + ROWS_TILE < n ? t0 + ROWS_TILE : n;
  int64_t begun = 0;
  for (int64_t i = t0 + threadIdx.x; i < t1; i += ROWS_THREADS) {
    const int32_t key = hdrs[off + i] >> blk_bits;
    if (i == 0 || key != (hdrs[off + i - 1] >> blk_bits)) ++begun;
  }
  int64_t total;
  block_scan(begun, warp_sums, total);
  if (threadIdx.x == 0) meta[3 * n_queries + 1 + b] = total;
}

__global__ void __launch_bounds__(ROWS_THREADS)
cand_rows_kernel(const int32_t* __restrict__ hdrs,
                 const int32_t* __restrict__ pays,
                 const int64_t* __restrict__ meta, int64_t n_queries,
                 int64_t kc, int blk_bits, int32_t* __restrict__ rows,
                 float* __restrict__ tf) {
  // keys[0] is the key of the word before the tile (-1 before the first)
  __shared__ int32_t keys[ROWS_TILE + 1];
  __shared__ int64_t warp_sums[ROWS_WARPS];

  const int64_t* tile_start = meta + 2 * n_queries;
  const int64_t* counts = meta + 3 * n_queries + 1;
  const int64_t b = blockIdx.x;
  const int64_t q = query_of(tile_start, n_queries, b);
  const int64_t off = meta[q];
  const int64_t n = meta[n_queries + q];
  int32_t* rq = rows + q * kc;
  float* tq = tf ? tf + q * kc : nullptr;
  const int64_t first = tile_start[q];
  const int64_t t0 = (b - first) * ROWS_TILE;

  // runs begun by the slice's earlier tiles
  int64_t before = 0;
  for (int64_t j = first + threadIdx.x; j < b; j += ROWS_THREADS) {
    before += counts[j];
  }
  int64_t base;
  block_scan(before, warp_sums, base);

  const int len = static_cast<int>(n - t0 < ROWS_TILE ? n - t0 : ROWS_TILE);
  for (int i = threadIdx.x; i < len; i += ROWS_THREADS) {
    keys[i + 1] = hdrs[off + t0 + i] >> blk_bits;
  }
  if (threadIdx.x == 0) {
    keys[0] = t0 ? hdrs[off + t0 - 1] >> blk_bits : -1;
  }
  __syncthreads();  // also: every read of warp_sums above is done

  const int i0 = threadIdx.x * ROWS_ITEMS;
  int64_t begun = 0;
#pragma unroll
  for (int j = 0; j < ROWS_ITEMS; ++j) {
    const int i = i0 + j;
    if (i < len && keys[i + 1] != keys[i]) ++begun;
  }
  int64_t total;
  const int64_t incl = block_scan(begun, warp_sums, total);
  // the candidate index of the run the thread's first word continues
  int64_t cur = base + incl - begun - 1;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < ROWS_ITEMS; ++j) {
    const int i = i0 + j;
    if (i >= len) break;
    const int32_t key = keys[i + 1];
    if (key != keys[i]) {
      if (tq && acc != 0.0f && cur >= 0 && cur < kc) atomicAdd(tq + cur, acc);
      acc = 0.0f;
      ++cur;
      if (cur < kc) rq[cur] = key;
    }
    if (tq) acc += static_cast<float>(__popc(pays[off + t0 + i]));
  }
  if (tq && acc != 0.0f && cur >= 0 && cur < kc) atomicAdd(tq + cur, acc);
}

}  // namespace

// Plain C entry for ctypes.  ``meta`` is a device int64 array of 3 *
// n_queries + 1 + n_tiles entries: the slice offsets of the ``n_queries``
// queries, their lengths, the prefix sums of their tile counts
// (ceil(length / ROWS_TILE); ``n_tiles`` in all), then one entry per tile
// that the call overwrites (its run count).  ``rows`` (and ``tf`` unless it
// is null) are [n_queries, kc].  The kernels run on ``stream`` and nothing
// here synchronises.  Returns cudaGetLastError().
extern "C" int sa_cand_rows(const void* hdrs, const void* pays, void* meta,
                            int64_t n_queries, int64_t n_tiles, int64_t kc,
                            int num_docs, int blk_bits, void* rows,
                            void* tf, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t init = (n_queries * kc + INIT_PER_BLOCK - 1) / INIT_PER_BLOCK;
  const int64_t grid = n_tiles > init ? n_tiles : init;
  if (grid > 0) {
    cand_rows_count_kernel<<<static_cast<unsigned>(grid), ROWS_THREADS, 0,
                             s>>>(
        static_cast<const int32_t*>(hdrs), static_cast<int64_t*>(meta),
        n_queries, kc, num_docs, blk_bits, static_cast<int32_t*>(rows),
        static_cast<float*>(tf));
  }
  if (n_tiles > 0) {
    cand_rows_kernel<<<static_cast<unsigned>(n_tiles), ROWS_THREADS, 0, s>>>(
        static_cast<const int32_t*>(hdrs), static_cast<const int32_t*>(pays),
        static_cast<const int64_t*>(meta), n_queries, kc, blk_bits,
        static_cast<int32_t*>(rows), static_cast<float*>(tf));
  }
  return static_cast<int>(cudaGetLastError());
}

// Words of a tile: the wrapper counts a query's tiles with it.
extern "C" int sa_cand_rows_tile() { return ROWS_TILE; }
