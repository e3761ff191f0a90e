// K8a: candidate rows -- run-compaction of each query's doc-sorted posting
// slice into its candidate row table, and for a term query its tf per
// candidate.
//
// Replaces the JAX package's searcharray_tpu/search/candidates.py
// _compact_rows (:201) and the tf scatter of cterm_body (:227): first =
// (keys[1:] != keys[:-1]); cidx = cumsum(first) - 1; rows = full(Kc,
// N).at[cidx].set(keys); tf = zeros(Kc).at[cidx].add(popcount(pays)).  XLA
// runs that as a cumsum, then two scatters, per query of a vmap.  No caller
// reads cidx, so it stays in registers here and is not stored.
//
// Bound on the card: bytes -- the 4 bytes of each header (and of each
// payload with tf) read once, and each query's row table (and tf row)
// written once.  For a launch of rare terms the tables decide it: 5 terms
// of 153,788 words in all write 2.6 MB of tables against 1.2 MB read.  So
// every table entry is stored exactly once, with no memset and no second
// pass, in ONE kernel of persistent blocks (no more than the card holds
// at once, by the occupancy API), each taking tiles of TILE words of all
// the slices, tile b, b + grid, b + 2 * grid, ...:
//
//   * a tile loads its doc keys to shared memory behind the key of the
//     word before it, and a block scan of (runs begun, popcounts) per
//     thread gives each word its run's rank in the tile and each word the
//     popcounts before it in the tile;
//   * its run prefix in its query comes from a single-pass decoupled
//     look-back, as K2's carries do (segment_sum.cu): the tile publishes
//     its run count (counted before its scan, so that the tiles after it
//     find it at once) in a 64-bit status word tagged with the launch's
//     epoch; after the scan warp 0 sums the words of the tiles before it,
//     32 at a time, back to one that holds its inclusive prefix (or to its
//     query's first tile), and publishes its own inclusive prefix.  Old
//     words carry an older epoch, so the status words need no reset; a
//     tile waits only on lower tiles, which resident blocks reach first;
//   * a run's first word owns it: its thread stores the run's key into
//     rows[cidx] and the run's popcount sum into tf[cidx] (runs past Kc
//     are dropped).  The sum is the difference of the tile's popcount
//     prefix at the run's two ends; the tile's last run, if it goes on
//     past the tile, is read on by the block, THREADS words a step, until
//     its doc's words end (a run never leaves one document).  A word that
//     continues a run begun in an earlier tile is summed there.  So tf
//     takes no atomics and no zeroing, and each sum is a sum of small
//     integers, exact in float32: the result equals the plain version's
//     bit for bit;
//   * every block fills its equal share of the launch's table,
//     [b * share, b * share + share), where it lies in a query's tail
//     [runs, Kc): the sentinel N into rows, 0 into tf, 16 bytes a store.
//     A query has no more runs than words, so [min(n, Kc), Kc) is filled
//     first, before the block's tiles, waiting for nothing; the rest,
//     [runs, min(n, Kc)), after them, the query's runs read from its last
//     tile's status word.  Spread over all resident blocks, not left to
//     each query's last tile: the tails are most of the bytes.

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "device_guard.cuh"

namespace {

// 1,024 threads of two words a tile: faster on the serving mix's largest
// cterm launch than 512 x 4, 256 x 8 or 1,024 x 1 (a 1,024-word tile),
// by scripts/k8a_probe.py --shapes (PERF.md section 6)
constexpr int THREADS = 1024;
constexpr int ITEMS = 2;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int64_t TAIL_PER_BLOCK = 1024;  // table entries a block fills, at
                                          // least, before the grid grows

// A tile's status word: its value (runs begun in it, or with ``inclusive``
// the runs of its query up to and including it) and the launch's epoch,
// in one 64-bit word, so a reader sees both or neither.
__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          bool inclusive,
                                                          unsigned value) {
  return (static_cast<unsigned long long>(epoch) << 33) |
         (static_cast<unsigned long long>(inclusive) << 32) | value;
}

// Tile t's word of this epoch; with ``inclusive``, once it holds the
// tile's inclusive prefix.
__device__ __forceinline__ unsigned long long wait_word(
    const unsigned long long* status, int64_t t, unsigned epoch,
    bool inclusive = false) {
  unsigned long long w;
  do {
    w = *reinterpret_cast<const volatile unsigned long long*>(status + t);
  } while (static_cast<unsigned>(w >> 33) != epoch ||
           (inclusive && !((w >> 32) & 1)));
  return w;
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        int64_t t, unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(status + t) = w;
}

// The runs of tile t's query begun before it: the values of the tiles
// before it back to the nearest one that holds an inclusive prefix; a tile
// before the query's first (``first``) reads as an inclusive 0.  Warp 0
// calls it; each lane waits for one earlier tile's word of this epoch.
__device__ __forceinline__ int64_t look_back(
    const unsigned long long* status, int64_t t, int64_t first,
    unsigned epoch) {
  const int lane = threadIdx.x & 31;
  int64_t sum = 0;
  for (int64_t hi = t - 1;; hi -= 32) {
    const int64_t b = hi - lane;
    const unsigned long long w =
        b < first ? status_word(epoch, true, 0) : wait_word(status, b, epoch);
    const unsigned inclusive = __ballot_sync(0xffffffffu, (w >> 32) & 1);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    int64_t part = lane <= stop ? static_cast<unsigned>(w) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
    }
    sum += part;
    if (inclusive) return sum;
  }
}

// Inclusive scan of one int64 per thread over the block; ``total`` gets
// the block's sum.  Ends with a barrier after its last read of
// ``warp_sums``.
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
    int64_t s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[WARPS - 1];
  const int64_t out = x + (wid ? warp_sums[wid - 1] : 0);
  __syncthreads();
  return out;
}

// rows[a, e) = value and, with tf, tf[a, e) = 0: 16-byte stores between
// the 16-byte boundaries (the tables are allocated 16-byte aligned).
__device__ __forceinline__ void fill_tail(int32_t* rows, float* tf,
                                          int64_t a, int64_t e,
                                          int32_t value) {
  const int64_t a4 = (a + 3) & ~int64_t{3};
  const int64_t e4 = e & ~int64_t{3};
  if (a4 >= e4) {
    for (int64_t i = a + threadIdx.x; i < e; i += THREADS) {
      rows[i] = value;
      if (tf) tf[i] = 0.0f;
    }
    return;
  }
  if (threadIdx.x < a4 - a) {
    rows[a + threadIdx.x] = value;
    if (tf) tf[a + threadIdx.x] = 0.0f;
  }
  if (threadIdx.x < e - e4) {
    rows[e4 + threadIdx.x] = value;
    if (tf) tf[e4 + threadIdx.x] = 0.0f;
  }
  const int4 v = make_int4(value, value, value, value);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = a4 + 4 * int64_t{threadIdx.x}; i < e4; i += 4 * THREADS) {
    *reinterpret_cast<int4*>(rows + i) = v;
    if (tf) *reinterpret_cast<float4*>(tf + i) = z;
  }
}

// ``meta``: offsets [Q], lengths [Q], tile starts [Q + 1], then per tile
// its query, its first word and its slice's end (words of hdrs/pays), so
// that a tile's loads wait on one load of its own record.
__global__ void __launch_bounds__(THREADS)
cand_rows_kernel(const int32_t* __restrict__ hdrs,
                 const int32_t* __restrict__ pays,
                 const int64_t* __restrict__ meta, int64_t n_queries,
                 int64_t n_tiles, int64_t kc, int32_t num_docs, int blk_bits,
                 int32_t* __restrict__ rows, float* __restrict__ tf,
                 unsigned long long* status, unsigned epoch) {
  // keys[0] is the key of the word before the tile (-1 before the first)
  __shared__ int32_t keys[TILE + 1];
  // popcounts of the tile's words before word i (psum[0] = 0)
  __shared__ int32_t psum[TILE + 1];
  // the tile position of each run begun in the tile, then its length
  __shared__ int32_t spos[TILE + 1];
  __shared__ int64_t warp_sums[WARPS];
  __shared__ int64_t base_s;
  __shared__ int32_t next_key, ahead;

  const int64_t* tile_start = meta + 2 * n_queries;
  const int64_t* tile_q = tile_start + n_queries + 1;
  const int64_t* tile_word = tile_q + n_tiles;
  const int64_t* tile_end = tile_word + n_tiles;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t q = tile_q[t];
    const int64_t word = tile_word[t];
    const int64_t end = tile_end[t];
    const int len = static_cast<int>(end - word < TILE ? end - word : TILE);
    const int32_t* h = hdrs + word;
    // every load of the tile at once: its keys (THREADS apart), its
    // payloads (ITEMS consecutive a thread), the words on either side
    int k[ITEMS], pc[ITEMS];
    const int i0 = threadIdx.x * ITEMS;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      k[j] = i < len ? h[i] : 0;
      pc[j] = tf && i0 + j < len ? pays[word + i0 + j] : 0;
    }
    const int64_t first = tile_start[q];
    int32_t before = -1, after = -1;
    if (threadIdx.x == 0) {
      before = word > 0 ? h[-1] >> blk_bits : -1;
      after = word + len < end ? h[len] >> blk_bits : -1;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < len) keys[i + 1] = k[j] >> blk_bits;
    }
    if (threadIdx.x == 0) {
      keys[0] = t == first ? -1 : before;
      next_key = after;
      ahead = 0;
    }
    // the thread's words: (runs begun, popcounts) packed for one scan
    int begun = 0, pops = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      pc[j] = __popc(static_cast<uint32_t>(pc[j]));
      pops += pc[j];
    }
    __syncthreads();  // keys
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j;
      if (i < len && keys[i + 1] != keys[i]) ++begun;
    }
    // the tile's run count, published before its scan: the tiles after it
    // find it there when they look back, one round trip
    int counted = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j;
      counted += __syncthreads_count(i < len && keys[i + 1] != keys[i]);
    }
    if (threadIdx.x == 0) {
      publish(status, t, status_word(epoch, t == first, counted));
    }
    int64_t packed_total;
    const int64_t packed = block_scan(
        (static_cast<int64_t>(begun) << 32) | pops, warp_sums, packed_total);
    const int total = static_cast<int>(packed_total >> 32);
    int rank = static_cast<int>(packed >> 32) - begun;  // runs before
    int below = static_cast<int>(packed & 0xffffffff) - pops;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j;
      if (i < len) {
        if (keys[i + 1] != keys[i]) spos[rank++] = i;
        below += pc[j];
        psum[i + 1] = below;
      }
    }
    if (threadIdx.x == 0) {
      psum[0] = 0;
      spos[total] = len;
    }
    // the runs of the query begun before the tile
    if (threadIdx.x < 32) {
      int64_t base = 0;
      if (t != first) {
        base = look_back(status, t, first, epoch);
        if (threadIdx.x == 0) {
          publish(status, t, status_word(epoch, true,
                                         static_cast<unsigned>(base + total)));
        }
      }
      if (threadIdx.x == 0) base_s = base;
    }
    __syncthreads();  // spos, psum, base_s, next_key
    // the tile's last run goes on past it: read on to its doc's last word
    if (tf && total > 0 && next_key == keys[len]) {
      const int32_t last = keys[len];
      const int64_t left = end - word - len;
      int acc = 0;
      for (int64_t s = 0;; s += THREADS) {
        const int64_t i = s + threadIdx.x;
        const bool same = i < left && (h[len + i] >> blk_bits) == last;
        if (same) acc += __popc(static_cast<uint32_t>(pays[word + len + i]));
        if (__syncthreads_count(same) < THREADS) break;
      }
      if (acc) atomicAdd(&ahead, acc);
      __syncthreads();
    }
    const int64_t base = base_s;
    int32_t* rq = rows + q * kc;
    float* tq = tf ? tf + q * kc : nullptr;
    for (int r = threadIdx.x; r < total; r += THREADS) {
      const int64_t cidx = base + r;
      if (cidx >= kc) break;
      const int s = spos[r];
      rq[cidx] = keys[s + 1];
      if (tq) {
        const int sum = psum[spos[r + 1]] - psum[s] + (r == total - 1
                                                       ? ahead : 0);
        tq[cidx] = static_cast<float>(sum);
      }
    }
    __syncthreads();  // the next tile overwrites the shared arrays
  }

  // the table's tails: an equal share of the table a block, on the blocks
  // past the tiles where the grid has more blocks than tiles (the tiles
  // are the longer chain), else on every block after its tiles
  const int64_t table = n_queries * kc;
  const int64_t tail0 = n_tiles < gridDim.x ? n_tiles : 0;
  if (table == 0 || blockIdx.x < tail0) return;
  const int64_t blocks = gridDim.x - tail0;
  int64_t share = (table + blocks - 1) / blocks;
  share = (share + 3) & ~int64_t{3};
  const int64_t lo = (blockIdx.x - tail0) * share;
  const int64_t hi = lo + share < table ? lo + share : table;
  // first what is known before any tile: a query has no more runs than
  // words, so [min(n, Kc), Kc) holds no candidate
  for (int64_t q = lo / kc; q < n_queries && q * kc < hi; ++q) {
    const int64_t n = meta[n_queries + q];
    const int64_t a = q * kc + (n < kc ? n : kc);
    const int64_t e = hi < (q + 1) * kc ? hi : (q + 1) * kc;
    fill_tail(rows, tf, lo > a ? lo : a, e, num_docs);
  }
  // then the rest, [runs, min(n, Kc)): a query's runs are its last tile's
  // inclusive prefix, waited for where the share meets it
  for (int64_t q = lo / kc; q < n_queries && q * kc < hi; ++q) {
    const int64_t n = meta[n_queries + q];
    const int64_t known = q * kc + (n < kc ? n : kc);
    if (lo >= known) continue;   // uniform: the block waits for nothing
    if (threadIdx.x == 0) {
      base_s = static_cast<unsigned>(
          wait_word(status, tile_start[q + 1] - 1, epoch, true));
    }
    __syncthreads();
    const int64_t a = q * kc + (base_s < kc ? base_s : kc);
    const int64_t e = hi < known ? hi : known;
    fill_tail(rows, tf, lo > a ? lo : a, e, num_docs);
    __syncthreads();  // base_s is read before the next query's write
  }
}

// One stream's scratch: a status word per tile, and the launch count that
// tags them.
struct Scratch {
  unsigned long long* status = nullptr;
  int64_t tiles = 0;
  unsigned epoch = 0;
};

std::mutex mu;
std::map<int, int64_t> resident;  // blocks a device holds at once
std::map<std::pair<int, cudaStream_t>, Scratch> scratch;

cudaError_t resident_blocks(int device, int64_t& blocks) {
  auto it = resident.find(device);
  if (it == resident.end()) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cand_rows_kernel, THREADS, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return err;
    it = resident.emplace(device, static_cast<int64_t>(per_sm) * sms).first;
  }
  blocks = it->second;
  return cudaSuccess;
}

cudaError_t launch(const int32_t* hdrs, const int32_t* pays,
                   const int64_t* meta, int64_t n_queries, int64_t n_tiles,
                   int64_t kc, int num_docs, int blk_bits, int32_t* rows,
                   float* tf, int device, cudaStream_t s) {
  const int64_t table = n_queries * kc;
  if (n_tiles == 0 && table == 0) return cudaSuccess;
  int64_t cap = 0;
  cudaError_t err = resident_blocks(device, cap);
  if (err != cudaSuccess) return err;
  // a block a tile and blocks for the tails, but no more than the card
  // holds at once: a tile waits only on lower tiles, and a table's tail on
  // its query's last tile, which then all run
  int64_t grid = n_tiles + (table + TAIL_PER_BLOCK - 1) / TAIL_PER_BLOCK;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  Scratch& sc = scratch[{device, s}];
  if (sc.tiles < n_tiles) {
    if (sc.status != nullptr) cudaFree(sc.status);  // waits for the device
    sc.status = nullptr;
    sc.tiles = 0;
    err = cudaMalloc(&sc.status, 8 * n_tiles);
    if (err != cudaSuccess) return err;
    sc.tiles = n_tiles;
    cudaMemsetAsync(sc.status, 0, 8 * n_tiles, s);  // epoch 0: never current
  }
  sc.epoch = sc.epoch % 0x7fffffffu + 1;  // 31 bits, never 0
  cand_rows_kernel<<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
      hdrs, pays, meta, n_queries, n_tiles, kc, num_docs, blk_bits, rows, tf,
      sc.status, sc.epoch);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  ``meta`` is a device int64 array of 3 *
// n_queries + 1 + 3 * n_tiles entries: the slice offsets of the
// ``n_queries`` queries, their lengths, the prefix sums of their tile
// counts (ceil(length / TILE); ``n_tiles`` in all), then each tile's
// query, each tile's first word and each tile's slice end (offset +
// length).  ``rows`` (and ``tf`` unless it is null) are
// [n_queries, kc], 16-byte aligned; every entry is written.  The kernel
// runs on ``stream`` and nothing here synchronises.  Returns the first
// CUDA error: of a query, a scratch allocation or the launch.
extern "C" int sa_cand_rows(const void* hdrs, const void* pays,
                            const void* meta, int64_t n_queries,
                            int64_t n_tiles, int64_t kc, int num_docs,
                            int blk_bits, void* rows, void* tf, int device,
                            void* stream) {
  const DeviceGuard guard(device);
  // held through the launch, so no other host thread frees the scratch of
  // this stream between its growth and the launch that uses it
  std::lock_guard<std::mutex> lock(mu);
  return static_cast<int>(launch(
      static_cast<const int32_t*>(hdrs), static_cast<const int32_t*>(pays),
      static_cast<const int64_t*>(meta), n_queries, n_tiles, kc, num_docs,
      blk_bits, static_cast<int32_t*>(rows), static_cast<float*>(tf), device,
      static_cast<cudaStream_t>(stream)));
}

// Words of a tile: the wrapper counts a query's tiles with it.
extern "C" int sa_cand_rows_tile() { return TILE; }

// Blocks of a launch: at most the card's resident blocks (0 on an error).
// It also tells the single-kernel design from the earlier two-kernel one.
extern "C" int sa_cand_rows_grid(int64_t n_queries, int64_t n_tiles,
                                 int64_t kc, int device) {
  const DeviceGuard guard(device);
  std::lock_guard<std::mutex> lock(mu);
  int64_t cap = 0;
  if (resident_blocks(device, cap) != cudaSuccess) return 0;
  int64_t grid =
      n_tiles + (n_queries * kc + TAIL_PER_BLOCK - 1) / TAIL_PER_BLOCK;
  if (grid > cap) grid = cap;
  return static_cast<int>(grid < 1 ? 1 : grid);
}
