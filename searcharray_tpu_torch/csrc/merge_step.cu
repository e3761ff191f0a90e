// K7: one bigram step of the sparse exact-phrase chain, for a chunk of
// queries, on doc-sorted posting slices.
//
// Replaces the sort-merge step of the JAX package
// (searcharray_tpu/search/phrase.py:_merge_step :123, _same_term_step :79,
// and the per-step body of _merged_chain :409): there one multi-operand
// sort of both lists, shifted compares on the sorted stream and a
// compaction scatter back to the base side's order.  The sort is that
// package's answer to a device without a fast search.  Here a step is a
// search:
//
//   * a query's *base* list (the raw term the continuation is shaped
//     like) is cut into tiles of MS_TILE words, one thread block each; the
//     wrapper passes each tile's query behind the query table;
//   * warp 0 narrows the *other* list (a raw term, or the previous step's
//     base headers with the continuation payloads it wrote) to the words
//     whose headers lie in [first - 1, last + 1] of the tile, with the
//     warp search of segmented.cuh;
//   * that range is staged in shared memory when it fits, and every
//     thread finds the lower bound of its base header in it: the hit is
//     the same-header partner, the element before it (rhs) or after it
//     (lhs) the adjacent-block partner when its header is h -/+ 1 -- the
//     compressed header doc << blk_bits | block crosses a document
//     boundary there exactly as the JAX package's sorted compare does;
//   * it writes, at the base word's own position, the flat doc key
//     (query's key base + header >> blk_bits), the match count as f32 and
//     the continuation payload.  The base side keeps its headers, so
//     nothing is compacted and the next step reads this payload buffer
//     beside the base term's header slice.  K2 reduces (key, count).
//
// A block window zeroes the payloads of words outside [min_blk, max_blk]
// on both sides as they are read; the words stay.  The same-term step
// (lhs and rhs the same list, first step of a chain) needs no search: its
// partners are the word's neighbours in the list.
//
// Bound on the card: 8 bytes read per base word and per other word, 12
// written per base word; about log2(range) shared-memory probes per word.
// A block's time is a chain of waits on device memory (the query table,
// the tile's ends, ~5 search rounds, the staging, the partners' payloads),
// so what counts is how many blocks an SM holds: MS_BLOCKS.  Staging the
// payloads too, or a thread taking consecutive words from a tile kept in
// shared memory, cost registers and shared memory and ran slower.

#include <cuda_runtime.h>

#include <cstdint>

#include "segmented.cuh"

namespace {

constexpr int MS_THREADS = 256;
constexpr int MS_BLOCKS = 8;    // resident per SM: 32 registers a thread
constexpr int MS_ITEMS = 4;
constexpr int MS_TILE = MS_THREADS * MS_ITEMS;  // base words per block
constexpr int MS_STAGE = 4096;  // other headers a block stages: 16 KB
constexpr int TOP = 17;         // bit of the last position in a block
constexpr int32_t LSB = (1 << 18) - 1;

// rows of the int64 [MS_ROWS, ld] query table; each tile's query follows
enum {
  BASE_OFF, BASE_N, OTHER_OFF, OTHER_N, OTHER_PAY_OFF, OUT_OFF, KEY_BASE,
  TILE_START, MS_ROWS
};

struct Window {
  int32_t blk_mask, min_blk, max_blk;
  __device__ __forceinline__ int32_t operator()(int32_t h, int32_t p) const {
    const int32_t blk = h & blk_mask;
    return blk >= min_blk && blk <= max_blk ? p : 0;
  }
};

template <bool RHS>
__global__ void __launch_bounds__(MS_THREADS, MS_BLOCKS)
merge_step_kernel(const int32_t* __restrict__ hdrs,
                  const int32_t* __restrict__ base_pays,
                  const int32_t* __restrict__ other_pays,
                  const int64_t* __restrict__ meta, int64_t ld, int blk_bits,
                  Window win, int same_term, int32_t* __restrict__ keys_out,
                  float* __restrict__ counts_out,
                  int32_t* __restrict__ cont_out) {
  __shared__ int32_t stage[MS_STAGE];
  __shared__ int64_t range[2];

  const int q = static_cast<int>(meta[MS_ROWS * ld + blockIdx.x]);
  const int64_t base_n = meta[BASE_N * ld + q];
  const int64_t i0 = (blockIdx.x - meta[TILE_START * ld + q]) * MS_TILE;
  const int64_t i1 = i0 + MS_TILE < base_n ? i0 + MS_TILE : base_n;
  const int64_t base_off = meta[BASE_OFF * ld + q];
  const int32_t* bh = hdrs + base_off;
  const int32_t* bp = base_pays + base_off;
  const int32_t* oh = hdrs + meta[OTHER_OFF * ld + q];
  const int32_t* op = other_pays + meta[OTHER_PAY_OFF * ld + q];
  const int64_t out_off = meta[OUT_OFF * ld + q];
  const int32_t key_base = static_cast<int32_t>(meta[KEY_BASE * ld + q]);

  int64_t r0 = 0, r1 = 0;
  bool staged = false;
  if (!same_term) {
    sa::block_range(oh, meta[OTHER_N * ld + q], 0,
                    static_cast<int64_t>(bh[i0]) - 1,
                    static_cast<int64_t>(bh[i1 - 1]) + 2, range);
    __syncthreads();
    r0 = range[0];
    r1 = range[1];
    staged = r1 - r0 <= MS_STAGE;
    if (staged) {
      for (int64_t i = threadIdx.x; i < r1 - r0; i += MS_THREADS) {
        stage[i] = oh[r0 + i];
      }
      __syncthreads();
    }
  }
  auto other_hdr = [&](int64_t i) { return staged ? stage[i - r0] : oh[i]; };

  for (int64_t i = i0 + threadIdx.x; i < i1; i += MS_THREADS) {
    const int32_t h = bh[i];
    const int32_t p = win(h, bp[i]);
    int32_t count = 0, cont = 0;
    if (p != 0 && same_term) {
      const int32_t ov = p & ((p << 1) & LSB);
      const int consec = __popc(ov & (ov << 1) & LSB);
      int32_t adj;
      if (RHS) {
        adj = (p & 1) && i > 0 && bh[i - 1] == h - 1
                  ? (win(h - 1, bp[i - 1]) >> TOP) & 1 : 0;
        cont = ov | adj;
      } else {
        adj = (p >> TOP) && i + 1 < base_n && bh[i + 1] == h + 1
                  ? win(h + 1, bp[i + 1]) & 1 : 0;
        cont = (p & (p >> 1)) | (adj << TOP);
      }
      count = __popc(ov) - ((consec + 1) >> 1) + adj;
    } else if (p != 0) {
      int64_t lo = r0, hi = r1;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (other_hdr(mid) < h) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const bool hit = lo < r1 && other_hdr(lo) == h;
      const int32_t inner = hit ? win(h, op[lo]) : 0;
      int32_t overlap, adj;
      if (RHS) {
        overlap = inner & (p >> 1);
        adj = (p & 1) && lo > r0 && other_hdr(lo - 1) == h - 1
                  ? (win(h - 1, op[lo - 1]) >> TOP) & 1 : 0;
        cont = ((overlap << 1) & LSB) | adj;
      } else {
        const int64_t k = lo + (hit ? 1 : 0);
        overlap = p & (inner >> 1);
        adj = (p >> TOP) && k < r1 && other_hdr(k) == h + 1
                  ? win(h + 1, op[k]) & 1 : 0;
        cont = overlap | (adj << TOP);
      }
      count = __popc(overlap) + adj;
    }
    keys_out[out_off + i] = key_base + (h >> blk_bits);
    counts_out[out_off + i] = static_cast<float>(count);
    if (cont_out != nullptr) cont_out[out_off + i] = cont;
  }
}

}  // namespace

// The base words a block takes: the wrapper cuts each query's base list
// into tiles of this many words.
extern "C" int sa_merge_step_tile() { return MS_TILE; }

// Plain C entry for ctypes.  ``meta`` is a device int64 [8, ld] table, one
// column for each of the ``ld`` queries: base_off, base_n, other_off,
// other_n (into ``hdrs``), other_pay_off (into ``other_pays``), out_off
// (into the outputs), key_base, tile_start (the query's first block;
// queries without base words take no block); behind it, ``n_tiles`` more
// entries: each block's query.  ``n_tiles`` blocks run on ``stream``;
// nothing here synchronises.  ``cont`` may be null.  Returns
// cudaGetLastError().
extern "C" int sa_merge_step(const void* hdrs, const void* base_pays,
                             const void* other_pays, const void* meta,
                             int64_t ld, int64_t n_tiles, int blk_bits,
                             int min_blk, int max_blk, int rhs,
                             int same_term, void* keys, void* counts,
                             void* cont, int device, void* stream) {
  cudaSetDevice(device);
  const Window win{(1 << blk_bits) - 1, min_blk, max_blk};
  auto* kernel = rhs ? merge_step_kernel<true> : merge_step_kernel<false>;
  kernel<<<static_cast<unsigned>(n_tiles), MS_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hdrs),
      static_cast<const int32_t*>(base_pays),
      static_cast<const int32_t*>(other_pays),
      static_cast<const int64_t*>(meta), ld, blk_bits, win, same_term,
      static_cast<int32_t*>(keys), static_cast<float*>(counts),
      static_cast<int32_t*>(cont));
  return static_cast<int>(cudaGetLastError());
}
