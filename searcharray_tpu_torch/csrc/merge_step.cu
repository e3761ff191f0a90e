// K7: one bigram step of the sparse exact-phrase chain, for a chunk of
// queries, on doc-sorted posting slices.
//
// Replaces the sort-merge step of the JAX package
// (searcharray_tpu/search/phrase.py:_merge_step :123, _same_term_step :79,
// and the per-step body of _merged_chain :409): there one multi-operand
// sort of both lists, shifted compares on the sorted stream and a
// compaction scatter back to the base side's order.  The sort is that
// package's answer to a device without a fast search.  Here a step is a
// sorted join (sorted_join.cuh):
//
//   * a query's *base* list (the raw term the continuation is shaped
//     like) is cut into tiles of MS_TILE words; persistent blocks take
//     runs of tiles, which may cross queries (the wrapper passes each
//     tile's query behind the query table);
//   * each tile's base words with one word either side, and the window of
//     the *other* list (a raw term, or the previous step's base headers
//     with the continuation payloads it wrote) from where the tile's range
//     of headers [first - 1, last + 1] starts, headers and payloads, reach
//     shared memory by cp.async while the block matches the tile before;
//   * a thread takes MS_ITEMS consecutive base words, finds the lower bound
//     of the first one's header in the window and walks forward for the
//     rest: the hit is the same-header partner, the element before it
//     (rhs) or after it (lhs) the adjacent-block partner when its header
//     is h -/+ 1 -- the compressed header doc << blk_bits | block crosses a
//     document boundary there exactly as the JAX package's sorted compare
//     does -- and every partner's payload is a shared-memory read;
//   * it writes, at the base word's own position, the flat doc key
//     (query's key base + header >> blk_bits), the match count as f32 and
//     the continuation payload where the query needs it.  The base side
//     keeps its headers, so nothing is compacted and the next step reads
//     this payload buffer beside the base term's header slice.  K2 reduces
//     (key, count).
//
// The direction (rhs: a left-to-right step, lhs: right-to-left), the
// same-term step (lhs and rhs the same list, the first step of a chain:
// its partners are the word's neighbours in the list, no other window) and
// whether the continuation is written are columns of the query table, so
// one launch takes a step of every chain of a call.  A block window zeroes
// the payloads of words outside [min_blk, max_blk] on both sides as they
// are read; the words stay.
//
// Bound on the card: 8 bytes read per base word and per other word, 12
// written per base word (8 without the continuation); about log2(window)
// shared-memory probes for a thread's first word, a short walk for the
// rest.  The first design gave each tile a block whose time was a chain of
// waits on device memory (the table, the tile's ends, ~5 search rounds,
// the staging, a search per word, the partners' payloads): 2,047 blocks of
// ~20 us in two waves for the largest windowed step.  Here a block pays a
// search only where it enters a query, and a tile's copies fly while the
// tile before it computes.  Sizing (nvcc -Xptxas -v and the chip runs of
// PERF.md): 128 threads of 4 words; a window of up to 1,024 words (the
// previous tile's range and a quarter more; the largest windowed step
// meets ~710 other words a tile); two stages and 2 KB through which each
// warp's writes leave 32 consecutive words a store: 27 KB a block, eight
// blocks an SM.  Handing a warp's live words to its first lanes (as K9
// does) lost on the steps whose words all keep a position.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "sorted_join.cuh"

namespace {

constexpr int MS_THREADS = 128;
constexpr int MS_ITEMS = 4;     // consecutive base words a thread: an int4
constexpr int MS_TILE = MS_THREADS * MS_ITEMS;
constexpr int MS_CAP = 1024;    // other words a tile stages
constexpr int MS_BLOCKS = 8;    // resident per SM
// a stage's buffers, whole 16-byte rows: the tile and a word either side
constexpr int B_WORDS = (MS_TILE + 2 + sj::PAD + 3) / 4 * 4;
constexpr int O_WORDS = (MS_CAP + sj::PAD + 3) / 4 * 4;
constexpr int TOP = 17;         // bit of the last position in a block
constexpr int32_t LSB = (1 << 18) - 1;

// rows of the int64 [MS_ROWS, ld] query table; each tile's query follows
enum {
  BASE_OFF, BASE_N, OTHER_OFF, OTHER_N, OTHER_PAY_OFF, OUT_OFF, KEY_BASE,
  TILE_START, FLAGS, MS_ROWS
};
// bits of FLAGS
enum { RHS = 1, SAME_TERM = 2, WRITE_CONT = 4 };

struct BlkWindow {
  int32_t blk_mask, min_blk, max_blk;
  __device__ __forceinline__ int32_t operator()(int32_t h, int32_t p) const {
    const int32_t blk = h & blk_mask;
    return blk >= min_blk && blk <= max_blk ? p : 0;
  }
};

// A tile of the block's run as it is staged.
struct Tile {
  int64_t i0, i1;        // base words [i0, i1) of the query's list
  int64_t b0;            // the first staged base word: i0 - 1, clamped
  int64_t base_off, base_n, out_off, tile_start;
  int32_t key_base, flags, q, b_shift;
  sj::Window o;          // the other list
};

// Warp 0: tile ``t`` and its windows into ``tl``.  Where ``prev`` (the
// block's previous tile) is of the same query, its row of the table is
// reused and the other window starts at ``s``, ``est`` words long (the
// previous range's length and a margin); else the row is read and a
// search of the other list finds the tile's range, staged exactly or,
// above MS_CAP, read in device memory.
__device__ __forceinline__ void open_tile(Tile& tl, const Tile* prev,
                                          int64_t t,
                                          const int64_t* __restrict__ meta,
                                          int64_t ld,
                                          const int32_t* __restrict__ hdrs,
                                          int64_t s, int64_t est, bool vec) {
  const int lane = threadIdx.x & 31;
  const bool same_q = prev != nullptr
                      && (t - prev->tile_start) * MS_TILE < prev->base_n;
  int q, flags;
  int64_t base_off, base_n, tile_start, other_off, other_n, pay_off,
      out_off, key_base;
  if (same_q) {
    q = prev->q;
    flags = prev->flags;
    base_off = prev->base_off;
    base_n = prev->base_n;
    tile_start = prev->tile_start;
    other_off = prev->o.off;
    other_n = prev->o.n_list;
    pay_off = prev->o.pay_off;
    out_off = prev->out_off;
    key_base = prev->key_base;
  } else {
    q = static_cast<int>(meta[MS_ROWS * ld + t]);
    flags = static_cast<int>(meta[FLAGS * ld + q]);
    base_off = meta[BASE_OFF * ld + q];
    base_n = meta[BASE_N * ld + q];
    tile_start = meta[TILE_START * ld + q];
    other_off = meta[OTHER_OFF * ld + q];
    other_n = meta[OTHER_N * ld + q];
    pay_off = meta[OTHER_PAY_OFF * ld + q];
    out_off = meta[OUT_OFF * ld + q];
    key_base = meta[KEY_BASE * ld + q];
  }
  const int64_t i0 = (t - tile_start) * MS_TILE;
  const int64_t i1 = i0 + MS_TILE < base_n ? i0 + MS_TILE : base_n;
  const bool same = flags & SAME_TERM;
  int64_t r0 = -1, r1 = -1;   // the exact range, found on entering a query
  if (!same && !same_q) {
    sa::warp_bounds(hdrs + other_off, other_n, 0,
                    static_cast<int64_t>(hdrs[base_off + i0]) - 1,
                    static_cast<int64_t>(hdrs[base_off + i1 - 1]) + 2, r0,
                    r1);
    s = r0;
    est = r1 - r0 + 1;   // and the word after it, which shows it covers
  }
  if (lane == 0) {
    tl.i0 = i0;
    tl.i1 = i1;
    tl.b0 = i0 > 0 ? i0 - 1 : 0;
    tl.base_off = base_off;
    tl.base_n = base_n;
    tl.out_off = out_off;
    tl.tile_start = tile_start;
    tl.key_base = static_cast<int32_t>(key_base);
    tl.flags = flags;
    tl.q = q;
    tl.b_shift = sj::shift_of(base_off, tl.b0, vec);
    const bool above = r1 - r0 > MS_CAP;
    sj::open_window(tl.o, other_off, pay_off, other_n, same ? other_n : s,
                    above ? 0 : (est < MS_CAP ? static_cast<int>(est)
                                              : MS_CAP), vec);
    if (above) {   // read in device memory
      tl.o.r0 = r0;
      tl.o.r1 = r1;
    }
  }
}

// One thread's MS_ITEMS consecutive base words of a tile, matched and
// written.  ``bh``/``bp`` point at the tile's word 0 (``prev``/``next``:
// the words at -1 and n exist); ``oh``/``op`` hold the other words that
// can be partners, ``on`` of them, sorted by unique header.  The first
// live word's lower bound is a binary search; with ``WALK`` (a staged
// window) the later words' are a forward merge from it.  keys, counts and
// conts (null: not written) point at the tile's word 0 in the outputs.
template <bool WALK>
__device__ __forceinline__ void match_words(
    const int32_t* bh, const int32_t* bp, int n, bool prev, bool next,
    const int32_t* oh, const int32_t* op, int on, int flags, BlkWindow win,
    int blk_bits, int32_t key_base, int32_t* wbuf, int32_t* __restrict__ keys,
    float* __restrict__ counts, int32_t* __restrict__ conts) {
  const bool rhs = flags & RHS, same = flags & SAME_TERM;
  int32_t key_v[MS_ITEMS], count_v[MS_ITEMS], cont_v[MS_ITEMS];
  int lo = -1;   // the lower bound of the previous live word's header
#pragma unroll
  for (int u = 0; u < MS_ITEMS; ++u) {
    const int j = threadIdx.x * MS_ITEMS + u;
    key_v[u] = count_v[u] = cont_v[u] = 0;
    if (j >= n) continue;
    const int32_t h = bh[j];
    const int32_t p = win(h, bp[j]);
    int32_t count = 0, cont = 0;
    if (p != 0 && same) {
      const int32_t ov = p & ((p << 1) & LSB);
      const int consec = __popc(ov & (ov << 1) & LSB);
      int32_t adj;
      if (rhs) {
        adj = (p & 1) && (j > 0 || prev) && bh[j - 1] == h - 1
                  ? (win(h - 1, bp[j - 1]) >> TOP) & 1 : 0;
        cont = ov | adj;
      } else {
        adj = (p >> TOP) && (j + 1 < n || next) && bh[j + 1] == h + 1
                  ? win(h + 1, bp[j + 1]) & 1 : 0;
        cont = (p & (p >> 1)) | (adj << TOP);
      }
      count = __popc(ov) - ((consec + 1) >> 1) + adj;
    } else if (p != 0) {
      if (lo < 0 || !WALK) {
        lo = sj::lower_bound32(oh, lo < 0 ? 0 : lo, on, h);
      } else {
        while (lo < on && oh[lo] < h) ++lo;   // the forward merge
      }
      const bool hit = lo < on && oh[lo] == h;
      const int32_t inner = hit ? win(h, op[lo]) : 0;
      int32_t overlap, adj;
      if (rhs) {
        overlap = inner & (p >> 1);
        adj = (p & 1) && lo > 0 && oh[lo - 1] == h - 1
                  ? (win(h - 1, op[lo - 1]) >> TOP) & 1 : 0;
        cont = ((overlap << 1) & LSB) | adj;
      } else {
        const int nx = lo + (hit ? 1 : 0);
        overlap = p & (inner >> 1);
        adj = (p >> TOP) && nx < on && oh[nx] == h + 1
                  ? win(h + 1, op[nx]) & 1 : 0;
        cont = overlap | (adj << TOP);
      }
      count = __popc(overlap) + adj;
    }
    key_v[u] = key_base + (h >> blk_bits);
    count_v[u] = __float_as_int(static_cast<float>(count));
    cont_v[u] = cont;
  }
  // the warp's 128 words leave through its buffer: one 16-byte store a
  // lane, then 32 consecutive words a store
  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 32 * MS_ITEMS;
  auto put = [&](const int32_t* v, int32_t* dst) {
    *reinterpret_cast<int4*>(wbuf + MS_ITEMS * lane) =
        make_int4(v[0], v[1], v[2], v[3]);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < MS_ITEMS; ++u) {
      const int j = w0 + 32 * u + lane;
      if (j < n) dst[j] = wbuf[32 * u + lane];
    }
    __syncwarp();
  };
  put(key_v, keys);
  put(count_v, reinterpret_cast<int32_t*>(counts));
  if (conts != nullptr) put(cont_v, conts);
}

__global__ void __launch_bounds__(MS_THREADS, MS_BLOCKS)
merge_join_kernel(const int32_t* __restrict__ hdrs,
                  const int32_t* __restrict__ base_pays,
                  const int32_t* __restrict__ other_pays,
                  const int64_t* __restrict__ meta, int64_t ld,
                  int64_t n_tiles, int blk_bits, BlkWindow win, int vec_in,
                  int32_t* __restrict__ keys_out,
                  float* __restrict__ counts_out,
                  int32_t* __restrict__ cont_out) {
  __shared__ __align__(16) int32_t bh_s[2][B_WORDS];
  __shared__ __align__(16) int32_t bp_s[2][B_WORDS];
  __shared__ __align__(16) int32_t oh_s[2][O_WORDS];
  __shared__ __align__(16) int32_t op_s[2][O_WORDS];
  __shared__ __align__(16) int32_t out_s[MS_THREADS / 32][32 * MS_ITEMS];
  __shared__ Tile tiles[2];

  const bool vec = vec_in != 0;
  const bool warp0 = threadIdx.x < 32;
  int32_t* wbuf = out_s[threadIdx.x >> 5];
  int64_t t0, t1;
  sj::tile_run(n_tiles, t0, t1);
  if (t0 >= t1) return;

  // every thread: the copies of stage k's tile
  auto issue = [&](int k) {
    const Tile& tl = tiles[k];
    const int64_t b1 = tl.i1 + 1 < tl.base_n ? tl.i1 + 1 : tl.base_n;
    sj::stage(bh_s[k], hdrs + tl.base_off, tl.base_off, tl.b0, b1 - tl.b0,
              vec);
    sj::stage(bp_s[k], base_pays + tl.base_off, tl.base_off, tl.b0,
              b1 - tl.b0, vec);
    sj::stage(oh_s[k], hdrs + tl.o.off, tl.o.off, tl.o.s, tl.o.n, vec);
    sj::stage(op_s[k], other_pays + tl.o.pay_off, tl.o.pay_off, tl.o.s,
              tl.o.n, vec);
    sj::cp_async_commit();
  };

  if (warp0) open_tile(tiles[0], nullptr, t0, meta, ld, hdrs, 0, 0, vec);
  __syncthreads();
  issue(0);

  int k = 0;
  for (int64_t t = t0; t < t1; ++t, k ^= 1) {
    sj::cp_async_wait_all();
    __syncthreads();
    Tile& tl = tiles[k];
    // the staged base headers, by index of the base list
    auto bh = [&](int64_t i) { return bh_s[k][tl.b_shift + (i - tl.b0)]; };
    const bool same = tl.flags & SAME_TERM;
    // warp 0: the other range of this tile -- the staged window if it
    // covers the tile, else the exact range in device memory -- and where
    // the next tile's window starts; then the next tile's row
    if (warp0) {
      int64_t end = 0, start = 0;
      if (!same && tl.o.r0 >= 0) {
        end = tl.o.r1;
        start = tl.o.r0;
      } else if (!same) {
        start = tl.o.s;
        const int64_t last = bh(tl.i1 - 1);
        if (sj::covers(tl.o, oh_s[k], last + 1)) {
          end = tl.o.s + sj::lower_bound(oh_s[k] + tl.o.h_shift, 0, tl.o.n,
                                         last + 2);
        } else {
          int64_t r0, r1;
          sa::warp_bounds(hdrs + tl.o.off, tl.o.n_list, 0,
                          static_cast<int64_t>(bh(tl.i0)) - 1, last + 2, r0,
                          r1);
          end = r1;
          start = r0;
          __syncwarp();
          if ((threadIdx.x & 31) == 0) {
            tl.o.r0 = r0;
            tl.o.r1 = r1;
          }
        }
      }
      if (t + 1 < t1) {
        // the next range: as long as this one, a quarter more and a margin
        open_tile(tiles[k ^ 1], &tl, t + 1, meta, ld, hdrs,
                  end - 2 > 0 ? end - 2 : 0,
                  (end - start) + ((end - start) >> 2) + 16, vec);
      }
    }
    __syncthreads();
    if (t + 1 < t1) issue(k ^ 1);

    // the tile's words from its word 0 on (the words either side at -1
    // and n), its outputs, and the other range: the staged window, or the
    // exact range in device memory
    const int n = static_cast<int>(tl.i1 - tl.i0);
    const int at = tl.b_shift + static_cast<int>(tl.i0 - tl.b0);
    const int64_t out = tl.out_off + tl.i0;
    int32_t* conts = cont_out != nullptr && (tl.flags & WRITE_CONT)
                         ? cont_out + out : nullptr;
    if (tl.o.r0 < 0) {
      match_words<true>(bh_s[k] + at, bp_s[k] + at, n, tl.i0 > 0,
                        tl.i1 < tl.base_n, oh_s[k] + tl.o.h_shift,
                        op_s[k] + tl.o.p_shift, tl.o.n, tl.flags, win,
                        blk_bits, tl.key_base, wbuf, keys_out + out,
                        counts_out + out, conts);
    } else {
      match_words<false>(bh_s[k] + at, bp_s[k] + at, n, tl.i0 > 0,
                         tl.i1 < tl.base_n, hdrs + tl.o.off + tl.o.r0,
                         other_pays + tl.o.pay_off + tl.o.r0,
                         static_cast<int>(tl.o.r1 - tl.o.r0), tl.flags, win,
                         blk_bits, tl.key_base, wbuf, keys_out + out,
                         counts_out + out, conts);
    }
  }
}

}  // namespace

// The base words of a tile: the wrapper cuts each query's base list into
// tiles of this many words.
extern "C" int sa_merge_join_tile() { return MS_TILE; }

// Plain C entry for ctypes.  ``meta`` is a device int64 [9, ld] table, one
// column for each of the ``ld`` queries: base_off, base_n, other_off,
// other_n (into ``hdrs``), other_pay_off (into ``other_pays``), out_off
// (into the outputs), key_base, tile_start (the query's first tile;
// queries without base words take none), flags (1: a left-to-right step,
// its continuation shaped like the right term; 2: the same-term step, the
// other columns unread; 4: write the continuation); behind it, ``n_tiles``
// more entries: each tile's query, in order.  Persistent blocks run on
// ``stream``; nothing here synchronises.  ``cont`` may be null.  Returns
// cudaGetLastError().
extern "C" int sa_merge_join(const void* hdrs, const void* base_pays,
                             const void* other_pays, const void* meta,
                             int64_t ld, int64_t n_tiles, int blk_bits,
                             int min_blk, int max_blk, void* keys,
                             void* counts, void* cont, int device,
                             void* stream) {
  static int64_t resident[64] = {};   // blocks each device holds at once
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  const DeviceGuard guard(device);
  if (resident[device] == 0) {
    const cudaError_t err = sj::resident_blocks(
        merge_join_kernel, MS_THREADS, 0, device, resident[device]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t grid = n_tiles < resident[device] ? n_tiles
                                                   : resident[device];
  if (grid <= 0) return static_cast<int>(cudaGetLastError());
  const BlkWindow win{(1 << blk_bits) - 1, min_blk, max_blk};
  const bool vec = ((reinterpret_cast<uintptr_t>(hdrs)
                     | reinterpret_cast<uintptr_t>(base_pays)
                     | reinterpret_cast<uintptr_t>(other_pays)) & 15) == 0;
  merge_join_kernel<<<static_cast<unsigned>(grid), MS_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hdrs),
      static_cast<const int32_t*>(base_pays),
      static_cast<const int32_t*>(other_pays),
      static_cast<const int64_t*>(meta), ld, n_tiles, blk_bits, win,
      static_cast<int>(vec), static_cast<int32_t*>(keys),
      static_cast<float*>(counts), static_cast<int32_t*>(cont));
  return static_cast<int>(cudaGetLastError());
}
