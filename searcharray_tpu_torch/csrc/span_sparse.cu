// K9: slop (sloppy phrase) coverage on doc-sorted posting slices -- per
// word of the anchor term, the number of its positions that lie in a
// window holding every query term often enough, for a chunk of queries.
//
// Replaces the JAX package's XLA program _span_impl
// (searcharray_tpu/search/spans.py:54-126): there, per anchor word, a
// searchsorted of every header h - C .. h + C in every term's list, the
// payloads found laid out as a raster of (2C + 1) * 18 position bits, an
// [A, T, B + 1] prefix sum over it for the window counts, and a second
// prefix sum over the windows that pass.  All static shapes, which is what
// that device wants.  Here nothing is laid out:
//
//   * a query's anchor list is cut into tiles of SS_THREADS words, one
//     thread block each and one thread a word; the wrapper passes each
//     tile's query behind the query table (as K7, merge_step.cu);
//   * per distinct term, warp 0 narrows the term's list to the headers in
//     [first - C, last + C] of the tile (the warp search of segmented.cuh)
//     and every thread finds the lower bound of its own h - C in that
//     range: ONE search per word and term.  The 2C + 1 headers h - C ..
//     h + C are consecutive integers and the list is sorted by unique
//     header, so the word for the next header is the cursor's own element
//     or the one after it: a forward walk, no further search;
//   * the windows [s, s + w], s = 18C - w .. 18C + 17, are visited in
//     order with the count of each term kept as a running sum:
//     need_t += bit_t(s + w + 1) - bit_t(s).  A term keeps two cursors
//     (the word the leaving bit is in, the word the entering bit is in)
//     and its count less its multiplicity: five integers, whatever w is;
//   * anchor position b (bit b of the word, position 18C + b of the
//     neighbourhood) is covered iff a window with s in [b - w, b] passed:
//     the index of the last passing start is all that takes;
//   * where the window fits one block either side (w <= 18, so C = 1)
//     and no term is named more than twice, the neighbourhood of a term
//     is three words, 54 bits: one 64-bit word.  Then the windows are not
//     walked at all: the starts that hold a term are a dilation of that
//     word (the pair trick of span_window.cu for a term named twice), the
//     terms' AND is one word of passing starts, its dilation upwards the
//     covered positions, and a popcount with the anchor's bits the
//     answer.  No state but that one word.
//
// Semantics as the JAX package computes them: a term's word at header
// h + d counts only while block + d stays in [0, 2^blk_bits), so a
// neighbourhood never leaves its document; a block window zeroes the
// payloads of words outside [min_blk, max_blk] (the words stay); a term
// named m times in the query needs m positions in the window.  Counts are
// small integers: equal to the plain version bit for bit.  It writes, at
// the anchor word's own position, the flat doc key (query's key base +
// header >> blk_bits) and the count as f32; K2 sums them per doc.
//
// Bound on the card: 8 bytes read per anchor word and per word of the
// other terms in the anchor's header range, 8 written per anchor word.
// Per anchor word with a set position the walked shapes need T * (w + 18)
// window steps, which bounds them by operations; the word-path shapes need
// a few dozen dilation steps a term, fewer than their bytes cost, so bytes
// bound those (ops/cuda/roofline.py:k9_work).  On the walked path the per-term
// state lives in local memory up to SS_LOCAL_TERMS distinct terms and in a
// scratch buffer the wrapper allocates above that, so no query is refused
// for its shape.

#include <cuda_runtime.h>

#include <cstdint>

#include "segmented.cuh"

namespace {

constexpr int SS_THREADS = 256;     // anchor words per block, one a thread
constexpr int SS_BLOCKS = 6;        // resident per SM: 40 registers a thread
constexpr int SS_LOCAL_TERMS = 8;   // terms whose state fits local memory
constexpr int LSB_BITS = 18;

// per-term state of a thread
enum { TRAIL_IDX, TRAIL_WORD, LEAD_IDX, LEAD_WORD, NEED, SS_STATE };

struct Window {
  int32_t blk_mask, min_blk, max_blk;
  __device__ __forceinline__ int32_t operator()(int32_t h, int32_t p) const {
    const int32_t blk = h & blk_mask;
    return blk >= min_blk && blk <= max_blk ? p : 0;
  }
};

// OR of y(p + o) over o in [0, len): log steps.
__device__ __forceinline__ uint64_t dilate_down(uint64_t y, int len) {
  for (int cur = 1; cur < len;) {
    const int k = cur < len - cur ? cur : len - cur;
    y |= y >> k;
    cur += k;
  }
  return y;
}

// OR of y(p - o) over o in [0, len).
__device__ __forceinline__ uint64_t dilate_up(uint64_t y, int len) {
  for (int cur = 1; cur < len;) {
    const int k = cur < len - cur ? cur : len - cur;
    y |= y << k;
    cur += k;
  }
  return y;
}

// Window starts s whose [s, s + w] holds at least ``mult`` (1 or 2) bits
// of x: a dilation, or for two bits the OR over every distance d of the
// pairs x & (x >> d) dilated over the starts that hold both.
__device__ __forceinline__ uint64_t present(uint64_t x, int w, int mult) {
  if (mult == 1) return dilate_down(x, w + 1);
  uint64_t ok = 0;
  for (int d = 1; d <= w; ++d) {
    ok |= dilate_down(x & (x >> d), w + 1 - d);
  }
  return ok;
}

// A term's list within the planes.
struct Side {
  const int32_t* h;
  const int32_t* p;
  int64_t n;
};

// The payload of ``side`` at header ``target`` (0 where it has no such
// word or ``blk``, the target's block, is outside the document).  ``idx``
// is the first index whose header is >= the previous target: it moves by
// at most one, since targets rise by one and headers are unique.
__device__ __forceinline__ int32_t lane_word(const Side& side, int32_t& idx,
                                             int32_t target, int32_t blk,
                                             const Window& win) {
  if (idx < side.n && side.h[idx] < target) ++idx;
  if (blk < 0 || blk > win.blk_mask) return 0;
  return idx < side.n && side.h[idx] == target ? win(target, side.p[idx]) : 0;
}

__global__ void __launch_bounds__(SS_THREADS, SS_BLOCKS)
span_sparse_kernel(const int32_t* __restrict__ hdrs,
                   const int32_t* __restrict__ pays,
                   const int64_t* __restrict__ meta, int64_t ld, int T,
                   int anchor, int w, int blk_bits, Window win, int words,
                   int32_t* __restrict__ scratch, int64_t scratch_stride,
                   int32_t* __restrict__ keys_out,
                   float* __restrict__ counts_out) {
  __shared__ int64_t range[2];

  // the query table: rows (off_t, n_t) per term, out_off, key_base,
  // tile_start; then the multiplicities; then each tile's query
  const int64_t* mults = meta + (2 * T + 3) * ld;
  const int q = static_cast<int>(mults[T + blockIdx.x]);
  auto side_of = [&](int t) {
    const int64_t off = meta[2 * t * ld + q];
    return Side{hdrs + off, pays + off, meta[(2 * t + 1) * ld + q]};
  };
  const Side a = side_of(anchor);
  const int64_t out_off = meta[2 * T * ld + q];
  const int32_t key_base = static_cast<int32_t>(meta[(2 * T + 1) * ld + q]);
  const int64_t i0 = (blockIdx.x - meta[(2 * T + 2) * ld + q]) * SS_THREADS;
  const int64_t i1 = i0 + SS_THREADS < a.n ? i0 + SS_THREADS : a.n;
  const int64_t i = i0 + threadIdx.x;
  const bool active = i < i1;

  const int C = (w + LSB_BITS - 1) / LSB_BITS;
  const int S0 = LSB_BITS * C - w;   // the first start, a bit of lane 0
  const int L = w + LSB_BITS;        // starts per anchor word
  const int32_t first = a.h[i0], last = a.h[i1 - 1];
  int32_t h = 0, p = 0;
  if (active) {
    h = a.h[i];
    p = win(h, a.p[i]);
  }
  const int32_t blk = h & win.blk_mask;
  const bool live = active && p != 0;   // no position, nothing to cover

  int32_t local[SS_LOCAL_TERMS * SS_STATE];
  int32_t* st = local;
  int64_t stride = 1;
  if (T > SS_LOCAL_TERMS) {
    st = scratch + out_off + i;
    stride = scratch_stride;
  }

  // every term's cursors at lane 0 (header h - C), and its count in the
  // first window [S0, S0 + w] = [S0, 18C]: lanes 0 .. C; or, on the word
  // path, the starts that hold every term so far
  uint64_t ok_starts = ~0ull;
  for (int t = 0; t < T; ++t) {
    const Side side = side_of(t);
    __syncthreads();
    sa::block_range(side.h, side.n, 0, static_cast<int64_t>(first) - C,
                    static_cast<int64_t>(last) + C + 1, range);
    __syncthreads();
    if (!live) continue;
    int64_t lo = range[0], hi = range[1];
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (side.h[mid] < h - C) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int32_t idx = static_cast<int32_t>(lo);
    int32_t word = lane_word(side, idx, h - C, blk - C, win);
    if (words) {
      // C = 1: the words at h - 1, h, h + 1 as one string of 54 bits
      uint64_t x = static_cast<uint32_t>(word);
      x |= static_cast<uint64_t>(lane_word(side, idx, h, blk, win))
           << LSB_BITS;
      x |= static_cast<uint64_t>(lane_word(side, idx, h + 1, blk + 1, win))
           << (2 * LSB_BITS);
      ok_starts &= present(x, w, static_cast<int>(mults[t]));
      continue;
    }
    int32_t* s = st + t * SS_STATE * stride;
    s[TRAIL_IDX * stride] = idx;
    s[TRAIL_WORD * stride] = word;
    const int end = S0 + w + 1;
    int count = 0;
    for (int lane = 0, from = S0;; from = 0) {
      const int to = end - lane * LSB_BITS < LSB_BITS ? end - lane * LSB_BITS
                                                       : LSB_BITS;
      count += __popc(word & ((1 << to) - 1) & ~((1 << from) - 1));
      if (end <= (lane + 1) * LSB_BITS) break;
      ++lane;
      word = lane_word(side, idx, h - C + lane, blk - C + lane, win);
    }
    s[LEAD_IDX * stride] = idx;
    s[LEAD_WORD * stride] = word;
    s[NEED * stride] = count - static_cast<int32_t>(mults[t]);
  }

  int covered = 0;
  if (live && words) {
    // position 18 + b is covered iff a start in [18 + b - w, 18 + b] passed
    covered = __popcll(dilate_up(ok_starts, w + 1)
                       & (static_cast<uint64_t>(p) << LSB_BITS));
  } else if (live) {
    int last_ok = -1;
    int lane_l = 0, bit_l = S0;   // the leaving position s
    int lane_e = C, bit_e = 1;    // the entering position s + w + 1
    for (int si = 0; si < L; ++si) {
      bool ok = true;
      for (int t = 0; t < T; ++t) {
        ok = ok && st[(t * SS_STATE + NEED) * stride] >= 0;
      }
      if (ok) last_ok = si;
      // the windows that hold anchor bit b are the starts b .. b + w of
      // this walk, so bit b is decided here, at si = b + w
      const int b = si - w;
      if (b >= 0 && ((p >> b) & 1) && last_ok >= b) ++covered;
      if (si + 1 == L) break;
      const bool fetch_l = bit_l == LSB_BITS, fetch_e = bit_e == LSB_BITS;
      if (fetch_l) {
        ++lane_l;
        bit_l = 0;
      }
      if (fetch_e) {
        ++lane_e;
        bit_e = 0;
      }
      for (int t = 0; t < T; ++t) {
        int32_t* s = st + t * SS_STATE * stride;
        if (fetch_l || fetch_e) {
          const Side side = side_of(t);
          if (fetch_l) {
            int32_t idx = s[TRAIL_IDX * stride];
            s[TRAIL_WORD * stride] = lane_word(side, idx, h - C + lane_l,
                                               blk - C + lane_l, win);
            s[TRAIL_IDX * stride] = idx;
          }
          if (fetch_e) {
            int32_t idx = s[LEAD_IDX * stride];
            s[LEAD_WORD * stride] = lane_word(side, idx, h - C + lane_e,
                                              blk - C + lane_e, win);
            s[LEAD_IDX * stride] = idx;
          }
        }
        s[NEED * stride] += ((s[LEAD_WORD * stride] >> bit_e) & 1)
                            - ((s[TRAIL_WORD * stride] >> bit_l) & 1);
      }
      ++bit_l;
      ++bit_e;
    }
  }
  if (active) {
    keys_out[out_off + i] = key_base + (h >> blk_bits);
    counts_out[out_off + i] = static_cast<float>(covered);
  }
}

}  // namespace

// The anchor words a block takes: the wrapper cuts each query's anchor
// list into tiles of this many words.
extern "C" int sa_span_sparse_tile() { return SS_THREADS; }

// The distinct terms whose per-thread state needs no scratch buffer.
extern "C" int sa_span_sparse_local_terms() { return SS_LOCAL_TERMS; }

// Plain C entry for ctypes.  ``meta`` is a device int64 table: [2T + 3, ld]
// with one column for each of the ``ld`` queries (rows: per term its slice
// offset and length in ``hdrs``/``pays``; out_off into the outputs;
// key_base; tile_start, the query's first block), then the T
// multiplicities, then ``n_tiles`` entries: each block's query.
// ``anchor`` is the column whose words are counted, ``w`` the window
// (query length + slop - 1).  ``words`` selects the 64-bit word path: the
// caller sets it only where w <= 18 and no multiplicity exceeds 2.
// ``scratch`` is an int32 [5 * T, scratch_stride] buffer, read and written
// only on the walked path when T exceeds sa_span_sparse_local_terms()
// (else it may be null); ``scratch_stride`` is at least the number of
// anchor words.  ``n_tiles`` blocks run on
// ``stream``; nothing here synchronises.  Returns cudaGetLastError().
extern "C" int sa_span_sparse(const void* hdrs, const void* pays,
                              const void* meta, int64_t ld, int64_t n_tiles,
                              int T, int anchor, int w, int blk_bits,
                              int min_blk, int max_blk, int words,
                              void* scratch,
                              int64_t scratch_stride, void* keys,
                              void* counts, int device, void* stream) {
  cudaSetDevice(device);
  const Window win{(1 << blk_bits) - 1, min_blk, max_blk};
  span_sparse_kernel<<<static_cast<unsigned>(n_tiles), SS_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hdrs), static_cast<const int32_t*>(pays),
      static_cast<const int64_t*>(meta), ld, T, anchor, w, blk_bits, win,
      words, static_cast<int32_t*>(scratch), scratch_stride,
      static_cast<int32_t*>(keys), static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}
