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
// that device wants.  Here nothing is laid out.  It is a sorted join of the
// anchor list's tiles against every term's list (sorted_join.cuh):
//
//   * a query's anchor list is cut into tiles of SS_THREADS words, one
//     thread a word; persistent blocks take runs of tiles, which may cross
//     queries (the wrapper passes each tile's query behind the query
//     table);
//   * each term's range of headers [first - C, last + C] of the tile is
//     found by one warp, all terms at once (warp t takes term t, and terms
//     t + 8, ... where there are more): a warp search where the block
//     enters a query, a shared-memory search of the staged window after
//     that.  One barrier for all terms.  The anchor's window is its tile
//     with C words either side.  The windows of the first SS_STAGED terms
//     (the anchor first), headers and payloads, reach shared memory by
//     cp.async while the block computes the tile before; further terms are
//     read in device memory;
//   * the tile's live anchor words (a position left in the block window;
//     the others cover nothing) are handed to its first threads, so that
//     the warps that cover positions are full;
//   * every such thread finds the lower bound of its h - C in each term's
//     window: the 2C + 1 headers h - C .. h + C are consecutive integers
//     and the list is sorted by unique header, so the word for the next
//     header is the cursor's own element or the one after it: a forward
//     walk, no further search;
//   * the windows [s, s + w], s = 18C - w .. 18C + 17, are visited in
//     order with the count of each term kept as a running sum:
//     need_t += bit_t(s + w + 1) - bit_t(s).  A term keeps two cursors
//     (the word the leaving bit is in, the word the entering bit is in)
//     and its count less its multiplicity: five integers, whatever w is.
//     Up to SS_REG_TERMS distinct terms the kernel is instantiated for T
//     and that state lives in registers; above it in a scratch buffer the
//     wrapper allocates, so no query is refused for its shape;
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
// bound those (ops/cuda/roofline.py:k9_work).  The first design gave each
// tile a block that searched term after term, two barriers a term around
// warp 0's search, then a binary search per thread in device memory and
// the words read there: ~8 waves of ~15 us chains on the largest launch.
// Here a block searches where it enters a query, reads every word of a
// staged term in shared memory, and a tile's copies fly while the tile
// before it computes.  Sizing (nvcc -Xptxas -v and the chip runs of
// PERF.md): 256 threads; a term's window of up to 1,024 words (the
// previous tile's range and a quarter more: the largest windowed launch
// meets ~480 words of its dense term a tile), the anchor's exactly its
// tile and 2C words; two stages, so 16.5 KB of dynamic shared memory a
// staged term; 52-79 registers (three blocks an SM on the walked path,
// four on the word path).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "device_guard.cuh"
#include "sorted_join.cuh"

namespace {

constexpr int SS_THREADS = 256;     // anchor words a tile, one a thread
constexpr int SS_WARPS = SS_THREADS / 32;
constexpr int SS_BLOCKS = 3;        // resident per SM at least: 85 registers
constexpr int SS_CAP = 1024;        // words of a term a tile stages
constexpr int SS_STAGED = 4;        // terms staged, the anchor first
constexpr int SS_REG_TERMS = 4;     // walked path: state in registers
constexpr int BUF = (SS_CAP + sj::PAD + 3) / 4 * 4;
constexpr int LSB_BITS = 18;

// per-term state of a thread on the walked path
enum { TRAIL_IDX, TRAIL_WORD, LEAD_IDX, LEAD_WORD, NEED, SS_STATE };

struct BlkWindow {
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

// The payload of ``v`` at header ``target`` (0 where it has no such word
// or ``blk``, the target's block, is outside the document).  ``idx`` is
// the first index whose header is >= the previous target: it moves by at
// most one, since targets rise by one and headers are unique.
__device__ __forceinline__ int32_t lane_word(const sj::View& v, int32_t& idx,
                                             int32_t target, int32_t blk,
                                             const BlkWindow& win) {
  if (idx < v.n && v.h[idx] < target) ++idx;
  if (blk < 0 || blk > win.blk_mask) return 0;
  return idx < v.n && v.h[idx] == target ? win(target, v.p[idx]) : 0;
}

// A tile of the block's run.
struct STile {
  int64_t i0, i1, out_off, tile_start, an;   // an: the anchor's words
  int32_t key_base, q;
};

// The walked path's per-term state: registers for TS terms, else the
// scratch buffer (TS = 0).
template <int TS>
struct RegState {
  int32_t v[TS][SS_STATE];
  __device__ __forceinline__ int32_t& at(int t, int f) { return v[t][f]; }
};

struct ScratchState {
  int32_t* st;
  int64_t stride;
  __device__ __forceinline__ int32_t& at(int t, int f) {
    return st[(t * SS_STATE + f) * stride];
  }
};

template <int TS>
using StateOf = typename std::conditional<TS == 0, ScratchState,
                                          RegState<TS>>::type;

template <int TS, bool WORDS>
__global__ void __launch_bounds__(SS_THREADS, SS_BLOCKS)
span_join_kernel(const int32_t* __restrict__ hdrs,
                 const int32_t* __restrict__ pays,
                 const int64_t* __restrict__ meta, int64_t ld,
                 int64_t n_tiles, int T_in, int anchor, int w, int blk_bits,
                 BlkWindow win, int vec_in, int32_t* __restrict__ scratch,
                 int64_t scratch_stride, int32_t* __restrict__ keys_out,
                 float* __restrict__ counts_out) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ STile tiles[2];
  __shared__ int32_t live_idx[SS_THREADS];   // the tile's live words
  __shared__ int32_t covered_s[SS_THREADS];  // their counts, by thread
  __shared__ int32_t live_n;

  const int T = TS > 0 ? TS : T_in;   // a constant below the register cap
  const int S = T < SS_STAGED ? T : SS_STAGED;
  const bool vec = vec_in != 0;
  // [2 stages][S slots][headers, payloads][BUF]; then [2][T] windows
  sj::Window* wins = reinterpret_cast<sj::Window*>(smem + 4 * S * BUF);
  auto hbuf = [&](int k, int slot) { return smem + (2 * (k * S + slot)) * BUF; };
  auto pbuf = [&](int k, int slot) {
    return smem + (2 * (k * S + slot) + 1) * BUF;
  };
  // the anchor takes slot 0, the others follow in column order
  auto slot_of = [&](int u) {
    return u == anchor ? 0 : (u < anchor ? u + 1 : u);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = (w + LSB_BITS - 1) / LSB_BITS;
  // the query table: rows (off_t, n_t) per term, out_off, key_base,
  // tile_start; then the multiplicities; then each tile's query
  const int64_t* mults = meta + (2 * T + 3) * ld;
  const int64_t* tile_q = mults + T;

  int64_t t0, t1;
  sj::tile_run(n_tiles, t0, t1);
  if (t0 >= t1) return;

  // tile t's query, first tile and anchor words, and its words [i0, i1);
  // the previous tile's where it is of the same query
  auto rows_of = [&](int64_t t, const STile* prev, bool& same_q, int& q,
                     int64_t& tile_start, int64_t& an, int64_t& i0,
                     int64_t& i1) {
    same_q = prev != nullptr
             && (t - prev->tile_start) * SS_THREADS < prev->an;
    if (same_q) {
      q = prev->q;
      tile_start = prev->tile_start;
      an = prev->an;
    } else {
      q = static_cast<int>(tile_q[t]);
      tile_start = meta[(2 * T + 2) * ld + q];
      an = meta[(2 * anchor + 1) * ld + q];
    }
    i0 = (t - tile_start) * SS_THREADS;
    i1 = i0 + SS_THREADS < an ? i0 + SS_THREADS : an;
  };
  // a warp: term u's window for tile t, in stage k.  The anchor's is its
  // tile with C words either side.  Another staged term's starts 2C words
  // before where its previous tile's range ended (``end``) within a query,
  // ``est`` words long (the previous range's length and a margin); on
  // entering a query a search finds the range, staged with the word after
  // it or, above SS_CAP, read in device memory.  An unstaged term's range
  // is searched in phase A of every tile
  auto open_term = [&](int k, int u, int64_t t, const STile* prev,
                       const sj::Window* prev_w, int64_t end, int64_t est) {
    bool same_q;
    int q;
    int64_t tile_start, an, i0, i1;
    rows_of(t, prev, same_q, q, tile_start, an, i0, i1);
    const int64_t off = same_q ? prev_w->off : meta[2 * u * ld + q];
    const int64_t n_list = same_q ? prev_w->n_list
                                  : meta[(2 * u + 1) * ld + q];
    const bool staged = slot_of(u) < S;
    int64_t s = 0, n = 0, r1 = -1;   // r1: the exact range's end, on entering
    if (u == anchor) {
      s = i0 > C ? i0 - C : 0;
      n = (i1 + C < n_list ? i1 + C : n_list) - s;
    } else if (staged && same_q) {
      s = end > 2 * C ? end - 2 * C : 0;
      n = est;
    } else if (staged) {
      const int64_t a_off = meta[2 * anchor * ld + q];
      sa::warp_bounds(hdrs + off, n_list, 0,
                      static_cast<int64_t>(hdrs[a_off + i0]) - C,
                      static_cast<int64_t>(hdrs[a_off + i1 - 1]) + C + 1, s,
                      r1);
      n = r1 - s + 1;
    }
    const bool above = r1 - s > SS_CAP;
    if (lane == 0) {
      sj::Window& wu = wins[k * T + u];
      sj::open_window(wu, off, off, n_list, s,
                      above ? 0 : static_cast<int>(n < SS_CAP ? n : SS_CAP),
                      vec);
      if (above) {   // read in device memory
        wu.r0 = s;
        wu.r1 = r1;
      }
    }
  };
  auto open_tile = [&](int k, int64_t t, const STile* prev) {
    bool same_q;
    int q;
    int64_t tile_start, an, i0, i1;
    rows_of(t, prev, same_q, q, tile_start, an, i0, i1);
    tiles[k] = STile{
        i0, i1, same_q ? prev->out_off : meta[2 * T * ld + q], tile_start,
        an, same_q ? prev->key_base
                   : static_cast<int32_t>(meta[(2 * T + 1) * ld + q]), q};
  };
  auto issue = [&](int k) {
    for (int u = 0; u < T; ++u) {
      const int slot = slot_of(u);
      if (slot >= S) continue;
      const sj::Window& wu = wins[k * T + u];
      sj::stage(hbuf(k, slot), hdrs + wu.off, wu.off, wu.s, wu.n, vec);
      sj::stage(pbuf(k, slot), pays + wu.pay_off, wu.pay_off, wu.s, wu.n,
                vec);
    }
    sj::cp_async_commit();
  };

  for (int u = warp; u < T; u += SS_WARPS) {
    open_term(0, u, t0, nullptr, nullptr, 0, 0);
  }
  if (threadIdx.x == 0) open_tile(0, t0, nullptr);
  __syncthreads();
  issue(0);

  int k = 0;
  for (int64_t t = t0; t < t1; ++t, k ^= 1) {
    sj::cp_async_wait_all();
    __syncthreads();
    const STile& tl = tiles[k];
    sj::Window* wk = wins + k * T;
    // the tile's first and last headers, from the anchor's window where it
    // holds the tile
    const sj::Window& aw = wk[anchor];
    const bool a_in = aw.s + aw.n >= tl.i1;
    auto anchor_hdr = [&](int64_t i) {
      return static_cast<int64_t>(a_in ? hbuf(k, 0)[aw.h_shift + (i - aw.s)]
                                       : hdrs[aw.off + i]);
    };
    const int64_t first = anchor_hdr(tl.i0), last = anchor_hdr(tl.i1 - 1);
    // phase A, warp u % 8 for term u: the range of this tile -- the staged
    // window if it covers the tile, else the exact range in device
    // memory -- and the term's window for the next tile
    for (int u = warp; u < T; u += SS_WARPS) {
      sj::Window& wu = wk[u];
      const int slot = slot_of(u);
      int64_t start = wu.s, end;
      if (wu.r0 >= 0) {
        start = wu.r0;
        end = wu.r1;
      } else if (slot < S && sj::covers(wu, hbuf(k, slot), last + C)) {
        // (the anchor's next window needs no end: it is the next tile)
        end = u == anchor ? 0
                          : wu.s + sj::lower_bound(hbuf(k, slot) + wu.h_shift,
                                                   0, wu.n, last + C + 1);
      } else {
        int64_t r0, r1;
        sa::warp_bounds(hdrs + wu.off, wu.n_list, 0, first - C,
                        last + C + 1, r0, r1);
        start = r0;
        end = r1;
        __syncwarp();
        if (lane == 0) {
          wu.r0 = r0;
          wu.r1 = r1;
        }
      }
      // the next range: as long as this one, a quarter more and a margin
      if (t + 1 < t1) {
        open_term(k ^ 1, u, t + 1, &tl, &wu, end,
                  (end - start) + ((end - start) >> 2) + 16 + 2 * C);
      }
    }
    if (threadIdx.x == 0) {
      live_n = 0;
      if (t + 1 < t1) open_tile(k ^ 1, t + 1, &tl);
    }
    __syncthreads();
    if (t + 1 < t1) issue(k ^ 1);

    // each term's words as the tile reads them; below the register cap
    // held in registers for the whole tile
    auto load_view = [&](int u) {
      const int slot = slot_of(u) < S ? slot_of(u) : 0;
      return sj::view_of(wk[u], hbuf(k, slot), pbuf(k, slot), hdrs, pays);
    };
    sj::View vs[TS > 0 ? TS : 1];
    if constexpr (TS > 0) {
#pragma unroll
      for (int u = 0; u < TS; ++u) vs[u] = load_view(u);
    }
    auto view = [&](int u) {
      if constexpr (TS > 0) {
        return vs[u];
      } else {
        return load_view(u);
      }
    };
    // this thread's own anchor word; the words with a position (live)
    // are handed to the first threads, so that the warps that cover
    // positions are full
    const sj::View av = load_view(anchor);
    const int64_t ia = tl.i0 + threadIdx.x;
    const bool active = ia < tl.i1;
    int32_t ha = 0;
    bool live_a = false;
    if (active) {
      ha = av.h[ia - av.base];
      live_a = win(ha, av.p[ia - av.base]) != 0;
    }
    const unsigned live_m = __ballot_sync(0xffffffffu, live_a);
    int slot = 0;
    if (lane == 0 && live_m != 0) slot = atomicAdd(&live_n, __popc(live_m));
    slot = __shfl_sync(0xffffffffu, slot, 0)
           + __popc(live_m & ((1u << lane) - 1));
    if (live_a) live_idx[slot] = threadIdx.x;
    __syncthreads();
    const bool live = threadIdx.x < live_n;
    const int src = live ? live_idx[threadIdx.x] : 0;
    const int64_t i = tl.i0 + src;   // the word this thread covers
    int32_t h = 0, p = 0;
    if (live) {
      h = av.h[i - av.base];
      p = win(h, av.p[i - av.base]);
    }
    const int32_t blk = h & win.blk_mask;
    // the first word of term u's view whose header is >= h - c: a search
    // of the view, but in the anchor's own list among the c words before
    // this one
    auto first_at = [&](int u, const sj::View& v, int c) {
      if (u != anchor) return sj::lower_bound32(v.h, 0, v.n, h - c);
      const int32_t own = static_cast<int32_t>(i - v.base);
      return sj::lower_bound32(v.h, own > c ? own - c : 0, own, h - c);
    };
    const int S0 = LSB_BITS * C - w;      // the first start, a bit of lane 0
    const int L = w + LSB_BITS;           // starts per anchor word

    int covered = 0;
    if (live && WORDS) {
      // C = 1: each term's words at h - 1, h, h + 1 as one string of 54
      // bits; the starts that hold every term
      uint64_t ok_starts = ~0ull;
      for (int u = 0; u < T; ++u) {
        const sj::View v = view(u);
        int32_t idx = first_at(u, v, 1);
        uint64_t x = static_cast<uint32_t>(lane_word(v, idx, h - 1, blk - 1,
                                                     win));
        x |= static_cast<uint64_t>(lane_word(v, idx, h, blk, win))
             << LSB_BITS;
        x |= static_cast<uint64_t>(lane_word(v, idx, h + 1, blk + 1, win))
             << (2 * LSB_BITS);
        ok_starts &= present(x, w, static_cast<int>(mults[u]));
      }
      // position 18 + b is covered iff a start in [18 + b - w, 18 + b]
      // passed
      covered = __popcll(dilate_up(ok_starts, w + 1)
                         & (static_cast<uint64_t>(p) << LSB_BITS));
    } else if (live) {
      StateOf<TS> st;
      if constexpr (TS == 0) {
        st = ScratchState{scratch + tl.out_off + i, scratch_stride};
      }
      // every term's cursors at lane 0 (header h - C), and its count in
      // the first window [S0, S0 + w] = [S0, 18C]: lanes 0 .. C
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const sj::View v = view(u);
        int32_t idx = first_at(u, v, C);
        int32_t word = lane_word(v, idx, h - C, blk - C, win);
        st.at(u, TRAIL_IDX) = idx;
        st.at(u, TRAIL_WORD) = word;
        const int end = S0 + w + 1;
        int count = 0;
        for (int ln = 0, from = S0;; from = 0) {
          const int to = end - ln * LSB_BITS < LSB_BITS ? end - ln * LSB_BITS
                                                         : LSB_BITS;
          count += __popc(word & ((1 << to) - 1) & ~((1 << from) - 1));
          if (end <= (ln + 1) * LSB_BITS) break;
          ++ln;
          word = lane_word(v, idx, h - C + ln, blk - C + ln, win);
        }
        st.at(u, LEAD_IDX) = idx;
        st.at(u, LEAD_WORD) = word;
        st.at(u, NEED) = count - static_cast<int32_t>(mults[u]);
      }
      int last_ok = -1;
      int lane_l = 0, bit_l = S0;   // the leaving position s
      int lane_e = C, bit_e = 1;    // the entering position s + w + 1
      for (int si = 0; si < L; ++si) {
        bool ok = true;
#pragma unroll
        for (int u = 0; u < T; ++u) {
          ok = ok && st.at(u, NEED) >= 0;
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
#pragma unroll
        for (int u = 0; u < T; ++u) {
          if (fetch_l || fetch_e) {
            const sj::View v = view(u);
            if (fetch_l) {
              int32_t idx = st.at(u, TRAIL_IDX);
              st.at(u, TRAIL_WORD) = lane_word(v, idx, h - C + lane_l,
                                               blk - C + lane_l, win);
              st.at(u, TRAIL_IDX) = idx;
            }
            if (fetch_e) {
              int32_t idx = st.at(u, LEAD_IDX);
              st.at(u, LEAD_WORD) = lane_word(v, idx, h - C + lane_e,
                                              blk - C + lane_e, win);
              st.at(u, LEAD_IDX) = idx;
            }
          }
          st.at(u, NEED) += ((st.at(u, LEAD_WORD) >> bit_e) & 1)
                            - ((st.at(u, TRAIL_WORD) >> bit_l) & 1);
        }
        ++bit_l;
        ++bit_e;
      }
    }
    if (live) covered_s[src] = covered;
    __syncthreads();
    if (active) {
      keys_out[tl.out_off + ia] = tl.key_base + (ha >> blk_bits);
      counts_out[tl.out_off + ia] =
          static_cast<float>(live_a ? covered_s[threadIdx.x] : 0);
    }
  }
}

template <int TS, bool WORDS>
int launch(const void* hdrs, const void* pays, const void* meta, int64_t ld,
           int64_t n_tiles, int T, int anchor, int w, int blk_bits,
           const BlkWindow& win, bool vec, void* scratch,
           int64_t scratch_stride, void* keys, void* counts, int device,
           cudaStream_t stream) {
  auto* kernel = span_join_kernel<TS, WORDS>;
  const int S = T < SS_STAGED ? T : SS_STAGED;
  const size_t smem = static_cast<size_t>(4 * S * BUF) * sizeof(int32_t)
                      + 2 * T * sizeof(sj::Window);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t resident = 0;
  const cudaError_t err = sj::resident_blocks(kernel, SS_THREADS, smem,
                                              device, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = n_tiles < resident ? n_tiles : resident;
  kernel<<<static_cast<unsigned>(grid), SS_THREADS, smem, stream>>>(
      static_cast<const int32_t*>(hdrs), static_cast<const int32_t*>(pays),
      static_cast<const int64_t*>(meta), ld, n_tiles, T, anchor, w, blk_bits,
      win, static_cast<int>(vec), static_cast<int32_t*>(scratch),
      scratch_stride, static_cast<int32_t*>(keys),
      static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The anchor words a tile takes: the wrapper cuts each query's anchor list
// into tiles of this many words.
extern "C" int sa_span_sparse_tile() { return SS_THREADS; }

// The distinct terms whose walked-path state lives in registers; above
// it the kernel needs the scratch buffer.
extern "C" int sa_span_sparse_local_terms() { return SS_REG_TERMS; }

// Plain C entry for ctypes.  ``meta`` is a device int64 table: [2T + 3, ld]
// with one column for each of the ``ld`` queries (rows: per term its slice
// offset and length in ``hdrs``/``pays``; out_off into the outputs;
// key_base; tile_start, the query's first tile), then the T
// multiplicities, then ``n_tiles`` entries: each tile's query, in order.
// ``anchor`` is the column whose words are counted, ``w`` the window
// (query length + slop - 1).  ``words`` selects the 64-bit word path: the
// caller sets it only where w <= 18 and no multiplicity exceeds 2.
// ``scratch`` is an int32 [5 * T, scratch_stride] buffer, read and written
// only on the walked path when T exceeds sa_span_sparse_local_terms()
// (else it may be null); ``scratch_stride`` is at least the number of
// anchor words.  Persistent blocks run on ``stream``; nothing here
// synchronises.  Returns cudaGetLastError().
extern "C" int sa_span_sparse(const void* hdrs, const void* pays,
                              const void* meta, int64_t ld, int64_t n_tiles,
                              int T, int anchor, int w, int blk_bits,
                              int min_blk, int max_blk, int words,
                              void* scratch,
                              int64_t scratch_stride, void* keys,
                              void* counts, int device, void* stream) {
  const DeviceGuard guard(device);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const BlkWindow win{(1 << blk_bits) - 1, min_blk, max_blk};
  const bool vec = ((reinterpret_cast<uintptr_t>(hdrs)
                     | reinterpret_cast<uintptr_t>(pays)) & 15) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
#define SA_SPAN_ARGS hdrs, pays, meta, ld, n_tiles, T, anchor, w, blk_bits, \
    win, vec, scratch, scratch_stride, keys, counts, device, s
  if (words) return launch<0, true>(SA_SPAN_ARGS);
  switch (T) {
    case 1: return launch<1, false>(SA_SPAN_ARGS);
    case 2: return launch<2, false>(SA_SPAN_ARGS);
    case 3: return launch<3, false>(SA_SPAN_ARGS);
    case 4: return launch<4, false>(SA_SPAN_ARGS);
    default: return launch<0, false>(SA_SPAN_ARGS);
  }
#undef SA_SPAN_ARGS
}
