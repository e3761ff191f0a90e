// K6: slop (sloppy phrase) coverage on dense planes -- per-doc counts of
// the anchor term's positions that lie in a window holding every query
// term often enough, for a group of queries, read from the plane pool.
//
// Replaces the JAX package's XLA program span_counts_dense_planes with
// _shift_posns_down, _shift_posns_up, _dilate and _win_pair_starts
// (searcharray_tpu/search/dense.py:576-648), which XLA runs as some tens
// of elementwise passes over the whole N*S plane per term.  This kernel
// reads each plane of a query once and keeps every intermediate in
// registers.
//
// Semantics, exactly as the JAX package computes them.  A plane is a bit
// string over the FLAT slot axis: slot j holds positions 18j .. 18j + 17,
// and nothing separates a doc's last slot from the next doc's first.
// With w = n + slop - 1 <= 18:
//
//   present_t(s) = some bit of term t in [s, s + w]       (multiplicity 1)
//                = two bits of term t in [s, s + w]       (multiplicity 2:
//                  OR over d = 1..w of x & (x >> d), dilated down over
//                  w + 1 - d starts)
//   ok(s)        = AND over the terms of present_t(s)
//   covered(p)   = OR of ok(s) over s in [p - w, p]
//   count(doc)   = popcount(anchor & covered) summed over the doc's S slots
//
// covered at a slot depends on the planes one slot before and one after
// it, no further (w <= 18).  So a slot's window of the bit string fits
// one 64-bit word: w bits of the slot before, the slot (or, where
// 2w + 36 <= 64, two slots), w bits of the slot after.  Every shift of
// the formulas is then a 64-bit shift, and the bits a shift drags in
// from outside the word never reach the counted bits.  Results are
// integers: equal to the plain version bit for bit.
//
// Bound on the card: the distinct planes of the launch read once (4 bytes
// a slot) and 4 bytes written per doc and query, against the integer
// operations of the dilations: a few tens per slot and term at
// multiplicity 1, some hundreds at multiplicity 2 and a wide window,
// where operations and not bytes bound it.
//
// Design: a warp owns 256 consecutive slots, 8 per lane, of every plane of
// every query of the group.  The slot before a lane's first and after its
// last come from the neighbouring lanes by shuffle; lanes 0 and 31 load
// theirs from memory, so a window needs no halo lanes.  The next plane is
// loaded before the current one is computed.  A doc of S <= 8 slots lies
// in one lane; up to S = 256 its lanes add up by shuffles; above that a
// warp lies inside one doc and adds its sum to the (zeroed) output with
// one atomic.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int LSB_BITS = 18;
constexpr uint32_t LSB = (1u << LSB_BITS) - 1;
constexpr int V = 8;           // slots per lane
constexpr int WARPS = 8;
constexpr int WINDOW = 32 * V; // slots per warp
constexpr int MAX_TERMS = 32;
constexpr unsigned FULL = 0xffffffffu;

struct SpanQuery {
  int T;                  // distinct terms
  int w;                  // window: n + slop - 1
  int anchor;             // the counted term's column
  int mult[MAX_TERMS];    // 1 or 2 per column
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

// Window starts s whose [s, s + w] holds at least `mult` bits of x.
__device__ __forceinline__ uint64_t present(uint64_t x, int w, int mult) {
  if (mult == 1) return dilate_down(x, w + 1);
  uint64_t ok = 0;
  for (int d = 1; d <= w; ++d) {
    ok |= dilate_down(x & (x >> d), w + 1 - d);
  }
  return ok;
}

// The lane's 8 slots of a plane, and for lanes 0 and 31 the slot before
// or after the warp's window; slots outside the plane read as zero.
__device__ __forceinline__ void load_plane(const int32_t* __restrict__ src,
                                           int64_t my, int64_t plane_size,
                                           bool vec16, int lane,
                                           uint32_t (&x)[V], uint32_t& edge) {
  if (vec16 && my + V <= plane_size) {
    const int4 lo = __ldg(reinterpret_cast<const int4*>(src + my));
    const int4 hi = __ldg(reinterpret_cast<const int4*>(src + my) + 1);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      x[v] = my + v < plane_size ? __ldg(src + my + v) : 0;
    }
  }
  edge = 0;
  if (lane == 0 && my > 0) edge = __ldg(src + my - 1);
  if (lane == 31 && my + V < plane_size) edge = __ldg(src + my + V);
}

// DPL: docs per lane (8 / S for S < 8, else 1).  M: slots per 64-bit word.
template <int DPL, int M>
__global__ void __launch_bounds__(WARPS * 32)
span_window_kernel(const int32_t* __restrict__ pool, int64_t plane_size,
                   const int32_t* __restrict__ slots, int n_queries,
                   const __grid_constant__ SpanQuery qr, int S,
                   int64_t n_windows, bool vec16, int64_t num_docs,
                   float* __restrict__ out, int64_t out_stride,
                   const int64_t* __restrict__ out_rows) {
  constexpr int NW = V / M;  // words per lane
  const int lane = threadIdx.x & 31;
  const int64_t window =
      static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (window >= n_windows) return;  // whole warps only
  const int64_t my = window * WINDOW + lane * V;
  const int T = qr.T, w = qr.w;
  const int total = n_queries * T;
  const int G = S <= V ? 1 : (S / V < 32 ? S / V : 32);  // lanes per doc

  uint32_t cur[V], nxt[V] = {}, cur_edge, nxt_edge = 0;
  load_plane(pool + static_cast<int64_t>(__ldg(slots)) * plane_size, my,
             plane_size, vec16, lane, cur, cur_edge);
  int li = 0;  // the load in cur: query li / T, column li % T
  for (int q = 0; q < n_queries; ++q) {
    uint64_t ok[NW], anc[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      ok[i] = ~0ull;
      anc[i] = 0;
    }
    for (int t = 0; t < T; ++t, ++li) {
      if (li + 1 < total) {
        load_plane(pool + static_cast<int64_t>(__ldg(slots + li + 1)) *
                              plane_size,
                   my, plane_size, vec16, lane, nxt, nxt_edge);
      }
      uint32_t prev = __shfl_up_sync(FULL, cur[V - 1], 1);
      uint32_t next = __shfl_down_sync(FULL, cur[0], 1);
      if (lane == 0) prev = cur_edge;
      if (lane == 31) next = cur_edge;
      const int mult = qr.mult[t];
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        // w bits of the slot before, M slots, the slot after
        const uint32_t before = i == 0 ? prev : cur[M * i - 1];
        const uint32_t after = i == NW - 1 ? next : cur[M * i + M];
        uint64_t word = static_cast<uint64_t>(before) >> (LSB_BITS - w) |
                        static_cast<uint64_t>(cur[M * i]) << w;
        if (M == 2) {
          word |= static_cast<uint64_t>(cur[M * i + M - 1]) << (w + LSB_BITS);
        }
        word |= static_cast<uint64_t>(after) << (w + M * LSB_BITS);
        ok[i] &= present(word, w, mult);
        if (t == qr.anchor) anc[i] = word;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) cur[v] = nxt[v];
      cur_edge = nxt_edge;
    }
    int cnt[V];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint64_t hit = (anc[i] & dilate_up(ok[i], w + 1)) >> w;
      cnt[M * i] = __popc(static_cast<uint32_t>(hit) & LSB);
      if (M == 2) {
        cnt[M * i + M - 1] =
            __popc(static_cast<uint32_t>(hit >> LSB_BITS) & LSB);
      }
    }
    const int64_t row = out_rows ? out_rows[q] : q;
    float* dst = out + row * out_stride;
    const int64_t d0 = my / S;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int sum = 0;
#pragma unroll
      for (int v = j * (V / DPL); v < (j + 1) * (V / DPL); ++v) sum += cnt[v];
      for (int o = 1; o < G; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
      if ((lane & (G - 1)) == 0 && d0 + j < num_docs) {
        if (S > WINDOW) {
          if (sum) atomicAdd(dst + d0, static_cast<float>(sum));
        } else {
          dst[d0 + j] = static_cast<float>(sum);
        }
      }
    }
  }
}

template <int DPL, int M>
int launch(const int32_t* pool, int64_t plane_size, const int32_t* slots,
           int n_queries, const SpanQuery& qr, int S, int64_t num_docs,
           float* out, int64_t out_stride, const int64_t* out_rows,
           cudaStream_t stream) {
  const int64_t n_windows = (plane_size + WINDOW - 1) / WINDOW;
  const int64_t blocks = (n_windows + WARPS - 1) / WARPS;
  const bool vec16 = plane_size % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  span_window_kernel<DPL, M><<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                               stream>>>(pool, plane_size, slots, n_queries,
                                         qr, S, n_windows, vec16, num_docs,
                                         out, out_stride, out_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  ``slots`` is a device int32 [n_queries, T]
// array of plane-pool rows, ``mults`` a HOST int32 [T] array of 1s and
// 2s.  Row q of the result goes to out[out_rows[q]] (out_rows a device
// int64 array) or to out[q] when out_rows is null; rows are
// ``out_stride`` floats apart.  Where a doc has more than 256 slots
// (blk_bits > 8) the kernel ADDS into the rows, which the caller has
// zeroed.  The kernel runs on ``stream`` and nothing here synchronises.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a query the
// kernel does not take.
extern "C" int sa_span_window(const void* pool, int64_t plane_size,
                              const void* slots, int64_t n_queries, int T,
                              int w, int anchor, const int32_t* mults,
                              int64_t num_docs, int blk_bits, void* out,
                              int64_t out_stride, const void* out_rows,
                              int device, void* stream) {
  if (T < 1 || T > MAX_TERMS || w < 1 || w > LSB_BITS || anchor < 0 ||
      anchor >= T || blk_bits < 0 || blk_bits > 18) {
    return cudaErrorInvalidValue;
  }
  SpanQuery qr{};
  qr.T = T;
  qr.w = w;
  qr.anchor = anchor;
  for (int t = 0; t < T; ++t) {
    if (mults[t] < 1 || mults[t] > 2) return cudaErrorInvalidValue;
    qr.mult[t] = mults[t];
  }
  const DeviceGuard guard(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* pl = static_cast<const int32_t*>(pool);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  float* o = static_cast<float*>(out);
  const int64_t* rows = static_cast<const int64_t*>(out_rows);
  const int nq = static_cast<int>(n_queries);
  const int S = 1 << blk_bits;
  // two slots share a word where 2w + 36 bits fit it
  const bool two = 2 * w + 2 * LSB_BITS <= 64;
#define SA_SPAN(DPL)                                                        \
  return two ? launch<DPL, 2>(pl, plane_size, sl, nq, qr, S, num_docs, o,   \
                              out_stride, rows, st)                         \
             : launch<DPL, 1>(pl, plane_size, sl, nq, qr, S, num_docs, o,   \
                              out_stride, rows, st)
  switch (S) {
    case 1: SA_SPAN(8);
    case 2: SA_SPAN(4);
    case 4: SA_SPAN(2);
    default: SA_SPAN(1);
  }
#undef SA_SPAN
}
