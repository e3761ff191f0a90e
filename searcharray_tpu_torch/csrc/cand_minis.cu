// K8b: mini-planes -- each query term's payload slots at the query's
// candidate rows only, as one pool of int32 [queries * terms, Kc << blk_bits]
// rows that the phrase chain (K5) and the slop window (K6) take as they
// take the plane pool, with num_docs = Kc.
//
// Replaces the JAX package's searcharray_tpu/search/candidates.py
// minis_for_rows (:258) and the rows= plane gathers of its dense group
// bodies (searcharray_tpu/search/dense.py:735-739, 784-788).  There a term
// with a pooled plane is a gather pool[slot, rows * S + s]; any other term
// is a searchsorted (or a doc -> candidate map) of its posting slice's doc
// keys into the row table, then a scatter of the payloads into a zeroed
// mini.  Here one launch builds every mini of a chunk; block b owns one
// tile of one (query, term) row: TILE slots, TILE / S candidates:
//
//   * a pool term copies its tile: slot e reads pool[slot][row(e / S) * S +
//     e % S], the row clipped to [0, N) (a sentinel row N reads the last
//     doc's slots).  At S = 8 a candidate is one 32-byte sector;
//   * a term of its own slice zeroes its tile, finds with the warp search
//     of segmented.cuh the words whose doc key lies between the tile's
//     first and last rows, and for each of them a lower bound of its key
//     among the tile's rows; on a hit it stores the payload at candidate
//     << blk_bits | block.  Headers are unique within a term, so no two
//     words store to one slot, and the block's own barrier orders its
//     zeroes before its stores.  The rows of such a query ascend, so a
//     key equal to some row lies in exactly one tile's range.
//
// Bound on the card: each mini slot written once (4 bytes), the pooled
// slots read once, each posting word in the rows' range read once (8
// bytes), the row table read.  A miss costs its search and no store.
//
// Design for the H100.  A block owns MINI_TILE (1,024) slots with
// MINI_THREADS (128) threads: the forced cphrase unit (two minis of
// 131,072 slots) is 256 blocks, all resident at once on 132 SMs, each
// thread with two 16-byte copies in flight.  (2,048-slot tiles, 256 or 64
// threads a block and 512-slot tiles measured no faster on that unit;
// scripts/k3_probe.py times such variants.)  The block loads its tile's
// rows (TILE / S int32) into shared memory with one coalesced load,
// issued beside its mini's slot, offset and length; both halves read rows
// from there:
//
//   * pooled: at S >= 4 a thread copies 16 bytes (4 slots of one
//     candidate; two threads a candidate at S = 8, one 32-byte sector)
//     with up to MINI_LOAD (4) of them in flight before it stores any;
//     scalar 4-byte copies below S = 4;
//   * own slice: 16-byte zero stores; warp 0 finds the tile's word range
//     (skipped for an empty slice); a binary search of each word's doc
//     key over the shared rows, its payload loaded beside its header.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "segmented.cuh"

namespace {

constexpr int MINI_THREADS = 128;
constexpr int64_t MINI_TILE = 1024;  // slots per block (at least one doc's)
constexpr int MINI_LOAD = 4;         // copies in flight a thread

__device__ __forceinline__ int32_t clip_row(int32_t r, int32_t num_docs) {
  return r < 0 ? 0 : (r >= num_docs ? num_docs - 1 : r);
}

// ``vec`` bit 0: 16-byte stores into the mini (its width a multiple of 4
// slots); bit 1: 16-byte pool reads too (S >= 4, pool rows aligned).
__global__ void __launch_bounds__(MINI_THREADS)
cand_minis_kernel(const int32_t* __restrict__ rows, int64_t rows_stride,
                  int64_t kc, const int64_t* __restrict__ meta,
                  int64_t n_minis, int terms, const int32_t* __restrict__ pool,
                  int64_t plane_size, const int32_t* __restrict__ hdrs,
                  const int32_t* __restrict__ pays, int32_t num_docs,
                  int blk_bits, int64_t tile, int64_t tiles, int vec,
                  int32_t* __restrict__ out) {
  __shared__ int32_t rs[MINI_TILE];  // the tile's rows
  __shared__ int64_t range[2];

  const int t = threadIdx.x;
  const int64_t mi = static_cast<int64_t>(blockIdx.x) / tiles;
  const int64_t width = kc << blk_bits;
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) % tiles) * tile;
  const int64_t e1 = e0 + tile < width ? e0 + tile : width;
  const int64_t c0 = e0 >> blk_bits;  // candidates [c0, c0 + nc)
  const int nc = static_cast<int>((e1 >> blk_bits) - c0);
  const int32_t* rq = rows + (mi / terms) * rows_stride + c0;
  // the mini's slot, slice offset and length, loaded beside its rows
  const int64_t slot = meta[mi];
  const int64_t off = meta[n_minis + mi];
  const int64_t n = meta[2 * n_minis + mi];
  for (int c = t; c < nc; c += MINI_THREADS) rs[c] = rq[c];
  int32_t* o = out + mi * width;
  const int64_t s_mask = (int64_t{1} << blk_bits) - 1;
  __syncthreads();

  if (slot >= 0) {
    const int32_t* src = pool + slot * plane_size;
    auto from = [&](int64_t e) {  // the pool slot of mini slot e
      const int32_t r = clip_row(rs[(e >> blk_bits) - c0], num_docs);
      return (static_cast<int64_t>(r) << blk_bits) | (e & s_mask);
    };
    if (vec & 2) {
      const int64_t u0 = e0 >> 2, nu = (e1 - e0) >> 2;
      int4* o4 = reinterpret_cast<int4*>(o) + u0;
      for (int64_t base = 0; base < nu; base += MINI_LOAD * MINI_THREADS) {
        int4 v[MINI_LOAD];
#pragma unroll
        for (int u = 0; u < MINI_LOAD; ++u) {
          const int64_t j = base + u * MINI_THREADS + t;
          if (j < nu) {
            v[u] = __ldg(reinterpret_cast<const int4*>(src + from(e0 + 4 * j)));
          }
        }
#pragma unroll
        for (int u = 0; u < MINI_LOAD; ++u) {
          const int64_t j = base + u * MINI_THREADS + t;
          if (j < nu) o4[j] = v[u];
        }
      }
    } else {
      for (int64_t base = e0; base < e1; base += MINI_LOAD * MINI_THREADS) {
        int32_t v[MINI_LOAD];
#pragma unroll
        for (int u = 0; u < MINI_LOAD; ++u) {
          const int64_t e = base + u * MINI_THREADS + t;
          if (e < e1) v[u] = __ldg(src + from(e));
        }
#pragma unroll
        for (int u = 0; u < MINI_LOAD; ++u) {
          const int64_t e = base + u * MINI_THREADS + t;
          if (e < e1) o[e] = v[u];
        }
      }
    }
    return;
  }

  if (vec & 1) {
    int4* o4 = reinterpret_cast<int4*>(o + e0);
    for (int64_t j = t; j < (e1 - e0) >> 2; j += MINI_THREADS) {
      o4[j] = make_int4(0, 0, 0, 0);
    }
  } else {
    for (int64_t e = e0 + t; e < e1; e += MINI_THREADS) o[e] = 0;
  }
  const int32_t* h = hdrs + off;
  if (n == 0) {
    if (t == 0) range[0] = range[1] = 0;
  } else {
    sa::block_range(h, n, blk_bits, rs[0],
                    static_cast<int64_t>(rs[nc - 1]) + 1, range);
  }
  __syncthreads();  // the range is read, and the zeroes precede the stores

  const int64_t w_hi = range[1];
  for (int64_t w = range[0] + t; w < w_hi; w += MINI_THREADS) {
    const int32_t hw = h[w];
    const int32_t pay = pays[off + w];  // loaded beside its header
    const int32_t key = hw >> blk_bits;
    int lo = 0, hi = nc;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rs[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < nc && rs[lo] == key) {
      o[((c0 + lo) << blk_bits) | (hw & s_mask)] = pay;
    }
  }
}

}  // namespace

// Plain C entry for ctypes.  ``rows`` holds the row tables, query q's at
// ``q * rows_stride`` (0: one table for all); ``meta`` is a device int64
// array: the pool slot of each of the ``n_minis`` (query, term) minis (-1
// for a term of its own slice), their slice offsets, then their lengths.
// ``out`` is int32 [n_minis, kc << blk_bits].  The kernel runs on
// ``stream`` and nothing here synchronises.  Returns cudaGetLastError().
extern "C" int sa_cand_minis(const void* rows, int64_t rows_stride,
                             int64_t kc, const void* meta, int64_t n_minis,
                             int terms, const void* pool, int64_t plane_size,
                             const void* hdrs, const void* pays,
                             int num_docs, int blk_bits, void* out,
                             int device, void* stream) {
  const DeviceGuard guard(device);
  const int64_t width = kc << blk_bits;
  const int64_t slots = int64_t{1} << blk_bits;
  const int64_t tile = slots > MINI_TILE ? slots : MINI_TILE;
  const int64_t tiles = (width + tile - 1) / tile;
  const bool vec_out =
      width % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vec_pool =
      vec_out && blk_bits >= 2 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  cand_minis_kernel<<<static_cast<unsigned>(n_minis * tiles), MINI_THREADS,
                      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), rows_stride, kc,
      static_cast<const int64_t*>(meta), n_minis, terms,
      static_cast<const int32_t*>(pool), plane_size,
      static_cast<const int32_t*>(hdrs), static_cast<const int32_t*>(pays),
      num_docs, blk_bits, tile, tiles, (vec_out ? 1 : 0) | (vec_pool ? 2 : 0),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
