// The pipeline K7 (merge_step.cu) and K9 (span_sparse.cu) share: a sorted
// join of one posting list's tiles against neighbour lists, by persistent
// blocks over runs of tiles, each tile's words staged in shared memory by
// asynchronous copies while the block computes the tile before it.
//
//   * The grid is min(tiles, SMs x resident blocks).  Block b owns the
//     contiguous run of the launch's tiles [b T / G, (b + 1) T / G); a run
//     may cross from one query into the next.
//   * A tile's range in a neighbour list is the words whose headers lie in
//     [first - C, last + C] of the tile.  Entering a query, the block finds
//     it with the warp search of segmented.cuh.  After that the next tile's
//     range starts at most 2C words before this one's end (its first header
//     is above this tile's last, and headers are unique), so the block
//     stages a window of up to `cap` words from there: no search per tile.
//   * A window *covers* its tile when it holds every word of the list whose
//     header is at most last + C: it reaches the end of the list, or its
//     last header is at least last + C.  Then every lookup of the tile is a
//     shared-memory read, and the window's words above the range are never
//     matched.  Otherwise (a range above the window) the block finds the
//     exact range in device memory and the tile reads it there; the result
//     is the same.
//   * Copies are cp.async, 16 bytes each where every list's base pointer is
//     16-byte aligned (the window then starts at the aligned word at or
//     before its first word: `shift` words earlier), else 4 bytes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "segmented.cuh"

namespace sj {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Words a staged buffer holds beyond its window: the alignment shift
// before it and the rounding of its last 16-byte copy after it.
constexpr int PAD = 8;

// Where the window [s, s + n) of a list whose first word is word ``off``
// of its (16-byte aligned) tensor starts in its buffer.
__device__ __forceinline__ int shift_of(int64_t off, int64_t s, bool vec) {
  return vec ? static_cast<int>((off + s) & 3) : 0;
}

// All threads of the block: copy words [s, s + n) of ``list`` (whose first
// word is word ``off`` of an aligned tensor) into ``buf``, the window's
// first word at buf[shift_of(off, s, vec)].  Not committed.
__device__ __forceinline__ void stage(int32_t* buf, const int32_t* list,
                                      int64_t off, int64_t s, int64_t n,
                                      bool vec) {
  if (n <= 0) return;
  if (vec) {
    const int32_t* from = list + s - shift_of(off, s, vec);
    const int64_t chunks = (shift_of(off, s, vec) + n + 3) >> 2;
    for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x) {
      cp_async16(buf + 4 * c, from + 4 * c);
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      cp_async4(buf + i, list + s + i);
    }
  }
}

// The first index in [lo, hi) whose header is >= target (hi if none).
__device__ __forceinline__ int64_t lower_bound(const int32_t* h, int64_t lo,
                                               int64_t hi, int64_t target) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (h[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The block's run of tiles.
__device__ __forceinline__ void tile_run(int64_t n_tiles, int64_t& t0,
                                         int64_t& t1) {
  t0 = blockIdx.x * n_tiles / gridDim.x;
  t1 = (blockIdx.x + 1) * n_tiles / gridDim.x;
}

// One neighbour list as a tile sees it.
struct Window {
  int64_t off;          // the list's first word in its tensor (headers)
  int64_t pay_off;      // ... and in the payload tensor
  int64_t n_list;       // the list's length
  int64_t s;            // the window's first word, an index of the list
  int32_t n;            // words staged (0: none)
  int32_t h_shift, p_shift;
  int64_t r0, r1;       // r0 >= 0: the exact range, read in device memory
};

// Lane 0 of a warp: a window of up to ``cap`` words from ``s``.
__device__ __forceinline__ void open_window(Window& w, int64_t off,
                                            int64_t pay_off, int64_t n_list,
                                            int64_t s, int cap, bool vec) {
  w.off = off;
  w.pay_off = pay_off;
  w.n_list = n_list;
  w.s = s;
  const int64_t n = n_list - s < cap ? n_list - s : cap;
  w.n = static_cast<int32_t>(n > 0 ? n : 0);
  w.h_shift = shift_of(off, s, vec);
  w.p_shift = shift_of(pay_off, s, vec);
  w.r0 = -1;
  w.r1 = -1;
}

// Whether the staged window holds every word of the list up to header
// ``top`` (the tile's last + C).
__device__ __forceinline__ bool covers(const Window& w, const int32_t* hbuf,
                                       int64_t top) {
  return w.s + w.n >= w.n_list
         || (w.n > 0 && hbuf[w.h_shift + w.n - 1] >= top);
}

// A list's words as a tile reads them: headers and payloads of its range
// (or staged window), ``n`` words from list index ``base`` on.
struct View {
  const int32_t* h;
  const int32_t* p;
  int32_t n;
  int64_t base;
};

__device__ __forceinline__ View view_of(const Window& w, const int32_t* hbuf,
                                        const int32_t* pbuf,
                                        const int32_t* hdrs,
                                        const int32_t* pays) {
  if (w.r0 >= 0) {
    return View{hdrs + w.off + w.r0, pays + w.pay_off + w.r0,
                static_cast<int32_t>(w.r1 - w.r0), w.r0};
  }
  return View{hbuf + w.h_shift, pbuf + w.p_shift, w.n, w.s};
}

// The first index in [lo, hi) whose header is >= target (hi if none), in
// 32-bit indices (a window, or a range of a list).
__device__ __forceinline__ int32_t lower_bound32(const int32_t* h, int32_t lo,
                                                 int32_t hi, int64_t target) {
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (h[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The blocks of ``kernel`` that ``device`` holds at once: resident blocks
// an SM (occupancy API) times its SMs.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, int device,
                            int64_t& blocks) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  return err;
}

}  // namespace sj
