// K4: plane fill -- expand term posting slices into dense payload planes,
// rows of the plane pool.
//
// Replaces the plane section of the JAX package's pool-fill program
// (searcharray_tpu/search/dense.py:_fill_fn, the "p" sub-fill at
// :222-234): pool[slot] = zeros(NS).at[hdr32].set(pay32, mode="drop").
// XLA runs that as a zero pass over the row and then a scatter, one term
// per fori_loop iteration.  Here one launch fills every missing row of a
// batch:
//
//   * block (g, r) owns flat slots [g*TILE, g*TILE + TILE) of row r and
//     finds its word range in the term's doc-sorted slice with the warp
//     search of segmented.cuh
//     (hdr32 is the flat slot index doc << blk_bits | block, unique and
//     increasing within a term; words past the plane, such as PAD_HDR32,
//     fall outside every range and are dropped);
//   * its threads zero a TILE-slot tile in shared memory, store the
//     range's payloads into it, and write the whole tile, zeros
//     included, with coalesced stores.  No separate zero pass, no
//     atomics (slots are unique), deterministic.
//
// Bound on the card: the 4 bytes written per slot of each row (32 MB per
// row at 1M docs and 8 slots per doc), plus 8 bytes read per posting
// word, and one ~log33(n)-round warp search per block.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "segmented.cuh"

namespace {

constexpr int FILL_TILE = 4096;  // slots per block: 16 KB of shared memory
constexpr int FILL_THREADS = 256;

__global__ void __launch_bounds__(FILL_THREADS)
plane_fill_kernel(const int32_t* __restrict__ hdrs,
                  const int32_t* __restrict__ pays,
                  const int64_t* __restrict__ offs,
                  const int64_t* __restrict__ ns,
                  const int64_t* __restrict__ slots,
                  int32_t* __restrict__ pool, int64_t plane_size) {
  __shared__ int32_t tile[FILL_TILE];
  __shared__ int64_t range[2];

  const int64_t row = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * FILL_TILE;
  const int64_t p1 =
      p0 + FILL_TILE < plane_size ? p0 + FILL_TILE : plane_size;
  const int64_t off = offs[row];
  const int32_t* h = hdrs + off;
  const int32_t* p = pays + off;

  for (int i = threadIdx.x; i < FILL_TILE; i += blockDim.x) tile[i] = 0;
  sa::block_range(h, ns[row], 0, p0, p1, range);
  __syncthreads();

  const int64_t w_hi = range[1];
  for (int64_t w = range[0] + threadIdx.x; w < w_hi; w += blockDim.x) {
    tile[h[w] - p0] = p[w];
  }
  __syncthreads();

  int32_t* dst = pool + slots[row] * plane_size + p0;
  for (int i = threadIdx.x; i < p1 - p0; i += blockDim.x) dst[i] = tile[i];
}

}  // namespace

// Plain C entry for ctypes.  ``offs``/``ns``/``slots`` are device int64
// arrays of ``n_rows`` entries; ``pool`` is the int32 [C, plane_size]
// plane pool.  The kernel runs on ``stream`` and nothing here
// synchronises.  Returns cudaGetLastError().
extern "C" int sa_plane_fill(const void* hdrs, const void* pays,
                             const void* offs, const void* ns,
                             const void* slots, int64_t n_rows, void* pool,
                             int64_t plane_size, int device, void* stream) {
  const DeviceGuard guard(device);
  const int64_t tiles = (plane_size + FILL_TILE - 1) / FILL_TILE;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(n_rows));
  plane_fill_kernel<<<grid, FILL_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hdrs), static_cast<const int32_t*>(pays),
      static_cast<const int64_t*>(offs), static_cast<const int64_t*>(ns),
      static_cast<const int64_t*>(slots), static_cast<int32_t*>(pool),
      plane_size);
  return static_cast<int>(cudaGetLastError());
}
