// K2: sorted segment-sum -- dense out[d] = sum of values[i] over
// sorted_ids[i] == d; ids >= num_out (the 2^30 pad) are dropped.
//
// Replaces the TPU kernel segment_sum_pallas
// (searcharray_tpu/ops/pallas/score.py:196, body _segsum_kernel at :166),
// which reduces each word tile with a one-hot compare-and-sum for want of
// a fast scatter on the TPU.  Here it is the same segmented reduction as
// K1 (score_term.cu): block g owns slots [g*D, g*D + D), finds its run
// of ids with the warp search of segmented.cuh, strides over it with
// coalesced loads and adds into a float row in shared memory, then writes
// each slot once.
//
// Many ids of one slot in a row (a long document holds thousands of one
// term's words) make every lane of a warp add into the same shared float,
// and those adds serialise: with one atomic per id, 11,072 ids of one
// slot took 0.34 ms on an H100.  So each warp first sums its runs of
// equal ids with shuffles (warp_run_sum) and adds one value per run.
//
// Shared-memory float atomics land in no fixed order, so a sum of
// arbitrary floats may differ from a sequential sum in the last bits
// (tolerance rtol 1e-5).  The batched term group feeds integer-valued
// popcounts, whose float sums are exact below 2^24 in any order.
//
// Bound on the card: the 8 bytes of id + value read per input element,
// plus 4 bytes written per output slot.

#include <cuda_runtime.h>

#include <cstdint>

#include "segmented.cuh"

namespace {

// Output slots per block.  One block of 256 threads reduces into a
// 4 KB shared-memory row.
constexpr int DOCS_PER_BLOCK = 1024;
constexpr int THREADS = 256;

// Lanes hold non-decreasing keys.  Afterwards the first lane of each run
// of equal keys holds the run's sum of v, and the call returns true
// there.  All 32 lanes of the warp must call it.
__device__ __forceinline__ bool warp_run_sum(int key, float& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float nv = __shfl_down_sync(0xffffffffu, v, o);
    const int nk = __shfl_down_sync(0xffffffffu, key, o);
    // keys are sorted: an equal key o lanes on means one run in between
    if (lane + o < 32 && nk == key) v += nv;
  }
  // every lane must take part in the shuffle, lane 0 included
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  return lane == 0 || prev != key;
}

__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const int32_t* __restrict__ ids,
                   const float* __restrict__ values, int64_t m,
                   float* __restrict__ out, int64_t num_out) {
  __shared__ float acc[DOCS_PER_BLOCK];
  __shared__ int64_t range[2];

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * DOCS_PER_BLOCK;
  const int64_t d1 = d0 + DOCS_PER_BLOCK < num_out
                         ? d0 + DOCS_PER_BLOCK
                         : num_out;
  for (int i = threadIdx.x; i < DOCS_PER_BLOCK; i += blockDim.x) {
    acc[i] = 0.0f;
  }
  sa::block_range(ids, m, 0, d0, d1, range);
  __syncthreads();

  // a warp-uniform trip count, so every lane takes part in the shuffles;
  // lanes past the range form a run of their own above every slot
  const int lane = threadIdx.x & 31;
  const int64_t hi = range[1];
  for (int64_t base = range[0] + (threadIdx.x - lane); base < hi;
       base += blockDim.x) {
    const int64_t i = base + lane;
    const int slot =
        i < hi ? static_cast<int>(ids[i] - d0) : DOCS_PER_BLOCK;
    float v = i < hi ? values[i] : 0.0f;
    if (warp_run_sum(slot, v) && v != 0.0f) atomicAdd(&acc[slot], v);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < d1 - d0; i += blockDim.x) out[d0 + i] = acc[i];
}

}  // namespace

// Plain C entry for ctypes (see sa_score_term).  Returns
// cudaGetLastError().
extern "C" int sa_segment_sum(const void* ids, const void* values, int64_t m,
                              void* out, int64_t num_out, int device,
                              void* stream) {
  cudaSetDevice(device);
  const int64_t grid = (num_out + DOCS_PER_BLOCK - 1) / DOCS_PER_BLOCK;
  segment_sum_kernel<<<static_cast<unsigned>(grid), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(values), m,
      static_cast<float*>(out), num_out);
  return static_cast<int>(cudaGetLastError());
}
