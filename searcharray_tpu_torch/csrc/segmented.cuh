// Shared pieces of the two segmented-reduction kernels (score_term.cu,
// segment_sum.cu): each thread block owns DOCS_PER_BLOCK consecutive
// output slots and finds its word range in the key-sorted input by binary
// search, so blocks need no bounds array and no inter-block communication.
#pragma once

#include <cstdint>

namespace sa {

// Output slots per block.  One block of 256 threads reduces into a
// 4 KB shared-memory row; at 1M docs the grid is 977 blocks, about one
// resident wave on the H100's 132 SMs (8 blocks of 256 threads per SM).
constexpr int DOCS_PER_BLOCK = 1024;
constexpr int THREADS = 256;

// First index in [0, n) whose key (word >> shift) is >= target; keys are
// non-decreasing.  Reads ~log2(n) words, mostly from L2 after the first
// blocks touch the slice.
__device__ __forceinline__ int64_t lower_bound_key(const int32_t* words,
                                                   int64_t n, int shift,
                                                   int64_t target) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(words[mid] >> shift) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace sa
