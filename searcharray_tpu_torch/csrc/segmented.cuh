// The search of the segmented kernels (score_term.cu, plane_fill.cu):
// each thread block owns a run of consecutive output slots and finds its
// word range in the key-sorted input, so blocks need no bounds array and
// no inter-block communication.  segment_sum.cu searches its merge path
// with the same probes in 32-bit.
#pragma once

#include <cstdint>

namespace sa {

// Probes of a round cut the candidates [a, b] into P + 1 parts of
// ``step`` = ceil((b - a + 1) / (P + 1)) candidates: probe j is the last
// candidate of part j, at most b - 1.  A probe below a is below every
// answer, so its key counts as below the target.  P is 32 or 16, so the
// one division per round is by a constant.
__device__ __forceinline__ int64_t step_of(int64_t a, int64_t b, int P) {
  const uint64_t span = static_cast<uint64_t>(b - a + 1);
  return static_cast<int64_t>(P == 32 ? (span + 32) / 33 : (span + 16) / 17);
}

__device__ __forceinline__ int64_t probe_at(int64_t a, int64_t b,
                                            int64_t step, int j) {
  const int64_t p = a - 1 + (j + 1) * step;
  return p < b - 1 ? p : b - 1;
}

// The answer lies in [a, b] and c of the P probes of that interval had a
// key below the target: it now lies between the last of them and the
// next.
__device__ __forceinline__ void narrow(int64_t& a, int64_t& b, int c, int P) {
  const int64_t step = step_of(a, b, P);
  const int64_t na = c == 0 ? a : probe_at(a, b, step, c - 1) + 1;
  b = c == P ? b : probe_at(a, b, step, c);
  a = na;
}

// The first index in [0, n) whose key (word >> shift) is >= t0, and the
// same for t1 >= t0 (n where there is none); keys are non-decreasing.
// All 32 lanes of one warp call it and all get both results.
//
// A round probes P points that cut an interval of candidates into P + 1
// parts, one global load per lane, and __ballot_sync counts the probes
// whose key is below the target; it divides by no variable (a 64-bit
// division by one is dozens of dependent instructions on the card).
// While both answers lie in one interval the 32 lanes probe it together
// for both targets (P = 32); once they part, lanes 0-15 and 16-31 probe
// one interval each (P = 16).  So a search takes about log33(n)
// dependent rounds: 2 for ~1,000 words, 5 for ~3M, where one thread's
// binary search took log2(n), 10 and 22.
__device__ __forceinline__ void warp_bounds(const int32_t* __restrict__ words,
                                            int64_t n, int shift, int64_t t0,
                                            int64_t t1, int64_t& r0,
                                            int64_t& r1) {
  const int lane = threadIdx.x & 31;
  // answer k lies in [a_k, b_k]; b_k = n means "no such key"
  int64_t a0 = 0, b0 = n, a1 = 0, b1 = n;
  while (a0 < b0 || a1 < b1) {
    const bool joint = a0 == a1 && b0 == b1;
    const int P = joint ? 32 : 16;
    const bool second = !joint && lane >= 16;
    const int64_t a = second ? a1 : a0, b = second ? b1 : b0;
    const int64_t p = probe_at(a, b, step_of(a, b, P),
                               joint ? lane : (lane & 15));
    bool lt0 = true, lt1 = true;
    if (p >= a) {
      const int64_t key = static_cast<int64_t>(words[p] >> shift);
      lt0 = key < t0;
      lt1 = key < t1;
    }
    const unsigned m0 = __ballot_sync(0xffffffffu, lt0);
    const unsigned m1 = __ballot_sync(0xffffffffu, lt1);
    narrow(a0, b0, __popc(joint ? m0 : (m0 & 0xffffu)), P);
    narrow(a1, b1, __popc(joint ? m1 : (m1 >> 16)), P);
  }
  r0 = a0;
  r1 = a1;
}

// Warp 0 of the block finds the block's word range [range[0], range[1])
// of keys in [t0, t1) and stores it in shared memory; the caller
// synchronises the block before reading it.
__device__ __forceinline__ void block_range(const int32_t* __restrict__ words,
                                            int64_t n, int shift, int64_t t0,
                                            int64_t t1, int64_t* range) {
  if (threadIdx.x < 32) {
    int64_t r0, r1;
    warp_bounds(words, n, shift, t0, t1, r0, r1);
    if (threadIdx.x == 0) {
      range[0] = r0;
      range[1] = r1;
    }
  }
}

}  // namespace sa
