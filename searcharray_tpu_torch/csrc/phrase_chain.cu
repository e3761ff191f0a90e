// K5: the bigram chain of exact phrases on dense planes -- per-doc phrase
// freqs of a group of queries, read straight from the plane pool.
//
// Replaces the JAX package's XLA chain phrase_counts_dense_planes /
// _dense_chain / _same_counts_dense (searcharray_tpu/search/dense.py:
// 494-570).  XLA runs each chain step as ~10 elementwise passes over the
// whole N*S plane, plus a slot-sum and a min per step.  This kernel reads
// each plane of a query once per block range and keeps every
// intermediate in shared memory.
//
// Semantics, exactly as the JAX package computes them (per slot s of the
// flat N*S axis, LSB = 18 bits, TOP = bit 17):
//
//   l2r step:  inner = L & (R >> 1);  a = (L[s-1] >> TOP) & R & 1
//              count = popc(inner) + a;  carry = ((inner << 1) & LSB) | a
//   r2l step:  ov = L & (R >> 1);  a = (L >> TOP) & R[s+1] & 1
//              count = popc(ov) + a;  carry = ov | a << TOP
//   same-term first step (equal pattern tags): the adjusted run count
//              popc(ov) - ceil(popc(ov & ov << 1 & LSB) / 2), ov = X & (X
//              << 1) & LSB, plus the same cross-slot adjacency on X alone.
//
// L[s-1] and R[s+1] are shifts over the FLAT axis: slot 0 of doc d reads
// the last slot of doc d-1 and zero at s = -1 or s = N*S.  Each doc's S
// slots are summed per step, and a doc's freq is the minimum over every
// step of every half of the plan.
//
// Design.  Block (g, q) owns docs [g*D, g*D + D) of query q, D*S = TILE
// slots (or one doc cut into TILE-slot pieces when S > TILE).  Step k of
// a half reads the carry of step k-1 one slot over, so an error in the
// first slot of a window travels one slot per step: the block loads a
// window of HALO >= steps extra slots before its range (l2r) or after it
// (r2l), runs every step over the whole window, and counts only its own
// slots.  No halo exchange between blocks.  Per step: one coalesced load
// of the step's plane into shared memory, one pass that computes counts
// and the next carry (double-buffered), a segmented warp-shuffle sum of
// each doc's slots into a shared per-doc sum, and a min into the per-doc
// result.  Counts are integers: the result equals the plain version bit
// for bit.
//
// Bound on the card: the T planes of each query, 4 bytes per slot each
// (128 MB for a 4-term phrase at 1M docs, 8 slots per doc), plus 1.6%
// halo, and 4 bytes written per doc.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_TERMS = 32;      // cap on the terms of one half
constexpr int HALO = 32;           // >= MAX_TERMS - 1 steps; warp-aligned
constexpr int TILE = 2048;         // counted slots per block pass
constexpr int WIN = TILE + HALO;   // window slots in shared memory
constexpr int THREADS = 256;
constexpr int LSB = (1 << 18) - 1;
constexpr int TOP = 17;
constexpr int BIG = 0x7fffffff;

struct ChainPlan {
  int n_halves;
  int dir[2];               // 0: l2r, 1: r2l
  int len[2];               // terms in the half (>= 2)
  int term[2][MAX_TERMS];   // column in the query's row of plane slots
  int tag[2][MAX_TERMS];    // same-term pattern tag of that column
};

__device__ __forceinline__ void load_window(const int32_t* __restrict__ src,
                                            int32_t* dst, int64_t base,
                                            int W, int64_t plane_size) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int64_t s = base + w;
    dst[w] = (s >= 0 && s < plane_size) ? src[s] : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
phrase_chain_kernel(const int32_t* __restrict__ pool, int64_t plane_size,
                    const int32_t* __restrict__ slots, int T,
                    const ChainPlan plan, int64_t num_docs, int blk_bits,
                    float* __restrict__ out, int64_t out_stride,
                    const int64_t* __restrict__ out_rows) {
  __shared__ int32_t carry[2][WIN];
  __shared__ int32_t plane[WIN];
  __shared__ int32_t stepsum[TILE];   // per doc of the block
  __shared__ int32_t result[TILE];    // per doc: min over steps so far
  __shared__ int32_t acc[2 * MAX_TERMS];  // per step, when S > TILE

  const int S = 1 << blk_bits;
  const int lane = threadIdx.x & 31;
  const int group = S < 32 ? S : 32;  // lanes of one doc within a warp
  const int64_t dpb = S >= TILE ? 1 : TILE / S;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * dpb;
  const int64_t d1 = d0 + dpb < num_docs ? d0 + dpb : num_docs;
  const int nd = static_cast<int>(d1 - d0);
  const int n_sub = S > TILE ? S / TILE : 1;
  const int32_t* qslots = slots + static_cast<int64_t>(blockIdx.y) * T;

  for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
    stepsum[i] = 0;
    result[i] = BIG;
  }
  if (threadIdx.x < 2 * MAX_TERMS) acc[threadIdx.x] = 0;
  __syncthreads();

  int n_steps = 0;
  for (int sub = 0; sub < n_sub; ++sub) {
    // counted slots [u0, u1); u0 is a multiple of TILE, so every window
    // base below is warp-aligned and each doc's lanes share one warp
    const int64_t u0 = (d0 << blk_bits) + static_cast<int64_t>(sub) * TILE;
    const int64_t u1 = n_sub > 1 ? u0 + TILE : (d1 << blk_bits);
    const int W = static_cast<int>(u1 - u0) + HALO;
    const int Wpad = (W + 31) & ~31;
    n_steps = 0;
    for (int h = 0; h < plan.n_halves; ++h) {
      const bool l2r = plan.dir[h] == 0;
      const int len = plan.len[h];
      const int64_t base = l2r ? u0 - HALO : u0;
      int cur = 0;
      for (int k = 0; k < len - 1; ++k) {
        // the plane this step reads, and its neighbour in the half
        const int i = l2r ? k + 1 : len - 2 - k;
        const int j = l2r ? i - 1 : i + 1;
        const bool same = k == 0 && plan.tag[h][i] == plan.tag[h][j];
        if (k == 0 && !same) {
          load_window(pool + static_cast<int64_t>(qslots[plan.term[h][j]]) *
                                 plane_size,
                      carry[cur], base, W, plane_size);
        }
        load_window(pool + static_cast<int64_t>(qslots[plan.term[h][i]]) *
                               plane_size,
                    plane, base, W, plane_size);
        __syncthreads();

        const int32_t* c = carry[cur];
        int32_t* nc_out = carry[cur ^ 1];
        for (int w = threadIdx.x; w < Wpad; w += blockDim.x) {
          int cnt = 0;
          if (w < W) {
            const int x = plane[w];  // R (l2r) or L (r2l)
            int nc;
            if (l2r) {
              if (same) {
                const int prev = w > 0 ? plane[w - 1] : 0;
                const int ov = x & ((x << 1) & LSB);
                const int consec = __popc(ov & (ov << 1) & LSB);
                const int a = (prev >> TOP) & x & 1;
                cnt = __popc(ov) - ((consec + 1) >> 1) + a;
                nc = ov | a;
              } else {
                const int L = c[w];
                const int prev = w > 0 ? c[w - 1] : 0;
                const int inner = L & (x >> 1);
                const int a = (prev >> TOP) & x & 1;
                cnt = __popc(inner) + a;
                nc = ((inner << 1) & LSB) | a;
              }
            } else {
              if (same) {
                const int next = w + 1 < W ? plane[w + 1] : 0;
                const int ov = x & ((x << 1) & LSB);
                const int consec = __popc(ov & (ov << 1) & LSB);
                const int a = (x >> TOP) & next & 1;
                cnt = __popc(ov) - ((consec + 1) >> 1) + a;
                nc = (x & (x >> 1)) | (a << TOP);
              } else {
                const int R = c[w];
                const int next = w + 1 < W ? c[w + 1] : 0;
                const int ov = x & (R >> 1);
                const int a = (x >> TOP) & next & 1;
                cnt = __popc(ov) + a;
                nc = ov | (a << TOP);
              }
            }
            nc_out[w] = nc;
          }
          // sum each doc's slots: groups of `group` lanes hold one doc
          for (int o = 1; o < group; o <<= 1) {
            cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
          }
          const bool counted = l2r ? (w >= HALO && w < W)
                                   : (w < W - HALO);
          if (counted && (lane & (group - 1)) == 0 && cnt != 0) {
            atomicAdd(&stepsum[((base + w) >> blk_bits) - d0], cnt);
          }
        }
        __syncthreads();

        if (n_sub == 1) {
          for (int d = threadIdx.x; d < nd; d += blockDim.x) {
            result[d] = min(result[d], stepsum[d]);
            stepsum[d] = 0;
          }
        } else if (threadIdx.x == 0) {
          acc[n_steps] += stepsum[0];
          stepsum[0] = 0;
        }
        __syncthreads();
        cur ^= 1;
        ++n_steps;
      }
    }
  }

  if (n_sub > 1 && threadIdx.x == 0) {
    int m = BIG;
    for (int k = 0; k < n_steps; ++k) m = min(m, acc[k]);
    result[0] = m;
  }
  __syncthreads();
  const int64_t row = out_rows ? out_rows[blockIdx.y] : blockIdx.y;
  float* dst = out + row * out_stride + d0;
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    dst[d] = static_cast<float>(result[d]);
  }
}

}  // namespace

// Plain C entry for ctypes.  ``slots`` is a device int32 [n_queries, T]
// array of plane-pool rows; ``plan`` is a HOST int32 array:
//   n_halves, then per half: dir, len, term[0..len), tag[0..len).
// Row q of the result goes to out[out_rows[q]] (out_rows a device int64
// array) or to out[q] when out_rows is null; rows are ``out_stride``
// floats apart.  The kernel runs on ``stream`` and nothing here
// synchronises.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a plan the kernel does not take.
extern "C" int sa_phrase_chain(const void* pool, int64_t plane_size,
                               const void* slots, int64_t n_queries, int T,
                               const int32_t* plan, int64_t num_docs,
                               int blk_bits, void* out, int64_t out_stride,
                               const void* out_rows, int device,
                               void* stream) {
  ChainPlan p{};
  int at = 0;
  p.n_halves = plan[at++];
  if (p.n_halves < 1 || p.n_halves > 2) return cudaErrorInvalidValue;
  for (int h = 0; h < p.n_halves; ++h) {
    p.dir[h] = plan[at++];
    p.len[h] = plan[at++];
    if (p.len[h] < 2 || p.len[h] > MAX_TERMS) return cudaErrorInvalidValue;
    for (int j = 0; j < p.len[h]; ++j) {
      p.term[h][j] = plan[at + j];
      if (p.term[h][j] < 0 || p.term[h][j] >= T) return cudaErrorInvalidValue;
    }
    at += p.len[h];
    for (int j = 0; j < p.len[h]; ++j) p.tag[h][j] = plan[at + j];
    at += p.len[h];
  }
  cudaSetDevice(device);
  const int S = 1 << blk_bits;
  const int64_t dpb = S >= TILE ? 1 : TILE / S;
  const dim3 grid(static_cast<unsigned>((num_docs + dpb - 1) / dpb),
                  static_cast<unsigned>(n_queries));
  phrase_chain_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pool), plane_size,
      static_cast<const int32_t*>(slots), T, p, num_docs, blk_bits,
      static_cast<float*>(out), out_stride,
      static_cast<const int64_t*>(out_rows));
  return static_cast<int>(cudaGetLastError());
}
