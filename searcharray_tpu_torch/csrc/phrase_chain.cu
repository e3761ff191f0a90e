// K5: the bigram chain of exact phrases on dense planes -- per-doc phrase
// freqs of a group of queries, read straight from the plane pool.
//
// Replaces the JAX package's XLA chain phrase_counts_dense_planes /
// _dense_chain / _same_counts_dense (searcharray_tpu/search/dense.py:
// 494-570).  XLA runs each chain step as ~10 elementwise passes over the
// whole N*S plane, plus a slot-sum and a min per step.  This kernel reads
// each plane of a query once and keeps every intermediate on chip.
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
// step of every half of the plan.  Counts are integers: the result equals
// the plain version bit for bit.
//
// Bound on the card: the distinct planes of the launch, 4 bytes per slot
// each (32 MB per plane at 1M docs and 8 slots per doc), read once, and 4
// bytes written per doc and query.  Nothing else is needed, so the kernel
// is a stream: its design keeps the memory busy.
//
// Design for S = 2^blk_bits <= 32 (chain_warp_kernel), in registers:
//
//   * A warp owns a window of 32 lanes x 8 consecutive slots.  A lane
//     holds its 8 slots of the carry in registers, so a doc of S <= 8
//     slots lies in one lane and its slot sum is a sum of registers; at
//     S = 16 or 32 two or four lanes hold a doc and one or two
//     __shfl_xor_sync add it up.  No shared-memory atomics, no block
//     barrier: the warps of a block never talk to each other.
//   * The neighbour slot of a step (L[s-1] in l2r, R[s+1] in r2l) is the
//     lane's own register or, for its first (last) slot, the previous
//     (next) lane's by __shfl_up_sync (__shfl_down_sync).  The window's
//     edge lane has no neighbour: an error there travels one slot per
//     step, so the window keeps hl (hr) lanes of halo before (after) its
//     counted lanes, at least one slot per step of the l2r (r2l) half,
//     rounded up to whole docs.  A 2-term phrase spends 1 of 32 lanes.
//   * Each lane streams its 32 bytes of every plane into a per-warp ring
//     of STAGES shared-memory stages with 16-byte cp.async (4-byte when
//     the rows are not 16-byte aligned), DIST loads ahead of the step
//     that reads them, so device memory stays busy while steps compute.
//     A lane reads back only what it copied, so cp.async.wait_group is
//     the only synchronisation.  Shared memory: 8 warps x 4 stages x 1 KB
//     = 32 KB per block.
//   * A warp walks every query of the group over its window, so a plane
//     that several queries share is read from device memory once and
//     again from L1/L2 a few steps later.
//
// Design for S >= 64 (chain_tile_kernel, long documents): a block owns
// 2048 slots (one doc cut into 2048-slot pieces when S is larger) plus a
// 32-slot halo, runs each step through shared memory and sums a doc's
// slots with shuffles and one shared atomic per warp.  Its per-doc arrays
// hold the 32 docs such a block can own.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int MAX_TERMS = 32;      // cap on the terms of one half
constexpr int LSB = (1 << 18) - 1;
constexpr int TOP = 17;
constexpr int BIG = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

struct ChainPlan {
  int n_halves;
  int dir[2];               // 0: l2r, 1: r2l
  int len[2];               // terms in the half (>= 2)
  int term[2][MAX_TERMS];   // column in the query's row of plane slots
  int tag[2][MAX_TERMS];    // same-term pattern tag of that column
};

// ---------------------------------------------------------------------------
// S <= 32: one warp per window, carries in registers
// ---------------------------------------------------------------------------
constexpr int WARPS = 8;
constexpr int V = 8;         // slots per lane
constexpr int STAGES = 4;    // ring stages per warp
constexpr int DIST = 2;      // loads in flight ahead of the one consumed

// A plan in the order the warp kernel consumes it: per half its direction
// and whether its first step is a same-term step; the plane columns of
// one query in load order (per half: the first step's other plane unless
// same-term, then the plane of each step).
struct WarpChain {
  int n_halves;
  int l2r[2];
  int same0[2];
  int steps[2];
  int n_loads;
  int col[2 * MAX_TERMS];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The lane's 8 slots of one stage: two 16-byte words, the first of every
// lane before the second of any, so both the copies and the reads of a
// warp touch 512 contiguous bytes each.
__device__ __forceinline__ int stage_at(int lane, int v) {
  return ((v >> 2) * 32 + lane) * 4 + (v & 3);
}

// Start the copy of load t (query t / n_loads, column col[t % n_loads])
// of this lane's 8 slots into its ring stage; slots outside the plane
// read as zero.  Always commits one cp.async group, empty past the end,
// so that the group count stays one per load.
__device__ __forceinline__ void issue_load(
    int t, int total, const WarpChain& chain, const int32_t* pool,
    int64_t plane_size, const int32_t* slots, int T, int64_t my, bool vec16,
    int32_t (*stage)[32 * V], int lane) {
  if (t < total) {
    const int q = t / chain.n_loads;
    const int col = chain.col[t - q * chain.n_loads];
    const int64_t row = __ldg(slots + static_cast<int64_t>(q) * T + col);
    const int32_t* src = pool + row * plane_size;
    int32_t* dst = stage[t % STAGES];
    if (vec16) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int64_t s = my + 4 * k;
        const bool in = s >= 0 && s < plane_size;
        cp_async16(dst + stage_at(lane, 4 * k), in ? src + s : src, in);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int64_t s = my + v;
        const bool in = s >= 0 && s < plane_size;
        cp_async4(dst + stage_at(lane, v), in ? src + s : src, in);
      }
    }
  }
  cp_async_commit();
}

template <int S>
__global__ void __launch_bounds__(WARPS * 32, 4)
chain_warp_kernel(const int32_t* __restrict__ pool, int64_t plane_size,
                  const int32_t* __restrict__ slots, int T, int n_queries,
                  const __grid_constant__ WarpChain chain, int hl, int hr,
                  int64_t n_windows,
                  bool vec16, int64_t num_docs, float* __restrict__ out,
                  int64_t out_stride, const int64_t* __restrict__ out_rows) {
  constexpr int DPL = S <= V ? V / S : 1;  // docs per lane
  constexpr int G = S <= V ? 1 : S / V;    // lanes per doc
  __shared__ __align__(16) int32_t ring[WARPS][STAGES][32 * V];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t window = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  if (window >= n_windows) return;  // whole warps only: no block barrier
  const int counted = (32 - hl - hr) * V;
  const int64_t ws = window * counted - hl * V;  // the window's first slot
  const int64_t my = ws + lane * V;              // this lane's first slot
  int32_t(*stage)[32 * V] = ring[warp];
  const int total = n_queries * chain.n_loads;

  for (int t = 0; t < DIST; ++t) {
    issue_load(t, total, chain, pool, plane_size, slots, T, my, vec16, stage,
               lane);
  }
  int t = 0;  // the next load to consume
  int x[V], c[V];
// The plane of load t into x, with load t + DIST started first.
#define SA_NEXT_PLANE()                                                    \
  do {                                                                     \
    issue_load(t + DIST, total, chain, pool, plane_size, slots, T, my,     \
               vec16, stage, lane);                                        \
    cp_async_wait<DIST>();                                                 \
    const int4* src_ = reinterpret_cast<const int4*>(stage[t % STAGES]);   \
    const int4 lo_ = src_[lane], hi_ = src_[32 + lane];                    \
    x[0] = lo_.x; x[1] = lo_.y; x[2] = lo_.z; x[3] = lo_.w;                \
    x[4] = hi_.x; x[5] = hi_.y; x[6] = hi_.z; x[7] = hi_.w;                \
    ++t;                                                                   \
  } while (0)

  const bool counts = lane >= hl && lane < 32 - hr;
  for (int q = 0; q < n_queries; ++q) {
    int res[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) res[j] = BIG;
    for (int h = 0; h < chain.n_halves; ++h) {
      const bool l2r = chain.l2r[h];
      if (!chain.same0[h]) {
        SA_NEXT_PLANE();
#pragma unroll
        for (int v = 0; v < V; ++v) c[v] = x[v];
      }
      for (int k = 0; k < chain.steps[h]; ++k) {
        SA_NEXT_PLANE();
        const bool same = k == 0 && chain.same0[h];
        int cnt[V];
        if (l2r) {
          // the slot before this lane's first: the previous lane's last
          int prev = __shfl_up_sync(FULL, same ? x[V - 1] : c[V - 1], 1);
          if (lane == 0) prev = 0;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int R = x[v];
            if (same) {
              const int ov = R & ((R << 1) & LSB);
              const int consec = __popc(ov & (ov << 1) & LSB);
              const int a = (prev >> TOP) & R & 1;
              cnt[v] = __popc(ov) - ((consec + 1) >> 1) + a;
              prev = R;
              c[v] = ov | a;
            } else {
              const int L = c[v];
              const int inner = L & (R >> 1);
              const int a = (prev >> TOP) & R & 1;
              cnt[v] = __popc(inner) + a;
              prev = L;
              c[v] = ((inner << 1) & LSB) | a;
            }
          }
        } else {
          // the slot after this lane's last: the next lane's first
          int next = __shfl_down_sync(FULL, same ? x[0] : c[0], 1);
          if (lane == 31) next = 0;
#pragma unroll
          for (int v = V - 1; v >= 0; --v) {
            const int L = x[v];
            if (same) {
              const int ov = L & ((L << 1) & LSB);
              const int consec = __popc(ov & (ov << 1) & LSB);
              const int a = (L >> TOP) & next & 1;
              cnt[v] = __popc(ov) - ((consec + 1) >> 1) + a;
              next = L;
              c[v] = (L & (L >> 1)) | (a << TOP);
            } else {
              const int R = c[v];
              const int ov = L & (R >> 1);
              const int a = (L >> TOP) & next & 1;
              cnt[v] = __popc(ov) + a;
              next = R;
              c[v] = ov | (a << TOP);
            }
          }
        }
        // per-doc sums of this step, and the min over steps
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          int sum = 0;
#pragma unroll
          for (int v = j * (V / DPL); v < (j + 1) * (V / DPL); ++v) {
            sum += cnt[v];
          }
#pragma unroll
          for (int o = 1; o < G; o <<= 1) {
            sum += __shfl_xor_sync(FULL, sum, o);
          }
          res[j] = min(res[j], sum);
        }
      }
    }
    if (counts && (lane & (G - 1)) == 0) {
      const int64_t row = out_rows ? out_rows[q] : q;
      float* dst = out + row * out_stride;
      const int64_t d0 = my / S;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        if (d0 + j < num_docs) dst[d0 + j] = static_cast<float>(res[j]);
      }
    }
  }
  cp_async_wait<0>();
#undef SA_NEXT_PLANE
}

template <int S>
int launch_warp(const int32_t* pool, int64_t plane_size, const int32_t* slots,
                int T, int n_queries, const WarpChain& chain, int hl, int hr,
                int64_t num_docs, float* out, int64_t out_stride,
                const int64_t* out_rows, cudaStream_t stream) {
  const int counted = (32 - hl - hr) * V;
  const int64_t n_windows = (plane_size + counted - 1) / counted;
  const int64_t blocks = (n_windows + WARPS - 1) / WARPS;
  const bool vec16 = plane_size % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  chain_warp_kernel<S><<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                         stream>>>(pool, plane_size, slots, T, n_queries,
                                   chain, hl, hr, n_windows, vec16, num_docs,
                                   out, out_stride, out_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// S >= 64: a block per 2048-slot tile, steps through shared memory
// ---------------------------------------------------------------------------
constexpr int HALO = 32;           // >= MAX_TERMS - 1 steps; warp-aligned
constexpr int TILE = 2048;         // counted slots per block pass
constexpr int WIN = TILE + HALO;   // window slots in shared memory
constexpr int TILE_THREADS = 256;
constexpr int TILE_DOCS = TILE / 64;  // docs of a block at S >= 64

__device__ __forceinline__ void load_window(const int32_t* __restrict__ src,
                                            int32_t* dst, int64_t base,
                                            int W, int64_t plane_size) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int64_t s = base + w;
    dst[w] = (s >= 0 && s < plane_size) ? src[s] : 0;
  }
}

__global__ void __launch_bounds__(TILE_THREADS)
chain_tile_kernel(const int32_t* __restrict__ pool, int64_t plane_size,
                  const int32_t* __restrict__ slots, int T,
                  const ChainPlan plan, int64_t num_docs, int blk_bits,
                  float* __restrict__ out, int64_t out_stride,
                  const int64_t* __restrict__ out_rows) {
  __shared__ int32_t carry[2][WIN];
  __shared__ int32_t plane[WIN];
  __shared__ int32_t stepsum[TILE_DOCS];  // per doc of the block
  __shared__ int32_t result[TILE_DOCS];   // per doc: min over steps so far
  __shared__ int32_t acc[2 * MAX_TERMS];  // per step, when S > TILE

  const int S = 1 << blk_bits;
  const int64_t dpb = S >= TILE ? 1 : TILE / S;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * dpb;
  const int64_t d1 = d0 + dpb < num_docs ? d0 + dpb : num_docs;
  const int nd = static_cast<int>(d1 - d0);
  const int n_sub = S > TILE ? S / TILE : 1;
  const int32_t* qslots = slots + static_cast<int64_t>(blockIdx.y) * T;

  for (int i = threadIdx.x; i < TILE_DOCS; i += blockDim.x) {
    stepsum[i] = 0;
    result[i] = BIG;
  }
  if (threadIdx.x < 2 * MAX_TERMS) acc[threadIdx.x] = 0;
  __syncthreads();

  int n_steps = 0;
  for (int sub = 0; sub < n_sub; ++sub) {
    // counted slots [u0, u1); u0 is a multiple of TILE, so every window
    // base below is warp-aligned and each warp lies in one doc
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
          // sum the warp's 32 slots (one doc), one atomic per warp
          for (int o = 1; o < 32; o <<= 1) {
            cnt += __shfl_xor_sync(FULL, cnt, o);
          }
          const bool counted = l2r ? (w >= HALO && w < W)
                                   : (w < W - HALO);
          if (counted && (threadIdx.x & 31) == 0 && cnt != 0) {
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

// The warp kernel's view of a plan, and its halo lanes: at least one slot
// per step of the half that runs towards that side, in whole docs.
WarpChain warp_chain(const ChainPlan& p, int S, int* hl, int* hr) {
  WarpChain w{};
  w.n_halves = p.n_halves;
  const int g = S <= V ? 1 : S / V;
  *hl = *hr = 0;
  for (int h = 0; h < p.n_halves; ++h) {
    const bool l2r = p.dir[h] == 0;
    const int len = p.len[h];
    // the half's terms in the order its steps read them
    int order[MAX_TERMS];
    for (int j = 0; j < len; ++j) order[j] = l2r ? j : len - 1 - j;
    w.l2r[h] = l2r;
    w.same0[h] = p.tag[h][order[0]] == p.tag[h][order[1]];
    w.steps[h] = len - 1;
    for (int j = w.same0[h] ? 1 : 0; j < len; ++j) {
      w.col[w.n_loads++] = p.term[h][order[j]];
    }
    const int lanes = ((len - 1 + V - 1) / V + g - 1) / g * g;
    if (l2r) {
      *hl = lanes > *hl ? lanes : *hl;
    } else {
      *hr = lanes > *hr ? lanes : *hr;
    }
  }
  return w;
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
  const DeviceGuard guard(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* pl = static_cast<const int32_t*>(pool);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  float* o = static_cast<float*>(out);
  const int64_t* rows = static_cast<const int64_t*>(out_rows);
  const int S = 1 << blk_bits;
  if (S <= 32) {
    int hl, hr;
    const WarpChain w = warp_chain(p, S, &hl, &hr);
    const int nq = static_cast<int>(n_queries);
    switch (S) {
      case 1: return launch_warp<1>(pl, plane_size, sl, T, nq, w, hl, hr,
                                    num_docs, o, out_stride, rows, st);
      case 2: return launch_warp<2>(pl, plane_size, sl, T, nq, w, hl, hr,
                                    num_docs, o, out_stride, rows, st);
      case 4: return launch_warp<4>(pl, plane_size, sl, T, nq, w, hl, hr,
                                    num_docs, o, out_stride, rows, st);
      case 8: return launch_warp<8>(pl, plane_size, sl, T, nq, w, hl, hr,
                                    num_docs, o, out_stride, rows, st);
      case 16: return launch_warp<16>(pl, plane_size, sl, T, nq, w, hl, hr,
                                      num_docs, o, out_stride, rows, st);
      default: return launch_warp<32>(pl, plane_size, sl, T, nq, w, hl, hr,
                                      num_docs, o, out_stride, rows, st);
    }
  }
  const int64_t dpb = S >= TILE ? 1 : TILE / S;
  const dim3 grid(static_cast<unsigned>((num_docs + dpb - 1) / dpb),
                  static_cast<unsigned>(n_queries));
  chain_tile_kernel<<<grid, TILE_THREADS, 0, st>>>(
      pl, plane_size, sl, T, p, num_docs, blk_bits, o, out_stride, rows);
  return static_cast<int>(cudaGetLastError());
}
