// K3: exact top-k of each row of f32[Q, N], values descending, ties to the
// smallest index.
//
// Replaces the JAX package's topk_exact (searcharray_tpu/ops/kernels.py:
// 101-138), which XLA runs as a block-max selection sized for another
// machine.  That shape is not carried over: this is a radix select.
//
// The tie rule becomes a total order when every element is one 64-bit
// key: the float's bits mapped to an order-preserving u32 (the value key;
// -0.0 maps to the key of +0.0, so the two compare equal as floats do) in
// the high half and ~index in the low half.  The k largest keys of a row
// are the answer, and no two keys are equal.  Rows hold no NaN.
//
// Steps, all on one stream, none of them read by the host:
//
//   1. up to three histogram passes over the value key, 11 + 11 + 10 bits
//      from the top (topk_hist_kernel, one block per 16384-element tile
//      of a row, a shared-memory histogram added into the row's global
//      one), each followed by topk_select_kernel (one block per row),
//      which finds the digit that holds the k-th key.  A row is done as
//      soon as the keys at or above the digit's lower bound number at
//      most `cap` (k itself above SORT_CAP, SORT_CAP below): later passes
//      return at once for it, so a typical row of distinct scores is read
//      by one or two histogram passes, not three.
//   2. A row whose k-th VALUE is shared by more elements than may be kept
//      (a row of zeros with fewer than k positive scores) is a tie row:
//      topk_tiescan_kernel walks it from index 0 and stops at the index
//      of the last tie to keep.  That is a few elements where ties are
//      dense, which is where such rows come from.
//   3. topk_filter_kernel reads the row once more and writes every key
//      at or above the threshold (between k and cap of them) to the row's
//      candidates, in no order.
//   4. topk_sort_kernel (k <= SORT_CAP) sorts a row's candidates in shared
//      memory (bitonic, 64-bit keys) and writes the first k as values and
//      indices.  Above SORT_CAP the filter leaves exactly k keys a row;
//      the caller orders those [Q, k] keys and topk_unpack_kernel turns
//      them into values and indices.
//
// Bound on the card: the rows read once (4 bytes an element) and 8 bytes
// written per result.  This design reads a row two to four times (one to
// three histograms and the filter), so it can reach a half to a quarter
// of that bound; the selection does no arithmetic to speak of.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BINS = 2048;         // 11-bit digits
constexpr int THREADS = 256;
constexpr int TILE = THREADS * 64; // elements of a row per block
constexpr int SORT_CAP = 2048;     // keys the sort kernel takes per row
constexpr int SORT_THREADS = 1024;
constexpr int SCAN_THREADS = 1024;
constexpr int LEVELS = 3;
constexpr unsigned FULL = 0xffffffffu;

__device__ __constant__ int SHIFT[LEVELS] = {21, 10, 0};
__device__ __constant__ int BITS[LEVELS] = {11, 11, 10};

struct RowState {
  uint32_t prefix;  // the value key's digits fixed so far, low bits zero
  uint32_t above;   // keys above the prefix's range (all of them kept)
  uint32_t done;    // the threshold is final
  uint32_t tie;     // keep keys above prefix and the first `need` equal
  uint32_t need;    // ties to keep
  uint32_t istar;   // index of the last tie to keep
  uint32_t count;   // the filter's cursor
  uint32_t m;       // keys the filter writes
};

// Order-preserving u32 of a float's bits; -0.0 as +0.0.
__device__ __forceinline__ uint32_t value_key(uint32_t b) {
  if (b == 0x80000000u) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// f(index in the row, float bits) over the block's tile of its row.
template <typename F>
__device__ __forceinline__ void for_tile(const float* __restrict__ row,
                                         int64_t n, int tile, bool vec, F f) {
  const int64_t lo = static_cast<int64_t>(tile) * TILE;
  const int64_t hi = lo + TILE < n ? lo + TILE : n;
  if (vec) {  // 16-byte aligned rows, n a multiple of 4
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int64_t i = lo / 4 + threadIdx.x; i < hi / 4; i += THREADS) {
      const uint4 v = __ldg(r4 + i);
      f(4 * i, v.x);
      f(4 * i + 1, v.y);
      f(4 * i + 2, v.z);
      f(4 * i + 3, v.w);
    }
  } else {
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x; i < hi; i += THREADS) {
      f(i, __float_as_uint(__ldg(row + i)));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
topk_hist_kernel(const float* __restrict__ x, int64_t n, int tiles, int level,
                 bool vec, const RowState* __restrict__ state,
                 uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[BINS];
  const int64_t row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  if (state[row].done) return;
  for (int i = threadIdx.x; i < BINS; i += THREADS) sh[i] = 0;
  __syncthreads();
  const int shift = SHIFT[level];
  const uint32_t mask = (1u << BITS[level]) - 1;
  const int up = shift + BITS[level];  // 32 at level 0: every key counts
  const uint32_t want = level ? state[row].prefix >> up : 0;
  // a thread adds a run of equal digits at once: a row of zeros costs it
  // one shared atomic, not one per element
  uint32_t last = 0, run = 0;
  for_tile(x + row * n, n, tile, vec, [&](int64_t, uint32_t b) {
    const uint32_t key = value_key(b);
    if (level && (key >> up) != want) return;
    const uint32_t d = (key >> shift) & mask;
    if (d == last) {
      ++run;
    } else {
      if (run) atomicAdd(&sh[last], run);
      last = d;
      run = 1;
    }
  });
  if (run) atomicAdd(&sh[last], run);
  __syncthreads();
  uint32_t* g = hist + row * BINS;
  for (int i = threadIdx.x; i < BINS; i += THREADS) {
    const uint32_t c = sh[i];
    if (c) atomicAdd(g + i, c);
  }
}

// One block per row: the digit of this level that holds the k-th key.
__global__ void __launch_bounds__(THREADS)
topk_select_kernel(uint32_t* __restrict__ hist, RowState* __restrict__ state,
                   int level, uint32_t k, uint32_t cap) {
  constexpr int PER = BINS / THREADS;
  __shared__ uint32_t sums[THREADS];
  RowState* st = state + blockIdx.x;
  const uint32_t done = st->done, above = st->above, prefix = st->prefix;
  if (done) return;
  uint32_t* g = hist + static_cast<int64_t>(blockIdx.x) * BINS;
  const int t = threadIdx.x;
  uint32_t c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = g[t * PER + j];
    g[t * PER + j] = 0;  // for the next level
    sum += c[j];
  }
  // inclusive suffix sums over the threads: keys in this and higher bins
  sums[t] = sum;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const uint32_t v = t + off < THREADS ? sums[t + off] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  const uint32_t incl = sums[t], excl = incl - sum;
  const uint32_t need = k - above;  // keys still to find in the prefix
  if (excl < need && need <= incl) {
    uint32_t acc = excl;
    int j = PER - 1;
    while (acc + c[j] < need) acc += c[j--];
    const uint32_t digit = t * PER + j;
    const uint32_t at_or_above = above + acc + c[j];
    st->prefix = prefix | (digit << SHIFT[level]);
    if (at_or_above <= cap) {
      st->done = 1;
      st->m = at_or_above;
    } else if (level == LEVELS - 1) {
      st->done = 1;
      st->tie = 1;
      st->need = need - acc;
      st->m = k;
    } else {
      st->above = above + acc;
    }
  }
}

// One block per tie row: the index of the `need`-th element whose value
// key equals the threshold, walking from index 0.
__global__ void __launch_bounds__(SCAN_THREADS)
topk_tiescan_kernel(const float* __restrict__ x, int64_t n,
                    RowState* __restrict__ state) {
  __shared__ uint32_t wsum[SCAN_THREADS / 32];
  RowState* st = state + blockIdx.x;
  if (!st->tie) return;
  const uint32_t thr = st->prefix, need = st->need;
  const float* row = x + static_cast<int64_t>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t seen = 0;
  for (int64_t base = 0; base < n && seen < need; base += SCAN_THREADS) {
    const int64_t i = base + threadIdx.x;
    const bool f = i < n && value_key(__float_as_uint(row[i])) == thr;
    const unsigned b = __ballot_sync(FULL, f);
    if (lane == 0) wsum[warp] = __popc(b);
    __syncthreads();
    uint32_t before = seen, total = 0;
    for (int w = 0; w < SCAN_THREADS / 32; ++w) {
      if (w < warp) before += wsum[w];
      total += wsum[w];
    }
    const uint32_t rank = before + __popc(b & ((1u << lane) - 1));
    if (f && rank + 1 == need) st->istar = static_cast<uint32_t>(i);
    seen += total;
    __syncthreads();
  }
}

// The next free candidate slot of a row, one atomic per warp's takers.
__device__ __forceinline__ uint32_t take_slot(uint32_t* counter) {
  const unsigned m = __activemask();
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(m, base, leader);
  return base + __popc(m & ((1u << lane) - 1));
}

__global__ void __launch_bounds__(THREADS)
topk_filter_kernel(const float* __restrict__ x, int64_t n, int tiles,
                   bool vec, RowState* __restrict__ state,
                   uint64_t* __restrict__ cand, int64_t cap) {
  const int64_t row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  RowState* st = state + row;
  const uint32_t thr = st->prefix, tie = st->tie, istar = st->istar;
  uint64_t* dst = cand + row * cap;
  for_tile(x + row * n, n, tile, vec, [&](int64_t i, uint32_t b) {
    const uint32_t key = value_key(b);
    const bool take = tie ? key > thr || (key == thr && i <= istar)
                          : key >= thr;
    if (take) {
      const uint32_t at = take_slot(&st->count);
      if (at < cap) {
        dst[at] = static_cast<uint64_t>(key) << 32 |
                  (0xffffffffu - static_cast<uint32_t>(i));
      }
    }
  });
}

// One block per row: its m <= SORT_CAP candidates sorted descending in
// shared memory, the first k written as values and indices.
__global__ void __launch_bounds__(SORT_THREADS)
topk_sort_kernel(const float* __restrict__ x, int64_t n,
                 const RowState* __restrict__ state,
                 const uint64_t* __restrict__ cand, int64_t cap, int64_t k,
                 float* __restrict__ vals, int32_t* __restrict__ idx) {
  __shared__ uint64_t s[SORT_CAP];
  const int64_t row = blockIdx.x;
  const int m = static_cast<int>(state[row].m);
  int P = 2;
  while (P < m) P <<= 1;
  for (int i = threadIdx.x; i < P; i += SORT_THREADS) {
    s[i] = i < m ? cand[row * cap + i] : 0;  // 0 is below every key
  }
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < P / 2; t += SORT_THREADS) {
        const int a = 2 * t - (t & (stride - 1)), b = a + stride;
        const uint64_t u = s[a], v = s[b];
        if ((u < v) == ((a & size) == 0)) {
          s[a] = v;
          s[b] = u;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += SORT_THREADS) {
    const uint32_t id = 0xffffffffu - static_cast<uint32_t>(s[i]);
    idx[row * k + i] = static_cast<int32_t>(id);
    vals[row * k + i] = x[row * n + id];
  }
}

// Ordered keys (only their low half is read) -> values and indices.
__global__ void __launch_bounds__(THREADS)
topk_unpack_kernel(const float* __restrict__ x, int64_t n,
                   const uint64_t* __restrict__ keys, int64_t k,
                   int64_t total, float* __restrict__ vals,
                   int32_t* __restrict__ idx) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    const uint32_t id = 0xffffffffu - static_cast<uint32_t>(keys[i]);
    idx[i] = static_cast<int32_t>(id);
    vals[i] = x[(i / k) * n + id];
  }
}

}  // namespace

// The keys the in-kernel sort takes per row: the wrapper orders the
// survivors itself above it.
extern "C" int sa_topk_sort_cap() { return SORT_CAP; }

// Bytes of scratch per row: its histogram and its state.
extern "C" int sa_topk_row_scratch_bytes() {
  return BINS * 4 + static_cast<int>(sizeof(RowState));
}

// Plain C entry for ctypes.  ``x`` is f32 [n_rows, n], rows contiguous;
// ``scratch`` holds n_rows * sa_topk_row_scratch_bytes() bytes; ``cand``
// is u64 [n_rows, cap] with cap = max(k, SORT_CAP).  With k <= SORT_CAP
// the values f32 [n_rows, k] and indices i32 [n_rows, k] are written;
// above it ``cand`` is left holding each row's k keys in no order, for
// sa_topk_unpack after the caller has ordered them.  Everything runs on
// ``stream``; nothing here synchronises.  Returns cudaGetLastError().
extern "C" int sa_topk(const void* x, int64_t n_rows, int64_t n, int64_t k,
                       void* scratch, void* cand, int64_t cap, void* vals,
                       void* idx, int device, void* stream) {
  if (k < 1 || k > n || cap < k || (k <= SORT_CAP && cap != SORT_CAP) ||
      (k > SORT_CAP && cap != k)) {
    return cudaErrorInvalidValue;
  }
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  uint32_t* hist = static_cast<uint32_t*>(scratch);
  RowState* state = reinterpret_cast<RowState*>(hist + n_rows * BINS);
  uint64_t* cd = static_cast<uint64_t*>(cand);
  cudaMemsetAsync(scratch, 0,
                  n_rows * (BINS * 4 + sizeof(RowState)), st);
  const int tiles = static_cast<int>((n + TILE - 1) / TILE);
  const unsigned blocks = static_cast<unsigned>(n_rows * tiles);
  const unsigned rows = static_cast<unsigned>(n_rows);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int level = 0; level < LEVELS; ++level) {
    topk_hist_kernel<<<blocks, THREADS, 0, st>>>(xf, n, tiles, level, vec,
                                                 state, hist);
    topk_select_kernel<<<rows, THREADS, 0, st>>>(
        hist, state, level, static_cast<uint32_t>(k),
        static_cast<uint32_t>(cap));
  }
  topk_tiescan_kernel<<<rows, SCAN_THREADS, 0, st>>>(xf, n, state);
  topk_filter_kernel<<<blocks, THREADS, 0, st>>>(xf, n, tiles, vec, state, cd,
                                                 cap);
  if (k <= SORT_CAP) {
    topk_sort_kernel<<<rows, SORT_THREADS, 0, st>>>(
        xf, n, state, cd, cap, k, static_cast<float*>(vals),
        static_cast<int32_t*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}

// Ordered keys u64 [n_rows, k] -> values f32 and indices i32 [n_rows, k].
extern "C" int sa_topk_unpack(const void* x, int64_t n_rows, int64_t n,
                              const void* keys, int64_t k, void* vals,
                              void* idx, int device, void* stream) {
  cudaSetDevice(device);
  const int64_t total = n_rows * k;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;
  topk_unpack_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const uint64_t*>(keys), k,
      total, static_cast<float*>(vals), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
