// K2: sorted segment-sum -- dense out[d] = sum of values[i] over
// sorted_ids[i] == d; ids >= num_out (the 2^30 pad) are dropped.
//
// Replaces the TPU kernel segment_sum_pallas
// (searcharray_tpu/ops/pallas/score.py:196, body _segsum_kernel at :166),
// which reduces each word tile with a one-hot compare-and-sum for want of
// a fast scatter on the TPU.
//
// Bound on the card: the 8 bytes of id + value read per in-range key,
// plus 4 bytes written per output slot.  So a block's work has to follow
// keys + slots, not slots alone: one slot can hold any number of keys (a
// long document's ~11k words of one term; the pad tail _flat_keys clamps
// onto a row's last slot, up to a fifth of the bucket), and a block that
// owned a fixed range of slots would walk such a run serially while the
// rest of the grid idled.
//
// Merge path (Merrill & Garland's merge-based segmented reduction).  The
// keys and the slot ends 0..num_out-1 form one merged sequence: key j
// goes before the end of slot r iff ids[j] <= r, so key j sits at
// position j + min(ids[j], num_out), which grows strictly with j.  The
// sequence is cut into tiles of TILE items, so a tile holds at most TILE
// keys and TILE slot ends whatever the run lengths, and each block takes
// an equal run of consecutive tiles.  A key >= num_out sits after every
// slot end, so a block stops at the last slot end and never reads the pad
// tail past that tile; no separate search for the in-range prefix is
// needed.
//
// Fixed costs per block, not bytes, decide the time on an H100: with one
// block per tile, a block spent ~8k cycles on its search and carries
// outside its loads and stores, and a search round that misses L2 costs
// ~1k cycles.  So the grid is no larger than the card holds at once (5
// blocks an SM), and a block pays those costs once:
// - warp 0 narrows the block's first key to 33 candidates with a 32-bit
//   ballot search (as sa::warp_bounds, on positions) while the other
//   warps clear the shared row; the first tile's window starts there;
// - each tile loads a window of WINDOW keys (16-byte loads where ids,
//   values and out are 16-byte aligned) and counts the keys whose
//   position lies before the tile's end, and for the first tile before
//   its start: a warp reduction and one barrier, no further search;
// - only the warps whose 256-key chunk holds keys of the tile sum it: a
//   segmented scan of the lanes' last runs joins the runs that cross
//   lanes, so each run is summed whole where it ends and stored once
//   into a float row in shared memory, and only slots at a chunk's edges
//   are added with an atomic (a compare-and-swap loop on shared floats);
// - every slot whose end lies in the tile is then written once with a
//   plain store, zeros included, 16 bytes at a time, and the last,
//   unfinished slot's part moves to the front of the row for the next
//   tile.
//
// Carries, in the same launch by a decoupled look-back: each block
// publishes its last, unfinished slot's part in one 64-bit word tagged
// with the launch's epoch and with whether that slot's keys began in the
// block.  A block whose first slot began in earlier blocks holds that
// slot back, publishes its own word, then sums the words of the blocks
// before it (32 at a time, one a lane) back to the one where the slot
// began, and stores the slot once.  No slot gets more than one store and
// nothing is added into out with an atomic.  A block waits only on
// blocks with a lower index, and the grid never exceeds the blocks the
// card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), so
// every block it waits on runs: blockIdx serves as the tile index with no
// counter.  Chosen over a ticket whose last block adds the carries (a
// fence and an atomic round trip in every block, then a serial tail:
// ~1 us a launch on an H100) and over a second launch (one more ramp).
// The epoch tag leaves old words stale, so the status words need no reset.
//
// Float adds land in no fixed order (shared atomics), so a sum
// of arbitrary floats may differ from a sequential sum in the last bits
// (tolerance rtol 1e-5).  The batched term group feeds integer-valued
// popcounts, whose float sums are exact below 2^24 in any order.
//
// Scratch (one status word per block) is owned here, one buffer per
// (device, stream), grown on demand: launches on one stream run in order,
// so they never share it concurrently.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;                  // consecutive keys a lane holds
constexpr int WINDOW = THREADS * VEC;   // keys loaded per tile
// merged items per tile: the window starts at the 16-byte line of the
// search's first candidate, up to 35 keys before the tile's first key, so
// it holds every key of a tile
constexpr int TILE = WINDOW - 36;
constexpr int NONE = INT_MAX;  // the slot of a key past the tile

// The probes of a search round, in 32-bit (m and num_out are below 2^31,
// so positions stay below 2^32): P probes cut the candidates [a, b] into
// P + 1 parts of ceil((b - a + 1) / (P + 1)); probe j is the last
// candidate of part j, at most b - 1.  sa::step_of, sa::probe_at and
// sa::narrow do the same in 64-bit for K1 and K4; in 64-bit a round of
// this search is a chain of products and divisions that cost ~1.5k cycles
// on an H100, ~10% of unit 2's time in chip_smoke.py.
template <int P>
__device__ __forceinline__ unsigned probe32(unsigned a, unsigned b, int j) {
  const unsigned step = (b - a + 1 + P) / (P + 1);
  const unsigned p = a - 1 + (j + 1) * step;
  return p < b - 1 ? p : b - 1;
}

template <int P>
__device__ __forceinline__ void narrow32(unsigned& a, unsigned& b, int c) {
  const unsigned na = c == 0 ? a : probe32<P>(a, b, c - 1) + 1;
  b = c == P ? b : probe32<P>(a, b, c);
  a = na;
}

// Narrows the number of keys before diagonal t of the merged sequence
// (the first p with position(p) >= t, m where there is none; it lies in
// [t - num_out, t]) to [a, b] with b - a <= 32, 32 probes a round
// (~log33(m / 32) rounds).  All 32 lanes of one warp call it.
__device__ __forceinline__ void warp_coarse(const int32_t* __restrict__ ids,
                                            unsigned m, unsigned num_out,
                                            unsigned t, unsigned& a,
                                            unsigned& b) {
  const int lane = threadIdx.x & 31;
  a = t > num_out ? t - num_out : 0;
  b = t < m ? t : m;
  while (b - a > 32) {
    const unsigned p = probe32<32>(a, b, lane);
    const unsigned id = static_cast<unsigned>(ids[p]);
    const bool lt = p + (id < num_out ? id : num_out) < t;
    narrow32<32>(a, b, __popc(__ballot_sync(0xffffffffu, lt)));
  }
}

// A block's published carry: its last slot's part, whether that slot's
// keys began in the block (so the sum is whole from its start) or only go
// on there, and the launch's epoch, in one 64-bit word, so a reader sees
// all three or none.  Words of earlier launches carry older epochs.
__device__ __forceinline__ unsigned long long carry_word(unsigned epoch,
                                                         bool whole,
                                                         float part) {
  return (static_cast<unsigned long long>(epoch) << 33) |
         (static_cast<unsigned long long>(whole) << 32) |
         __float_as_uint(part);
}

// The part of block ``block``'s first slot that earlier blocks hold:
// their carries, back to the one where the slot's keys began.  Warp 0
// calls it; each lane waits for one earlier block's word of this epoch.
__device__ __forceinline__ float look_back(
    const unsigned long long* status, unsigned block, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  float sum = 0.0f;
  for (int64_t base = static_cast<int64_t>(block) - 1;; base -= 32) {
    const int64_t b = base - lane;
    unsigned long long w = carry_word(epoch, true, 0.0f);  // before block 0
    if (b >= 0) {
      do {
        w = *reinterpret_cast<const volatile unsigned long long*>(status + b);
      } while (static_cast<unsigned>(w >> 33) != epoch);
    }
    const unsigned whole = __ballot_sync(0xffffffffu, (w >> 32) & 1);
    const int stop = whole ? __ffs(whole) - 1 : 31;  // the lane it began in
    float part = lane <= stop ? __uint_as_float(static_cast<unsigned>(w))
                              : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
    }
    sum += part;
    if (whole) return sum;
  }
}

// One warp's chunk of 32 x VEC consecutive keys, VEC a lane, as
// tile-relative slots: non-decreasing, NONE past the tile's last key
// (keys before its first come as slot 0 with value 0).  Puts each slot's
// sum over the chunk into acc once.  A lane sums its own runs; a run that
// ends inside the lane and began there is stored at once (it is no
// other lane's).  The lanes' last runs go through a segmented scan, which
// hands each lane the part of its first run that earlier lanes hold, so
// a run that crosses lanes is summed whole where it ends.  Only the slots
// at the chunk's edges, which other chunks may share, and slot 0, which
// holds the previous tile's carry, are added with an atomic (a
// compare-and-swap loop on shared floats).  All 32 lanes must call it.
__device__ __forceinline__ void chunk_sums(const int (&slot)[VEC],
                                           const float (&v)[VEC],
                                           float* acc) {
  const int lane = threadIdx.x & 31;
  const int head_key = slot[0];
  const int last_key = slot[VEC - 1];
  // the lane's runs: the first (head), stored middles, the last (tail)
  float head = 0.0f, part = v[0];
  bool in_head = true;
#pragma unroll
  for (int j = 1; j < VEC; ++j) {
    if (slot[j] == slot[j - 1]) {
      part += v[j];
    } else {
      if (in_head) {
        head = part;
      } else {
        acc[slot[j - 1]] = part;
      }
      in_head = false;
      part = v[j];
    }
  }
  // keys are sorted: an equal last key o lanes back means one run between
  float scan = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float nv = __shfl_up_sync(0xffffffffu, scan, o);
    const int nk = __shfl_up_sync(0xffffffffu, last_key, o);
    if (lane >= o && nk == last_key) scan += nv;
  }
  const float prev_scan = __shfl_up_sync(0xffffffffu, scan, 1);
  const int prev_key = __shfl_up_sync(0xffffffffu, last_key, 1);
  const int next_head = __shfl_down_sync(0xffffffffu, head_key, 1);
  const int edge0 = __shfl_sync(0xffffffffu, head_key, 0);
  const int edge1 = __shfl_sync(0xffffffffu, last_key, 31);
  const float carry = lane > 0 && prev_key == head_key ? prev_scan : 0.0f;
  auto emit = [&](int key, float sum) {
    if (key == NONE) return;
    if (key == 0 || key == edge0 || key == edge1) {
      if (sum != 0.0f) atomicAdd(&acc[key], sum);
    } else {
      acc[key] = sum;
    }
  };
  if (!in_head) emit(head_key, carry + head);
  if (lane == 31 || next_head != last_key) emit(last_key, scan);
}

// Keys i0 .. i0 + VEC - 1 (past m: id INT_MAX, value 0).
template <bool kVec>
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ ids,
                                          const float* __restrict__ values,
                                          int64_t m, int64_t i0,
                                          int32_t (&id)[VEC],
                                          float (&v)[VEC]) {
  if (kVec && i0 + VEC <= m) {
#pragma unroll
    for (int h = 0; h < VEC; h += 4) {
      const int4 iv = __ldg(reinterpret_cast<const int4*>(ids + i0 + h));
      const float4 fv = __ldg(reinterpret_cast<const float4*>(values + i0 + h));
      id[h] = iv.x; id[h + 1] = iv.y; id[h + 2] = iv.z; id[h + 3] = iv.w;
      v[h] = fv.x; v[h + 1] = fv.y; v[h + 2] = fv.z; v[h + 3] = fv.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      id[j] = i0 + j < m ? ids[i0 + j] : INT_MAX;
      v[j] = i0 + j < m ? values[i0 + j] : 0.0f;
    }
  }
}

// Block b takes the merged items [b per_block, (b + 1) per_block), in
// tiles of TILE items (the last one shorter).  At most 48 registers, so 5
// blocks fit an SM: at 64 (4 an SM) a launch of ~600 tiles takes two
// tiles a block, ~1.2 us slower on an H100.
template <bool kVec>
__global__ void __launch_bounds__(THREADS, 5)
segment_sum_kernel(const int32_t* __restrict__ ids,
                   const float* __restrict__ values, int64_t m,
                   float* __restrict__ out, int64_t num_out,
                   int64_t per_block,
                   unsigned long long* __restrict__ status, unsigned epoch) {
  // the tile's slots r .. r_end: those that end in it, then the carry's
  __shared__ float acc[TILE + 1];
  __shared__ int64_t start;
  __shared__ int warp_keys[2][WARPS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t total = num_out + m;
  const int n32 = static_cast<int>(num_out);  // below 2^31 (the wrapper's)
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t d1 = d0 + per_block < total ? d0 + per_block : total;
  // warp 0 narrows the block's first key to 33 candidates while the other
  // warps clear the row; the first tile's window starts there
  if (warp == 0) {
    unsigned a, b;
    warp_coarse(ids, static_cast<unsigned>(m), static_cast<unsigned>(num_out),
                static_cast<unsigned>(d0), a, b);
    if (lane == 0) start = a;
  } else {
    for (int i = threadIdx.x - 32; i <= TILE; i += THREADS - 32) {
      acc[i] = 0.0f;
    }
  }
  __syncthreads();
  int64_t k = start;   // the tile's first key, once counted
  int64_t r = 0, r0 = 0;
  // thread 0: the key before the block's first one, to learn (late)
  // whether the first slot's keys began in earlier blocks
  int32_t key_before = -1;
  float own0 = 0.0f;  // thread 0: the block's part of slot r0, if owed

  // tiles until the block's end or the last slot end: past it only pad
  // keys are left (block-uniform, so every lane takes part in shuffles)
  for (int64_t d = d0; d < d1 && (d == d0 || r < num_out); d += TILE) {
    const bool opening = d == d0;
    const int64_t d_end = d + TILE < d1 ? d + TILE : d1;
    const int64_t ka = k & ~static_cast<int64_t>(3);
    const int o0 = threadIdx.x * VEC;  // the lane's first key
    int32_t id[VEC];
    float v[VEC];
    load_keys<kVec>(ids, values, m, ka + o0, id, v);
    // Window offsets o = p - ka; key p sits at position ka + o +
    // min(id, num_out) (below 2^32).  The keys of the window before d and
    // before d_end are prefixes of it (every key before ka lies before d).
    const unsigned before_d = static_cast<unsigned>(d - ka);
    const unsigned before_end = static_cast<unsigned>(d_end - ka);
    const int present = m - ka < WINDOW ? static_cast<int>(m - ka) : WINDOW;
    int c_first = 0, c_end = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const unsigned q = static_cast<unsigned>(o0 + j) +
                         static_cast<unsigned>(id[j] < n32 ? id[j] : n32);
      const bool here = o0 + j < present;
      c_first += here && q < before_d;
      c_end += here && q < before_end;
    }
    c_end = __reduce_add_sync(0xffffffffu, c_end);
    if (opening) c_first = __reduce_add_sync(0xffffffffu, c_first);
    if (lane == 0) {
      warp_keys[0][warp] = c_end;
      warp_keys[1][warp] = c_first;
    }
    __syncthreads();
    int end = 0, first = static_cast<int>(k - ka);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) end += warp_keys[0][w];
    if (opening) {
      first = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) first += warp_keys[1][w];
      k = ka + first;
      r = r0 = d0 - k;
      if (threadIdx.x == 0 && k > 0) key_before = ids[k - 1];
    }
    if (r >= num_out) break;  // only pad keys are left
    const int r32 = static_cast<int>(r);
    auto active = [&](int last) {
      return warp * 32 * VEC < last && (warp + 1) * 32 * VEC > first;
    };
    const int64_t k_end = ka + end;
    const int64_t r_end = d_end - k_end;  // slots [r, r_end) end here

    if (active(end)) {
      int slot[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int o = o0 + j;
        const int rel = (id[j] < n32 ? id[j] : n32) - r32;
        slot[j] = o < first ? 0 : o < end && id[j] < n32 ? rel : NONE;
        if (o < first) v[j] = 0.0f;
      }
      chunk_sums(slot, v, acc);
    }
    __syncthreads();

    // each finished slot once, clearing the row behind it.  Thread 0
    // takes slot r: if it is r0 and its keys began in earlier blocks, it
    // keeps the block's part (own0) for after the look-back.
    const int n_slots = static_cast<int>(r_end - r);
    if (threadIdx.x == 0 && n_slots > 0) {
      if (r == r0 && key_before == r0) {
        own0 = acc[0];
      } else {
        out[r] = acc[0];
      }
      acc[0] = 0.0f;
    }
    const int head = 1 + static_cast<int>(-(r + 1) & 3);  // first aligned
    if (threadIdx.x + 1 < head && threadIdx.x + 1 < n_slots) {
      out[r + threadIdx.x + 1] = acc[threadIdx.x + 1];
      acc[threadIdx.x + 1] = 0.0f;
    }
    for (int i = head + 4 * threadIdx.x; i < n_slots; i += 4 * THREADS) {
      if (kVec && i + 4 <= n_slots) {
        *reinterpret_cast<float4*>(out + r + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
        acc[i] = acc[i + 1] = acc[i + 2] = acc[i + 3] = 0.0f;
      } else {
        for (int j = i; j < i + 4 && j < n_slots; ++j) {
          out[r + j] = acc[j];
          acc[j] = 0.0f;
        }
      }
    }
    __syncthreads();
    // the unfinished slot r_end's part opens the next tile's row (the
    // next tile's barrier orders this before its adds)
    if (threadIdx.x == 0 && n_slots > 0) {
      acc[0] = acc[n_slots];
      acc[n_slots] = 0.0f;
    }
    k = k_end;
    r = r_end;
  }

  // publish this block's carry before waiting on earlier ones, so no
  // block's wait depends on another's
  if (warp == 0) {
    const bool owed = __shfl_sync(0xffffffffu, key_before == r0, 0);
    if (lane == 0) {
      *reinterpret_cast<volatile unsigned long long*>(status + blockIdx.x) =
          carry_word(epoch, !(owed && r == r0), r < num_out ? acc[0] : 0.0f);
    }
    if (owed && r > r0) {
      const float before = look_back(status, blockIdx.x, epoch);
      if (lane == 0) out[r0] = own0 + before;
    }
  }
}

// One stream's scratch: a carry word per block, and the launch count
// that tags them.
struct Scratch {
  unsigned long long* status = nullptr;
  int64_t blocks = 0;
  unsigned epoch = 0;
};

std::mutex mu;
std::map<int, int64_t> resident;  // blocks a device holds at once
std::map<std::pair<int, cudaStream_t>, Scratch> scratch;

cudaError_t resident_blocks(int device, int64_t& blocks) {
  auto it = resident.find(device);
  if (it == resident.end()) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_sum_kernel<true>, THREADS, 0);
    int per_sm_unaligned = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm_unaligned, segment_sum_kernel<false>, THREADS, 0);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return err;
    if (per_sm_unaligned < per_sm) per_sm = per_sm_unaligned;
    it = resident.emplace(device, static_cast<int64_t>(per_sm) * sms).first;
  }
  blocks = it->second;
  return cudaSuccess;
}

cudaError_t launch(const int32_t* ids, const float* values, int64_t m,
                   float* out, int64_t num_out, int device, cudaStream_t s) {
  int64_t cap = 0;
  cudaError_t err = resident_blocks(device, cap);
  if (err != cudaSuccess) return err;
  // no more blocks than the card holds at once: a block waits only on
  // earlier ones, which then all run (see look_back)
  const int64_t tiles = (num_out + m + TILE - 1) / TILE;
  const int64_t per_block = (tiles + cap - 1) / cap * TILE;
  const int64_t grid = (num_out + m + per_block - 1) / per_block;
  Scratch& sc = scratch[{device, s}];
  if (sc.blocks < grid) {
    if (sc.status != nullptr) cudaFree(sc.status);  // waits for the device
    sc.status = nullptr;
    sc.blocks = 0;
    err = cudaMalloc(&sc.status, 8 * grid);
    if (err != cudaSuccess) return err;
    sc.blocks = grid;
    cudaMemsetAsync(sc.status, 0, 8 * grid, s);  // epoch 0: never current
  }
  sc.epoch = sc.epoch % 0x7fffffffu + 1;  // 31 bits, never 0
  const bool aligned = ((reinterpret_cast<uintptr_t>(ids) |
                         reinterpret_cast<uintptr_t>(values) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  auto kernel = aligned ? segment_sum_kernel<true> : segment_sum_kernel<false>;
  kernel<<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
      ids, values, m, out, num_out, per_block, sc.status, sc.epoch);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes (see sa_score_term).  Returns the first CUDA
// error: of a query, a scratch allocation or the launch.
extern "C" int sa_segment_sum(const void* ids, const void* values, int64_t m,
                              void* out, int64_t num_out, int device,
                              void* stream) {
  const DeviceGuard guard(device);
  if (num_out <= 0) return 0;
  if (num_out > INT_MAX || m > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // held through the launch, so no other host thread frees the scratch of
  // this stream between its growth and the launch that uses it
  std::lock_guard<std::mutex> lock(mu);
  return static_cast<int>(launch(
      static_cast<const int32_t*>(ids), static_cast<const float*>(values), m,
      static_cast<float*>(out), num_out, device,
      static_cast<cudaStream_t>(stream)));
}
