// K1: fused term scoring -- per-doc popcount tf with the BM25 family in
// the epilogue -- and its multi-row form, the tf-pool fill.
//
// Replaces the TPU kernel score_term_pallas
// (searcharray_tpu/ops/pallas/score.py:86, body _kernel at :30).  The
// Pallas version walks output doc blocks and reduces every word tile with
// a one-hot (doc_block x WORD_TILE) compare-and-sum, because the TPU has
// no fast scatter.  Hopper has fast shared-memory integer atomics, so
// here the same computation is a segmented reduction:
//
//   * block (g, r) owns docs [g*D, g*D + D) of row r (D = 1024, or 4096
//     for a launch of rare terms: see WIDE), and warp 0 finds
//     its word range [w_lo, w_hi) in the row's doc-sorted slice with the
//     warp search of segmented.cuh (hdr >> blk_bits is the doc key; PAD
//     words sort last and fall outside every range): ~log33(M) dependent
//     loads instead of a thread's log2(M);
//   * its threads stride over the range with coalesced 4-byte loads of
//     hdr32 and pay32, four words each in flight, take __popc of the
//     payload and add it into an int counter per doc in shared memory.
//     Integer adds are exact, so the result does not depend on the order
//     the atomics land in;
//   * the epilogue converts each count to float, applies the similarity
//     as ops/kernels.py's similarity_plain and K10 (similarity.cu) round
//     it (explicit round-to-nearest intrinsics; the length norm and its
//     sum with tf are the two fused multiply-adds of the JAX package's
//     programs) and writes each output doc exactly once, four docs
//     per thread with 16-byte loads of the counts and doc lengths and a
//     16-byte store where the row is 16-byte aligned.
//
// sa_score_term fills one f32[N] row with any similarity kind.
// sa_score_term_rows fills many tf rows (kind none) of the tf pool in one
// launch, grid = doc blocks x rows, each row its own slice of the posting
// planes, as K4 (plane_fill.cu) fills plane rows.
//
// Bound on the card: the 8 bytes of hdr32 + pay32 read per posting word,
// plus 4 bytes written (and 4 read for the doc length) per output doc.
// For a rare term at 1M docs the output row dominates: a dense f32[N] is
// written whatever the posting length, 1.25 us at 3.35 TB/s.  What stood
// between the old kernel and that was the dependent chain of a block's
// search before its first store; the warp search cuts it to ~2 loads.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "segmented.cuh"

namespace {

// kind codes, shared with ops/cuda/score.py
constexpr int KIND_NONE = 0;
constexpr int KIND_BM25 = 1;
constexpr int KIND_BM25_IMPACT = 2;
constexpr int KIND_BM25_LEGACY = 3;

__device__ __forceinline__ float similarity(int kind, float tf, float dl,
                                            float idf, float avgdl, float k1,
                                            float b) {
  if (kind == KIND_NONE) return tf;
  // denom = tf + k1 * ((1 - b) + b * (dl / avgdl)), its two multiply-adds
  // fused as the JAX package's compiled programs fuse them
  const float denom = __fmaf_rn(
      k1, __fmaf_rn(b, __fdiv_rn(dl, avgdl), __fsub_rn(1.0f, b)), tf);
  switch (kind) {
    case KIND_BM25:
      return __fmul_rn(__fdiv_rn(tf, denom), idf);
    case KIND_BM25_IMPACT:
      return __fdiv_rn(tf, denom);
    case KIND_BM25_LEGACY:  // idf * ((tf * (k1 + 1)) / (tf + norm))
      return __fmul_rn(idf,
                       __fdiv_rn(__fmul_rn(tf, __fadd_rn(k1, 1.0f)), denom));
  }
  return tf;  // unreachable: the wrapper validates kind
}

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // posting words per thread in flight
// Docs per block.  A launch whose every row has at most one word per
// SPARSE docs takes WIDE blocks: a thread then has UNROLL words or fewer
// on average, and a block's fixed cost (its search, its barriers) buys
// 16 KB of output instead of 4 KB.  Denser rows keep NARROW blocks,
// whose threads walk 4x fewer words each.
constexpr int NARROW = 1024;
constexpr int WIDE = 4096;
constexpr int SPARSE = WIDE / (THREADS * UNROLL);

bool wide(int64_t max_words, int64_t num_docs) {
  return max_words * SPARSE <= num_docs;
}

struct Similarity {
  int kind;
  float idf, avgdl, k1, b;
};

// Row r = blockIdx.y: words [offs[r], offs[r] + ns[r]) of hdrs/pays into
// out[out_rows[r]]; with offs null, the single row hdrs[0, n_words) into
// out itself.  At most 32 registers, so that 2048 threads fit on an SM:
// a rare term's block is mostly latency, which resident blocks hide.
template <int DOCS>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
score_term_kernel(const int32_t* __restrict__ hdrs,
                  const int32_t* __restrict__ pays,
                  const int64_t* __restrict__ offs,
                  const int64_t* __restrict__ ns, int64_t n_words,
                  const int64_t* __restrict__ out_rows,
                  float* __restrict__ out, int64_t out_stride,
                  const float* __restrict__ doc_lens, int64_t num_docs,
                  int blk_bits, const Similarity sim) {
  __shared__ __align__(16) int tf[DOCS];
  __shared__ int64_t range[2];

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * DOCS;
  const int64_t d1 = d0 + DOCS < num_docs ? d0 + DOCS : num_docs;
  if (offs) {
    hdrs += offs[blockIdx.y];
    pays += offs[blockIdx.y];
    n_words = ns[blockIdx.y];
    out += out_rows[blockIdx.y] * out_stride;
  }
  int4* tf4 = reinterpret_cast<int4*>(tf);
  for (int i = threadIdx.x; i < DOCS / 4; i += blockDim.x) {
    tf4[i] = make_int4(0, 0, 0, 0);
  }
  sa::block_range(hdrs, n_words, blk_bits, d0, d1, range);
  __syncthreads();

  // UNROLL words per thread in flight: their loads issue before any add.
  // A block with no words (most of a rare term's) skips the loop and its
  // barrier: each thread reads back only zeros the first barrier ordered.
  const int64_t w_hi = range[1];
  int64_t w = range[0] + threadIdx.x;
  const bool any = range[0] < w_hi;
  for (; w + (UNROLL - 1) * THREADS < w_hi; w += UNROLL * THREADS) {
    int h[UNROLL], p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h[u] = hdrs[w + u * THREADS];
      p[u] = pays[w + u * THREADS];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pc = __popc(static_cast<uint32_t>(p[u]));
      if (pc) atomicAdd(&tf[(h[u] >> blk_bits) - d0], pc);
    }
  }
  for (; w < w_hi; w += THREADS) {
    const int pc = __popc(static_cast<uint32_t>(pays[w]));
    if (pc) atomicAdd(&tf[(hdrs[w] >> blk_bits) - d0], pc);
  }
  if (any) __syncthreads();

  const bool dl = sim.kind != KIND_NONE;
  const bool vec =
      d1 - d0 == DOCS &&
      reinterpret_cast<uintptr_t>(out + d0) % 16 == 0 &&
      (!dl || reinterpret_cast<uintptr_t>(doc_lens + d0) % 16 == 0);
  if (vec) {
    float4* dst = reinterpret_cast<float4*>(out + d0);
    const float4* lens = reinterpret_cast<const float4*>(doc_lens + d0);
    for (int i = threadIdx.x; i < DOCS / 4; i += blockDim.x) {
      const int4 t = tf4[i];
      const float4 l = dl ? lens[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[i] = make_float4(
          similarity(sim.kind, static_cast<float>(t.x), l.x, sim.idf,
                     sim.avgdl, sim.k1, sim.b),
          similarity(sim.kind, static_cast<float>(t.y), l.y, sim.idf,
                     sim.avgdl, sim.k1, sim.b),
          similarity(sim.kind, static_cast<float>(t.z), l.z, sim.idf,
                     sim.avgdl, sim.k1, sim.b),
          similarity(sim.kind, static_cast<float>(t.w), l.w, sim.idf,
                     sim.avgdl, sim.k1, sim.b));
    }
  } else {
    for (int i = threadIdx.x; i < d1 - d0; i += blockDim.x) {
      const float len = dl ? doc_lens[d0 + i] : 0.0f;
      out[d0 + i] = similarity(sim.kind, static_cast<float>(tf[i]), len,
                               sim.idf, sim.avgdl, sim.k1, sim.b);
    }
  }
}

template <int DOCS>
int launch(const int32_t* hdrs, const int32_t* pays, const int64_t* offs,
           const int64_t* ns, int64_t n_words, const int64_t* out_rows,
           int64_t n_rows, float* out, int64_t out_stride,
           const float* doc_lens, int64_t num_docs, int blk_bits,
           const Similarity& sim, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((num_docs + DOCS - 1) / DOCS),
                  static_cast<unsigned>(n_rows));
  score_term_kernel<DOCS><<<grid, THREADS, 0, stream>>>(
      hdrs, pays, offs, ns, n_words, out_rows, out, out_stride, doc_lens,
      num_docs, blk_bits, sim);
  return static_cast<int>(cudaGetLastError());
}

int launch_any(bool is_wide, const void* hdrs, const void* pays,
               const void* offs, const void* ns, int64_t n_words,
               const void* out_rows, int64_t n_rows, void* out,
               int64_t out_stride, const void* doc_lens, int64_t num_docs,
               int blk_bits, const Similarity& sim, void* stream) {
  auto* h = static_cast<const int32_t*>(hdrs);
  auto* p = static_cast<const int32_t*>(pays);
  auto* o = static_cast<const int64_t*>(offs);
  auto* n = static_cast<const int64_t*>(ns);
  auto* r = static_cast<const int64_t*>(out_rows);
  auto* dst = static_cast<float*>(out);
  auto* dl = static_cast<const float*>(doc_lens);
  auto st = static_cast<cudaStream_t>(stream);
  return is_wide ? launch<WIDE>(h, p, o, n, n_words, r, n_rows, dst,
                                out_stride, dl, num_docs, blk_bits, sim, st)
                 : launch<NARROW>(h, p, o, n, n_words, r, n_rows, dst,
                                  out_stride, dl, num_docs, blk_bits, sim,
                                  st);
}

}  // namespace

// Plain C entries for ctypes.  Pointers are device pointers of contiguous
// tensors checked by the Python wrapper; the kernel runs on ``stream``
// and nothing here synchronises.  Each returns cudaGetLastError().
extern "C" int sa_score_term(const void* hdrs, const void* pays,
                             int64_t n_words, const void* doc_lens, void* out,
                             int64_t num_docs, int blk_bits, int kind,
                             float idf, float avgdl, float k1, float b,
                             int device, void* stream) {
  const DeviceGuard guard(device);
  return launch_any(wide(n_words, num_docs), hdrs, pays, nullptr, nullptr,
                    n_words, nullptr, 1, out, 0, doc_lens, num_docs,
                    blk_bits, Similarity{kind, idf, avgdl, k1, b}, stream);
}

// ``offs``/``ns``/``out_rows`` are device int64 arrays of ``n_rows``
// entries: row r's words are [offs[r], offs[r] + ns[r]) of hdrs/pays and
// its tf goes to out + out_rows[r] * out_stride (kind none).
// ``max_words`` is the largest ns[r], from the host.
extern "C" int sa_score_term_rows(const void* hdrs, const void* pays,
                                  const void* offs, const void* ns,
                                  const void* out_rows, int64_t n_rows,
                                  int64_t max_words, void* out,
                                  int64_t out_stride, int64_t num_docs,
                                  int blk_bits, int device, void* stream) {
  const DeviceGuard guard(device);
  return launch_any(wide(max_words, num_docs), hdrs, pays, offs, ns, 0,
                    out_rows, n_rows, out, out_stride, nullptr, num_docs,
                    blk_bits, Similarity{KIND_NONE, 0.f, 1.f, 0.f, 0.f},
                    stream);
}
