// K1: fused term scoring -- per-doc popcount tf with the BM25 family in
// the epilogue.
//
// Replaces the TPU kernel score_term_pallas
// (searcharray_tpu/ops/pallas/score.py:86, body _kernel at :30).  The
// Pallas version walks output doc blocks and reduces every word tile with
// a one-hot (doc_block x WORD_TILE) compare-and-sum, because the TPU has
// no fast scatter.  Hopper has fast shared-memory integer atomics, so
// here the same computation is a segmented reduction:
//
//   * block g owns docs [g*D, g*D + D) and binary-searches its word range
//     [w_lo, w_hi) in the term's doc-sorted slice (hdr >> blk_bits is the
//     doc key; PAD words sort last and fall outside every range);
//   * its threads stride over the range with coalesced 4-byte loads of
//     hdr32 and pay32, take __popc of the payload and add it into an int
//     counter per doc in shared memory.  Integer adds are exact, so the
//     result does not depend on the order the atomics land in;
//   * the epilogue converts each count to float, applies the similarity
//     with the association of scoring.apply_similarity_device (explicit
//     round-to-nearest intrinsics, so no fused multiply-add changes the
//     float32 result) and writes each output doc exactly once.
//
// Bound on the card: the 8 bytes of hdr32 + pay32 read per posting word,
// plus 4 bytes written (and 4 read for the doc length) per output doc.
// For a hot term at 1M docs the output row dominates: a dense f32[N] is
// written whatever the posting length.

#include <cuda_runtime.h>

#include <cstdint>

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
  // norm = k1 * ((1 - b) + b * (dl / avgdl))
  float norm = __fmul_rn(
      k1, __fadd_rn(__fsub_rn(1.0f, b), __fmul_rn(b, __fdiv_rn(dl, avgdl))));
  float denom = __fadd_rn(tf, norm);
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

__global__ void __launch_bounds__(sa::THREADS)
score_term_kernel(const int32_t* __restrict__ hdrs,
                  const int32_t* __restrict__ pays, int64_t n_words,
                  const float* __restrict__ doc_lens, float* __restrict__ out,
                  int64_t num_docs, int blk_bits, int kind, float idf,
                  float avgdl, float k1, float b) {
  __shared__ int tf[sa::DOCS_PER_BLOCK];
  __shared__ int64_t range[2];

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * sa::DOCS_PER_BLOCK;
  const int64_t d1 = d0 + sa::DOCS_PER_BLOCK < num_docs
                         ? d0 + sa::DOCS_PER_BLOCK
                         : num_docs;
  for (int i = threadIdx.x; i < sa::DOCS_PER_BLOCK; i += blockDim.x) tf[i] = 0;
  if (threadIdx.x < 2) {
    range[threadIdx.x] = sa::lower_bound_key(hdrs, n_words, blk_bits,
                                             threadIdx.x == 0 ? d0 : d1);
  }
  __syncthreads();

  const int64_t w_hi = range[1];
  for (int64_t w = range[0] + threadIdx.x; w < w_hi; w += blockDim.x) {
    const int pc = __popc(static_cast<uint32_t>(pays[w]));
    if (pc) atomicAdd(&tf[(hdrs[w] >> blk_bits) - d0], pc);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < d1 - d0; i += blockDim.x) {
    const int64_t d = d0 + i;
    const float dl = kind == KIND_NONE ? 0.0f : doc_lens[d];
    out[d] = similarity(kind, static_cast<float>(tf[i]), dl, idf, avgdl, k1,
                        b);
  }
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers of contiguous
// tensors checked by the Python wrapper; the kernel runs on ``stream``
// and nothing here synchronises.  Returns cudaGetLastError().
extern "C" int sa_score_term(const void* hdrs, const void* pays,
                             int64_t n_words, const void* doc_lens, void* out,
                             int64_t num_docs, int blk_bits, int kind,
                             float idf, float avgdl, float k1, float b,
                             int device, void* stream) {
  cudaSetDevice(device);
  const int64_t grid =
      (num_docs + sa::DOCS_PER_BLOCK - 1) / sa::DOCS_PER_BLOCK;
  score_term_kernel<<<static_cast<unsigned>(grid), sa::THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hdrs), static_cast<const int32_t*>(pays),
      n_words, static_cast<const float*>(doc_lens), static_cast<float*>(out),
      num_docs, blk_bits, kind, idf, avgdl, k1, b);
  return static_cast<int>(cudaGetLastError());
}
