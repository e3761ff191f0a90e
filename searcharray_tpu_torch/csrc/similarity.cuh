// The similarity of one term frequency: the per-element function of K10
// (similarity.cu) and of the fused ranking pass (topk.cu's rank_rows), so
// that both round every score alike, in the order ops/kernels.py's
// similarity_plain fixes:
//
//   x     = __fdiv_rn(dl, avgdl)
//   denom = __fmaf_rn(k1, __fmaf_rn(b, x, 1 - b), tf)
//   bm25        = __fmul_rn(__fdiv_rn(tf, denom), idf)
//   bm25_legacy = __fmul_rn(idf, __fdiv_rn(__fmul_rn(tf, k1 + 1), denom))
//   bm25_impact = __fdiv_rn(tf, denom)
//   classic     = __fdiv_rn(__fmul_rn(idf, __fsqrt_rn(tf)), __fsqrt_rn(dl))
//
// No guard on a zero length: classic reads 0 / 0 there, as the plain
// version does.
#pragma once

#include <cuda_runtime.h>

namespace sim {

// kind codes, shared with ops/cuda/score.py (SIM_KINDS)
constexpr int BM25 = 1;
constexpr int BM25_IMPACT = 2;
constexpr int BM25_LEGACY = 3;
constexpr int CLASSIC = 4;

struct Params {
  int kind;
  float idf, avgdl, k1, b, one_minus_b, k1_plus_1;
};

// The Params of a launch: host float arithmetic, one IEEE single rounding
// each.
inline Params params(int kind, float idf, float avgdl, float k1, float b) {
  return Params{kind, idf, avgdl, k1, b, 1.0f - b, k1 + 1.0f};
}

// The similarity of kind KIND (a compile-time code).
template <int KIND>
__device__ __forceinline__ float score(const Params& p, float tf, float dl,
                                       float idf) {
  if (KIND == CLASSIC) {
    return __fdiv_rn(__fmul_rn(idf, __fsqrt_rn(tf)), __fsqrt_rn(dl));
  }
  const float inner = __fmaf_rn(p.b, __fdiv_rn(dl, p.avgdl), p.one_minus_b);
  const float denom = __fmaf_rn(p.k1, inner, tf);
  if (KIND == BM25) return __fmul_rn(__fdiv_rn(tf, denom), idf);
  if (KIND == BM25_LEGACY) {
    return __fmul_rn(idf, __fdiv_rn(__fmul_rn(tf, p.k1_plus_1), denom));
  }
  return __fdiv_rn(tf, denom);  // BM25_IMPACT
}

// The similarity of the launch's kind (``p.kind``, read at run time).
__device__ __forceinline__ float score(const Params& p, float tf, float dl,
                                       float idf) {
  switch (p.kind) {
    case CLASSIC:
      return score<CLASSIC>(p, tf, dl, idf);
    case BM25:
      return score<BM25>(p, tf, dl, idf);
    case BM25_LEGACY:
      return score<BM25_LEGACY>(p, tf, dl, idf);
    default:
      return score<BM25_IMPACT>(p, tf, dl, idf);
  }
}

}  // namespace sim
