// K10: the similarity -- BM25, its legacy and impact forms, or classic --
// of a block of term frequencies, in one elementwise pass.
//
// Replaces the XLA fusion of the JAX package's apply_similarity_device
// (searcharray_tpu/search/scoring.py:29), which every scoring path of the
// JAX package runs after its tf: the batch driver's group bodies, the
// candidate finish, the phrase and slop paths.  PyTorch has no single op
// for it, and no torch op rounds ``a * b + c`` once, which XLA's program
// does twice on the CPU (the length norm and its sum with tf are fused
// multiply-adds wherever avgdl is a traced argument).  So the kernel pins
// every rounding with an intrinsic, in the order ops/kernels.py's
// similarity_plain fixes:
//
//   x     = __fdiv_rn(dl, avgdl)
//   denom = __fmaf_rn(k1, __fmaf_rn(b, x, 1 - b), tf)
//   bm25        = __fmul_rn(__fdiv_rn(tf, denom), idf)
//   bm25_legacy = __fmul_rn(idf, __fdiv_rn(__fmul_rn(tf, k1 + 1), denom))
//   bm25_impact = __fdiv_rn(tf, denom)
//   classic     = __fdiv_rn(__fmul_rn(idf, __fsqrt_rn(tf)), __fsqrt_rn(dl))
//
// (Triton's ``/`` may lower to an approximate division; nvcc's intrinsics
// give one IEEE rounding each.)
//
// Layout: tf is f32 [rows, n] with a row stride, out the same (it may be
// tf itself: each thread reads an element before it writes it), doc
// lengths one f32 [n] row for every row or f32 [rows, n] (the candidate
// path's lengths gathered per row), idf one scalar or one per row.
//
// Bound on the card: bytes.  4 bytes of tf read and 4 of out written per
// element, plus the doc lengths once a launch ([n]) or per element
// ([rows, n]); a few float operations per element are far below the
// card's float32 rate.  A block owns a tile of COLS columns over up to
// ROWS rows: each thread loads its four doc lengths once (16 bytes) and
// reuses them across the rows, and moves tf and out 16 bytes at a time
// where the rows are 16-byte aligned (scalar loads otherwise).

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

// kind codes, shared with ops/cuda/score.py (SIM_KINDS)
constexpr int SIM_BM25 = 1;
constexpr int SIM_BM25_IMPACT = 2;
constexpr int SIM_BM25_LEGACY = 3;
constexpr int SIM_CLASSIC = 4;

constexpr int THREADS = 256;
constexpr int COLS = THREADS * 4;  // columns of a block's tile
constexpr int ROWS = 16;           // rows a block walks with one tile

struct Params {
  int kind;
  float idf, avgdl, k1, b, one_minus_b, k1_plus_1;
};

__device__ __forceinline__ float sim(const Params& p, float tf, float dl,
                                     float idf) {
  if (p.kind == SIM_CLASSIC) {
    return __fdiv_rn(__fmul_rn(idf, __fsqrt_rn(tf)), __fsqrt_rn(dl));
  }
  const float inner = __fmaf_rn(p.b, __fdiv_rn(dl, p.avgdl), p.one_minus_b);
  const float denom = __fmaf_rn(p.k1, inner, tf);
  if (p.kind == SIM_BM25) return __fmul_rn(__fdiv_rn(tf, denom), idf);
  if (p.kind == SIM_BM25_LEGACY) {
    return __fmul_rn(idf, __fdiv_rn(__fmul_rn(tf, p.k1_plus_1), denom));
  }
  return __fdiv_rn(tf, denom);  // SIM_BM25_IMPACT
}

// Block (x, y): columns [x * COLS, x * COLS + COLS), rows [y * ROWS,
// y * ROWS + ROWS); thread t its four columns x * COLS + 4t ...
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
similarity_kernel(const float* tf, int64_t rows, int64_t n, int64_t tf_stride,
                  const float* __restrict__ doc_lens, int64_t dl_stride,
                  const float* __restrict__ idfs, float* out,
                  int64_t out_stride, const Params p) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * COLS + 4 * threadIdx.x;
  if (c >= n) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * ROWS;
  const int64_t r1 = r0 + ROWS < rows ? r0 + ROWS : rows;
  const int w = n - c < 4 ? static_cast<int>(n - c) : 4;  // columns here
  float dl[4] = {1.f, 1.f, 1.f, 1.f};
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t r = r0; r < r1; ++r) {
    const float* lens = doc_lens + r * dl_stride + c;
    if (r == r0 || dl_stride) {
      if (VEC) {
        const float4 v = *reinterpret_cast<const float4*>(lens);
        dl[0] = v.x, dl[1] = v.y, dl[2] = v.z, dl[3] = v.w;
      } else {
        for (int j = 0; j < w; ++j) dl[j] = lens[j];
      }
    }
    const float idf = idfs ? idfs[r] : p.idf;
    const float* src = tf + r * tf_stride + c;
    float* dst = out + r * out_stride + c;
    if (VEC) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      *reinterpret_cast<float4*>(dst) =
          make_float4(sim(p, v.x, dl[0], idf), sim(p, v.y, dl[1], idf),
                      sim(p, v.z, dl[2], idf), sim(p, v.w, dl[3], idf));
    } else {
      for (int j = 0; j < w; ++j) t[j] = src[j];
      for (int j = 0; j < w; ++j) dst[j] = sim(p, t[j], dl[j], idf);
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Plain C entry for ctypes (see sa_score_term).  ``tf`` and ``out`` are
// f32 [rows, n] with row strides ``tf_stride`` and ``out_stride`` (``out``
// may be ``tf``); ``doc_lens`` is f32 [n] with ``dl_stride`` 0, or f32
// [rows, n] with row stride ``dl_stride``; ``idfs`` is f32 [rows], or null
// for the one ``idf``.  ``kind`` is a SIM_* code.  Returns
// cudaGetLastError().
extern "C" int sa_similarity(const void* tf, int64_t rows, int64_t n,
                             int64_t tf_stride, const void* doc_lens,
                             int64_t dl_stride, const void* idfs, float idf,
                             void* out, int64_t out_stride, int kind,
                             float avgdl, float k1, float b, int device,
                             void* stream) {
  const DeviceGuard guard(device);
  if (rows <= 0 || n <= 0) return 0;
  if (kind < SIM_BM25 || kind > SIM_CLASSIC || rows > 65535LL * ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // host float arithmetic: one IEEE single rounding each
  const Params p{kind, idf, avgdl, k1, b, 1.0f - b, k1 + 1.0f};
  const bool vec = n % 4 == 0 && tf_stride % 4 == 0 && out_stride % 4 == 0 &&
                   dl_stride % 4 == 0 && aligned16(tf) && aligned16(out) &&
                   aligned16(doc_lens);
  const dim3 grid(static_cast<unsigned>((n + COLS - 1) / COLS),
                  static_cast<unsigned>((rows + ROWS - 1) / ROWS));
  auto kernel = vec ? similarity_kernel<true> : similarity_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tf), rows, n, tf_stride,
      static_cast<const float*>(doc_lens), dl_stride,
      static_cast<const float*>(idfs), static_cast<float*>(out), out_stride,
      p);
  return static_cast<int>(cudaGetLastError());
}
