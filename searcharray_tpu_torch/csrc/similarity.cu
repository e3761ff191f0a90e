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
// similarity_plain fixes: similarity.cuh's sim::score, the per-element
// function that the fused ranking pass (topk.cu, rank_rows) shares.
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
#include "similarity.cuh"

namespace {

using sim::Params;

constexpr int THREADS = 256;
constexpr int COLS = THREADS * 4;  // columns of a block's tile
constexpr int ROWS = 16;           // rows a block walks with one tile

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
          make_float4(sim::score(p, v.x, dl[0], idf),
                      sim::score(p, v.y, dl[1], idf),
                      sim::score(p, v.z, dl[2], idf),
                      sim::score(p, v.w, dl[3], idf));
    } else {
      for (int j = 0; j < w; ++j) t[j] = src[j];
      for (int j = 0; j < w; ++j) dst[j] = sim::score(p, t[j], dl[j], idf);
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
// for the one ``idf``.  ``kind`` is a sim:: kind code.  Returns
// cudaGetLastError().
extern "C" int sa_similarity(const void* tf, int64_t rows, int64_t n,
                             int64_t tf_stride, const void* doc_lens,
                             int64_t dl_stride, const void* idfs, float idf,
                             void* out, int64_t out_stride, int kind,
                             float avgdl, float k1, float b, int device,
                             void* stream) {
  const DeviceGuard guard(device);
  if (rows <= 0 || n <= 0) return 0;
  if (kind < sim::BM25 || kind > sim::CLASSIC || rows > 65535LL * ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = sim::params(kind, idf, avgdl, k1, b);
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
