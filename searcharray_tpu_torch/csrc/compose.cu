// K11: edismax's dismax / tie / mm composition of per-field score stacks
// into one f32 score per document, in one elementwise pass.
//
// Replaces the XLA fusions of the JAX package's composers
// (searcharray_tpu/solr.py: _compose_tc_jit :110, _compose_fc_jit :135,
// and the two branches of _compose_batch_jit :509-553).  PyTorch has no
// single op for it, and no torch op rounds ``a * b + c`` once, which XLA's
// programs do on the CPU.  So every rounding is pinned by an intrinsic, in
// the order ops/kernels.py's compose_plain fixes (read from the JAX
// programs' CPU code: vfmadd where listed, one rounding per op elsewhere):
//
//   term-centric, per term t (fields f in order):
//     fs_f = __fmul_rn(s_f, b_f);  mx = max_f fs_f
//     sm   = fs_0, then __fmaf_rn(s_f, b_f, sm) (CHAIN: edismax's program)
//            or __fadd_rn(sm, fs_f) (edismax_batch's, under lax.map)
//     ts   = __fmaf_rn(__fsub_rn(sm, mx), tie, mx)
//     tot  = __fadd_rn(tot, ts), cnt += ts > 0
//   out = cnt >= msm ? tot : 0
//
//   field-centric, per field f:
//     tot_f = the sum of its terms' scores in order, cnt_f of those > 0
//     v_f   = __fmul_rn(cnt_f >= msm_f ? tot_f : 0, b_f)
//     sm    = __fadd_rn(sm, v_f), mx = max_f v_f
//   out = __fmaf_rn(__fsub_rn(sm, mx), tie, mx)
//
// Layout: up to MAX_FIELDS stacks, each f32 [T_f, n] with its own row
// stride (the batch path passes row views of a shared stack), given as a
// table of pointers in the launch's parameters beside the boosts, term
// counts and msm values; out is f32 [n].
//
// Bound on the card: bytes.  Every stack element is read once (4 bytes)
// and every document's score written once (4 bytes); a few float
// operations per element are far below the card's float32 rate.  A
// thread owns one column and walks the terms and fields in the JAX order;
// neighbouring threads read neighbouring addresses of each row, so every
// load of a warp is one 128-byte line, and each thread's loads of the
// next rows are independent of its arithmetic.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_FIELDS = 16;

struct Stacks {
  const float* ptr[MAX_FIELDS];
  int64_t stride[MAX_FIELDS];
  int terms[MAX_FIELDS];
  float boost[MAX_FIELDS];
  int msm[MAX_FIELDS];
  int fields;
  float tie;
};

__device__ __forceinline__ float fmax_keep(float a, float b) {
  return b > a ? b : a;
}

template <bool CHAIN>
__global__ void __launch_bounds__(THREADS)
compose_tc_kernel(const Stacks st, int64_t n, float* __restrict__ out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= n) return;
  float tot = 0.f;
  int cnt = 0;
  for (int t = 0; t < st.terms[0]; ++t) {
    const float s0 = __ldg(st.ptr[0] + t * st.stride[0] + c);
    float mx = __fmul_rn(s0, st.boost[0]);
    float sm = mx;
    for (int f = 1; f < st.fields; ++f) {
      const float s = __ldg(st.ptr[f] + t * st.stride[f] + c);
      const float fs = __fmul_rn(s, st.boost[f]);
      mx = fmax_keep(mx, fs);
      sm = CHAIN ? __fmaf_rn(s, st.boost[f], sm) : __fadd_rn(sm, fs);
    }
    const float ts = __fmaf_rn(__fsub_rn(sm, mx), st.tie, mx);
    cnt += ts > 0.f;
    tot = __fadd_rn(tot, ts);
  }
  out[c] = cnt >= st.msm[0] ? tot : 0.f;
}

__global__ void __launch_bounds__(THREADS)
compose_fc_kernel(const Stacks st, int64_t n, float* __restrict__ out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= n) return;
  float sm = 0.f, mx = 0.f;
  for (int f = 0; f < st.fields; ++f) {
    float tot = 0.f;
    int cnt = 0;
    for (int t = 0; t < st.terms[f]; ++t) {
      const float s = __ldg(st.ptr[f] + t * st.stride[f] + c);
      cnt += s > 0.f;
      tot = __fadd_rn(tot, s);
    }
    const float v = __fmul_rn(cnt >= st.msm[f] ? tot : 0.f, st.boost[f]);
    sm = __fadd_rn(sm, v);
    mx = f == 0 ? v : fmax_keep(mx, v);
  }
  out[c] = __fmaf_rn(__fsub_rn(sm, mx), st.tie, mx);
}

}  // namespace

// Plain C entry for ctypes (see sa_score_term).  ``ptrs``, ``strides``,
// ``terms``, ``boosts`` and ``msms`` are host arrays of ``fields`` entries:
// each stack's device address, its row stride in elements, its number of
// rows, its boost and its msm (term-centric: every ``terms`` entry is the
// same and ``msms[0]`` is the query's).  ``out`` is f32 [n] on the device.
// ``chain`` takes the term-centric field sum as fused multiply-adds.
// Returns cudaGetLastError().
extern "C" int sa_compose(const int64_t* ptrs, const int64_t* strides,
                          const int32_t* terms, const float* boosts,
                          const int32_t* msms, int fields, int64_t n,
                          float tie, int term_centric, int chain, void* out,
                          int device, void* stream) {
  const DeviceGuard guard(device);
  if (fields < 1 || fields > MAX_FIELDS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  Stacks st{};
  for (int f = 0; f < fields; ++f) {
    st.ptr[f] = reinterpret_cast<const float*>(ptrs[f]);
    st.stride[f] = strides[f];
    st.terms[f] = terms[f];
    st.boost[f] = boosts[f];
    st.msm[f] = msms[f];
    if (terms[f] < 0 || (term_centric && terms[f] != terms[0])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  st.fields = fields;
  st.tie = tie;
  const unsigned grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (!term_centric) {
    compose_fc_kernel<<<grid, THREADS, 0, s>>>(st, n, o);
  } else if (chain) {
    compose_tc_kernel<true><<<grid, THREADS, 0, s>>>(st, n, o);
  } else {
    compose_tc_kernel<false><<<grid, THREADS, 0, s>>>(st, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}
