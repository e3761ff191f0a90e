"""K1 (fused term scoring) and K2 (sorted segment-sum): Hopper kernels,
their plain PyTorch versions, and the build.

The kernels are CUDA C++ in ``searcharray_tpu_torch/csrc/`` with a plain C
interface.  At first use they are compiled with ``nvcc`` for ``sm_90a``
into ``build/searcharray_tpu_torch/kernels/`` (keyed by a hash of the
sources) and loaded with ctypes.

Each wrapper takes its plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises; it never falls back.  Each
wrapper counts its kernel launches in a plain int attribute
(``score_term.launches``, ``segment_sum.launches``).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from searcharray_tpu_torch.ops.kernels import apply_similarity_device

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "searcharray_tpu_torch", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

KINDS = {"none": 0, "bm25": 1, "bm25_impact": 2, "bm25_legacy": 3}

_lib = None
_lib_lock = threading.Lock()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsa_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no library for the current sources exists;
    returns its path.  Raises with the compiler's output on failure."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[p for p in _sources() if p.endswith(".cu")]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i64, c_int, c_f = (ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_float)
            lib.sa_score_term.argtypes = [vp, vp, i64, vp, vp, i64, c_int,
                                          c_int, c_f, c_f, c_f, c_f, c_int,
                                          vp]
            lib.sa_score_term.restype = c_int
            lib.sa_segment_sum.argtypes = [vp, vp, i64, vp, i64, c_int, vp]
            lib.sa_segment_sum.restype = c_int
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# K1: fused term scoring
# ---------------------------------------------------------------------------
def popcount_i32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of non-negative int32 values (torch has no popcount
    op; ``>>`` on int32 is arithmetic, exact for the 18-bit payloads)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


def _f32(x) -> float:
    """A scalar rounded to float32, as a Python float (exact)."""
    return float(np.float32(x))


def score_term_plain(hdrs, pays, doc_lens, idf, avgdl, *, num_docs: int,
                     blk_bits: int, kind: str = "bm25", k1: float = 1.2,
                     b: float = 0.75) -> torch.Tensor:
    """Plain PyTorch K1: popcount tf by doc key (PAD and out-of-range keys
    masked before ``index_add_``, which raises on a bad index), then the
    similarity."""
    keys = hdrs >> blk_bits
    ok = keys < num_docs
    tf = torch.zeros(num_docs, dtype=torch.float32, device=hdrs.device)
    tf.index_add_(0, keys[ok], popcount_i32(pays[ok]).to(torch.float32))
    return apply_similarity_device(kind, tf, doc_lens, _f32(idf),
                                   _f32(avgdl), k1, b)


def score_term(hdrs: torch.Tensor, pays: torch.Tensor,
               doc_lens: torch.Tensor, idf: float, avgdl: float, *,
               num_docs: int, blk_bits: int, kind: str = "bm25",
               k1: float = 1.2, b: float = 0.75,
               out: torch.Tensor = None) -> torch.Tensor:
    """Per-doc tf of one term's doc-sorted (hdr32, pay32) slice with the
    similarity ``kind`` (none / bm25 / bm25_impact / bm25_legacy) fused.

    ``hdrs``/``pays`` are int32[M] (PAD_HDR32 words and keys >= num_docs
    are dropped), ``doc_lens`` f32[num_docs].  Returns f32[num_docs], in
    ``out`` when given (a contiguous f32[num_docs], e.g. a tf-pool row)."""
    if kind not in KINDS:
        raise ValueError(f"K1 has no similarity kind {kind}")
    dev = hdrs.device
    for t, name, dt in ((hdrs, "hdrs", torch.int32),
                        (pays, "pays", torch.int32),
                        (doc_lens, "doc_lens", torch.float32)):
        _check(t, name, dt, dev)
    if pays.shape != hdrs.shape or doc_lens.shape[0] != num_docs:
        raise ValueError("hdrs/pays lengths differ or doc_lens is not "
                         "f32[num_docs]")
    if out is None:
        out = torch.empty(num_docs, dtype=torch.float32, device=dev)
    else:
        _check(out, "out", torch.float32, dev)
        if out.shape[0] != num_docs:
            raise ValueError("out must be f32[num_docs]")
    if dev.type == "cpu":
        out.copy_(score_term_plain(hdrs, pays, doc_lens, idf, avgdl,
                                   num_docs=num_docs, blk_bits=blk_bits,
                                   kind=kind, k1=k1, b=b))
        return out
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    if num_docs == 0:
        return out
    lib = _get_lib()
    err = lib.sa_score_term(
        hdrs.data_ptr(), pays.data_ptr(), hdrs.shape[0], doc_lens.data_ptr(),
        out.data_ptr(), num_docs, blk_bits, KINDS[kind], _f32(idf),
        _f32(avgdl), _f32(k1), _f32(b), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "score_term")
    score_term.launches += 1
    return out


score_term.launches = 0


# ---------------------------------------------------------------------------
# K2: sorted segment-sum
# ---------------------------------------------------------------------------
def segment_sum_plain(sorted_ids, values, *, num_docs: int) -> torch.Tensor:
    """Plain PyTorch K2: ``index_add_`` of the in-range ids."""
    ok = (sorted_ids >= 0) & (sorted_ids < num_docs)
    out = torch.zeros(num_docs, dtype=torch.float32, device=values.device)
    return out.index_add_(0, sorted_ids[ok], values[ok])


def segment_sum(sorted_ids: torch.Tensor, values: torch.Tensor, *,
                num_docs: int) -> torch.Tensor:
    """Dense f32[num_docs] sums of ``values`` grouped by ``sorted_ids``
    (non-decreasing int32; ids >= num_docs, such as a 2^30 pad, are
    dropped)."""
    dev = sorted_ids.device
    _check(sorted_ids, "sorted_ids", torch.int32, dev)
    _check(values, "values", torch.float32, dev)
    if values.shape != sorted_ids.shape:
        raise ValueError("sorted_ids and values lengths differ")
    if dev.type == "cpu":
        return segment_sum_plain(sorted_ids, values, num_docs=num_docs)
    if dev.type != "cuda":
        raise ValueError(f"no K2 kernel for device {dev}")
    out = torch.empty(num_docs, dtype=torch.float32, device=dev)
    if num_docs == 0:
        return out
    lib = _get_lib()
    err = lib.sa_segment_sum(
        sorted_ids.data_ptr(), values.data_ptr(), sorted_ids.shape[0],
        out.data_ptr(), num_docs, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
