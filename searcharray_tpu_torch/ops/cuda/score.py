"""K1 (fused term scoring), K2 (sorted segment-sum), K3 (exact top-k), K4
(plane fill), K5 (the exact-phrase bigram chain on dense planes), K6 (the
slop window coverage on dense planes), K7 (a bigram step of the sparse
phrase chain), K8a (candidate rows from a posting slice), K8b (mini-planes
over candidate rows), K9 (the slop window coverage on posting slices) and
K10 (the similarity of a block of term frequencies) and K11 (edismax's
dismax / tie / mm composition): Hopper kernels, their plain PyTorch
versions, and the build of the one kernel library.

The kernels are CUDA C++ in ``searcharray_tpu_torch/csrc/`` with a plain C
interface.  At first use they are compiled with ``nvcc`` for ``sm_90a``
into ``build/searcharray_tpu_torch/kernels/`` (keyed by a hash of the
sources) and loaded with ctypes.

Each wrapper takes its plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises; it never falls back.  Each
wrapper counts its kernel launches in a plain int attribute
(``score_term.launches``, ``score_term_rows.launches``,
``segment_sum.launches``, ``topk.launches``, ``plane_fill.launches``,
``phrase_chain.launches``, ``span_window.launches``,
``merge_step.launches``, ``cand_rows.launches``, ``cand_minis.launches``,
``span_sparse.launches``, ``similarity.launches``,
``compose.launches``, ``rank_rows.launches``), under ``COUNT_LOCK``.  A
K3 launch is one call of a C entry, which enqueues one or two kernels (k
up to ``sa_topk_one_pass_cap()``) or ``TOPK_KERNELS_PER_LAUNCH`` (larger
k); ``topk.kernels`` counts them, and ``rank_rows.kernels`` those of the
fused ranking pass (K3's two-launch selection over scores that K10's
per-element function computes as it reads them: one kernel or two).  A
K8a launch enqueues ``CAND_ROWS_KERNELS_PER_LAUNCH``.
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

from searcharray_tpu_torch.ops.kernels import (  # noqa: F401 (re-export)
    compact_rows_plain,
    compose_plain,
    merge_step_plain,
    minis_for_rows_plain,
    per_query,
    phrase_counts_dense_planes,
    popcount_i32,
    rank_rows_plain,
    similarity_plain,
    span_counts_dense_planes_plain,
    span_neighbourhood_plain,
    topk_exact,
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "searcharray_tpu_torch", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

KINDS = {"none": 0, "bm25": 1, "bm25_impact": 2, "bm25_legacy": 3}
SIM_KINDS = {"bm25": 1, "bm25_impact": 2, "bm25_legacy": 3, "classic": 4}

CHAIN_MAX_TERMS = 32         # K5 takes phrases of at most this many terms
SPAN_MAX_TERMS = 32          # K6 takes at most this many distinct terms
SPAN_MAX_WINDOW = 18         # K6's window: one slot's positions
TOPK_KERNELS_PER_LAUNCH = 9  # above the one-pass cap: three histogram and
                             # select passes, the tie scan, the filter, and
                             # the sort or the unpack
CAND_ROWS_KERNELS_PER_LAUNCH = 1   # K8a: one single-pass kernel

_lib = None
_lib_lock = threading.Lock()

# The wrappers' launch counts and the engine's counters are host integers
# that concurrent queries bump together: one lock keeps each
# read-modify-write whole, so a count read after the threads join is
# exact.
COUNT_LOCK = threading.Lock()


def bump(counter: list, n: int = 1) -> None:
    """``counter[0] += n`` under ``COUNT_LOCK`` (the engine's counters:
    ``dense.DISPATCHES``, ``batch.CAND_GROUPS``, ``sharded.PLANS``...)."""
    with COUNT_LOCK:
        counter[0] += n


def _launched(wrapper, kernels: int = 0) -> None:
    """Count one launch of ``wrapper``, and ``kernels`` device kernels it
    enqueued where the wrapper counts them (``topk.kernels``)."""
    with COUNT_LOCK:
        wrapper.launches += 1
        if kernels:
            wrapper.kernels += kernels


def _sources(csrc_dir: str = CSRC_DIR):
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cu"))
                  + glob.glob(os.path.join(csrc_dir, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256()
    for path in _sources(csrc_dir):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"libsa_kernels-{h.hexdigest()[:16]}.so")


def build(csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR) -> str:
    """Compile the kernels of ``csrc_dir`` (the package's own by default)
    into ``build_dir`` if no library for those sources exists there;
    returns its path.  One nvcc per source, all started together, then
    one link.  Raises with the compiler's output on failure."""
    so = library_path(csrc_dir, build_dir)
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        jobs = []
        for src in (p for p in _sources(csrc_dir) if p.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            jobs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", *NVCC_FLAGS, "-o", lib,
                              *(obj for obj, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(lib, so)
    return so


_vp, _i64, _int, _f = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_float)
# the C entries of the library and their argument types
_ENTRIES = {
    "sa_score_term": [_vp, _vp, _i64, _vp, _vp, _i64, _int, _int, _f, _f,
                      _f, _f, _int, _vp],
    "sa_score_term_rows": [_vp, _vp, _vp, _vp, _vp, _i64, _i64, _vp, _i64,
                           _i64, _int, _int, _vp],
    "sa_segment_sum": [_vp, _vp, _i64, _vp, _i64, _int, _vp],
    "sa_plane_fill": [_vp, _vp, _vp, _vp, _vp, _i64, _vp, _i64, _int, _vp],
    "sa_phrase_chain": [_vp, _i64, _vp, _i64, _int, _vp, _i64, _int, _vp,
                        _i64, _vp, _int, _vp],
    "sa_merge_join": [_vp, _vp, _vp, _vp, _i64, _i64, _int, _int, _int,
                      _vp, _vp, _vp, _int, _vp],
    "sa_merge_join_tile": [],
    "sa_topk": [_vp, _i64, _i64, _i64, _vp, _vp, _i64, _vp, _vp, _int, _vp],
    "sa_topk_unpack": [_vp, _i64, _i64, _vp, _i64, _vp, _vp, _int, _vp],
    "sa_topk_sort_cap": [],
    "sa_topk_row_scratch_bytes": [],
    "sa_topk_select": [_vp, _i64, _i64, _i64, _vp, _vp, _vp, _int, _vp],
    "sa_topk_tile": [],
    "sa_topk_one_pass_cap": [],
    "sa_rank_rows": [_vp, _i64, _vp, _i64, _i64, _vp, _vp, _int, _f, _f, _f,
                     _i64, _vp, _vp, _vp, _int, _vp],
    "sa_span_window": [_vp, _i64, _vp, _i64, _int, _int, _int, _vp, _i64,
                       _int, _vp, _i64, _vp, _int, _vp],
    "sa_span_sparse": [_vp, _vp, _vp, _i64, _i64, _int, _int, _int, _int,
                       _int, _int, _int, _vp, _i64, _vp, _vp, _int, _vp],
    "sa_span_sparse_tile": [],
    "sa_span_sparse_local_terms": [],
    "sa_cand_rows": [_vp, _vp, _vp, _i64, _i64, _i64, _int, _int, _vp, _vp,
                     _int, _vp],
    "sa_cand_rows_tile": [],
    "sa_cand_rows_grid": [_i64, _i64, _i64, _int],
    "sa_cand_minis": [_vp, _i64, _i64, _vp, _i64, _int, _vp, _i64, _vp, _vp,
                      _int, _int, _vp, _int, _vp],
    "sa_similarity": [_vp, _i64, _i64, _i64, _vp, _i64, _vp, _f, _vp, _i64,
                      _int, _f, _f, _f, _int, _vp],
    "sa_compose": [_vp, _vp, _vp, _vp, _vp, _int, _i64, _f, _int, _int, _vp,
                   _int, _vp],
}


def load_library(path: str):
    """Load a kernel library built by ``build`` and declare the argument
    types of the C entries it has."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _int
    return lib


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(build())
    return _lib


def _check(t: torch.Tensor, name: str, dtype, device,
                 ndim: int = 1) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor")


def _host_index(values, name: str, bound: int) -> np.ndarray:
    """A host int64 index array, every entry checked to lie in [0, bound)
    before a kernel dereferences it."""
    arr = np.asarray(values, dtype=np.int64)
    if arr.size and (arr.min() < 0 or arr.max() >= bound):
        raise ValueError(f"{name} out of range [0, {bound})")
    return arr


def host_to_device(values, device) -> torch.Tensor:
    """A small host array (slots, offsets, idfs) as a tensor on
    ``device``.  On a card it goes through pinned memory with a
    non-blocking copy: a plain copy from pageable memory makes the host
    wait for everything enqueued before it, once per wrapper call."""
    arr = np.ascontiguousarray(values)
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(arr, device=device)
    return torch.from_numpy(arr).pin_memory().to(device, non_blocking=True)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# K1: fused term scoring
# ---------------------------------------------------------------------------
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
    return similarity_plain(kind, tf, doc_lens, _f32(idf), _f32(avgdl), k1,
                            b)


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
    _launched(score_term)
    return out


score_term.launches = 0


def score_term_rows_plain(hdrs, pays, offs, ns, out, out_rows, *,
                          num_docs: int, blk_bits: int) -> torch.Tensor:
    """Plain PyTorch multi-row K1: one ``score_term_plain`` (kind none)
    per row."""
    for off, n, row in zip(offs.tolist(), ns.tolist(), out_rows.tolist()):
        out[row] = score_term_plain(hdrs[off: off + n], pays[off: off + n],
                                    None, 0.0, 1.0, num_docs=num_docs,
                                    blk_bits=blk_bits, kind="none")
    return out


def score_term_rows(hdrs: torch.Tensor, pays: torch.Tensor, offs, ns,
                    out: torch.Tensor, out_rows, *, num_docs: int,
                    blk_bits: int) -> torch.Tensor:
    """Per-doc tf (kind none) of many terms in one launch: for each row r,
    ``out[out_rows[r]]`` = the tf of the words ``[offs[r], offs[r] +
    ns[r])`` of the doc-sorted ``hdrs``/``pays`` planes.

    ``out`` is an f32 [R, num_docs] tensor (the tf pool), filled in place
    and returned; ``offs``/``ns``/``out_rows`` are host integer sequences,
    one entry per row."""
    dev = out.device
    _check(hdrs, "hdrs", torch.int32, dev)
    _check(pays, "pays", torch.int32, dev)
    _check(out, "out", torch.float32, dev, ndim=2)
    if pays.shape != hdrs.shape or out.shape[1] != num_docs:
        raise ValueError("hdrs/pays lengths differ or out rows are not "
                         "num_docs wide")
    offs = _host_index(offs, "offs", hdrs.shape[0] + 1)
    ns = np.asarray(ns, dtype=np.int64)
    rows = _host_index(out_rows, "out_rows", out.shape[0])
    if not (offs.shape == ns.shape == rows.shape) or offs.ndim != 1:
        raise ValueError("offs, ns and out_rows must be 1-D of one length")
    if ns.size and (ns.min() < 0 or (offs + ns).max() > hdrs.shape[0]):
        raise ValueError("a posting slice runs past the planes")
    if len(set(rows.tolist())) != len(rows):
        raise ValueError("a tf row is filled twice in one call")
    if dev.type == "cpu":
        return score_term_rows_plain(hdrs, pays, offs, ns, out, rows,
                                     num_docs=num_docs, blk_bits=blk_bits)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    if len(rows) == 0 or num_docs == 0:
        return out
    meta = host_to_device(np.stack([offs, ns, rows]), dev)
    err = _get_lib().sa_score_term_rows(
        hdrs.data_ptr(), pays.data_ptr(), meta[0].data_ptr(),
        meta[1].data_ptr(), meta[2].data_ptr(), len(rows), int(ns.max()),
        out.data_ptr(), out.stride(0), num_docs, blk_bits, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "score_term_rows")
    _launched(score_term_rows)
    return out


score_term_rows.launches = 0


# ---------------------------------------------------------------------------
# K2: sorted segment-sum
# ---------------------------------------------------------------------------
def segment_sum_plain(sorted_ids, values, *, num_docs: int) -> torch.Tensor:
    """Plain PyTorch K2: ``index_add_`` of the in-range ids, in the dtype
    of ``values`` (float64 values give a reference for float32 sums)."""
    ok = (sorted_ids >= 0) & (sorted_ids < num_docs)
    out = torch.zeros(num_docs, dtype=values.dtype, device=values.device)
    return out.index_add_(0, sorted_ids[ok], values[ok])


def segment_sum(sorted_ids: torch.Tensor, values: torch.Tensor, *,
                num_docs: int) -> torch.Tensor:
    """Dense f32[num_docs] sums of ``values`` grouped by ``sorted_ids``
    (non-decreasing int32; ids >= num_docs, such as a 2^30 pad, are
    dropped).  One launch, split evenly over keys and output slots
    (csrc/segment_sum.cu), so a long run of one id costs what as many
    spread ids cost."""
    dev = sorted_ids.device
    _check(sorted_ids, "sorted_ids", torch.int32, dev)
    _check(values, "values", torch.float32, dev)
    if values.shape != sorted_ids.shape:
        raise ValueError("sorted_ids and values lengths differ")
    if not 0 <= num_docs < 2**31 or sorted_ids.shape[0] >= 2**31:
        raise ValueError("K2 takes fewer than 2^31 keys and slots")
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
    _launched(segment_sum)
    return out


segment_sum.launches = 0


# ---------------------------------------------------------------------------
# K3: exact top-k
# ---------------------------------------------------------------------------
# Plain PyTorch K3 (``ops/kernels.py:topk_exact``): values and int64
# indices.
topk_plain = topk_exact


def topk(x: torch.Tensor, k: int):
    """The k largest of each row of f32[..., N] (a 1-D row is a batch of
    one): (values f32[..., k] descending, indices int32[..., k]), ties to
    the smallest index; -0.0 and +0.0 tie.  Rows must hold no NaN.

    On a CUDA tensor this is K3 (csrc/topk.cu): a selection on the 64-bit
    keys of ``ops/kernels.py:topk_keys`` with nothing read by the host.  Up to ``sa_topk_one_pass_cap()`` (64) that is each tile of
    ``sa_topk_tile()`` elements selecting its k in shared memory, then a
    merge of the tiles' keys: two kernels, one where a row is one tile.
    Above it, the radix select over the whole row orders its survivors in
    the kernel up to ``sa_topk_sort_cap()`` of them (2048); above that
    their [Q, k] 64-bit keys are ordered by one ``torch.sort`` on the
    device, which is a sort of the survivors, not the selection.  Raises
    for k outside [1, N], rows that are not contiguous, and 2^31 elements
    or more."""
    dev = x.device
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.float32")
    if x.dim() < 1:
        raise ValueError("x must have a last axis to rank")
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() >= 2**31:
        raise ValueError("K3 takes fewer than 2^31 elements")
    if dev.type == "cpu":
        vals, idx = topk_plain(x, k)
        return vals, idx.to(torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no K3 kernel for device {dev}")
    lead = x.shape[:-1]
    rows = x.numel() // n
    vals = torch.empty(lead + (k,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    if rows == 0:
        return vals, idx
    lib = _get_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # a library without the two-launch path (an earlier build, timed in
    # turns with this one) takes every k by the radix select
    if hasattr(lib, "sa_topk_select") and k <= lib.sa_topk_one_pass_cap():
        tiles = -(-n // lib.sa_topk_tile())
        part = (torch.empty((rows, tiles, k), dtype=torch.int64,
                            device=dev) if tiles > 1 else None)
        err = lib.sa_topk_select(x.data_ptr(), rows, n, k,
                                 None if part is None else part.data_ptr(),
                                 vals.data_ptr(), idx.data_ptr(), dev.index,
                                 stream)
        _raise_on(err, "topk")
        _launched(topk, 1 if tiles == 1 else 2)
        return vals, idx
    sort_cap = lib.sa_topk_sort_cap()
    cap = max(k, sort_cap)
    scratch = torch.empty(rows * lib.sa_topk_row_scratch_bytes(),
                          dtype=torch.uint8, device=dev)
    cand = torch.empty((rows, cap), dtype=torch.int64, device=dev)
    err = lib.sa_topk(x.data_ptr(), rows, n, k, scratch.data_ptr(),
                      cand.data_ptr(), cap, vals.data_ptr(), idx.data_ptr(),
                      dev.index, stream)
    _raise_on(err, "topk")
    if k > sort_cap:
        # unsigned order as signed order: flip the top bit (the unpack
        # reads only the low half)
        keys = torch.sort(cand ^ (-2**63), dim=-1, descending=True).values
        err = lib.sa_topk_unpack(x.data_ptr(), rows, n, keys.data_ptr(), k,
                                 vals.data_ptr(), idx.data_ptr(), dev.index,
                                 stream)
        _raise_on(err, "topk unpack")
    _launched(topk, TOPK_KERNELS_PER_LAUNCH)
    return vals, idx


topk.launches = 0
topk.kernels = 0   # device kernels the launches enqueued


# ---------------------------------------------------------------------------
# K3 with K10 inside: the fused ranking pass
# ---------------------------------------------------------------------------
RANK_MAX_K = 64      # csrc/topk.cu's ONE_PASS_CAP: the k the fused pass takes
RANK_TILE = 16384    # csrc/topk.cu's SEL_TILE: elements of a row per block


def rank_rows(kind: str, src: torch.Tensor, slots, doc_lens: torch.Tensor,
              idfs: torch.Tensor, avgdl: float, k1: float, b: float, k: int):
    """The k best scores of each ranked row, never stored in full: what
    ``topk(similarity(kind, rows, doc_lens, idfs, ...), k)`` returns, bit
    for bit, where ``rows`` is ``src.index_select(0, slots)`` (``src``
    itself where ``slots`` is None).  ``src`` is f32 [R, N] with
    contiguous rows (a tf pool, or a group's K5 / K6 freqs), ``slots`` an
    int64 tensor of source rows on its device (each in [0, R), not
    checked: a plan's pool slots), ``doc_lens`` f32 [N] (counts, >= 0),
    ``idfs`` f32 with one entry per ranked row; k in [1, min(N,
    RANK_MAX_K)].  Returns (values f32 [Q, k] descending, indices int32
    [Q, k]), ties to the smallest index.

    On a CUDA tensor this is one launch (csrc/topk.cu, ``sa_rank_rows``):
    K3's two-launch selection over the rows' scores, each computed by
    K10's per-element function as its tf is read (one kernel where a row
    is one tile, else two).  It replaces the gather of the rows, K10's
    [Q, N] score block and K3's read of it on the batch driver's ranked
    groups."""
    if kind not in SIM_KINDS:
        raise ValueError(f"the fused pass has no similarity kind {kind}")
    dev = src.device
    if src.dtype != torch.float32 or src.dim() != 2:
        raise TypeError("src must be f32 [R, N]")
    R, n = src.shape
    if n > 1 and src.stride(1) != 1:
        raise ValueError("src must have contiguous rows")
    if not 1 <= k <= min(n, RANK_MAX_K):
        raise ValueError(f"k must be in [1, {min(n, RANK_MAX_K)}], got {k}")
    if n >= 2**31:
        raise ValueError("the fused pass takes rows of fewer than 2^31")
    if slots is not None:
        _check(slots, "slots", torch.int64, dev)
    Q = R if slots is None else slots.shape[0]
    _check(doc_lens, "doc_lens", torch.float32, dev)
    _check(idfs, "idfs", torch.float32, dev)
    if doc_lens.shape[0] != n or idfs.shape[0] != Q:
        raise ValueError("doc_lens takes one entry a column, idfs one a "
                         "ranked row")
    if dev.type == "cpu":
        vals, idx = rank_rows_plain(kind, src, slots, doc_lens, idfs, avgdl,
                                    k1, b, k)
        return vals, idx.to(torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no fused ranking kernel for device {dev}")
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return vals, idx
    lib = _get_lib()
    tiles = -(-n // RANK_TILE)
    part = (torch.empty((Q, tiles, k), dtype=torch.int64, device=dev)
            if tiles > 1 else None)
    err = lib.sa_rank_rows(
        src.data_ptr(), src.stride(0), None if slots is None
        else slots.data_ptr(), Q, n, doc_lens.data_ptr(), idfs.data_ptr(),
        SIM_KINDS[kind], _f32(avgdl), _f32(k1), _f32(b), k,
        None if part is None else part.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "rank_rows")
    _launched(rank_rows, 1 if tiles == 1 else 2)
    return vals, idx


rank_rows.launches = 0
rank_rows.kernels = 0   # device kernels the launches enqueued


# ---------------------------------------------------------------------------
# K4: plane fill
# ---------------------------------------------------------------------------
def plane_fill_plain(hdrs, pays, offs, ns, slots, pool) -> torch.Tensor:
    """Plain PyTorch K4: zero each row, then store the slice's payloads at
    their headers (headers past the plane, such as PAD_HDR32, dropped)."""
    plane_size = pool.shape[1]
    for off, n, slot in zip(offs.tolist(), ns.tolist(), slots.tolist()):
        h = hdrs[off: off + n]
        ok = h < plane_size
        row = pool[slot]
        row.zero_()
        row[h[ok].long()] = pays[off: off + n][ok]
    return pool


def plane_fill(hdrs: torch.Tensor, pays: torch.Tensor, offs, ns, slots,
               pool: torch.Tensor) -> torch.Tensor:
    """Expand posting slices into dense payload planes: for each row r,
    ``pool[slots[r]]`` = 0 except ``pool[slots[r], hdr] = pay`` over the
    words ``[offs[r], offs[r] + ns[r])`` of ``hdrs``/``pays``.

    ``hdrs``/``pays`` are the int32 posting planes, ``pool`` the int32
    [C, N << blk_bits] plane pool (filled in place and returned);
    ``offs``/``ns``/``slots`` are host integer sequences, one entry per
    row.  One launch fills every row."""
    dev = pool.device
    _check(hdrs, "hdrs", torch.int32, dev)
    _check(pays, "pays", torch.int32, dev)
    _check(pool, "pool", torch.int32, dev, ndim=2)
    if pays.shape != hdrs.shape:
        raise ValueError("hdrs/pays lengths differ")
    offs = _host_index(offs, "offs", hdrs.shape[0] + 1)
    ns = np.asarray(ns, dtype=np.int64)
    slots = _host_index(slots, "slots", pool.shape[0])
    if not (offs.shape == ns.shape == slots.shape) or offs.ndim != 1:
        raise ValueError("offs, ns and slots must be 1-D of one length")
    if ns.size and (ns.min() < 0 or (offs + ns).max() > hdrs.shape[0]):
        raise ValueError("a posting slice runs past the planes")
    if len(set(slots.tolist())) != len(slots):
        raise ValueError("a pool row is filled twice in one call")
    if dev.type == "cpu":
        return plane_fill_plain(hdrs, pays, offs, ns, slots, pool)
    if dev.type != "cuda":
        raise ValueError(f"no K4 kernel for device {dev}")
    if len(slots) == 0 or pool.shape[1] == 0:
        return pool
    rows = host_to_device(np.stack([offs, ns, slots]), dev)
    err = _get_lib().sa_plane_fill(
        hdrs.data_ptr(), pays.data_ptr(), rows[0].data_ptr(),
        rows[1].data_ptr(), rows[2].data_ptr(), len(slots), pool.data_ptr(),
        pool.shape[1], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "plane_fill")
    _launched(plane_fill)
    return pool


plane_fill.launches = 0


# ---------------------------------------------------------------------------
# K5: the exact-phrase bigram chain on the plane pool
# ---------------------------------------------------------------------------
def _plan_ints(plan, pattern, T: int) -> np.ndarray:
    """The chain plan in K5's host layout: n_halves, then per half
    (dir, len, terms..., tags...)."""
    if T > CHAIN_MAX_TERMS:
        raise ValueError(f"K5 takes phrases of at most {CHAIN_MAX_TERMS} "
                         f"terms, got {T}")
    if len(pattern) != T or not 1 <= len(plan) <= 2:
        raise ValueError("the pattern must tag every term; the plan has one "
                         "or two halves")
    out = [len(plan)]
    for direction, idxs in plan:
        idxs = list(idxs)
        if len(idxs) < 2 or min(idxs) < 0 or max(idxs) >= T:
            raise ValueError(f"bad chain half {direction} {idxs}")
        out += [0 if direction == "l2r" else 1, len(idxs), *idxs,
                *(pattern[i] for i in idxs)]
    return np.asarray(out, np.int32)


def phrase_chain_plain(pool, slots, plan, pattern, *, num_docs: int,
                       blk_bits: int) -> torch.Tensor:
    """Plain PyTorch K5: gather each query's planes, then the chain."""
    slots_t = torch.as_tensor(np.asarray(slots, np.int64), device=pool.device)
    planes = [pool[slots_t[:, i]] for i in range(slots_t.shape[1])]
    return phrase_counts_dense_planes(planes, list(pattern), plan, num_docs,
                                      1 << blk_bits)


def phrase_chain(pool: torch.Tensor, slots, plan, pattern, *, num_docs: int,
                 blk_bits: int, out: torch.Tensor = None,
                 out_rows=None) -> torch.Tensor:
    """Per-doc exact phrase freqs of a group of queries sharing one chain
    structure, read from the plane pool.

    ``pool`` is the int32 [C, num_docs << blk_bits] plane pool, ``slots``
    a host int [Qg, T] array of each query's plane rows, ``plan`` the
    chain halves ((direction, term indices), ...) and ``pattern`` the
    same-term tags.  Returns f32 [Qg, num_docs]; with ``out`` (an f32
    [R, num_docs] tensor such as the tf pool) writes query q's freqs into
    row ``out_rows[q]`` instead and returns ``out``."""
    dev = pool.device
    _check(pool, "pool", torch.int32, dev, ndim=2)
    if pool.shape[1] != num_docs << blk_bits:
        raise ValueError("pool rows are not num_docs << blk_bits wide")
    slots = _host_index(slots, "slots", pool.shape[0])
    if slots.ndim != 2:
        raise ValueError("slots must be [queries, terms]")
    Qg, T = slots.shape
    plan_ints = _plan_ints(plan, pattern, T)
    if out is None:
        out = torch.empty((Qg, num_docs), dtype=torch.float32, device=dev)
        rows = None
    else:
        _check(out, "out", torch.float32, dev, ndim=2)
        if out.shape[1] != num_docs:
            raise ValueError("out rows are not num_docs wide")
        rows = _host_index(out_rows, "out_rows", out.shape[0])
        if rows.shape != (Qg,) or len(set(rows.tolist())) != Qg:
            raise ValueError("out_rows must name one distinct row per query")
    if dev.type == "cpu":
        freqs = phrase_chain_plain(pool, slots, plan, pattern,
                                   num_docs=num_docs, blk_bits=blk_bits)
        if rows is None:
            return freqs
        out[torch.as_tensor(rows)] = freqs
        return out
    if dev.type != "cuda":
        raise ValueError(f"no K5 kernel for device {dev}")
    if Qg == 0 or num_docs == 0:
        return out
    slots_t = host_to_device(slots.astype(np.int32), dev)
    rows_t = None if rows is None else host_to_device(rows, dev)
    err = _get_lib().sa_phrase_chain(
        pool.data_ptr(), pool.shape[1], slots_t.data_ptr(), Qg, T,
        plan_ints.ctypes.data, num_docs, blk_bits, out.data_ptr(),
        num_docs, None if rows_t is None else rows_t.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "phrase_chain")
    _launched(phrase_chain)
    return out


phrase_chain.launches = 0


# ---------------------------------------------------------------------------
# K6: slop window coverage on the plane pool
# ---------------------------------------------------------------------------
def span_window_plain(pool, slots, w: int, mults, *, anchor: int = 0,
                      num_docs: int, blk_bits: int) -> torch.Tensor:
    """Plain PyTorch K6: per query, gather its planes, then the window
    coverage (one query at a time: the dilations hold several planes of
    temporaries)."""
    slots = np.asarray(slots, np.int64)
    out = torch.empty((slots.shape[0], num_docs), dtype=torch.float32,
                      device=pool.device)
    for q, row in enumerate(slots):
        out[q] = span_counts_dense_planes_plain(
            [pool[int(s)] for s in row], anchor, w, num_docs, 1 << blk_bits,
            mults=tuple(mults))
    return out


def span_window(pool: torch.Tensor, slots, w: int, mults, *, anchor: int = 0,
                num_docs: int, blk_bits: int, out: torch.Tensor = None,
                out_rows=None) -> torch.Tensor:
    """Per-doc slop span counts of a group of queries sharing one window
    ``w`` (query length + slop - 1), anchor column and multiplicities,
    read from the plane pool.

    ``pool`` is the int32 [C, num_docs << blk_bits] plane pool, ``slots``
    a host int [Qg, T] array of the plane rows of each query's DISTINCT
    terms, ``mults`` each column's multiplicity in the query (1 or 2) and
    ``anchor`` the column whose covered positions are counted.  Returns
    f32 [Qg, num_docs]; with ``out`` (an f32 [R, num_docs] tensor such as
    the tf pool) writes query q's counts into row ``out_rows[q]`` instead
    and returns ``out``."""
    dev = pool.device
    _check(pool, "pool", torch.int32, dev, ndim=2)
    if pool.shape[1] != num_docs << blk_bits:
        raise ValueError("pool rows are not num_docs << blk_bits wide")
    slots = _host_index(slots, "slots", pool.shape[0])
    if slots.ndim != 2:
        raise ValueError("slots must be [queries, terms]")
    Qg, T = slots.shape
    mults = np.asarray(mults, np.int32)
    if mults.shape != (T,) or not 1 <= T <= SPAN_MAX_TERMS:
        raise ValueError(f"K6 takes 1 to {SPAN_MAX_TERMS} distinct terms "
                         "and one multiplicity for each")
    if T and (mults.min() < 1 or mults.max() > 2):
        raise ValueError("K6 takes multiplicities of 1 and 2")
    if not 1 <= w <= SPAN_MAX_WINDOW:
        raise ValueError(f"K6 takes a window 1 <= w <= {SPAN_MAX_WINDOW}, "
                         f"got {w}")
    if not 0 <= anchor < T:
        raise ValueError(f"anchor {anchor} is not a column of the query")
    if out is None:
        out = torch.empty((Qg, num_docs), dtype=torch.float32, device=dev)
        rows = None
    else:
        _check(out, "out", torch.float32, dev, ndim=2)
        if out.shape[1] != num_docs:
            raise ValueError("out rows are not num_docs wide")
        rows = _host_index(out_rows, "out_rows", out.shape[0])
        if rows.shape != (Qg,) or len(set(rows.tolist())) != Qg:
            raise ValueError("out_rows must name one distinct row per query")
    if dev.type == "cpu":
        freqs = span_window_plain(pool, slots, w, mults, anchor=anchor,
                                  num_docs=num_docs, blk_bits=blk_bits)
        if rows is None:
            return freqs
        out[torch.as_tensor(rows)] = freqs
        return out
    if dev.type != "cuda":
        raise ValueError(f"no K6 kernel for device {dev}")
    if Qg == 0 or num_docs == 0:
        return out
    slots_t = host_to_device(slots.astype(np.int32), dev)
    rows_t = None if rows is None else host_to_device(rows, dev)
    if blk_bits > 8:
        # a doc of more than 256 slots spans warps: the kernel adds each
        # warp's sum into rows zeroed here
        if rows_t is None:
            out.zero_()
        else:
            out.index_fill_(0, rows_t, 0.0)
    err = _get_lib().sa_span_window(
        pool.data_ptr(), pool.shape[1], slots_t.data_ptr(), Qg, T, int(w),
        int(anchor), mults.ctypes.data, num_docs, blk_bits, out.data_ptr(),
        num_docs, None if rows_t is None else rows_t.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "span_window")
    _launched(span_window)
    return out


span_window.launches = 0


# ---------------------------------------------------------------------------
# K7: one bigram step of the sparse exact-phrase chain
# ---------------------------------------------------------------------------
# bits of K7's flags row (csrc/merge_step.cu)
MERGE_RHS, MERGE_SAME_TERM, MERGE_WRITE_CONT = 1, 2, 4


def prefix_offsets(ns) -> np.ndarray:
    """Where each query's words start in a step's outputs: the exclusive
    prefix sum of the base lengths, int64."""
    ns = np.asarray(ns, dtype=np.int64)
    return np.concatenate([[0], np.cumsum(ns)[:-1]]).astype(np.int64)


def merge_step(hdrs: torch.Tensor, base_pays: torch.Tensor,
               other_pays: torch.Tensor, base_off, base_n, other_off,
               other_n, other_pay_off, *, cont_side,
               same_term=False, blk_bits: int, key_stride: int = 0,
               min_blk=None, max_blk=None, need_cont=True):
    """One bigram step of the sparse phrase chain for a chunk of queries.

    Query q matches its *base* words ``hdrs/base_pays[base_off[q] :
    base_off[q] + base_n[q]]`` (the raw term the continuation is shaped
    like: the right term of a left-to-right step, ``cont_side="rhs"``, the
    left one of a right-to-left step, ``"lhs"``) against its *other*
    words: headers ``hdrs[other_off[q] : + other_n[q]]`` with payloads
    ``other_pays[other_pay_off[q] : + other_n[q]]`` (the posting payloads
    for a raw term, the previous step's continuation for a carry).  Both
    lists are sorted by unique header.  With ``same_term`` (both sides the
    same list, the first step of a chain) the query's other arguments are
    not read.  ``cont_side``, ``same_term`` and ``need_cont`` are one value
    for the launch or one per query, so one launch takes a step of chains
    of either direction.  ``min_blk``/``max_blk`` (both or neither) zero
    the payloads of words whose block is outside the window; the words
    stay.

    Returns (keys int32[M], counts f32[M], cont int32[M] or None) over all
    base words, M = sum(base_n), query q's at ``prefix_offsets(base_n)[q]``
    in its own order: the flat doc key ``q * key_stride + (hdr >>
    blk_bits)``, the match count, and the continuation payload (None where
    no query needs it; a query without ``need_cont`` leaves its words of
    it unwritten on the card).  Keys are non-decreasing, as K2 takes them.
    The offsets are host integer sequences, one entry per query."""
    dev = hdrs.device
    _check(hdrs, "hdrs", torch.int32, dev)
    _check(base_pays, "base_pays", torch.int32, dev)
    _check(other_pays, "other_pays", torch.int32, dev)
    if base_pays.shape != hdrs.shape:
        raise ValueError("hdrs/base_pays lengths differ")
    W = hdrs.shape[0]
    base_off = _host_index(base_off, "base_off", W + 1)
    base_n = np.asarray(base_n, dtype=np.int64)
    Q = len(base_off)
    sides = per_query(cont_side, Q, "cont_side")
    if any(c not in ("rhs", "lhs") for c in (
            [cont_side] if isinstance(cont_side, str) else sides)):
        raise ValueError(f"cont_side must be rhs or lhs, got {cont_side!r}")
    same = np.asarray(per_query(same_term, Q, "same_term"), dtype=bool)
    conts = np.asarray(per_query(need_cont, Q, "need_cont"), dtype=bool)
    # a same-term query reads no other list: its other columns are its base
    other_off = np.where(same, base_off,
                         np.asarray(other_off, dtype=np.int64))
    other_n = np.where(same, base_n, np.asarray(other_n, dtype=np.int64))
    other_pay_off = np.where(same, 0,
                             np.asarray(other_pay_off, dtype=np.int64))
    other_off = _host_index(other_off, "other_off", W + 1)
    other_pay_off = _host_index(other_pay_off, "other_pay_off",
                                other_pays.shape[0] + 1)
    if any(a.shape != (Q,) for a in (base_n, other_off, other_n,
                                     other_pay_off)):
        raise ValueError("the per-query offsets must be 1-D of one length")
    if Q and (base_n.min() < 0 or other_n.min() < 0
              or (base_off + base_n).max() > W
              or (other_off + other_n).max() > W
              or (other_pay_off + np.where(same, 0, other_n)).max()
              > other_pays.shape[0]):
        raise ValueError("a posting slice runs past its tensor")
    M = int(base_n.sum())
    if M >= 2**31 or not 0 <= Q * key_stride < 2**31:
        raise ValueError("K7 takes fewer than 2^31 base words and keys")
    if (min_blk is None) != (max_blk is None):
        raise ValueError("a block window needs min_blk and max_blk")
    if dev.type == "cpu":
        keys, counts, cont = merge_step_plain(
            hdrs, base_pays, other_pays, base_off, base_n, other_off,
            other_n, other_pay_off, cont_side=sides,
            same_term=same.tolist(), blk_bits=blk_bits,
            key_stride=key_stride, min_blk=min_blk, max_blk=max_blk)
        return keys, counts, (cont if conts.any() else None)
    if dev.type != "cuda":
        raise ValueError(f"no K7 kernel for device {dev}")
    keys = torch.empty(M, dtype=torch.int32, device=dev)
    counts = torch.empty(M, dtype=torch.float32, device=dev)
    cont = (torch.empty(M, dtype=torch.int32, device=dev) if conts.any()
            else None)
    if M == 0:
        return keys, counts, cont
    lib = _get_lib()
    tile = lib.sa_merge_join_tile()
    n_tiles = -(-base_n // tile)
    # the query table, one column per query, then each tile's query
    queries = np.arange(Q, dtype=np.int64)
    flags = ((np.asarray(sides) == "rhs") * MERGE_RHS
             + same * MERGE_SAME_TERM + conts * MERGE_WRITE_CONT)
    meta = host_to_device(np.concatenate([
        base_off, base_n, other_off, other_n, other_pay_off,
        prefix_offsets(base_n), queries * key_stride,
        prefix_offsets(n_tiles), flags.astype(np.int64),
        np.repeat(queries, n_tiles)]), dev)
    window = ((0, (1 << 18) - 1) if min_blk is None
              else (int(min_blk), int(max_blk)))
    err = lib.sa_merge_join(
        hdrs.data_ptr(), base_pays.data_ptr(), other_pays.data_ptr(),
        meta.data_ptr(), Q, int(n_tiles.sum()), blk_bits, *window,
        keys.data_ptr(), counts.data_ptr(),
        None if cont is None else cont.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "merge_step")
    _launched(merge_step)
    return keys, counts, cont


merge_step.launches = 0


# ---------------------------------------------------------------------------
# K8a: candidate rows of the candidate-subset engine
# ---------------------------------------------------------------------------
def cand_rows_plain(hdrs, pays, offs, ns, Kc: int, *, num_docs: int,
                    blk_bits: int, with_tf: bool = True):
    """Plain PyTorch K8a: ``compact_rows_plain`` per query on its exact
    slice (every word valid), the popcounts of its payloads summed per
    run with ``with_tf``."""
    rows, tfs = [], []
    for o, n in zip(np.asarray(offs).tolist(), np.asarray(ns).tolist()):
        h = hdrs[o: o + n]
        r, _cidx, tf = compact_rows_plain(
            h >> blk_bits, torch.ones_like(h, dtype=torch.bool), Kc,
            num_docs, popcount_i32(pays[o: o + n]) if with_tf else None)
        rows.append(r)
        tfs.append(tf)
    empty = torch.empty((0, Kc), device=hdrs.device)
    rows = (torch.stack(rows) if rows else empty.to(torch.int32))
    if not with_tf:
        return rows, None
    return rows, (torch.stack(tfs) if tfs else empty)


def cand_rows(hdrs: torch.Tensor, pays: torch.Tensor, offs, ns, Kc: int, *,
              num_docs: int, blk_bits: int, with_tf: bool = True):
    """The candidate rows of a chunk of queries, one posting slice each.

    Query q's words are ``[offs[q], offs[q] + ns[q])`` of the doc-sorted
    ``hdrs``/``pays`` planes (host integer sequences, one entry per query).
    Returns (rows int32 [Q, Kc]: each query's distinct doc keys ascending,
    then ``num_docs``; tf f32 [Q, Kc]: the popcount of each candidate's
    payloads, or None without ``with_tf``).  Runs past
    ``Kc`` are dropped.  One launch of one kernel (csrc/cand_rows.cu:
    persistent blocks over the slices' tiles, each tile's run prefix by a
    decoupled look-back)."""
    dev = hdrs.device
    _check(hdrs, "hdrs", torch.int32, dev)
    _check(pays, "pays", torch.int32, dev)
    if pays.shape != hdrs.shape:
        raise ValueError("hdrs/pays lengths differ")
    offs = _host_index(offs, "offs", hdrs.shape[0] + 1)
    ns = np.asarray(ns, dtype=np.int64)
    if offs.ndim != 1 or ns.shape != offs.shape:
        raise ValueError("offs and ns must be 1-D of one length")
    if ns.size and (ns.min() < 0 or (offs + ns).max() > hdrs.shape[0]):
        raise ValueError("a posting slice runs past the planes")
    if Kc < 0 or not 0 <= num_docs < 2**31 or int(ns.sum()) >= 2**31:
        raise ValueError("K8a takes Kc >= 0 and fewer than 2^31 docs and "
                         "words")
    if dev.type == "cpu":
        return cand_rows_plain(hdrs, pays, offs, ns, Kc, num_docs=num_docs,
                               blk_bits=blk_bits, with_tf=with_tf)
    if dev.type != "cuda":
        raise ValueError(f"no K8a kernel for device {dev}")
    Q = len(offs)
    rows = torch.empty((Q, Kc), dtype=torch.int32, device=dev)
    tf = (torch.empty((Q, Kc), dtype=torch.float32, device=dev) if with_tf
          else None)
    if Q == 0:
        return rows, tf
    lib = _get_lib()
    tile = lib.sa_cand_rows_tile()
    tiles = -(-ns // tile)
    starts = np.concatenate([[0], np.cumsum(tiles)]).astype(np.int64)
    # each tile's record: its query, its first word, its slice's end
    tq = np.repeat(np.arange(Q, dtype=np.int64), tiles)
    tword = offs[tq] + (np.arange(len(tq)) - starts[tq]) * tile
    meta = host_to_device(np.concatenate(
        [offs, ns, starts, tq, tword, (offs + ns)[tq]]), dev)
    n_tiles = len(tq)
    err = lib.sa_cand_rows(
        hdrs.data_ptr(), pays.data_ptr(), meta.data_ptr(), Q, n_tiles, Kc,
        num_docs, blk_bits, rows.data_ptr(),
        None if tf is None else tf.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "cand_rows")
    _launched(cand_rows)
    return rows, tf


cand_rows.launches = 0


# ---------------------------------------------------------------------------
# K8b: mini-planes over candidate rows
# ---------------------------------------------------------------------------
def cand_minis(rows: torch.Tensor, slots, offs, ns, *, pool,
               hdrs: torch.Tensor, pays: torch.Tensor, num_docs: int,
               blk_bits: int) -> torch.Tensor:
    """The mini-planes of a chunk of queries over their candidate rows.

    ``rows`` is an int32 [Q, Kc] tensor of row tables (or one [Kc] table
    for every query); ``slots``, ``offs`` and ``ns`` are host int [Q, T]
    arrays, one column per term.  Term t of query q with ``slots[q, t] >=
    0`` copies its plane-pool row's ``2^blk_bits`` slots at each row
    (``pool`` is the int32 [C, num_docs << blk_bits] plane pool; rows are
    clipped to [0, num_docs), so a sentinel row reads the last doc's); a
    term with slot -1 is zero but for the payloads of its posting slice
    ``[offs[q, t], offs[q, t] + ns[q, t])`` whose doc key is one of the
    query's rows, which must then be ascending.  Returns int32 [Q * T, Kc
    << blk_bits]: a pool whose row ``q * T + t`` is that term's mini-plane,
    as K5 and K6 take it with ``num_docs = Kc``.  One launch
    (csrc/cand_minis.cu)."""
    dev = rows.device
    if rows.dtype != torch.int32 or rows.dim() not in (1, 2) or not (
            rows.is_contiguous()):
        raise ValueError("rows must be a contiguous int32 [Q, Kc] or [Kc] "
                         "tensor")
    _check(hdrs, "hdrs", torch.int32, dev)
    _check(pays, "pays", torch.int32, dev)
    if pays.shape != hdrs.shape:
        raise ValueError("hdrs/pays lengths differ")
    slots = np.asarray(slots, dtype=np.int64)
    if slots.ndim != 2:
        raise ValueError("slots must be [queries, terms]")
    Q, T = slots.shape
    Kc = rows.shape[-1]
    if rows.dim() == 2 and rows.shape[0] != Q:
        raise ValueError("one row table per query, or one for all")
    plane_size = num_docs << blk_bits
    if (slots >= 0).any():
        if pool is None:
            raise ValueError("a term with a slot needs the pool")
        _check(pool, "pool", torch.int32, dev, ndim=2)
        if pool.shape[1] != plane_size:
            raise ValueError("pool rows are not num_docs << blk_bits wide")
        _host_index(slots[slots >= 0], "slots", pool.shape[0])
    if slots.size and slots.min() < -1:
        raise ValueError("a slot is a pool row or -1")
    mini = slots < 0
    offs = np.where(mini, np.asarray(offs, dtype=np.int64), 0)
    ns = np.where(mini, np.asarray(ns, dtype=np.int64), 0)
    if offs.shape != slots.shape:
        raise ValueError("slots, offs and ns must have one shape")
    _host_index(offs, "offs", hdrs.shape[0] + 1)
    if ns.size and (ns.min() < 0 or (offs + ns).max() > hdrs.shape[0]):
        raise ValueError("a posting slice runs past the planes")
    if num_docs < 1 or Kc * (1 << blk_bits) >= 2**31:
        raise ValueError("K8b takes num_docs >= 1 and minis of fewer than "
                         "2^31 slots")
    if dev.type == "cpu":
        return minis_for_rows_plain(rows, slots, offs, ns, pool=pool,
                                    hdrs=hdrs, pays=pays, num_docs=num_docs,
                                    blk_bits=blk_bits)
    if dev.type != "cuda":
        raise ValueError(f"no K8b kernel for device {dev}")
    out = torch.empty((Q * T, Kc << blk_bits), dtype=torch.int32, device=dev)
    if Q * T == 0 or Kc == 0:
        return out
    meta = host_to_device(np.concatenate(
        [slots.ravel(), offs.ravel(), ns.ravel()]), dev)
    err = _get_lib().sa_cand_minis(
        rows.data_ptr(), Kc if rows.dim() == 2 else 0, Kc, meta.data_ptr(),
        Q * T, T, None if pool is None else pool.data_ptr(), plane_size,
        hdrs.data_ptr(), pays.data_ptr(), num_docs, blk_bits, out.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "cand_minis")
    _launched(cand_minis)
    return out


cand_minis.launches = 0


# ---------------------------------------------------------------------------
# K9: slop window coverage on the posting slices
# ---------------------------------------------------------------------------
SPAN_STATE_INTS = 5   # per-term integers of a K9 thread (csrc/span_sparse.cu)


def span_sparse_plain(hdrs, pays, offs, ns, w: int, mults, *, anchor: int = 0,
                      blk_bits: int, key_stride: int = 0, min_blk=None,
                      max_blk=None):
    """Plain PyTorch K9: ``span_neighbourhood_plain`` per query, the keys
    offset into the flat space ``q * key_stride + doc``."""
    keys, counts = [], []
    for q, (o, n) in enumerate(zip(np.asarray(offs), np.asarray(ns))):
        k, c = span_neighbourhood_plain(hdrs, pays, o, n, anchor, mults, w,
                                        blk_bits=blk_bits, min_blk=min_blk,
                                        max_blk=max_blk)
        keys.append(k + q * key_stride)
        counts.append(c)
    if not keys:
        return (hdrs.new_empty(0), torch.empty(0, dtype=torch.float32,
                                               device=hdrs.device))
    return torch.cat(keys).to(torch.int32), torch.cat(counts)


def span_sparse(hdrs: torch.Tensor, pays: torch.Tensor, offs, ns, w: int,
                mults, *, anchor: int = 0, blk_bits: int,
                key_stride: int = 0, min_blk=None, max_blk=None):
    """Slop window coverage of a chunk of queries sharing one window ``w``
    (query length + slop - 1), anchor column and multiplicities, on their
    doc-sorted posting slices.

    ``offs``/``ns`` are host int [Q, T] arrays: the exact slice of each
    query's DISTINCT terms in ``hdrs``/``pays`` (sorted by unique header),
    ``mults`` each column's multiplicity in the query (1 or more) and
    ``anchor`` the column whose covered positions are counted.  A term's
    word at header ``h + d`` is read only while ``block + d`` stays in
    ``[0, 2^blk_bits)``.  ``min_blk``/``max_blk`` (both or neither) zero
    the payloads of words whose block is outside the window; the words
    stay.  Every ``w >= 1`` and any number of terms is taken.  The kernel
    has two paths with one result: where ``w <= 18`` and no multiplicity
    exceeds 2 a term's neighbourhood is one 64-bit word and the windows
    are dilations of it; otherwise the windows are walked one start at a
    time.

    Returns (keys int32[M], counts f32[M]) over all anchor words, M =
    sum(ns[:, anchor]), query q's at ``prefix_offsets(ns[:, anchor])[q]``
    in its own order: the flat doc key ``q * key_stride + (hdr >>
    blk_bits)`` and the number of the word's positions that some passing
    window covers.  Keys are non-decreasing, as K2 takes them."""
    return _span_sparse(hdrs, pays, offs, ns, w, mults, anchor=anchor,
                        blk_bits=blk_bits, key_stride=key_stride,
                        min_blk=min_blk, max_blk=max_blk)


def _span_sparse(hdrs, pays, offs, ns, w, mults, *, anchor=0, blk_bits,
                 key_stride=0, min_blk=None, max_blk=None, walked=False):
    """``span_sparse``; ``walked`` keeps a launch that the 64-bit word path
    would take on the walked path, so that the two can be held to each
    other and timed on one input."""
    dev = hdrs.device
    _check(hdrs, "hdrs", torch.int32, dev)
    _check(pays, "pays", torch.int32, dev)
    if pays.shape != hdrs.shape:
        raise ValueError("hdrs/pays lengths differ")
    W = hdrs.shape[0]
    offs = _host_index(offs, "offs", W + 1)
    ns = np.asarray(ns, dtype=np.int64)
    if offs.ndim != 2 or ns.shape != offs.shape:
        raise ValueError("offs and ns must be [queries, terms]")
    Q, T = offs.shape
    mults = np.asarray(mults, dtype=np.int64)
    if T < 1 or mults.shape != (T,) or mults.min() < 1:
        raise ValueError("K9 takes one multiplicity >= 1 for each of one or "
                         "more distinct terms")
    if w < 1:
        raise ValueError(f"K9 takes a window w >= 1, got {w}")
    if not 0 <= anchor < T:
        raise ValueError(f"anchor {anchor} is not a column of the query")
    if Q and (ns.min() < 0 or (offs + ns).max() > W):
        raise ValueError("a posting slice runs past the planes")
    M = int(ns[:, anchor].sum())
    if M >= 2**31 or (Q and ns.max() >= 2**31) or not (
            0 <= Q * key_stride < 2**31):
        raise ValueError("K9 takes fewer than 2^31 words and keys")
    if (min_blk is None) != (max_blk is None):
        raise ValueError("a block window needs min_blk and max_blk")
    if dev.type == "cpu":
        return span_sparse_plain(hdrs, pays, offs, ns, w, mults,
                                 anchor=anchor, blk_bits=blk_bits,
                                 key_stride=key_stride, min_blk=min_blk,
                                 max_blk=max_blk)
    if dev.type != "cuda":
        raise ValueError(f"no K9 kernel for device {dev}")
    keys = torch.empty(M, dtype=torch.int32, device=dev)
    counts = torch.empty(M, dtype=torch.float32, device=dev)
    if M == 0:
        return keys, counts
    lib = _get_lib()
    n_tiles = -(-ns[:, anchor] // lib.sa_span_sparse_tile())
    words = w <= SPAN_MAX_WINDOW and mults.max() <= 2 and not walked
    scratch = (torch.empty(SPAN_STATE_INTS * T * M, dtype=torch.int32,
                           device=dev)
               if T > lib.sa_span_sparse_local_terms() and not words
               else None)
    # the query table, one column per query; the multiplicities; then each
    # tile's query
    queries = np.arange(Q, dtype=np.int64)
    table = np.empty((2 * T + 3, Q), np.int64)
    table[0: 2 * T: 2] = offs.T
    table[1: 2 * T: 2] = ns.T
    table[2 * T] = prefix_offsets(ns[:, anchor])
    table[2 * T + 1] = queries * key_stride
    table[2 * T + 2] = prefix_offsets(n_tiles)
    meta = host_to_device(np.concatenate([
        table.ravel(), mults, np.repeat(queries, n_tiles)]), dev)
    window = ((0, (1 << 18) - 1) if min_blk is None
              else (int(min_blk), int(max_blk)))
    err = lib.sa_span_sparse(
        hdrs.data_ptr(), pays.data_ptr(), meta.data_ptr(), Q,
        int(n_tiles.sum()), T, int(anchor), int(w), blk_bits, *window,
        int(words), None if scratch is None else scratch.data_ptr(), M,
        keys.data_ptr(), counts.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "span_sparse")
    _launched(span_sparse)
    return keys, counts


span_sparse.launches = 0


# ---------------------------------------------------------------------------
# K10: the similarity of a block of term frequencies
# ---------------------------------------------------------------------------
def similarity(kind: str, tfs: torch.Tensor, doc_lens: torch.Tensor, idf,
               avgdl: float, k1: float, b: float,
               out: torch.Tensor = None) -> torch.Tensor:
    """The similarity ``kind`` (bm25 / bm25_legacy / bm25_impact /
    classic) of f32 ``tfs``, [N] or [Q, N] (rows may be strided, columns
    contiguous), rounded as ``similarity_plain`` rounds it.  ``doc_lens``
    is f32 [N] (or a [1, N] view), broadcast over the rows, or a
    contiguous f32 [Q, N]; ``idf`` a number or f32 with one entry per row.
    The result goes to ``out`` when given (a contiguous f32 tensor of
    ``tfs``' shape; ``tfs`` itself where the caller owns it), else to a
    new tensor.  One launch (csrc/similarity.cu)."""
    if kind not in SIM_KINDS:
        raise ValueError(f"K10 has no similarity kind {kind}")
    dev = tfs.device
    if tfs.dtype != torch.float32 or tfs.dim() not in (1, 2):
        raise TypeError("tfs must be f32 [N] or [Q, N]")
    t2 = tfs.reshape(1, -1) if tfs.dim() == 1 else tfs
    Q, N = t2.shape
    if N > 1 and t2.stride(1) != 1:
        raise ValueError("tfs must have contiguous rows")
    _check(doc_lens, "doc_lens", torch.float32, dev, ndim=doc_lens.dim())
    if doc_lens.numel() == N and doc_lens.shape[-1] == N:
        dl_stride = 0
    elif doc_lens.shape == t2.shape:
        dl_stride = N
    else:
        raise ValueError(f"doc_lens of shape {tuple(doc_lens.shape)} fit "
                         f"neither [N] nor [Q, N] of tfs {tuple(tfs.shape)}")
    idfs = None
    if torch.is_tensor(idf):
        _check(idf, "idf", torch.float32, dev, ndim=idf.dim())
        if idf.numel() != Q:
            raise ValueError("a tensor idf needs one entry per row")
        idfs = idf.reshape(Q)
        idf = 0.0
    if out is None:
        out = torch.empty(tfs.shape, dtype=torch.float32, device=dev)
    else:
        _check(out, "out", torch.float32, dev, ndim=tfs.dim())
        if out.shape != tfs.shape:
            raise ValueError("out must have tfs' shape")
    if out.numel() == 0:
        return out
    if dev.type == "cpu":
        # broadcast as the kernel does: one idf per row, lengths per column
        got = similarity_plain(
            kind, t2, doc_lens.reshape(-1, N),
            idf if idfs is None else idfs[:, None], avgdl, k1, b)
        return out.copy_(got.reshape(tfs.shape))
    if dev.type != "cuda":
        raise ValueError(f"no K10 kernel for device {dev}")
    lib = _get_lib()
    err = lib.sa_similarity(
        t2.data_ptr(), Q, N, t2.stride(0), doc_lens.data_ptr(), dl_stride,
        None if idfs is None else idfs.data_ptr(), _f32(idf),
        out.data_ptr(), N, SIM_KINDS[kind], _f32(avgdl), _f32(k1), _f32(b),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "similarity")
    _launched(similarity)
    return out


similarity.launches = 0


# ---------------------------------------------------------------------------
# K11: edismax's composition
# ---------------------------------------------------------------------------
COMPOSE_MAX_FIELDS = 16   # csrc/compose.cu's MAX_FIELDS


def compose(stacks, boosts, tie: float, msm, *, term_centric: bool,
            chain: bool = True, out: torch.Tensor = None) -> torch.Tensor:
    """edismax's dismax / tie / mm composition of F f32 [T_f, N] score
    stacks (rows may be strided, columns contiguous) into f32 [N], rounded
    as ``compose_plain`` rounds it (its docstring has the forms).
    ``msm`` is one int (term-centric) or one per field; ``out`` a
    contiguous f32 [N] for the result.  One launch (csrc/compose.cu)."""
    F = len(stacks)
    if not 1 <= F <= COMPOSE_MAX_FIELDS or len(boosts) != F:
        raise ValueError(f"K11 composes 1 to {COMPOSE_MAX_FIELDS} fields, "
                         "each with a boost")
    dev = stacks[0].device
    N = stacks[0].shape[1] if stacks[0].dim() == 2 else -1
    for s in stacks:
        if s.dtype != torch.float32 or s.dim() != 2 or s.shape[1] != N:
            raise ValueError("stacks must be f32 [T_f, N] of one N")
        if s.device != dev:
            raise ValueError(f"a stack is on {s.device}, expected {dev}")
        if s.shape[0] and N > 1 and s.stride(1) != 1:
            raise ValueError("stacks must have contiguous rows")
    terms = [int(s.shape[0]) for s in stacks]
    if term_centric:
        if len(set(terms)) != 1:
            raise ValueError("term-centric stacks need one term count")
        msms = [int(msm)] * F
    else:
        msms = [int(m) for m in msm]
        if len(msms) != F:
            raise ValueError("field-centric composition needs one msm per "
                             "field")
    if out is None:
        out = torch.empty(N, dtype=torch.float32, device=dev)
    else:
        _check(out, "out", torch.float32, dev)
        if out.shape[0] != N:
            raise ValueError("out must be f32 [N]")
    if dev.type == "cpu":
        return compose_plain(stacks, boosts, tie, msm,
                             term_centric=term_centric, chain=chain, out=out)
    if dev.type != "cuda":
        raise ValueError(f"no K11 kernel for device {dev}")
    if N == 0:
        return out
    ptrs = np.asarray([s.data_ptr() for s in stacks], np.int64)
    strides = np.asarray([s.stride(0) for s in stacks], np.int64)
    t32 = np.asarray(terms, np.int32)
    b32 = np.asarray(boosts, np.float32)
    m32 = np.asarray(msms, np.int32)
    lib = _get_lib()
    err = lib.sa_compose(ptrs.ctypes.data, strides.ctypes.data,
                         t32.ctypes.data, b32.ctypes.data, m32.ctypes.data,
                         F, N, _f32(tie), int(term_centric), int(chain),
                         out.data_ptr(), dev.index,
                         torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "compose")
    _launched(compose)
    return out


compose.launches = 0
