"""searcharray_tpu_torch — the PyTorch/CUDA port of searcharray_tpu.

Ranked term retrieval over a positional roaringish index held on a torch
device: host build (numpy + the C++ runtime) -> posting planes on the
device -> per-term tf from the hand-written Hopper kernel K1 with the BM25
family fused -> exact top-k -> batched serving.  Every device is named
explicitly: ``SearchArray.index(strings, device="cuda")``.
"""
from searcharray_tpu_torch.pandas_ext.array import SearchArray, Terms, TermsDtype  # noqa: F401
from searcharray_tpu_torch.search.similarity import (  # noqa: F401
    Similarity,
    bm25_impact,
    bm25_legacy_similarity,
    bm25_similarity,
    classic_similarity,
    compute_idf,
    default_bm25,
)
from searcharray_tpu_torch.utils.topk import SetOfResults  # noqa: F401

__version__ = "0.1.0"
__all__ = ["SearchArray", "Terms", "TermsDtype", "SetOfResults",
           "Similarity", "bm25_similarity", "bm25_legacy_similarity",
           "bm25_impact", "classic_similarity", "compute_idf",
           "default_bm25"]
