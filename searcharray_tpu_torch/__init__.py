"""searcharray_tpu_torch — the PyTorch/CUDA port of searcharray_tpu.

Ranked retrieval of terms, exact phrases and slop phrases over a
positional roaringish index held on a torch device: host build (numpy +
the C++ runtime) -> posting planes on the device -> per-term tf (kernel
K1, the BM25 family fused), exact phrases on dense planes (K4, K5) or on
the posting slices (K7, K2), slop phrases on dense planes (K6) or on the
posting slices (K9, K2) -> exact top-k (K3) -> batched serving with one
copy to the host, and the Solr ``edismax`` / ``edismax_batch`` composer
over dataframe columns (its dismax / tie / mm composition K11).  Every
kernel is written by hand for Hopper.  Every device is named explicitly:
``SearchArray.index(strings, device="cuda")``.  An index saves and loads
through ``index/store.py`` (one on-disk format with the JAX package), its
postings can be memory-mapped (``data_dir=``), and an array pickles and
takes assignments (``__setitem__``).  With ``mesh=`` the index is also
split by doc range into shards (``parallel/sharded.py``): one process
drives every shard's engine and kernels on the mesh's devices, and a
per-shard top-k merges through K3.
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
from searcharray_tpu_torch.solr import (  # noqa: F401
    edismax,
    edismax_batch,
    parse_min_should_match,
)
from searcharray_tpu_torch.utils.topk import SetOfResults  # noqa: F401

__version__ = "0.1.0"
__all__ = ["SearchArray", "Terms", "TermsDtype", "SetOfResults",
           "Similarity", "bm25_similarity", "bm25_legacy_similarity",
           "bm25_impact", "classic_similarity", "compute_idf",
           "default_bm25", "edismax", "edismax_batch",
           "parse_min_should_match"]
