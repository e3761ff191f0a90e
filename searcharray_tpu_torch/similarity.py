"""Import-path parity with the reference: `searcharray.similarity`."""
from searcharray_tpu_torch.search.similarity import (  # noqa: F401
    Similarity,
    bm25_impact,
    bm25_legacy_similarity,
    bm25_similarity,
    classic_similarity,
    compute_idf,
    default_bm25,
)
