"""Import-path parity with the reference: ``searcharray.postings``."""
from searcharray_tpu_torch.pandas_ext.array import (  # noqa: F401
    SearchArray,
    Terms,
    TermsDtype,
)
from searcharray_tpu_torch.index.builder import ws_tokenizer  # noqa: F401
