"""Port parity: host index build and device attach (searcharray_tpu_torch)
against the JAX package, on the same numpy-seeded corpus."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from searcharray_tpu.index import builder as jbuilder
from searcharray_tpu.index.device import DeviceIndex as JDeviceIndex
from searcharray_tpu.index.device import derive_attach_arrays as j_derive
from searcharray_tpu_torch.index import builder as tbuilder
from searcharray_tpu_torch.index.device import (
    DeviceIndex,
    derive_attach_arrays,
    from_numpy_state,
)


def make_docs(n=700, seed=11):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta", "Alpha,", "Beta."] + [
        f"w{i}" for i in range(50)]
    return [" ".join(rng.choice(vocab, size=rng.integers(1, 30)))
            for _ in range(n)]


def numpy_state(built) -> dict:
    """The JAX-built index as numpy arrays and Python lists."""
    return {
        "data": built.postings.data,
        "offsets": built.postings.offsets,
        "lengths": built.postings.lengths,
        "doc_lens": built.doc_lens,
        "doc_freqs": built.doc_freqs,
        "avg_doc_length": built.avg_doc_length,
        "terms": [built.vocab.get_term(i) for i in range(len(built.vocab))],
    }


def assert_same_built(a, b):
    np.testing.assert_array_equal(a.postings.data, b.postings.data)
    np.testing.assert_array_equal(a.postings.offsets, b.postings.offsets)
    np.testing.assert_array_equal(a.postings.lengths, b.postings.lengths)
    np.testing.assert_array_equal(a.doc_lens, b.doc_lens)
    np.testing.assert_array_equal(a.doc_freqs, b.doc_freqs)
    np.testing.assert_array_equal(a.doc_term.cols, b.doc_term.cols)
    np.testing.assert_array_equal(a.doc_term.rows, b.doc_term.rows)
    assert a.avg_doc_length == b.avg_doc_length
    assert ([a.vocab.get_term(i) for i in range(len(a.vocab))]
            == [b.vocab.get_term(i) for i in range(len(b.vocab))])


@pytest.mark.parametrize("tokenizer", ["ws_tokenizer", "std_tokenizer"])
@pytest.mark.parametrize("batch_size", [100_000, 128])
def test_build_index_bit_identical(tokenizer, batch_size):
    docs = make_docs()
    want = jbuilder.build_index(docs, getattr(jbuilder, tokenizer),
                                batch_size=batch_size, workers=1)
    got = tbuilder.build_index(docs, getattr(tbuilder, tokenizer),
                               batch_size=batch_size, workers=1)
    assert_same_built(got, want)


def test_build_index_python_tokenizer_bit_identical():
    docs = make_docs(seed=3)

    def tok(s):
        return s.lower().split()

    assert_same_built(tbuilder.build_index(docs, tok, workers=1),
                      jbuilder.build_index(docs, tok, workers=1))


def test_build_index_empty_corpus():
    got = tbuilder.build_index([])
    assert got.corpus_size == 0 and got.postings.num_terms == 0


def test_derive_attach_arrays_identical():
    built = jbuilder.build_index(make_docs(), workers=1)
    state = numpy_state(built)
    want = j_derive(built)
    got = derive_attach_arrays(from_numpy_state(state, "cpu").built)
    # the port reads only the planes and their layout constants
    assert set(got) == {"hdr32", "pay32", "blk_bits", "max_bucket"}
    for key in ("hdr32", "pay32"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("blk_bits", "max_bucket"):
        assert got[key] == want[key]


@pytest.mark.parametrize("with_derived", [False, True])
def test_from_numpy_state_round_trip(with_derived):
    built = jbuilder.build_index(make_docs(), workers=1)
    state = numpy_state(built)
    if with_derived:
        state["derived"] = j_derive(built)
    dev = from_numpy_state(state, "cpu")
    assert_same_built(dev.built, built)
    jdev = JDeviceIndex(built)
    assert dev.blk_bits == jdev.blk_bits
    assert dev.hdrs.dtype == torch.int32 and dev.pays.dtype == torch.int32
    np.testing.assert_array_equal(dev.hdrs.numpy(), np.asarray(jdev.hdrs))
    np.testing.assert_array_equal(dev.pays.numpy(),
                                  np.asarray(jdev.pays).view(np.int32))
    np.testing.assert_array_equal(dev.doc_lens.numpy(),
                                  np.asarray(jdev.doc_lens))
    for tid in range(len(built.vocab)):
        assert dev.term_span(tid) == jdev.term_span(tid)
    # and the state carried back out rebuilds the same device index
    again = from_numpy_state(numpy_state(dev.built), "cpu")
    np.testing.assert_array_equal(again.hdrs.numpy(), dev.hdrs.numpy())


def test_from_numpy_state_rejects_duplicate_terms():
    built = jbuilder.build_index(make_docs(), workers=1)
    state = numpy_state(built)
    state["terms"] = state["terms"][:-1] + [state["terms"][0]]
    with pytest.raises(ValueError):
        from_numpy_state(state, "cpu")


def test_device_index_is_on_the_named_device():
    built = tbuilder.build_index(make_docs(), workers=1)
    dev = DeviceIndex(built, "cpu")
    assert dev.device == torch.device("cpu")
    assert dev.hdrs.device.type == "cpu" and dev.doc_lens.device.type == "cpu"


def test_import_loads_no_jax():
    code = ("import searcharray_tpu_torch, sys; "
            "import searcharray_tpu_torch.search.phrase; "
            "assert not [m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')]")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr


def test_c_entries_match_their_declared_argument_types():
    """Every ``extern "C"`` entry of csrc/ is declared in the wrapper
    module with as many argument types as the source gives it
    parameters (ctypes checks no signature itself)."""
    import glob
    import os
    import re

    from searcharray_tpu_torch.ops.cuda import score as kc

    found = {}
    for path in glob.glob(os.path.join(kc.CSRC_DIR, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert found == {name: len(types)
                     for name, types in kc._ENTRIES.items()}
