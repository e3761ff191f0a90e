"""tests/test_tokenizer_parity.py against the port's builder: the native
(C++) tokenizer and the Python one index the same terms, lengths and
posting words (any non-ASCII doc is routed through Python), and each
build equals the JAX package's on the same corpus, term by term."""
import numpy as np
import pytest

from searcharray_tpu.index.builder import build_index as jbuild_index
from searcharray_tpu_torch.index import native as native_mod
from searcharray_tpu_torch.index.builder import (
    build_index,
    std_tokenizer,
    ws_tokenizer,
)
from test_tokenizer_parity import MIXED_CORPUS


def _term_vectors(built):
    """doc -> sorted term strings, for cross-build comparison."""
    return [sorted(built.vocab.get_term(int(tid))
                   for tid in built.doc_term.row_terms(d))
            for d in range(built.corpus_size)]


def _force_python(monkeypatch):
    monkeypatch.setattr(native_mod, "native_available", lambda: False)
    monkeypatch.setattr(native_mod, "tokenize_corpus",
                        lambda *a, **k: None)
    monkeypatch.setattr(native_mod, "sort_by_term", lambda *a, **k: None)
    monkeypatch.setattr(native_mod, "invert_encode", lambda *a, **k: None)


def _same_postings(a, b):
    """Equal posting words term by term (vocab ids may differ)."""
    assert sorted(a.vocab.get_term(i) for i in range(len(a.vocab))) == \
        sorted(b.vocab.get_term(i) for i in range(len(b.vocab)))
    for tid_a in range(len(a.vocab)):
        term = a.vocab.get_term(tid_a)
        np.testing.assert_array_equal(
            a.postings.term_slice(tid_a),
            b.postings.term_slice(b.vocab.get_term_id(term)), err_msg=term)


@pytest.mark.parametrize("tokenizer", [ws_tokenizer, std_tokenizer],
                         ids=["ws", "std"])
def test_native_matches_python_on_mixed_corpus(monkeypatch, tokenizer):
    if not native_mod.native_available():
        pytest.skip("no native library (g++ unavailable)")
    b_native = build_index(MIXED_CORPUS, tokenizer=tokenizer)
    with monkeypatch.context() as m:
        _force_python(m)
        b_python = build_index(MIXED_CORPUS, tokenizer=tokenizer)
    assert _term_vectors(b_native) == _term_vectors(b_python)
    np.testing.assert_array_equal(b_native.doc_lens, b_python.doc_lens)
    _same_postings(b_native, b_python)
    jbuilt = jbuild_index(MIXED_CORPUS, tokenizer=tokenizer)
    assert _term_vectors(b_native) == _term_vectors(jbuilt)
    np.testing.assert_array_equal(b_native.doc_lens, jbuilt.doc_lens)
    _same_postings(b_native, jbuilt)


def test_accented_lowercase_matches_query_tokenization():
    """'CAFÉ' must index as 'café' so query-time tokenization matches."""
    built = build_index(["CAFÉ ole", "nothing here"], tokenizer=std_tokenizer)
    q = std_tokenizer("CAFÉ")
    assert q == ["café"]
    assert built.vocab.get_term_id("café") >= 0


def test_ascii_control_whitespace_parity():
    """\\x1c-\\x1f are whitespace to str.split(); C++ must agree."""
    built = build_index(["a\x1cb\x1dc\x1ed\x1fe"], tokenizer=ws_tokenizer)
    assert built.doc_lens[0] == 5.0


def test_mixed_batch_stitches_doc_order(monkeypatch):
    """Interleaved ASCII / non-ASCII docs keep correct doc ids."""
    docs = ["alpha beta", "naïve café", "gamma", "Ωmega prime", "delta"]
    b_mixed = build_index(docs, tokenizer=ws_tokenizer)
    with monkeypatch.context() as m:
        _force_python(m)
        b_py = build_index(docs, tokenizer=ws_tokenizer)
    np.testing.assert_array_equal(b_mixed.doc_lens, b_py.doc_lens)
    assert _term_vectors(b_mixed) == _term_vectors(b_py)
    assert _term_vectors(b_mixed) == _term_vectors(
        jbuild_index(docs, tokenizer=ws_tokenizer))
