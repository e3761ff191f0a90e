"""Persistence and observability of the port against the JAX package: one
on-disk store format for both packages (v3, read back to v1), made in
``tmp_path`` by either package and loaded by the other; ``data_dir=``
memory maps and pickling; ``hbm_report`` / ``memory_report`` with the
JAX package's assertions (tests/test_concurrency.py); ``trace``."""
import json
import os
import pickle

import numpy as np
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.index import device as jdevice
from searcharray_tpu.index import store as jstore
from searcharray_tpu.utils.profiling import hbm_report as jhbm_report
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.index import device as tdevice
from searcharray_tpu_torch.index import native as tnative
from searcharray_tpu_torch.index import store as tstore
from searcharray_tpu_torch.utils import profiling

QUERIES = ["alpha", "w3", ["alpha", "beta"], ["w1", "w2"], "nope"]


def make_docs(n=900, seed=21):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma"] + [f"w{i}" for i in range(60)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 40)))
            for _ in range(n)]
    docs[17] = " ".join(rng.choice(vocab, size=3000))   # a long doc
    return docs


@pytest.fixture(scope="module")
def pair():
    docs = make_docs()
    return JSearchArray.index(docs), SearchArray.index(docs, device="cpu")


def attached(built, device="cpu"):
    arr = SearchArray([], device=device)
    arr._attach(arr._state.__class__(built, device))
    return arr


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def same_answers(got, want):
    for q in QUERIES:
        np.testing.assert_array_equal(bits(got.score(q)), bits(want.score(q)),
                                      err_msg=str(q))
    gs, gi = got.score_batch(QUERIES, top_k=7, slop=[0, 0, 0, 2, 0])
    ws, wi = want.score_batch(QUERIES, top_k=7, slop=[0, 0, 0, 2, 0])
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(bits(gs), bits(ws))


@pytest.mark.parametrize("mmap", [True, False])
def test_a_jax_store_loads_in_the_port(pair, tmp_path, mmap, monkeypatch):
    jarr, tarr = pair
    jstore.save_index(jarr._built, str(tmp_path))
    built = tstore.load_index(str(tmp_path), mmap=mmap)
    assert isinstance(built.postings.data, np.memmap) == mmap
    assert built.derived is not None
    want = tdevice.derive_attach_arrays(tarr._built)

    # the store's planes go to the device as they are: no derivation
    def no_derivation(_):
        raise AssertionError("derived again")

    monkeypatch.setattr(tdevice, "derive_attach_arrays", no_derivation)
    restored = attached(built)
    dev = restored.dev
    assert dev._usable_derived(built) is not None
    np.testing.assert_array_equal(dev.hdrs.numpy(), want["hdr32"])
    np.testing.assert_array_equal(dev.pays.numpy(),
                                  want["pay32"].view(np.int32))
    same_answers(restored, tarr)
    for q in ("alpha", ["alpha", "beta"]):
        np.testing.assert_array_equal(bits(restored.score(q)),
                                      bits(jarr.score(q)))


@pytest.mark.parametrize("mmap", [True, False])
def test_a_port_store_loads_in_jax(pair, tmp_path, mmap):
    jarr, tarr = pair
    tstore.save_index(tarr._built, str(tmp_path))
    built = jstore.load_index(str(tmp_path), mmap=mmap)
    dev = jdevice.DeviceIndex(built)
    assert dev._usable_derived(built) is not None   # the JAX check passes
    want = jdevice.derive_attach_arrays(jarr._built)
    for name in ("hdr32", "pay32", "block_word_max"):
        np.testing.assert_array_equal(np.asarray(built.derived[name]),
                                      want[name])
    restored = JSearchArray([])
    restored._attach(built)
    for q in QUERIES:
        np.testing.assert_array_equal(bits(restored.score(q)),
                                      bits(jarr.score(q)), err_msg=str(q))
    # and the port loads its own store
    same_answers(attached(tstore.load_index(str(tmp_path), mmap=mmap)),
                 tarr)


def test_block_word_max_without_the_native_runtime(pair, monkeypatch):
    jarr, tarr = pair
    want = jdevice.derive_attach_arrays(jarr._built)["block_word_max"]
    np.testing.assert_array_equal(tstore.block_word_max(tarr._built), want)
    monkeypatch.setattr(tnative, "block_max", lambda *a: None)
    np.testing.assert_array_equal(tstore.block_word_max(tarr._built), want)


def downgrade(directory, version):
    """A store of an earlier format from a v3 one: v2 has no attach
    arrays, v1 keeps its metadata in one ``meta.npz``."""
    for name in ("hdr32", "pay32", "block_word_max"):
        os.remove(os.path.join(directory, name + ".npy"))
    if version == 1:
        arrays = {}
        for name in ("offsets", "lengths", "dt_cols", "dt_rows", "doc_lens"):
            path = os.path.join(directory, name + ".npy")
            arrays[name] = np.load(path)
            os.remove(path)
        os.remove(os.path.join(directory, "doc_freqs.npy"))
        np.savez(os.path.join(directory, "meta.npz"), **arrays)
    with open(os.path.join(directory, "index.json")) as f:
        meta = json.load(f)
    meta["format_version"] = version
    with open(os.path.join(directory, "index.json"), "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_older_stores_load_in_both_packages(pair, tmp_path, version, writer):
    jarr, tarr = pair
    (jstore if writer == "jax" else tstore).save_index(
        (jarr if writer == "jax" else tarr)._built, str(tmp_path))
    downgrade(str(tmp_path), version)
    built = tstore.load_index(str(tmp_path))
    assert built.derived is None
    np.testing.assert_array_equal(built.doc_freqs, tarr._built.doc_freqs)
    same_answers(attached(built), tarr)
    jbuilt = jstore.load_index(str(tmp_path))
    restored = JSearchArray([])
    restored._attach(jbuilt)
    np.testing.assert_array_equal(restored.score("alpha"),
                                  jarr.score("alpha"))


def test_shards_wait_for_item_14(pair, tmp_path):
    # ported (item 14): the port's shard store is the JAX package's, array
    # for array, and a count never saved raises the same error
    jarr, tarr = pair
    d = tstore.save_shards(tarr._built, str(tmp_path / "t"), 2)
    jd = jstore.save_shards(jarr._built, str(tmp_path / "j"), 2)
    assert os.path.basename(d) == os.path.basename(jd) == "shards-S2"
    got = tstore.load_shards(str(tmp_path / "t"), 2)
    want = jstore.load_shards(str(tmp_path / "j"), 2)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(value), err_msg=name)
    assert isinstance(got["hdrs"], np.memmap)
    with pytest.raises(FileNotFoundError, match="no saved S=3 partition"):
        tstore.load_shards(str(tmp_path / "t"), 3)


def test_data_dir_memmaps_and_pickles_as_a_path(pair, tmp_path):
    jarr, tarr = pair
    docs = make_docs()
    arr = SearchArray.index(docs, device="cpu", data_dir=str(tmp_path))
    post = arr._built.postings
    assert isinstance(post.data, np.memmap)
    assert os.path.dirname(post.mmap_path) == str(tmp_path)
    blob = pickle.dumps(arr)
    assert post.mmap_path.encode() in blob
    # the path, not the words: smaller than an in-memory array's pickle
    # by the posting buffer
    assert len(blob) + post.data.nbytes < len(pickle.dumps(tarr)) + 1024
    restored = pickle.loads(blob)
    assert restored._built.postings.mmap_path == post.mmap_path
    assert restored.device == "cpu" and restored._state.dev is None
    same_answers(restored, tarr)
    # the JAX package memmaps the same way
    jmm = JSearchArray.index(docs, data_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(
        np.asarray(jmm._built.postings.data), np.asarray(post.data))


def test_pickling_keeps_the_device_and_attaches_lazily(pair):
    _, tarr = pair
    view = tarr[10:500]
    for arr in (tarr, view):
        arr.score("alpha")   # attached before pickling
        restored = pickle.loads(pickle.dumps(arr))
        assert restored.device == "cpu" and restored._state.dev is None
        assert restored.subset == arr.subset
        np.testing.assert_array_equal(restored.rows, arr.rows)
        np.testing.assert_array_equal(bits(restored.score("alpha")),
                                      bits(arr.score("alpha")))
        assert restored._state.dev.device.type == "cpu"
    # the state names the device; a CUDA array keeps its own
    state = tarr.__getstate__()
    state["device"] = "cuda"
    clone = SearchArray([])
    clone.__setstate__(state)
    assert clone.device == "cuda" and clone._state.dev is None


def test_hbm_report(pair):
    """tests/test_concurrency.py::test_hbm_report on the port."""
    jarr, tarr = pair
    tarr.score("alpha")  # force the device copy
    rep = profiling.hbm_report(tarr)
    assert rep["index.hdrs"] > 0
    assert rep["index.total"] >= rep["index.hdrs"] + rep["index.pays"]
    assert not any(k.startswith("device.") for k in rep)   # a CPU index
    assert profiling.hbm_report(tarr.dev) == rep
    assert "index.total" in profiling.format_hbm_report(tarr)


def test_hbm_and_memory_report_account_pools(pair):
    """tests/test_concurrency.py::test_hbm_and_memory_report_account_pools
    on the port, and the same keys as the JAX package's report."""
    jarr, tarr = pair
    for arr in (jarr, tarr):
        arr.score_batch([["alpha", "w5"], "w3"])  # fills both pools
    rep = profiling.hbm_report(tarr)
    assert rep.get("pool.plane_pool", 0) > 0
    assert rep.get("pool.tf_pool", 0) > 0
    assert rep["pool.plane_pool.slots_used"] >= 1
    assert rep["index.total"] >= rep["pool.plane_pool"] + rep["pool.tf_pool"]
    jrep = jhbm_report(jarr)
    assert set(rep) == {k for k in jrep if not k.startswith("device.")}
    for k in ("pool.plane_pool.slots_total", "pool.tf_pool.slots_total"):
        assert isinstance(rep[k], int) and rep[k] > 0
    txt = tarr.memory_report()
    assert "Plane Pool" in txt and "TF Pool" in txt
    jtxt = jarr.memory_report()
    assert txt.split("Plane Pool")[0] == jtxt.split("Plane Pool")[0]
    assert tarr.memory_usage() == tarr.nbytes > 0


def test_trace_writes_a_chrome_trace(pair, tmp_path):
    _, tarr = pair
    with profiling.trace(str(tmp_path / "tr")):
        tarr.score_batch(["alpha", ["alpha", "beta"]], top_k=3)
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("score_batch" in e.get("name", "") or e.get("ph") == "X"
               for e in events)
