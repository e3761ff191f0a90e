"""Index persistence: the memmap tier and the versioned on-disk store.

The JAX package's store (``searcharray_tpu/index/store.py``) with its
imports rewired, and one on-disk format for both packages: a store that
either package writes, the other loads.  An index can spill its posting
buffer to one contiguous file (``memmap_postings``), which a pickle then
holds as its path (``TermPostings.__getstate__``), so a pickled dataframe
with search columns stays small (the reference's
``phrase/memmap_arrays.py:145-208``).  The JAX package's
``postings_getstate`` / ``postings_setstate`` repeat those methods and
have no caller, so they are not copied.

Format v3 (read back to v1) persists the device-attach arrays beside the
postings: the padded hdr32 / pay32 planes, which the port's
``DeviceIndex`` uploads as they are, and the per-term block-word max
with its ``doc_block`` of 1024, which the JAX package's loader requires
of every v3 store (it bounds its Pallas grid; the port's K1 needs no
bound, so only ``save_index`` computes it, for the store).  A store may
also hold doc-range shard partitions (``save_shards``, ``shards-S{n}/``),
in the JAX package's format too.
"""
from __future__ import annotations

import json
import logging
import os

import numpy as np

from searcharray_tpu_torch.index.builder import (
    BuiltIndex,
    DocTermMatrix,
    TermPostings,
)
from searcharray_tpu_torch.index.vocab import Vocabulary
from searcharray_tpu_torch.ops import encoding as enc

FORMAT_VERSION = 3
DOC_BLOCK = 1024   # the doc range of block_word_max, as the JAX package reads it
_META_ARRAYS = ("offsets", "lengths", "dt_cols", "dt_rows", "doc_lens",
                "doc_freqs")
_DERIVED_ARRAYS = ("hdr32", "pay32", "block_word_max")


def _next_filename(data_dir: str, suffix: str) -> str:
    os.makedirs(data_dir, exist_ok=True)
    return os.path.join(data_dir, f"{len(os.listdir(data_dir))}{suffix}")


def memmap_postings(postings: TermPostings, data_dir: str) -> None:
    """Spill the posting buffer to disk and re-open it memory-mapped."""
    filename = _next_filename(data_dir, ".dat")
    postings.data.tofile(filename)
    postings.data = np.memmap(filename, dtype=np.uint64, mode="r")
    postings.mmap_path = filename


def block_word_max(built: BuiltIndex, doc_block: int = DOC_BLOCK) -> np.ndarray:
    """Per term: the most posting words in any ``doc_block``-sized doc
    range (the JAX package's ``DeviceIndex._per_term_block_max``): one C++
    pass (``native.block_max``), or one vectorised numpy pass without the
    native runtime (words are (term, doc)-sorted, so the words of one term
    in one doc block are a contiguous run)."""
    post = built.postings
    W = len(post.data)
    V = post.num_terms
    out = np.zeros(V, dtype=np.int64)
    if W == 0:
        return out
    from searcharray_tpu_torch.index import native as native_mod

    nat = native_mod.block_max(post.data, post.offsets, post.lengths,
                               doc_block)
    if nat is not None:
        return nat
    docs_blk = enc.keys_of(post.data).astype(np.int64) // doc_block
    tid = np.repeat(np.arange(V, dtype=np.int64), post.lengths)
    change = np.ones(W, dtype=bool)
    change[1:] = (tid[1:] != tid[:-1]) | (docs_blk[1:] != docs_blk[:-1])
    starts = np.flatnonzero(change)
    run_len = np.diff(np.concatenate([starts, [W]]))
    np.maximum.at(out, tid[starts], run_len)
    return out


def save_index(built: BuiltIndex, directory: str) -> None:
    """Write a versioned on-disk index (postings, CSR metadata, vocab).

    Every array is a plain ``.npy``: they load at disk speed and mmap.
    v3 also persists the device-attach arrays (the padded hdr32 / pay32
    planes of ``device.derive_attach_arrays`` and the per-term block-word
    max), so a later attach is an upload, not a derivation."""
    from searcharray_tpu_torch.index.device import derive_attach_arrays

    os.makedirs(directory, exist_ok=True)
    np.asarray(built.postings.data).tofile(
        os.path.join(directory, "postings.dat"))
    arrays = {
        "offsets": built.postings.offsets,
        "lengths": built.postings.lengths,
        "dt_cols": built.doc_term.cols,
        "dt_rows": built.doc_term.rows,
        "doc_lens": built.doc_lens,
        "doc_freqs": built.doc_freqs,
    }
    for name in _META_ARRAYS:
        np.save(os.path.join(directory, name + ".npy"), arrays[name])
    derived = dict(built.derived or derive_attach_arrays(built))
    if derived.get("block_word_max") is None \
            or derived.get("doc_block") != DOC_BLOCK:
        derived["block_word_max"] = block_word_max(built)
        derived["doc_block"] = DOC_BLOCK
    for name in _DERIVED_ARRAYS:
        np.save(os.path.join(directory, name + ".npy"),
                np.asarray(derived[name]))
    with open(os.path.join(directory, "index.json"), "w") as f:
        json.dump(
            {
                "format_version": FORMAT_VERSION,
                "avg_doc_length": built.avg_doc_length,
                "num_docs": int(built.corpus_size),
                "num_terms": len(built.vocab),
                "blk_bits": int(derived["blk_bits"]),
                "doc_block": int(derived["doc_block"]),
                "max_bucket": int(derived["max_bucket"]),
            },
            f,
        )
    with open(os.path.join(directory, "vocab.txt"), "w", encoding="utf-8") as f:
        for i in range(len(built.vocab)):
            f.write(json.dumps(built.vocab.get_term(i)) + "\n")


_SHARD_ARRAYS = ("hdrs", "pays", "offsets", "lengths", "doc_lens",
                 "shard_starts")


def save_shards(built: BuiltIndex, directory: str, num_shards: int) -> str:
    """Persist a doc-range shard partition beside a saved index.

    Writes ``shards-S{num_shards}/`` under ``directory`` holding the
    per-shard device-attach arrays (``ShardedIndex.partition``'s) and
    ``shards.json``, so a serving process on a mesh cold-starts at upload
    speed instead of re-running the O(S*W) host re-partition.  One store
    can hold partitions for several shard counts."""
    from searcharray_tpu_torch.parallel.sharded import ShardedIndex

    parts = ShardedIndex.partition(built, num_shards)
    d = os.path.join(directory, f"shards-S{num_shards}")
    os.makedirs(d, exist_ok=True)
    for name in _SHARD_ARRAYS:
        np.save(os.path.join(d, name + ".npy"), parts[name])
    with open(os.path.join(d, "shards.json"), "w") as f:
        json.dump({
            "num_shards": num_shards,
            "shard_docs": int(parts["shard_docs"]),
            "blk_bits": int(parts["blk_bits"]),
            "num_docs": int(parts["num_docs"]),
        }, f)
    return d


def load_shards(directory: str, num_shards: int) -> dict:
    """Memory-map a persisted shard partition (see save_shards)."""
    d = os.path.join(directory, f"shards-S{num_shards}")
    meta_path = os.path.join(d, "shards.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"no saved S={num_shards} partition under {directory}; run "
            f"save_shards(built, dir, {num_shards}) once")
    with open(meta_path) as f:
        meta = json.load(f)
    parts = {
        name: np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
        for name in _SHARD_ARRAYS
    }
    parts.update(meta)
    return parts


def load_index(directory: str, mmap: bool = True) -> BuiltIndex:
    """Open a store of format v1 to v3 (either package's).  With ``mmap``
    the postings and the arrays are read-only memory maps; a v3 store's
    attach arrays ride along in ``BuiltIndex.derived``."""
    with open(os.path.join(directory, "index.json")) as f:
        meta = json.load(f)
    version = meta["format_version"]
    if version not in (1, 2, 3):
        raise ValueError(f"Unsupported index format {version}")
    if version == 1:
        z = np.load(os.path.join(directory, "meta.npz"))
        m = {name: z[name] for name in z.files}
    else:
        mode = "r" if mmap else None
        m = {
            name: np.load(os.path.join(directory, name + ".npy"),
                          mmap_mode=mode)
            for name in _META_ARRAYS
        }
    dat = os.path.join(directory, "postings.dat")
    data = (
        np.memmap(dat, dtype=np.uint64, mode="r")
        if mmap
        else np.fromfile(dat, dtype=np.uint64)
    )
    postings = TermPostings(data, np.asarray(m["offsets"]),
                            np.asarray(m["lengths"]))
    if mmap:
        postings.mmap_path = dat
    vocab = Vocabulary()
    with open(os.path.join(directory, "vocab.txt"), encoding="utf-8") as f:
        for line in f:
            vocab.add_term(json.loads(line))
    derived = None
    if version < 3 and meta["num_docs"] >= 1_000_000:
        logging.getLogger(__name__).warning(
            "index %s is a v%d store: device attach will re-derive the "
            "posting planes (minutes of host time at this scale). Run "
            "scripts/upgrade_store_v3.py %s once to persist them.",
            directory, version, directory)
    if version >= 3:
        mode = "r" if mmap else None
        derived = {
            name: np.load(os.path.join(directory, name + ".npy"),
                          mmap_mode=mode)
            for name in _DERIVED_ARRAYS
        }
        derived["blk_bits"] = meta["blk_bits"]
        derived["doc_block"] = meta["doc_block"]
        derived["max_bucket"] = meta["max_bucket"]
    return BuiltIndex(
        postings=postings,
        doc_term=DocTermMatrix(m["dt_cols"], m["dt_rows"]),
        vocab=vocab,
        doc_lens=np.asarray(m["doc_lens"]),
        avg_doc_length=meta["avg_doc_length"],
        # absent in the oldest stores: recomputed by BuiltIndex then
        doc_freqs=np.asarray(m["doc_freqs"]) if "doc_freqs" in m else None,
        derived=derived,
    )
