"""Pandas ExtensionArray facade over the torch device index.

The JAX package's facade (`Terms`, `TermsDtype`, `SearchArray`) with the
device as an explicit argument: ``SearchArray.index(strings,
device="cuda")``.  Search methods run over the whole corpus on that device
and gather the view's rows at the end; ``score`` and ``termfreqs`` of one
query are a one-query batch (``search/batch.py``), or with a position
window run on the query's posting slices.  The dtype registers as
``"tokenized_text_torch"``, so pandas take/concat hand back this package's
arrays.  Terms, exact phrases (dense planes, or the sparse chain for
position windows and corpora the planes cannot hold) and slop phrases
(the dense window kernel, or the sparse neighbourhood kernel for a
position window, ``n + slop - 1 > 18``, a term more than twice and
corpora the planes cannot hold) are ported, the candidate-subset engine
for selective queries on large corpora, and ``score_batch_device`` (with
``rows=``, a doc-id subset) for callers that compose on the device
(``solr.edismax``).  Postings can live in a memory-mapped file
(``index(..., data_dir=)``), an array pickles with its device (a
memmapped one as its file's path) and re-attaches lazily on unpickle, and
``__setitem__`` re-indexes the assigned rows (``builder.replace_docs``)
and drops the device copy, whose pools go with it.  With ``mesh=`` (a
``parallel.sharded.Mesh`` of torch devices) the index is also split by
doc range into shards beside the single-device one
(``parallel/sharded.py``): ``score_batch``, ``score_batch_device`` and
``edismax`` over a full view then plan each batch once and run the plan
on every shard, ranking through a per-shard top-k and a merge.
``warm_serving`` issues the batch driver's group shapes once before the
first live query (``utils/warm.py``).

Searches may run from many threads at once (each on the default stream
or on a stream of its own); each returns what it would alone.  An index
is held by one thread at a time from a batch's plan to its last launch
(``index/device.py:SlotMaps.held``).  ``__setitem__`` while other threads
search the array is not supported, as pandas assignment is not
thread-safe in the reference.
"""
from __future__ import annotations

import json
import numbers
import threading
import warnings
from collections import Counter
from typing import Iterable, List, Optional, Union

import numpy as np
import pandas as pd
import torch
from pandas.api.extensions import (
    ExtensionArray,
    ExtensionDtype,
    no_default,
    register_extension_dtype,
    take as pd_take,
)
from pandas.api.types import is_list_like

from searcharray_tpu_torch.index.builder import (
    BuiltIndex,
    build_index,
    build_index_from_terms,
    replace_docs,
    ws_tokenizer,
)
from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.index.vocab import TermMissingError
from searcharray_tpu_torch.ops import encoding as enc
from searcharray_tpu_torch.ops.cuda.score import host_to_device
from searcharray_tpu_torch.search import batch as batch_mod
from searcharray_tpu_torch.search import dense as dense_mod
from searcharray_tpu_torch.search import phrase as phrase_mod
from searcharray_tpu_torch.search import scoring
from searcharray_tpu_torch.search import spans as spans_mod
from searcharray_tpu_torch.search.similarity import Similarity, default_bm25
from searcharray_tpu_torch.utils import profiling


def _bytes_h(num_bytes):
    suffixes = ["B", "KB", "MB", "GB", "TB", "PB"]
    i = 0
    num = float(num_bytes)
    while num >= 1024 and i < len(suffixes) - 1:
        num /= 1024.0
        i += 1
    return f"{num:.2f} {suffixes[i]}"


class Terms:
    """One indexed doc: a bag of term -> tf plus optional positions."""

    def __init__(self, postings, doc_len: int = 0, posns: Optional[dict] = None,
                 encoded=False):
        self.postings = postings
        self.doc_len = doc_len
        self.posns = posns
        self.encoded = encoded

    def termfreq(self, token):
        return self.postings[token]

    def terms(self):
        return self.postings.items()

    @staticmethod
    def _decode(words):
        _, p = enc.decode_words(np.asarray(words, dtype=np.uint64))
        return p.astype(np.uint32)

    def positions(self, term=None):
        """Positions per term.  Rows fetched from an index hold ENCODED
        posting words (``encoded=True``) and decode here on demand."""
        if self.posns is None:
            return {}
        if term is None:
            if self.encoded:
                return {t: self._decode(w)
                        for t, w in self.posns.items()}.items()
            return self.posns.items()
        w = self.posns[term]
        return self._decode(w) if self.encoded else w

    def raw_positions(self, vocab, term=None):
        if self.posns is None:
            return {}
        if term is None:
            return [(vocab.get_term_id(t), self.positions(t))
                    for t in self.posns]
        return [(vocab.get_term_id(term), self.positions(term))]

    def tf_to_dense(self, vocab):
        dense = np.zeros(len(vocab))
        for term, freq in self.terms():
            dense[vocab.get_term_id(term)] = freq
        return dense

    def __len__(self):
        return len(self.postings)

    def __repr__(self):
        return f"Terms({set(self.postings.keys())})"

    def __str__(self):
        return repr(self)

    def __eq__(self, other):
        if isinstance(other, SearchArray):
            return other == self
        same = isinstance(other, Terms) and self.postings == other.postings
        if same and self.doc_len == other.doc_len:
            return True

    def __lt__(self, other):
        if not isinstance(other, Terms):
            # pandas rank/sort compares against Infinity/NegInfinity
            # sentinels; defer to their reflected comparison
            return NotImplemented
        for key in sorted(set(self.postings) | set(other.postings)):
            lhs_val = self.postings.get(key, 0)
            rhs_val = other.postings.get(key, 0)
            if lhs_val < rhs_val:
                return True
            elif lhs_val > rhs_val:
                return False
        return False

    def __le__(self, other):
        return self < other or self == other

    def __gt__(self, other):
        return not (self < other) and self != other

    def __hash__(self):
        return hash(json.dumps(self.postings, sort_keys=True))


@register_extension_dtype
class TermsDtype(ExtensionDtype):
    """Pandas dtype for tokenized, searchable text on a torch device."""

    name = "tokenized_text_torch"
    type = Terms
    kind = "O"

    @classmethod
    def construct_from_string(cls, string):
        if not isinstance(string, str):
            raise TypeError(
                "'construct_from_string' expects a string, got {}".format(type(string))
            )
        elif string == cls.name:
            return cls()
        raise TypeError(
            "Cannot construct a '{}' from '{}'".format(cls.__name__, string)
        )

    @classmethod
    def construct_array_type(cls):
        return SearchArray

    def __repr__(self):
        return "TermsDtype()"

    @property
    def na_value(self):
        return Terms({})

    def valid_value(self, value):
        return (isinstance(value, dict) or pd.isna(value)
                or isinstance(value, Terms))


class _IndexState:
    """Mutable holder shared by all row views of one backing index.

    ``__setitem__`` swaps ``built`` in place, so every pandas view of the
    same array sees the mutation, while ``copy()`` makes a new holder:
    copy-on-write.  ``lock`` guards the swap and the lazy device attach,
    so threads that query a fresh array attach one ``DeviceIndex``."""

    __slots__ = ("built", "dev", "device", "sharded", "cache_gt_than",
                 "lock")

    def __init__(self, built: BuiltIndex, device, dev=None, sharded=None):
        self.built = built
        self.device = device
        self.dev = dev
        self.sharded = sharded  # parallel.sharded.ShardedIndex with mesh=
        self.cache_gt_than = 25  # pool-admission threshold (see warm())
        self.lock = threading.Lock()


class SearchArray(ExtensionArray):
    """An array of tokenized text, indexed for search on a torch device.

    Build with :meth:`index`; normal pandas slicing yields row views over
    the shared device index.
    """

    dtype = TermsDtype()
    _readonly = False

    def __init__(self, postings, tokenizer=ws_tokenizer, avoid_copies=True,
                 device="cuda"):
        if not is_list_like(postings):
            raise TypeError("Expected list-like object, got {}".format(type(postings)))
        self.tokenizer = tokenizer
        self.avoid_copies = avoid_copies
        self._attach(_IndexState(build_index_from_terms(postings, Terms),
                                 device))

    # ------------------------------------------------------------------
    # construction / wiring
    # ------------------------------------------------------------------
    def _attach(self, state: _IndexState, rows: Optional[np.ndarray] = None,
                subset: bool = False):
        self._state = state
        self.rows = (np.arange(state.built.corpus_size, dtype=np.int64)
                     if rows is None else rows)
        self.subset = subset

    def _view(self, state: _IndexState, rows=None,
              subset=False) -> "SearchArray":
        new = SearchArray([], tokenizer=self.tokenizer,
                          avoid_copies=self.avoid_copies,
                          device=state.device)
        new._attach(state, rows=rows, subset=subset)
        return new

    @property
    def _built(self) -> BuiltIndex:
        return self._state.built

    @property
    def device(self):
        return self._state.device

    @property
    def doc_lens(self) -> np.ndarray:
        return self._built.doc_lens[self.rows]

    @property
    def avg_doc_length(self) -> float:
        return self._built.avg_doc_length

    @property
    def corpus_size(self) -> int:
        return self._built.corpus_size

    @property
    def dev(self) -> DeviceIndex:
        """The device index, attached at the first search (once, however
        many threads search a fresh array)."""
        state = self._state
        dev = state.dev
        if dev is None:
            with state.lock:
                if state.dev is None:
                    state.dev = DeviceIndex(state.built, state.device)
                dev = state.dev
        return dev

    @property
    def term_dict(self):
        return self._built.vocab

    @property
    def _full_view(self) -> bool:
        return not self.subset and len(self.rows) == self.corpus_size

    @classmethod
    def index(cls, array: Iterable, tokenizer=ws_tokenizer, truncate=False,
              batch_size=100_000, avoid_copies=True, workers=4,
              cache_gt_than=25, data_dir: Optional[str] = None,
              autowarm=True, mesh=None, device="cuda") -> "SearchArray":
        """Tokenize and index an iterable of strings; the index lives on
        ``device`` (a torch device, "cuda" by default).  With ``data_dir``
        the posting buffer is spilled to a file there and memory-mapped
        (``index/store.py:memmap_postings``): a pickle of the array then
        holds the file's path, not the postings.  With ``mesh`` (a
        ``parallel.sharded.Mesh`` with "docs" / "queries" axes) the
        postings are also split by doc range over the mesh's devices
        (``ShardedIndex``); batched scoring and edismax then run per
        shard."""
        if not is_list_like(array):
            raise TypeError("Expected list-like object, got {}".format(type(array)))
        built = build_index(array, tokenizer, truncate=truncate,
                            batch_size=batch_size, workers=workers)
        if data_dir is not None:
            from searcharray_tpu_torch.index.store import memmap_postings

            memmap_postings(built.postings, data_dir)
        arr = cls([], tokenizer=tokenizer, avoid_copies=avoid_copies,
                  device=device)
        arr._attach(_IndexState(built, device))
        if mesh is not None:
            from searcharray_tpu_torch.parallel.sharded import ShardedIndex

            arr._state.sharded = ShardedIndex.build(built, mesh=mesh)
        if autowarm:
            arr.warm(cache_gt_than=cache_gt_than)
        else:
            arr._state.cache_gt_than = cache_gt_than
        return arr

    def warm(self, cache_gt_than: Optional[int] = None):
        """Prefill the tf pool with the hottest terms (more than
        ``cache_gt_than`` posting words; default: the value given at
        :meth:`index` time), one K1 launch each, so the first queries
        against frequent terms skip their fills."""
        if cache_gt_than is None:
            cache_gt_than = self._state.cache_gt_than
        self._state.cache_gt_than = cache_gt_than
        lengths = self._built.postings.lengths
        common = np.flatnonzero(lengths > cache_gt_than)
        if dense_mod.dense_eligible(self.dev) and len(common):
            hot = common[np.argsort(-lengths[common], kind="stable")]
            tf_cap = max(0, dense_mod.tf_capacity(self.dev) - 8)
            dense_mod.ensure_tfs(self.dev, [int(t) for t in hot[:tf_cap]])

    def warm_serving(self, **kwargs) -> int:
        """Warm the serving path for this index before the first live
        query: issue ``score_batch`` calls that reach every group shape
        the batch driver forms for this corpus, so the kernel library is
        loaded, each kernel's module loaded on the card (CUDA loads
        modules at their first launch), the caching allocator grown and
        the pinned staging buffers allocated.  On a sharded array it warms
        the sharded path.  See ``utils/warm.py:warm_serving`` for the
        knobs; returns the number of warm queries issued."""
        from searcharray_tpu_torch.utils.warm import warm_serving as _ws

        return _ws(self, **kwargs)

    @classmethod
    def _from_sequence(cls, scalars, *, dtype=None, copy=False):
        if dtype is not None and not isinstance(dtype, TermsDtype):
            return scalars
        if isinstance(scalars, np.ndarray) and scalars.dtype.kind not in "OUS":
            return scalars
        return cls(scalars)

    # ------------------------------------------------------------------
    # pandas protocol
    # ------------------------------------------------------------------
    def memory_usage(self, deep=False):
        return self.nbytes

    @property
    def nbytes(self):
        b = self._built
        return (
            b.postings.nbytes
            + b.doc_term.nbytes
            + b.doc_lens.nbytes
            + b.vocab.nbytes
        )

    def _row_to_terms(self, corpus_row: int) -> Terms:
        """One corpus row as a Terms scalar.  Positions stay ENCODED
        (posting words; Terms decodes lazily on .positions()) and tf is the
        payload popcount, so fetching a row never decodes anything."""
        b = self._built
        tids = b.doc_term.row_terms(corpus_row)
        tfs = {}
        posns = {}
        for tid in tids:
            term = b.vocab.get_term(int(tid))
            sl = b.postings.term_slice(int(tid))
            keys = enc.keys_of(sl)
            mine = sl[keys == np.uint64(corpus_row)]
            posns[term] = mine
            tfs[term] = max(1, int(enc.popcount64(
                mine & np.uint64(enc.LSB_MASK)).sum()))
        return Terms(tfs, doc_len=int(b.doc_lens[corpus_row]), posns=posns,
                     encoded=True)

    def __getitem__(self, key):
        key = pd.api.indexers.check_array_indexer(self, key)
        if isinstance(key, numbers.Integral):
            row = int(key)
            if row < 0:
                row += len(self)
            if row < 0 or row >= len(self):
                raise IndexError("index out of bounds")
            return self._row_to_terms(int(self.rows[row]))
        new = self._view(self._state, rows=self.rows[key], subset=True)
        new._readonly = self._readonly
        return new

    def __setitem__(self, key, value):
        if self._readonly:
            raise ValueError("Cannot modify read-only array")
        key = pd.api.indexers.check_array_indexer(self, key)
        if isinstance(value, pd.Series):
            value = value.values
        if isinstance(value, pd.DataFrame):
            value = value.values.flatten()
        if isinstance(value, SearchArray):
            value = value.to_numpy()
        if isinstance(value, list):
            value = np.asarray(value, dtype=object)
        if not isinstance(value, np.ndarray) and not self.dtype.valid_value(value):
            raise ValueError(
                f"Cannot set non-object array to SearchArray -- "
                f"you passed type:{type(value)} -- {value}"
            )
        if isinstance(key, numbers.Integral) and isinstance(value, np.ndarray):
            raise ValueError("Cannot set a single value to an array")

        # the logical positions assigned (key: int, slice, mask or fancy)
        logical = np.arange(len(self))[key]
        if isinstance(logical, numbers.Integral) or np.isscalar(logical):
            logical = np.asarray([int(logical)])
        if not isinstance(value, np.ndarray):
            value = np.asarray([value] * len(logical), dtype=object)
        elif len(value) == 1 and len(logical) != 1:
            value = np.asarray([value[0]] * len(logical), dtype=object)
        elif len(value) != len(logical):
            raise ValueError(
                f"cannot set {len(logical)} positions from "
                f"{len(value)} values"
            )
        if pd.isna(value).any():
            value = np.asarray(
                [Terms({}) if pd.isna(v) else v for v in value], dtype=object
            )

        # Only the assigned docs are re-indexed and spliced into the CSR
        # (builder.replace_docs).  De-alias: a logical position whose
        # backing row another position of this view shares (take and fancy
        # indexing repeat backing rows) gets a fresh backing row, so
        # assigning one position never changes its aliases.
        counts = np.bincount(self.rows, minlength=self._built.corpus_size)
        next_row = self._built.corpus_size
        new_rows = self.rows.copy()
        appended = False
        doc_ids: List[int] = []
        vals: List[Terms] = []
        for pos, v in zip(logical, value):
            if isinstance(v, dict):
                v = Terms(v, doc_len=len(v))
            backing = int(self.rows[int(pos)])
            if counts[backing] > 1:
                backing = next_row
                next_row += 1
                new_rows[int(pos)] = backing
                appended = True
            doc_ids.append(backing)
            vals.append(v)
        # Swap the shared holder's index in place: every pandas view of
        # this array sees the mutation, copies (other holders) do not.  The
        # device copy goes with its pools (tf rows, cached phrase and slop
        # rows, planes, the phrase-tf cache's counts and recipes) and
        # re-attaches on the next search.  Assignment is not safe against
        # queries running in other threads (nor is pandas assignment in
        # the reference); a query that took the old device index finishes
        # on it.
        built = replace_docs(self._built, np.asarray(doc_ids, dtype=np.int64),
                             vals, Terms)
        sharded = None
        if self._state.sharded is not None:
            # re-shard the mutated index on the same mesh, so the sharded
            # routes see the mutation too
            from searcharray_tpu_torch.parallel.sharded import ShardedIndex

            sharded = ShardedIndex.build(built,
                                         mesh=self._state.sharded.mesh)
        with self._state.lock:
            self._state.built = built
            self._state.dev = None
            if sharded is not None:
                self._state.sharded = sharded
        if appended:
            self.rows = new_rows
            self.subset = True

    def value_counts(self, dropna: bool = True):
        counts = Counter(self[:])
        if dropna:
            counts.pop(Terms({}), None)
        return pd.Series(counts)

    def __len__(self):
        return len(self.rows)

    def __eq__(self, other):
        if isinstance(other, (pd.DataFrame, pd.Series, pd.Index)):
            return NotImplemented
        if isinstance(other, SearchArray):
            if len(self) != len(other):
                return False
            return np.asarray(self[:], dtype=object) == np.asarray(
                other[:], dtype=object)
        if isinstance(other, Terms):
            return np.asarray([t == other for t in self[:]], dtype=bool)
        if is_list_like(other):
            # row by row against an array built from the list
            if len(self) != len(other):
                return False
            if len(other) == 0:
                return np.array([], dtype=bool)
            other = SearchArray(other, tokenizer=self.tokenizer,
                                device=self.device)
            return np.asarray(self[:], dtype=object) == np.asarray(
                other[:], dtype=object)
        return np.full(len(self), False)

    def isna(self):
        return np.asarray(self.doc_lens == 0)

    def unique(self):
        return self[:]

    def __iter__(self):
        if len(self) > 10000:
            warnings.warn(
                "Iterating over SearchArray is very slow and not recommended."
            )
        return super().__iter__()

    def take(self, indices, allow_fill=False, fill_value=None):
        result_indices = pd_take(np.arange(len(self.rows)), indices,
                                 allow_fill=allow_fill, fill_value=-1)
        if allow_fill and -1 in result_indices:
            if fill_value is None or pd.isna(fill_value):
                fill_value = Terms({}, encoded=True)
            rows = [fill_value if r < 0 else self[int(r)]
                    for r in result_indices]
            return SearchArray(rows, tokenizer=self.tokenizer,
                               avoid_copies=self.avoid_copies,
                               device=self.device)
        return self[result_indices].copy()

    def copy(self):
        if self.avoid_copies:
            # share the immutable built index and device buffers, the
            # sharded runtime included
            state = _IndexState(self._built, self.device, self._state.dev,
                                sharded=self._state.sharded)
        else:
            import copy as _copy

            state = _IndexState(_copy.deepcopy(self._built), self.device)
        return self._view(state, rows=self.rows.copy(), subset=self.subset)

    @classmethod
    def _concat_same_type(cls, to_concat):
        to_concat = list(to_concat)
        first = to_concat[0]
        # full-corpus views concatenate by merging their built indexes
        if all(ea._full_view and ea.tokenizer is first.tokenizer
               for ea in to_concat):
            from searcharray_tpu_torch.index.builder import merge_built

            merged = merge_built([ea._built for ea in to_concat])
            return first._view(_IndexState(merged, first.device))
        data = np.concatenate([np.asarray(ea[:], dtype=object)
                               for ea in to_concat])
        return SearchArray(data, tokenizer=first.tokenizer,
                           device=first.device)

    @classmethod
    def _from_factorized(cls, values, original):
        return cls(values, tokenizer=original.tokenizer,
                   device=original.device)

    def _values_for_factorize(self):
        return np.asarray(self[:], dtype=object), Terms({})

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError(
                "SearchArray rows are materialised on conversion; a no-copy "
                "numpy view is not possible"
            )
        return np.asarray([self._row_to_terms(int(r)) for r in self.rows],
                          dtype=object)

    def to_numpy(self, dtype=None, copy=False, na_value=no_default):
        # conversion materialises fresh Terms rows (never a view), so the
        # result is writeable even where the array is read-only
        result = np.asarray(self, dtype=dtype)
        if na_value is not no_default:
            result[self.isna()] = na_value
        return result

    def __getstate__(self):
        # the sharded runtime is not pickled (as in the JAX package): the
        # unpickled array scores on its one device
        return {
            "built": self._built,
            "device": str(self.device),
            "rows": self.rows,
            "subset": self.subset,
            "tokenizer": self.tokenizer,
            "avoid_copies": self.avoid_copies,
        }

    def __setstate__(self, state):
        self.tokenizer = state["tokenizer"]
        self.avoid_copies = state["avoid_copies"]
        # the device copy re-attaches on the first search, on this device
        self._attach(_IndexState(state["built"], state["device"]),
                     rows=state["rows"], subset=state["subset"])

    def memory_report(self, N=1000):
        b = self._built
        N = min(N, len(b.vocab))
        sizes = sorted(
            ((b.vocab.get_term(i), int(b.postings.lengths[i]) * 8)
             for i in range(N)),
            key=lambda x: x[1], reverse=True,
        )
        report = (
            "\n        SearchArray Memory Report\n"
            "        -------------------------\n"
            f"        Number of Terms: {len(b.vocab)}\n"
            "        -------------------------\n"
            f"        Doc/Term Matrix: {_bytes_h(b.doc_term.nbytes)}\n"
            f"        Positions:       {_bytes_h(b.postings.nbytes)}\n"
            f"        Term Dictionary: {_bytes_h(b.vocab.nbytes)}\n"
        )
        # the device's serving pools, its largest allocations
        dev = self._state.dev
        if dev is not None:
            with dev.maps.lock:
                pools = [(dev.plane_pool, len(dev.maps.plane_slot),
                          "Plane Pool"),
                         (dev.tf_pool, len(dev.maps.tf_slot), "TF Pool")]
            for pool, used, label in pools:
                if pool is not None:
                    nbytes = pool.numel() * pool.element_size()
                    report += (
                        f"        {label}:      {_bytes_h(nbytes)} "
                        f"({used}/{pool.shape[0]} slots)\n"
                    )
        report += "\n"
        cum = 0
        for i, (term, nb) in enumerate(sizes):
            cum += nb
            report += (
                f"        Term {i}: {term} - {_bytes_h(nb)} - "
                f"Cumulative: {_bytes_h(cum)}\n"
            )
        return report

    # ------------------------------------------------------------------
    # search API
    # ------------------------------------------------------------------
    def _gather_rows(self, dense) -> np.ndarray:
        """A corpus-wide f32 device vector as this view's numpy rows."""
        dense_np = dense.cpu().numpy()
        return dense_np if self._full_view else dense_np[self.rows]

    def _check_token_arg(self, token) -> Union[str, List[str]]:
        """A term (str) or a phrase (list of two or more str)."""
        if isinstance(token, str):
            return token
        if isinstance(token, list) and len(token) == 1:
            return token[0]
        if isinstance(token, list):
            return token
        raise TypeError("Expected a string or list of strings for phrases")

    def _resolve_tid(self, token: str) -> int:
        """Token -> term id (-1 for a vocabulary miss)."""
        try:
            return self.term_dict.get_term_id(token)
        except TermMissingError:
            return -1

    def _resolve_tids(self, token: Union[str, List[str]]) -> List[int]:
        tokens = [token] if isinstance(token, str) else token
        return [self._resolve_tid(t) for t in tokens]

    def _one_query(self, tids: List[int], kind: str, k1: float, b: float,
                   slop: int, min_posn: Optional[int],
                   max_posn: Optional[int]) -> torch.Tensor:
        """One resolved query's f32[N] freqs (kind ``none``) or scores on
        the device.  With no position window it is a one-query batch (the
        batch driver's routing, pools and idf); a window takes the term's
        or phrase's posting slices, which touch no pool."""
        if min_posn is None and max_posn is None:
            return batch_mod.score_batch_fused(
                self.dev, [tids], kind, k1, b, slop=[slop],
                as_device=True)[0]
        if len(tids) == 1:
            return scoring.score_term_dense(self.dev, tids[0], kind, k1, b,
                                            min_posn, max_posn)
        if slop:
            return spans_mod.span_freqs_dense(self.dev, tids, slop, min_posn,
                                              max_posn, kind, k1, b)
        return phrase_mod.phrase_freqs_dense(self.dev, tids, min_posn,
                                             max_posn, kind, k1, b)

    def termfreqs(self, token: Union[List[str], str], slop: int = 0,
                  min_posn: Optional[int] = None,
                  max_posn: Optional[int] = None) -> np.ndarray:
        tids = self._resolve_tids(self._check_token_arg(token))
        if min(tids) < 0:
            return np.zeros(len(self), dtype=np.float32)
        return self._gather_rows(self._one_query(tids, "none", 1.2, 0.75,
                                                 slop, min_posn, max_posn))

    def docfreq(self, token: str) -> int:
        if not isinstance(token, str):
            raise TypeError("Expected a string")
        tid = self._resolve_tid(token)
        return 0 if tid < 0 else scoring.docfreq(self.dev, tid)

    def doclengths(self) -> np.ndarray:
        return self.doc_lens

    def score(self, token: Union[str, List[str]],
              similarity: Similarity = default_bm25, slop: int = 0,
              min_posn: Optional[int] = None,
              max_posn: Optional[int] = None) -> np.ndarray:
        token = self._check_token_arg(token)
        fused = getattr(similarity, "_fused", None)
        if fused is None:
            # Custom (user) similarity: honour the reference protocol
            # exactly -- subset-shaped numpy tfs/doc_lens in, scores out;
            # idf covers every query term (a vocabulary miss has df 0).
            tokens = [token] if isinstance(token, str) else token
            dfs = [self.docfreq(t) for t in tokens]
            tfs = self.termfreqs(token, slop=slop, min_posn=min_posn,
                                 max_posn=max_posn)
            scores = similarity(tfs, np.asarray(dfs), self.doclengths(),
                                self.avg_doc_length, self.corpus_size)
            return np.asarray(scores, dtype=np.float32)
        kind, k1, b = fused
        tids = self._resolve_tids(token)
        if min(tids) < 0 or self.avg_doc_length == 0:
            return np.zeros(len(self), dtype=np.float32)
        return self._gather_rows(self._one_query(tids, kind, k1, b, slop,
                                                 min_posn, max_posn))

    @profiling.spanned("facade.score_batch")
    def score_batch(self, queries: List[Union[str, List[str]]],
                    similarity: Similarity = default_bm25, slop=0,
                    top_k: Optional[int] = None, block: bool = True):
        """Score a batch of terms, exact phrases and slop phrases with one
        host copy.

        Returns float32[Q, len(self)], or with ``top_k`` set,
        ``(scores[Q, k], indices[Q, k])`` ranked on the device.  With
        ``block=False`` (requires ``top_k``, a fused similarity, a full
        un-sliced view and no mesh) the call returns a zero-arg
        ``collect()`` once all device work is enqueued; invoking it waits
        for the one copy.
        ``slop`` is an int for every query or one per query, so a request
        mixing exact and slop phrases is ONE batch (one pool-fill wave); a
        one-term query ignores it.  A slop phrase the dense window kernel
        cannot take is scored on its posting slices (``span`` groups,
        search/batch.py) in the same batch.  A full view of a sharded
        array (``mesh=``) scores per shard and ranks through the shards'
        top-k and their merge (``ShardedIndex.topk``)."""
        fused = getattr(similarity, "_fused", None)
        sharded = self._state.sharded if self._full_view else None
        if not block and not (fused is not None and top_k is not None
                              and self._full_view and sharded is None):
            raise ValueError(
                "block=False requires top_k, a fused similarity, a full "
                "un-sliced view, and no mesh")
        slops = ([slop] * len(queries) if np.isscalar(slop)
                 else [int(s) for s in slop])
        if len(slops) != len(queries):
            raise ValueError("per-query slop length must match queries")
        tokens = [self._check_token_arg(q) for q in queries]
        if fused is None:
            dense = np.stack([self.score(t, similarity=similarity, slop=s)
                              for t, s in zip(tokens, slops)])
        else:
            kind, k1, b = fused
            qtids = [self._resolve_tids(t) for t in tokens]
            if sharded is not None and top_k is not None:
                scores, idx = sharded.topk(qtids, min(top_k, len(self)),
                                           kind, k1, b, slop=slops)
                with profiling.span("batch.wait"):
                    return (scores.cpu().numpy(),
                            idx.cpu().numpy().astype(np.int64))
            if sharded is not None:
                out = sharded.score_batch_device(qtids, kind, k1, b,
                                                 slop=slops)
                with profiling.span("batch.wait"):
                    return out.cpu().numpy()
            if self._full_view and top_k is not None:
                return batch_mod.score_batch_fused(
                    self.dev, qtids, kind, k1, b,
                    top_k=min(top_k, len(self)), defer=not block,
                    slop=slops)
            dense = batch_mod.score_batch_fused(self.dev, qtids, kind, k1, b,
                                                slop=slops)
            if not self._full_view:
                dense = dense[:, self.rows]
        if top_k is None:
            return dense
        idx = np.argsort(dense, axis=1)[:, ::-1][:, :top_k]
        return np.take_along_axis(dense, idx, axis=1), idx

    @profiling.spanned("facade.score_batch_device")
    def score_batch_device(self, queries: List[Union[str, List[str]]],
                           similarity: Similarity = default_bm25, slop=0,
                           rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """Like :meth:`score_batch`, but the f32[Q, len(self)] scores stay
        a tensor on the array's device: nothing is copied to the host.
        For callers that compose further on the device (``solr.edismax``).
        ``slop`` is an int or one per query.  A fused similarity on a full
        view is one ``score_batch_fused(as_device=True)`` call; a custom
        similarity is scored per query on the host and its stack staged on
        the device; a sliced view gathers its rows on the device.

        With ``rows`` (a doc-id subset; requires a fused similarity,
        slop=0 and a full un-sliced view) the scores are f32[Q,
        len(rows)] and the work is proportional to the subset: the phrase
        phases' cost contract of the reference (solr.py:328-338).  A full
        view of a sharded array (``mesh=``) scores per shard
        (``ShardedIndex.score_batch_device``; with ``rows`` each shard its
        own)."""
        if not np.isscalar(slop):
            slop = [int(s) for s in slop]
            if len(slop) != len(queries):
                raise ValueError("per-query slop length must match queries")
            if not any(slop):
                slop = 0
        fused = getattr(similarity, "_fused", None)
        if rows is not None:
            if (fused is None or not np.isscalar(slop) or slop != 0
                    or not self._full_view):
                raise ValueError(
                    "rows= requires a fused similarity, slop=0, and a "
                    "full un-sliced view")
            kind, k1, b = fused
            qtids = [self._resolve_tids(self._check_token_arg(q))
                     for q in queries]
            rows = np.asarray(rows, dtype=np.int64)
            if self._state.sharded is not None:
                return self._state.sharded.score_batch_device(
                    qtids, kind, k1, b, rows=rows)
            return batch_mod.score_batch_fused(
                self.dev, qtids, kind, k1, b, as_device=True, rows=rows)
        slops = [slop] * len(queries) if np.isscalar(slop) else slop
        if fused is None:
            # custom similarity: the reference protocol per query (the
            # view's rows already), the stack staged for composition
            if not queries:
                return torch.zeros((0, len(self)), dtype=torch.float32,
                                   device=self.dev.device)
            return torch.as_tensor(
                np.stack([self.score(q, similarity=similarity, slop=s)
                          for q, s in zip(queries, slops)]),
                device=self.dev.device)
        kind, k1, b = fused
        qtids = [self._resolve_tids(self._check_token_arg(q))
                 for q in queries]
        if self._state.sharded is not None and self._full_view:
            return self._state.sharded.score_batch_device(qtids, kind, k1, b,
                                                          slop=slops)
        out = batch_mod.score_batch_fused(self.dev, qtids, kind, k1, b,
                                          slop=slops, as_device=True)
        if self._full_view:
            return out
        return out[:, host_to_device(self.rows, self.dev.device)]

    def topk(self, token: Union[str, List[str]], k: int = 10,
             similarity: Similarity = default_bm25, slop: int = 0):
        """Top-k (scores, row indices) for one query, ranked on the device
        through the batch driver (the single-device index's, on a sharded
        array too, as in the JAX package); a host argpartition for custom
        similarities and sliced views."""
        k = min(k, len(self))
        fused = getattr(similarity, "_fused", None)
        if fused is not None and self._full_view:
            kind, k1, b = fused
            scores, idx = batch_mod.score_batch_fused(
                self.dev, [self._resolve_tids(self._check_token_arg(token))],
                kind, k1, b, top_k=k, slop=slop)
            return scores[0], idx[0]
        scores = self.score(token, similarity=similarity, slop=slop)
        idx = np.argpartition(scores, -k)[-k:]
        idx = idx[np.argsort(scores[idx])[::-1]]
        return scores[idx], idx

    def positions(self, token: str, key=None) -> List[np.ndarray]:
        """The positions of ``token`` in each row of the view (or in the
        rows ``key`` selects), decoded from the host postings."""
        tid = self.term_dict.get_term_id(token)
        wanted = self.rows[key] if key is not None else self.rows
        if isinstance(wanted, numbers.Integral):
            wanted = np.asarray([wanted])
        sl = self._built.postings.term_slice(tid)
        keys = enc.keys_of(sl).astype(np.int64)
        mask = np.isin(keys, wanted)
        dkeys, posns = enc.decode_words(sl[mask])
        by_doc: dict = {}
        if len(dkeys):
            cuts = np.concatenate(
                [[0], np.flatnonzero(dkeys[1:] != dkeys[:-1]) + 1])
            split = np.split(posns.astype(np.uint32), cuts[1:])
            by_doc = dict(zip(dkeys[cuts].astype(np.int64), split))
        return [by_doc.get(int(d), np.array([], dtype=np.uint32))
                for d in wanted]
