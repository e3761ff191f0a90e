"""Doc-axis sharding: one process drives a corpus split by doc range into
S shards, each a ``DeviceIndex`` that runs the port's own engine and
kernels.

The port of ``searcharray_tpu/parallel/sharded.py``.  The JAX module is
single-controller too: one Python process drives the whole mesh through
``shard_map``.  Here a ``Mesh`` is a 2-D grid of torch devices with a
``docs`` axis (one row per doc shard) and a ``queries`` axis (the row's
devices split a batch's queries in contiguous parts).  A device may
repeat: ``default_mesh(devices=[torch.device("cuda")] * 8)`` is 4 doc
shards x 2 query parts on one card, and on a host with several cards
shard s goes to its own.  Launches are asynchronous, so a loop over the
shards overlaps their device work.  A process group of one rank per
shard would need every rank to make every facade call, and NCCL puts no
two ranks on one card.

* ``partition`` splits the postings by doc range and re-bases the keys
  to shard-local ids, with one global ``blk_bits`` (the corpus's longest
  doc): the numpy arrays that ``index/store.py:save_shards`` persists, in
  the JAX package's format.
* The queries axis's parts that name the same devices in every doc row
  form one lane (on one card: a single lane).  A shard is one
  ``DeviceIndex`` per lane, on that lane's device of its mesh row.  Its
  ``BuiltIndex`` holds its re-based postings and doc lengths beside the
  corpus's vocabulary, ``doc_freqs`` and ``avg_doc_length``; every idf
  reads the corpus's doc count (``stats_docs``) and a phrase's split and
  a slop phrase's anchor the corpus's posting lengths
  (``stats_lengths``), so a shard scores its docs as the whole index
  would; shards on one device divide the pools' byte budgets
  (``pool_share``).
* The shards of a lane share one ``SlotMaps`` (the JAX module's
  ``ensure_shard_planes`` / ``ensure_shard_tfs`` slot maps): a key has
  the same pool row on each of them, every pool has the capacity of the
  smallest, and one plan of a batch holds for all of them.
* ``score_batch_device`` plans a batch once per lane
  (``search/batch.py:plan_batch`` over the lane's ``PlanView``: the
  corpus's doc count for the candidate switch, the largest shard for
  buckets, ``Kc`` and the buffer bound, as the JAX module does) and runs
  the plan on each shard (``run_plan``: the pool fills from the shard's
  own slices, then every group's launches), holding the lane's slot maps
  from the plan to the last shard's run (``SlotMaps.held``: threads may
  query one index).  The [Q, n_s] blocks are placed into f32[Q, N] on
  the device of mesh entry (0, 0).
* ``topk`` ranks each shard's block with K3 (``ops/cuda/score.py:topk``),
  offsets the [Q, k_s] candidates by ``shard_starts`` and ranks the
  [Q, sum k_s] candidates with K3 again: the full doc axis never leaves
  its shard's device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from searcharray_tpu_torch.index.builder import (
    BuiltIndex,
    DocTermMatrix,
    TermPostings,
)
from searcharray_tpu_torch.index.device import (
    DeviceIndex,
    SlotMaps,
    canonical_device,
)
from searcharray_tpu_torch.ops import encoding as enc
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda
from searcharray_tpu_torch.ops.cuda.score import bump
from searcharray_tpu_torch.ops.kernels import (
    PAD_HDR32,
    blk_bits_for,
    bucket_of,
    compress_planes,
    expand_bucket_of,
)
from searcharray_tpu_torch.search import batch as batch_mod
from searcharray_tpu_torch.search import dense as dense_mod

# Batch plans made: one per call on a mesh whose query parts share their
# devices (one lane), one per lane a call's queries reach otherwise.
PLANS = [0]
# Candidate chunks planned, each once for all shards, with every group of
# a ``rows=`` call (the JAX module's counter of candidate and rows
# programs).
CAND_PROGRAMS = [0]
# K3 calls of ``topk``: on a shard's block, and the merges of candidates.
SHARD_TOPKS = [0]
TOPK_MERGES = [0]


class Mesh:
    """A 2-D grid of torch devices: ``devices[d, j]`` holds doc shard d's
    part j of the queries axis.  ``shape`` maps the axis names to their
    sizes, as a JAX mesh's does."""

    def __init__(self, devices, axis_names=("docs", "queries")):
        rows = [list(r) for r in devices]
        width = len(rows[0]) if rows else 0
        if not rows or not width or any(len(r) != width for r in rows):
            raise ValueError("a mesh is a non-empty 2-D grid of devices")
        self.devices = np.empty((len(rows), width), dtype=object)
        for d, r in enumerate(rows):
            for j, device in enumerate(r):
                # entries naming one card compare equal
                self.devices[d, j] = canonical_device(device)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


def default_mesh(axis_docs: str = "docs", axis_queries: str = "queries",
                 devices=None) -> Mesh:
    """A (docs x queries) mesh over ``devices`` (every CUDA device by
    default); the queries axis takes a factor of 2 when the device count
    is even, as the JAX package's does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= (e.g. "
                               "[torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    flat = list(np.asarray(devices, dtype=object).reshape(-1))
    n = len(flat)
    q = 2 if n % 2 == 0 and n > 1 else 1
    return Mesh([flat[d * q: (d + 1) * q] for d in range(n // q)],
                (axis_docs, axis_queries))


class ShardedIndex:
    """A BuiltIndex partitioned by doc range across a mesh's ``docs`` axis."""

    def __init__(self, mesh: Mesh, shards: List[List[DeviceIndex]],
                 replica: np.ndarray, shard_starts: np.ndarray, vocab,
                 avg_doc_length: float, corpus_size: int,
                 max_shard_docs: int, blk_bits: int, doc_freqs):
        self.mesh = mesh
        # shards[d]: one DeviceIndex per lane; replica[d, j]: the lane of
        # query part j (the same in every row d)
        self.shards = shards
        self.replica = replica
        # a lane's shards share one slot map; its PlanView reads them
        self.lanes = []
        for lane in range(len(shards[0])):
            members = [reps[lane] for reps in shards]
            maps = SlotMaps(max(d.corpus_size for d in members),
                            members[0].blk_bits,
                            max(d.pool_share for d in members))
            for dev in members:
                dev.maps = maps
            self.lanes.append(batch_mod.PlanView(members))
        self.shard_starts = shard_starts      # int64[S]: global doc base
        self.shard_sizes = np.asarray([s[0].corpus_size for s in shards],
                                      np.int64)
        self.vocab = vocab
        self.avg_doc_length = avg_doc_length
        self.corpus_size = corpus_size
        self.max_shard_docs = max_shard_docs
        self.blk_bits = blk_bits
        self.doc_freqs = doc_freqs
        self.num_shards = len(shards)
        self.device = mesh.devices[0, 0]      # where results are placed

    # ------------------------------------------------------------------
    @staticmethod
    def partition(built: BuiltIndex, S: int) -> dict:
        """Host-side doc-range partition of a BuiltIndex into S shards.

        Returns the numpy shard arrays ({hdrs [S, W], pays [S, W],
        offsets/lengths [S, V], doc_lens [S, shard_docs]} + scalars) that
        ``build`` uploads; also what ``index/store.py:save_shards``
        persists, so a serving process cold-starts without re-running
        this O(S*W) re-partition."""
        return _partition(built, S)[0]

    @classmethod
    def _from_parts(cls, parts: dict, mesh: Mesh, vocab,
                    avg_doc_length: float, doc_freqs,
                    shard_words: Optional[list] = None) -> "ShardedIndex":
        # the corpus's per-term posting words: each shard's sum
        stats_lengths = np.asarray(parts["lengths"], np.int64).sum(axis=0)
        S = mesh.shape["docs"]
        if int(np.shape(parts["hdrs"])[0]) != S:
            raise ValueError(f"a partition of {np.shape(parts['hdrs'])[0]} "
                             f"shards on a mesh of {S}")
        N = int(parts["num_docs"])
        shard_docs = int(parts["shard_docs"])
        blk_bits = int(parts["blk_bits"])
        starts = np.asarray(parts["shard_starts"], dtype=np.int64)
        # lanes: the distinct columns of the mesh (query parts that name
        # the same device in every doc row share one); shards that share a
        # device divide its pools' budgets
        lane_of: dict = {}
        replica = np.zeros(mesh.devices.shape, np.int64)
        for j in range(mesh.devices.shape[1]):
            replica[:, j] = lane_of.setdefault(tuple(mesh.devices[:, j]),
                                               len(lane_of))
        share: dict = {}
        for col in lane_of:
            for device in col:
                share[device] = share.get(device, 0) + 1
        shards = []
        for s in range(S):
            n_s = max(0, min(N, int(starts[s]) + shard_docs) - int(starts[s]))
            lengths = np.asarray(parts["lengths"][s], dtype=np.int64)
            W = int(lengths.sum())
            words = (shard_words[s] if shard_words is not None
                     else _words_of(parts["hdrs"][s, :W], parts["pays"][s, :W],
                                    blk_bits))
            built = BuiltIndex(
                postings=TermPostings(
                    words, np.asarray(parts["offsets"][s], dtype=np.int64),
                    lengths),
                doc_term=DocTermMatrix(np.empty(0, np.uint32),
                                       np.zeros(n_s + 1, np.int64)),
                vocab=vocab,
                doc_lens=np.array(parts["doc_lens"][s, :n_s],
                                  dtype=np.float32),
                avg_doc_length=avg_doc_length, doc_freqs=doc_freqs,
                derived={"hdr32": parts["hdrs"][s], "pay32": parts["pays"][s],
                         "blk_bits": blk_bits})
            shards.append([DeviceIndex(built, col[s], blk_bits=blk_bits,
                                       stats_docs=N,
                                       stats_lengths=stats_lengths,
                                       pool_share=share[col[s]])
                           for col in lane_of])
        return cls(mesh, shards, replica, starts, vocab, avg_doc_length, N,
                   shard_docs, blk_bits, doc_freqs)

    @classmethod
    def build(cls, built: BuiltIndex, mesh: Optional[Mesh] = None
              ) -> "ShardedIndex":
        if mesh is None:
            mesh = default_mesh()
        parts, words = _partition(built, mesh.shape["docs"])
        return cls._from_parts(parts, mesh, built.vocab,
                               built.avg_doc_length, built.doc_freqs, words)

    @classmethod
    def load(cls, directory: str, mesh: Optional[Mesh] = None
             ) -> "ShardedIndex":
        """Attach the per-shard arrays persisted by
        ``index/store.py:save_shards`` (memory-mapped, uploaded as they
        are: no host re-partition).  The saved shard count must match the
        mesh's ``docs`` axis; vocab and doc_freqs load from the same
        store (either package's)."""
        from searcharray_tpu_torch.index.store import load_index, load_shards

        if mesh is None:
            mesh = default_mesh()
        parts = load_shards(directory, mesh.shape["docs"])
        built = load_index(directory)
        return cls._from_parts(parts, mesh, built.vocab,
                               built.avg_doc_length, built.doc_freqs)

    # ------------------------------------------------------------------
    # the plan and the shard loop
    # ------------------------------------------------------------------
    def _lane_parts(self, Q: int) -> dict:
        """lane -> the indexes of its queries: the Q queries split in
        contiguous parts over the queries axis, the parts of one lane
        together."""
        qa = self.mesh.shape["queries"]
        per = -(-Q // qa)
        by_lane: dict = {}
        for j in range(qa):
            qsel = np.arange(j * per, min(Q, (j + 1) * per))
            if len(qsel):
                by_lane.setdefault(int(self.replica[0, j]), []).append(qsel)
        return {lane: np.concatenate(qs) for lane, qs in by_lane.items()}

    def _place(self, blocks: list, Q: int, cols: list) -> torch.Tensor:
        """The blocks as one f32[Q, width] on ``self.device``: shard d's
        block into columns ``cols[d]`` (a slice, or an index array)."""
        width = sum(c.stop - c.start if isinstance(c, slice) else len(c)
                    for c in cols)
        out = torch.zeros((Q, width), dtype=torch.float32, device=self.device)
        for c, pieces in zip(cols, blocks):
            if not isinstance(c, slice):
                c = kernels_cuda.host_to_device(c, self.device)
            for qsel, blk in pieces:
                blk = blk.to(self.device, non_blocking=True)
                if len(qsel) == Q:
                    out[:, c] = blk
                    continue
                q = kernels_cuda.host_to_device(qsel, self.device)
                out[q if isinstance(c, slice) else q[:, None], c] = blk
        return out

    def _doc_cols(self) -> list:
        return [slice(int(lo), int(lo) + int(n))
                for lo, n in zip(self.shard_starts, self.shard_sizes)]

    def _fan_out(self, out: torch.Tensor, expand: list) -> torch.Tensor:
        if len(expand) == out.shape[0]:
            return out
        return out[kernels_cuda.host_to_device(np.asarray(expand, np.int64),
                                               out.device)]

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------
    def _batch_blocks(self, queries_tids, kind, k1, b, slop, rows=None):
        """Every shard's [len(qsel), n_s] blocks of the distinct queries,
        one plan per lane run on each of its shards: (blocks, their
        count, the fan-out map, each shard's columns)."""
        uniq, uslops, expand = batch_mod.dedup_queries(queries_tids, slop)
        cols, local = self._doc_cols(), None
        if rows is not None:
            # each shard scores its own rows, in ascending local order;
            # their columns go back to the caller's order
            sid = np.searchsorted(self.shard_starts, rows, side="right") - 1
            cols, local = [], []
            for d in range(self.num_shards):
                pos = np.flatnonzero(sid == d)
                pos = pos[np.argsort(rows[pos], kind="stable")]
                cols.append(pos)
                local.append(rows[pos] - self.shard_starts[d])
        blocks: list = [[] for _ in range(self.num_shards)]
        for lane, qsel in self._lane_parts(len(uniq)).items():
            view = self.lanes[lane]
            uploads: dict = {}
            runs = []
            # the lane's maps held from its plan through the last shard's
            # run (one lane at a time: a thread never holds two)
            with view.held():
                plan = batch_mod.plan_batch(
                    view, [uniq[i] for i in qsel], kind,
                    slop=[uslops[i] for i in qsel],
                    allow_candidates=rows is None,
                    n_out=self.corpus_size if rows is None else len(rows))
                bump(PLANS)
                # the JAX module's count: candidate chunks, and every group
                # of a rows= call
                bump(CAND_PROGRAMS,
                     plan.n_cand if rows is None else plan.n_specs)
                try:
                    for d, dev in enumerate(view.members):
                        if local is None:
                            rows_t, n_out = None, dev.corpus_size
                        else:
                            rows_t = kernels_cuda.host_to_device(
                                local[d].astype(np.int32), dev.device)
                            n_out = len(local[d])
                        runs.append((d, dev, n_out, batch_mod.run_plan(
                            dev, plan, kind, k1, b, rows=rows_t, shard=d,
                            uploads=uploads, launch=n_out > 0)))
                except BaseException:
                    dense_mod.release(view.maps, plan.fills)
                    raise
            for d, dev, n_out, outs in runs:
                blocks[d].append((qsel, batch_mod.assemble(
                    dev, plan, outs, n_out, as_device=True,
                    uploads=uploads)))
        return blocks, len(uniq), expand, cols

    def score_batch_device(self, queries_tids, kind: str = "bm25",
                           k1: float = 1.2, b: float = 0.75, slop=0,
                           rows=None) -> torch.Tensor:
        """Mixed term / phrase / slop batch of term-id queries -> f32[Q, N]
        on ``self.device`` (the JAX module's sharded counterpart of
        ``score_batch_fused(as_device=True)``).  ``slop`` is an int or one
        per query.  With ``rows`` (global doc ids, in any order; slop 0)
        the scores are f32[Q, len(rows)]: each shard scores its own rows
        only (``score_batch_fused(rows=)``)."""
        if rows is not None:
            slops = [slop] if np.isscalar(slop) else slop
            if any(int(s) != 0 for s in slops):
                raise ValueError("rows= requires slop=0")
            rows = np.asarray(rows, dtype=np.int64)
            if rows.ndim != 1 or (rows.size and (
                    rows.min() < 0 or rows.max() >= self.corpus_size)):
                raise ValueError(
                    f"rows must be doc ids in [0, {self.corpus_size})")
        blocks, Q, expand, cols = self._batch_blocks(queries_tids, kind, k1,
                                                     b, slop, rows)
        return self._fan_out(self._place(blocks, Q, cols), expand)

    def topk(self, x, k: int, kind: str = "bm25", k1: float = 1.2,
             b: float = 0.75, slop=0):
        """Top-k over the doc axis: (scores f32[Q, k], global doc ids
        int64[Q, k]) on ``self.device``, ties to the smallest doc id.
        ``x`` is a [Q, N] score tensor (split into the shards' column
        blocks) or a list of term-id queries (scored per shard as
        ``score_batch_device`` does, never placed into [Q, N]).

        K3 ranks each shard's block (k_s = min(k, n_s)); the candidates,
        offset by the shard starts, are laid out in shard order, each
        shard's in rank order, and K3 ranks those [Q, sum k_s].  Within a
        shard K3 orders equal scores by ascending index and the shards
        are in doc order, so among ties the smallest candidate column is
        the smallest global doc id: the JAX rule."""
        if torch.is_tensor(x):
            Q = x.shape[0]
            whole = np.arange(Q)
            blocks = [[(whole, x[:, c])] for c in self._doc_cols()]
            expand = list(range(Q))
        else:
            blocks, Q, expand, _ = self._batch_blocks(x, kind, k1, b, slop)
        vals, idx = self._merge_topk(blocks, Q, k)
        return self._fan_out(vals, expand), self._fan_out(idx, expand)

    def topk_fn(self, shape, k: int):
        """The JAX module's form: a callable ranking a [Q, N] tensor."""
        return lambda dense: self.topk(dense, k)

    def _merge_topk(self, blocks: list, Q: int, k: int):
        dev = self.device
        if Q == 0 or k == 0:
            return (torch.zeros((Q, k), dtype=torch.float32, device=dev),
                    torch.zeros((Q, k), dtype=torch.int64, device=dev))
        cand_v, cand_i = [], []
        for d, pieces in enumerate(blocks):
            n_d = int(self.shard_sizes[d])
            if n_d == 0:
                continue
            k_d = min(k, n_d)
            v = torch.empty((Q, k_d), dtype=torch.float32, device=dev)
            i = torch.empty((Q, k_d), dtype=torch.int64, device=dev)
            for qsel, blk in pieces:
                bv, bi = kernels_cuda.topk(blk.contiguous(), k_d)
                bump(SHARD_TOPKS)
                bv = bv.to(dev, non_blocking=True)
                bi = bi.to(dev, non_blocking=True).long() + int(
                    self.shard_starts[d])
                if len(qsel) == Q:
                    v, i = bv, bi
                else:
                    sel = kernels_cuda.host_to_device(qsel, dev)
                    v[sel], i[sel] = bv, bi
            cand_v.append(v)
            cand_i.append(i)
        cv = torch.cat(cand_v, dim=1).contiguous()
        ci = torch.cat(cand_i, dim=1)
        vals, j = kernels_cuda.topk(cv, k)
        bump(TOPK_MERGES)
        return vals, torch.gather(ci, 1, j.long())

    def _resolve(self, tokens) -> List[int]:
        return [self.vocab.get_term_id(t) if t in self.vocab else -1
                for t in tokens]

    def _query_blocks(self, queries, k1, b):
        """Per shard, each query's OR of terms: its term rows (BM25 with
        the corpus's doc_freqs, one plan for every term of the batch)
        summed in term order."""
        tids = [self._resolve(q) for q in queries]
        flat = [[t] for q in tids for t in q]
        blocks, U, expand, _ = self._batch_blocks(flat, "bm25", k1, b, 0)
        out = []
        for d, pieces in enumerate(blocks):
            dev = self.shards[d][0].device
            n_d = int(self.shard_sizes[d])
            rows = torch.zeros((U, n_d), dtype=torch.float32, device=dev)
            for qsel, blk in pieces:
                rows[kernels_cuda.host_to_device(qsel, dev)] = blk.to(dev)
            summed = torch.zeros((len(queries), n_d), dtype=torch.float32,
                                 device=dev)
            r = 0
            for j, q in enumerate(tids):
                for _ in q:
                    summed[j] += rows[expand[r]]
                    r += 1
            out.append([(np.arange(len(queries)), summed)])
        return out

    def score_queries(self, queries: Sequence[Sequence[str]],
                      k1: float = 1.2, b: float = 0.75) -> torch.Tensor:
        """BM25 of a batch of (OR-composed) term queries -> f32[Q, N]."""
        return self._place(self._query_blocks(queries, k1, b), len(queries),
                           self._doc_cols())

    def topk_queries(self, queries: Sequence[Sequence[str]], k: int = 10,
                     k1: float = 1.2, b: float = 0.75):
        """Per-query global top-k: host (scores f32[Q, k], doc ids
        int64[Q, k])."""
        k = min(k, self.corpus_size)
        vals, idx = self._merge_topk(self._query_blocks(queries, k1, b),
                                     len(queries), k)
        return (vals.cpu().numpy().astype(np.float32),
                idx.cpu().numpy().astype(np.int64))

    def phrase_freqs(self, tokens: Sequence[str], k1: float = 1.2,
                     b: float = 0.75, kind: str = "none") -> torch.Tensor:
        """Exact-phrase frequencies (or, with ``kind``, scores) f32[N]:
        one plan, each shard's own (a phrase never crosses a document),
        idf from the corpus's statistics; zeros when a token is not in
        the vocabulary."""
        return self._phrase_row(tokens, 0, kind, k1, b)

    def span_freqs(self, tokens: Sequence[str], slop: int, k1: float = 1.2,
                   b: float = 0.75, kind: str = "none") -> torch.Tensor:
        """Slop-phrase frequencies (or scores) f32[N], one plan; zeros
        when a token is not in the vocabulary."""
        return self._phrase_row(tokens, slop, kind, k1, b)

    def _phrase_row(self, tokens, slop, kind, k1, b) -> torch.Tensor:
        tids = self._resolve(tokens)
        if any(t < 0 for t in tids):
            return torch.zeros(self.corpus_size, dtype=torch.float32,
                               device=self.device)
        if len(tids) < 2:
            raise ValueError("Must have at least two terms")
        return self.score_batch_device([tids], kind, k1, b, slop=slop)[0]

    def device_indexes(self) -> List[DeviceIndex]:
        """Every shard's DeviceIndex, replicas included."""
        return [dev for reps in self.shards for dev in reps]


def _words_of(hdrs: np.ndarray, pays: np.ndarray, blk_bits: int) -> np.ndarray:
    """uint64 posting words from a shard's (hdr32, pay32) planes: the
    inverse of ``compress_planes``."""
    h = np.asarray(hdrs).astype(np.uint64)
    keys = h >> np.uint64(blk_bits)
    blks = h & np.uint64((1 << blk_bits) - 1)
    return ((keys << np.uint64(enc.KEY_SHIFT))
            | (blks << np.uint64(enc.MSB_SHIFT))
            | np.asarray(pays).astype(np.uint64))


def _partition(built: BuiltIndex, S: int):
    """``ShardedIndex.partition``'s dict, and each shard's re-based uint64
    words (its host postings)."""
    N = built.corpus_size
    V = len(built.vocab)
    shard_docs = -(-max(N, 1) // S)
    starts = np.arange(S, dtype=np.int64) * shard_docs

    post = built.postings
    word_keys = enc.keys_of(post.data).astype(np.int64)
    word_term = np.repeat(np.arange(V, dtype=np.int64), post.lengths)
    word_shard = np.minimum(word_keys // shard_docs, S - 1)

    shard_datas, shard_offs, shard_lens = [], [], []
    max_words = 1
    for s in range(S):
        mask = word_shard == s
        words = post.data[mask]
        # re-base doc keys to shard-local ids
        words = words - (np.uint64(starts[s]) << np.uint64(enc.KEY_SHIFT))
        lens = np.bincount(word_term[mask], minlength=V).astype(np.int64)
        offs = np.zeros(V, dtype=np.int64)
        offs[1:] = np.cumsum(lens)[:-1]
        shard_datas.append(words)
        shard_offs.append(offs)
        shard_lens.append(lens)
        max_words = max(max_words, len(words))

    max_len = int(max(1, max(l.max(initial=0) for l in shard_lens)))
    # the tail pad covers the largest slice any kernel takes
    max_bucket = max(bucket_of(max_len), expand_bucket_of(max_len))
    W = max_words + max_bucket
    max_doc_len = float(built.doc_lens.max()) if len(built.doc_lens) else 1
    blk_bits = blk_bits_for(int(max_doc_len))
    hdrs_np = np.full((S, W), PAD_HDR32, dtype=np.int32)
    pays_np = np.zeros((S, W), dtype=np.uint32)
    for s in range(S):
        h, p = compress_planes(shard_datas[s], blk_bits)
        hdrs_np[s, : len(h)] = h
        pays_np[s, : len(p)] = p

    doc_lens_np = np.zeros((S, shard_docs), dtype=np.float32)
    for s in range(S):
        lo = starts[s]
        hi = min(N, lo + shard_docs)
        if hi > lo:
            doc_lens_np[s, : hi - lo] = built.doc_lens[lo:hi]
    parts = {
        "hdrs": hdrs_np, "pays": pays_np,
        "offsets": np.stack(shard_offs), "lengths": np.stack(shard_lens),
        "doc_lens": doc_lens_np, "shard_starts": starts,
        "shard_docs": shard_docs, "blk_bits": blk_bits,
        "num_docs": N,
    }
    return parts, shard_datas
