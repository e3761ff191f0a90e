"""K8a (csrc/cand_rows.cu) as its single-pass kernel runs it, emulated on
the CPU.

``k8a_blocks`` follows ``cand_rows_kernel`` step by step: the grid of
persistent blocks (a block per tile and one per TAIL_PER_BLOCK table
entries, at most the resident blocks), tiles of TILE words taken b,
b + grid, ..., a tile's keys behind the key of the word before it, the
packed block scan of (runs begun, popcounts), each tile's status word
(its run count, then its inclusive prefix) and the decoupled look-back of
one warp's lanes over the tiles before it, the run's first word storing
its key and its popcount sum (the tile's last run read on past the tile,
THREADS words a step, to its doc's last word), and each tail block's
equal share of the table (the blocks past the tiles where there are more
blocks than tiles, else every block after its tiles) filled where it
lies in a query's tail (the part past the query's words first, the rest
once its runs are known), with 16-byte stores between 16-byte
boundaries.  Look-backs complete in a random order
(every tile has published its run count first, as a block does before it
waits), so some read run counts and go on, some stop at an inclusive
prefix, some at the query's first tile.  At tiny tiles, warps and grids
every branch runs, every table entry must be stored exactly once, and
the result must equal ``cand_rows_plain`` and the JAX package's
``cterm_body`` / ``_compact_rows``, on posting slices from a numpy seed.
Change the kernel, change its emulation with it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu.search import candidates as jcand
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc

BRANCHES = {
    "first tile of a query", "look-back goes on past run counts",
    "look-back stops at an inclusive prefix",
    "look-back stops at the query's first tile",
    "last run read on past the tile", "read on over several steps",
    "last run began in an earlier tile", "runs dropped at Kc",
    "tail filled with scalar stores", "tail filled with 16-byte stores",
    "empty query", "tail known before the tiles",
    "tail after the query's runs", "tails on blocks without tiles",
    "tails on every block after its tiles",
    "lanes before the query's first tile wait on nothing",
}


def popcount(x):
    return np.asarray([bin(int(v) & 0xFFFFFFFF).count("1") for v in x],
                      np.int64)


def k8a_blocks(hdrs, pays, offs, ns, kc_, num_docs, blk_bits, with_tf, *,
               threads=4, items=2, lanes=4, cap=6, tail_per_block=8,
               seed=0, seen=None):
    """(rows int32 [Q, Kc], tf f32 [Q, Kc] or None) as the kernel computes
    them, at tiles of threads * items words, a look-back warp of ``lanes``
    and at most ``cap`` resident blocks."""
    seen = set() if seen is None else seen
    tile = threads * items
    offs, ns = np.asarray(offs, np.int64), np.asarray(ns, np.int64)
    Q = len(ns)
    tiles = -(-ns // tile)
    tile_start = np.concatenate([[0], np.cumsum(tiles)]).astype(np.int64)
    n_tiles, table = int(tile_start[-1]), Q * kc_
    rows = np.full(table, -7, np.int64)           # -7: never stored
    tf = np.full(table, np.nan, np.float64)
    stores = np.zeros(table, np.int64)
    if n_tiles == 0 and table == 0:
        return rows.reshape(Q, kc_).astype(np.int32), (
            tf.reshape(Q, kc_).astype(np.float32) if with_tf else None)
    grid = max(1, min(cap, n_tiles + -(-table // tail_per_block)))
    if any(n == 0 for n in ns):
        seen.add("empty query")

    def query_of(t):
        lo, hi = 0, Q
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            if tile_start[mid] <= t:
                lo = mid
            else:
                hi = mid
        return lo

    # every tile's scan and its first status word
    status, local = {}, {}
    for t in range(n_tiles):
        q = query_of(t)
        off, n, first = offs[q], ns[q], tile_start[q]
        t0 = (t - first) * tile
        ln = int(min(tile, n - t0))
        keys = np.empty(ln + 1, np.int64)
        keys[1:] = hdrs[off + t0: off + t0 + ln] >> blk_bits
        keys[0] = hdrs[off + t0 - 1] >> blk_bits if t0 else -1
        next_key = (int(hdrs[off + t0 + ln]) >> blk_bits
                    if t0 + ln < n else -1)
        pc = (popcount(pays[off + t0: off + t0 + ln]) if with_tf
              else np.zeros(ln, np.int64))
        begins = np.nonzero(keys[1:] != keys[:-1])[0]
        total = len(begins)
        spos = np.concatenate([begins, [ln]])
        psum = np.concatenate([[0], np.cumsum(pc)])
        status[t] = (t == first, total)
        if t == first:
            seen.add("first tile of a query")
        local[t] = dict(q=q, off=off, n=n, t0=t0, ln=ln, keys=keys,
                        next_key=next_key, total=total, spos=spos,
                        psum=psum, first=first)

    def look_back(t, first):
        total, hi = 0, t - 1
        while True:
            words = [(True, 0) if b < first else status[b]
                     for b in range(hi, hi - lanes, -1)]
            incl = [w[0] for w in words]
            stop = incl.index(True) if any(incl) else lanes - 1
            total += sum(w[1] for w in words[: stop + 1])
            if hi - lanes + 1 < first:
                seen.add("lanes before the query's first tile wait on "
                         "nothing")
            if any(incl):
                seen.add("look-back stops at the query's first tile"
                         if hi - stop == first else
                         "look-back stops at an inclusive prefix")
                return total
            seen.add("look-back goes on past run counts")
            hi -= lanes

    order = np.random.default_rng(seed).permutation(n_tiles)
    for t in order:
        L = local[t]
        base = 0
        if t != L["first"]:
            base = look_back(t, L["first"])
            status[t] = (True, base + L["total"])
        L["base"] = base

    # the blocks' tiles, b, b + grid, ...
    for b in range(grid):
        for t in range(b, n_tiles, grid):
            L = local[t]
            keys, ln, total = L["keys"], L["ln"], L["total"]
            if total == 0:
                seen.add("last run began in an earlier tile")
            ahead = 0
            if with_tf and total > 0 and L["next_key"] == keys[ln]:
                seen.add("last run read on past the tile")
                start, left = L["off"] + L["t0"] + ln, L["n"] - L["t0"] - ln
                s, steps = 0, 0
                while True:
                    i = np.arange(s, s + threads)
                    same = (i < left) & (hdrs[start + np.minimum(
                        i, max(left - 1, 0))] >> blk_bits == keys[ln])
                    ahead += int(popcount(pays[start + i[same]]).sum())
                    steps += 1
                    if same.sum() < threads:
                        break
                    s += threads
                if steps > 1:
                    seen.add("read on over several steps")
            for r in range(total):
                cidx = L["base"] + r
                if cidx >= kc_:
                    seen.add("runs dropped at Kc")
                    break
                s = L["spos"][r]
                at = L["q"] * kc_ + cidx
                rows[at] = keys[s + 1]
                stores[at] += 1
                if with_tf:
                    tf[at] = (L["psum"][L["spos"][r + 1]] - L["psum"][s]
                              + (ahead if r == total - 1 else 0))

    # each block's share of the table's tails: [min(n, Kc), Kc) of a query
    # before any tile (a query has no more runs than words), [runs,
    # min(n, Kc)) once its last tile's inclusive prefix is there
    def fill(a, e):
        if a < e:
            a4, e4 = (a + 3) & ~3, e & ~3
            seen.add("tail filled with scalar stores" if a4 >= e4
                     else "tail filled with 16-byte stores")
            rows[a:e] = num_docs
            stores[a:e] += 1
            if with_tf:
                tf[a:e] = 0.0

    # on the blocks past the tiles where there are more blocks than tiles
    tail0 = n_tiles if n_tiles < grid else 0
    seen.add("tails on blocks without tiles" if tail0
             else "tails on every block after its tiles")
    if table:
        share = -(-table // (grid - tail0))
        share = (share + 3) & ~3
        for b in range(grid - tail0):
            lo, hi = b * share, min(table, b * share + share)
            q = lo // kc_
            while q < Q and q * kc_ < hi:
                known = q * kc_ + min(ns[q], kc_)
                if known < min(hi, (q + 1) * kc_):
                    seen.add("tail known before the tiles")
                fill(max(lo, known), min(hi, (q + 1) * kc_))
                if lo < known:
                    last = tile_start[q + 1] - 1
                    assert status[last][0]
                    seen.add("tail after the query's runs")
                    fill(max(lo, q * kc_ + min(status[last][1], kc_)),
                         min(hi, known))
                q += 1
    assert (stores == 1).all(), "a table entry stored other than once"
    return rows.reshape(Q, kc_).astype(np.int32), (
        tf.reshape(Q, kc_).astype(np.float32) if with_tf else None)


def slices(seed, sizes, num_docs, blk_bits, long_run=0):
    """Doc-sorted slices of unique headers laid end to end, then a PAD tail;
    with ``long_run``, one doc in the middle of the first slice's range
    has that many words (a run across tiles).  (hdrs, pays, offs)."""
    rng = np.random.default_rng(seed)
    S = 1 << blk_bits
    mid = num_docs // 2
    others = np.setdiff1d(np.arange(num_docs * S),
                          np.arange(mid * S, mid * S + S))
    hdrs, pays, offs, at = [], [], [], 0
    for i, n in enumerate(sizes):
        lr = min(long_run, n, S) if i == 0 else 0
        head = mid * S + np.arange(lr, dtype=np.int64)
        rest = rng.choice(others, size=n - lr, replace=False)
        flat = np.sort(np.concatenate([head, rest]))
        hdrs.append(flat.astype(np.int32))
        pays.append(rng.integers(1, 1 << 18, n).astype(np.int32))
        offs.append(at)
        at += n
    hdrs.append(np.full(8, K.PAD_HDR32, np.int32))
    pays.append(np.zeros(8, np.int32))
    return np.concatenate(hdrs), np.concatenate(pays), offs


def jax_rows(h, p, off, n, kc_, num_docs, bb):
    bucket = K.expand_bucket_of(max(1, n))
    hp = np.concatenate([h, np.full(bucket, K.PAD_HDR32, np.int32)])
    pp = np.concatenate([p, np.zeros(bucket, np.int32)])
    static = {"N": num_docs, "blk_bits": bb}
    jtf, jrows = jcand.cterm_body(static, kc_, bucket, jnp.asarray(hp),
                                  jnp.asarray(pp.view(np.uint32)), off, n)
    return np.asarray(jrows), np.asarray(jtf)


CASES = {
    # name: (sizes, num_docs, blk_bits, Kc, long_run)
    "one run across a tile": ([13, 5], 30, 3, 16, 6),
    "one run across several tiles": ([60, 9], 12, 6, 32, 40),
    "empty slice between": ([11, 0, 17, 0], 40, 3, 24, 0),
    "Kc below the runs": ([50, 30], 200, 3, 7, 0),
    "Kc = 0": ([20, 4], 50, 3, 0, 3),
    "Q = 0": ([], 50, 3, 16, 0),
    "many small queries": ([3, 1, 0, 8, 9, 2, 16, 7], 25, 2, 12, 0),
    "one long query": ([200], 400, 3, 256, 5),
}


@pytest.mark.parametrize("with_tf", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k8a_blocks_match_plain_and_jax(case, with_tf):
    sizes, num_docs, bb, kc_, long_run = CASES[case]
    h, p, offs = slices(len(case), sizes, num_docs, bb, long_run)
    got_rows, got_tf = k8a_blocks(h, p, offs, sizes, kc_, num_docs, bb,
                                  with_tf, seed=len(case))
    want_rows, want_tf = kc.cand_rows(
        torch.from_numpy(h), torch.from_numpy(p), offs, sizes, kc_,
        num_docs=num_docs, blk_bits=bb, with_tf=with_tf)
    np.testing.assert_array_equal(got_rows, want_rows.numpy())
    if with_tf:
        np.testing.assert_array_equal(got_tf, want_tf.numpy())
    else:
        assert got_tf is None and want_tf is None
    for q, (o, n) in enumerate(zip(offs, sizes)):
        if kc_ == 0:
            continue
        jrows, jtf = jax_rows(h, p, o, n, kc_, num_docs, bb)
        np.testing.assert_array_equal(got_rows[q], jrows)
        if with_tf:
            np.testing.assert_array_equal(got_tf[q], jtf)


@pytest.mark.parametrize("seed", range(6))
def test_k8a_blocks_random_slices(seed):
    """Random slice sizes, docs of many blocks (runs across tiles), Kc on
    both sides of the runs, grids of 1 to 9 blocks and look-back warps of
    1 to 5 lanes."""
    rng = np.random.default_rng(seed)
    bb = int(rng.integers(0, 6))
    num_docs = int(rng.integers(5, 60))
    sizes = [int(min(x, (num_docs - 1) << bb)) for x in rng.integers(0, 70, 5)]
    h, p, offs = slices(seed, sizes, num_docs, bb,
                        long_run=int(rng.integers(0, 30)))
    kc_ = int(rng.integers(0, 40))
    for cap, lanes in ((1, 1), (3, 2), (9, 5)):
        got_rows, got_tf = k8a_blocks(h, p, offs, sizes, kc_, num_docs, bb,
                                      True, cap=cap, lanes=lanes,
                                      seed=seed + cap)
        want_rows, want_tf = kc.cand_rows(
            torch.from_numpy(h), torch.from_numpy(p), offs, sizes, kc_,
            num_docs=num_docs, blk_bits=bb)
        np.testing.assert_array_equal(got_rows, want_rows.numpy())
        np.testing.assert_array_equal(got_tf, want_tf.numpy())


def test_k8a_blocks_run_every_branch():
    seen = set()
    for case in sorted(CASES):
        sizes, num_docs, bb, kc_, long_run = CASES[case]
        h, p, offs = slices(len(case), sizes, num_docs, bb, long_run)
        for seed in range(3):
            k8a_blocks(h, p, offs, sizes, kc_, num_docs, bb, True,
                       seed=seed, seen=seen)
    assert seen == BRANCHES, f"untaken: {sorted(BRANCHES - seen)}"


def test_k8a_is_one_kernel_a_launch():
    assert kc.CAND_ROWS_KERNELS_PER_LAUNCH == 1
