"""K7 (csrc/merge_step.cu) and K9 (csrc/span_sparse.cu) as the sorted-join
pipeline of csrc/sorted_join.cuh runs them, emulated on the CPU.

``k7_blocks`` and ``k9_blocks`` follow the kernels step by step: the
persistent blocks' contiguous tile runs (crossing queries), the windows of
the neighbour lists (a search where a block enters a query, else from
2C words before where the previous tile's range ended), whether a staged
window covers its tile (else the exact range, read in device memory), the
shared-memory lower bound of a thread's first word and the forward merge
for the rest (K7), the per-term lower bound and forward walk (K9), the
direction, same-term and continuation flags per query (K7), the word path
and the walked path with its state in registers or in the scratch buffer
(K9; which thread covers a live word -- the kernel hands a tile's live
words to its first threads -- changes no result and is not emulated).
At small tiles, windows and grids every branch runs, and the result
must equal the plain versions (``merge_step_plain``, ``span_sparse_plain``)
and the JAX package's ``_merge_step``, ``_same_term_step`` and
``_span_impl``, on random posting lists from a numpy seed.  Change a
kernel, change its emulation with it."""
from bisect import bisect_left

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu.search import phrase as jphrase
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc
from test_torch_sparse_slop import jax_span_freqs, random_lists

LSB = (1 << 18) - 1
TOP = 17


class Window:
    """A neighbour list as one tile sees it (sorted_join.cuh:Window).  A
    range found on entering a query, ``r1`` its end, that is above the cap
    is read in device memory: nothing staged."""

    def __init__(self, h, p, n_list, s, n, cap, r1=-1, seen=None):
        self.h, self.p, self.n_list, self.s = h, p, n_list, s
        above = r1 - s > cap
        self.n = 0 if above else max(0, min(n, cap, n_list - s))
        self.r0, self.r1 = (s, r1) if above else (-1, -1)
        if above and seen is not None:
            seen.add("above the window on entering")
        # the staged copy: what the tile's cp.async calls bring in
        self.sh, self.sp = h[s: s + self.n], p[s: s + self.n]

    def covers(self, top):
        return (self.s + self.n >= self.n_list
                or (self.n > 0 and self.sh[self.n - 1] >= top))

    def exact(self, t0, t1):
        """The warp search: the exact range of headers [t0, t1)."""
        self.r0 = bisect_left(self.h, t0)
        self.r1 = bisect_left(self.h, t1)
        return self.r1

    def view(self):
        """(headers, payloads, 0, n) as the tile reads them, and the list
        index of their first word."""
        if self.r0 >= 0:
            return (self.h[self.r0: self.r1], self.p[self.r0: self.r1], 0,
                    self.r1 - self.r0)
        return self.sh, self.sp, 0, self.n

    def base(self):
        return self.r0 if self.r0 >= 0 else self.s


def tile_run(b, grid, n_tiles):
    return b * n_tiles // grid, (b + 1) * n_tiles // grid


def blk_window(blk_bits, window):
    mask = (1 << blk_bits) - 1
    lo, hi = (0, LSB) if window is None else window

    def win(h, p):
        return p if lo <= (h & mask) <= hi else 0

    return mask, win


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------
def k7_blocks(hdrs, base_pays, other_pays, base_off, base_n, other_off,
              other_n, other_pay_off, sides, sames, conts, *, blk_bits,
              key_stride, window, threads, items, cap, grid, seen):
    """K7's launch as merge_join_kernel runs it; (keys, counts, cont)."""
    hl, bpl, opl = hdrs.tolist(), base_pays.tolist(), other_pays.tolist()
    _, win = blk_window(blk_bits, window)
    tile = threads * items
    Q = len(base_n)
    n_tiles = [-(-int(n) // tile) for n in base_n]
    tile_start = np.concatenate([[0], np.cumsum(n_tiles)[:-1]]).astype(int)
    tile_q = np.repeat(np.arange(Q), n_tiles).tolist()
    out_off = kc.prefix_offsets(base_n).tolist()
    M = int(np.sum(base_n))
    keys = np.zeros(M, np.int64)
    counts = np.zeros(M, np.float32)
    cont_out = np.zeros(M, np.int64)
    T = len(tile_q)
    if T == 0:
        return keys, counts, cont_out

    def open_tile(t, prev_q, s, est):
        q = tile_q[t]
        bo, bn = int(base_off[q]), int(base_n[q])
        i0 = (t - tile_start[q]) * tile
        i1 = min(i0 + tile, bn)
        oo, on, po = int(other_off[q]), int(other_n[q]), int(other_pay_off[q])
        oh, op = hl[oo: oo + on], opl[po: po + on]
        r1 = -1
        if not sames[q] and q != prev_q:
            seen.add("search on entering a query")
            s = bisect_left(oh, hl[bo + i0] - 1)
            r1 = bisect_left(oh, hl[bo + i1 - 1] + 2)
            est = r1 - s + 1
        elif not sames[q]:
            seen.add("window from the previous end")
        return dict(q=q, i0=i0, i1=i1, b0=max(0, i0 - 1),
                    bh=hl[bo: bo + bn], bp=bpl[bo: bo + bn],
                    o=Window(oh, op, on, on if sames[q] else s, est, cap, r1,
                             seen))

    for b in range(min(grid, T)):
        t0, t1 = tile_run(b, min(grid, T), T)
        if t0 >= t1:
            continue
        if len({tile_q[t] for t in range(t0, t1)}) > 1:
            seen.add("run crosses queries")
        tiles = [open_tile(t0, -1, 0, 0), None]
        k = 0
        for t in range(t0, t1):
            tl = tiles[k]
            q, i0, i1, o = tl["q"], tl["i0"], tl["i1"], tl["o"]
            bh, bp = tl["bh"], tl["bp"]
            end = start = 0
            if not sames[q] and o.r0 >= 0:
                start, end = o.r0, o.r1
            elif not sames[q]:
                last = bh[i1 - 1]
                start = o.s
                if o.covers(last + 1):
                    seen.add("staged")
                    end = o.s + bisect_left(o.sh, last + 2, 0, o.n)
                else:
                    seen.add("exact range in device memory")
                    end = o.exact(bh[i0] - 1, last + 2)
                    start = o.r0
            if t + 1 < t1:
                tiles[k ^ 1] = open_tile(t + 1, q, max(end - 2, 0),
                                         (end - start) + ((end - start) >> 2)
                                         + 16)
            oh, op, olo, ohi = o.view()
            rhs = sides[q] == "rhs"
            seen.add(sides[q] + (" same-term" if sames[q] else ""))
            for th in range(threads):
                lo = -1
                for u in range(items):
                    i = i0 + th * items + u
                    if i >= i1:
                        break
                    h = bh[i]
                    p = win(h, bp[i])
                    count = cnt = 0
                    if p and sames[q]:
                        ov = p & ((p << 1) & LSB)
                        consec = (ov & (ov << 1) & LSB).bit_count()
                        if rhs:
                            adj = ((win(h - 1, bp[i - 1]) >> TOP) & 1
                                   if (p & 1) and i > 0 and bh[i - 1] == h - 1
                                   else 0)
                            cnt = ov | adj
                        else:
                            adj = (win(h + 1, bp[i + 1]) & 1
                                   if (p >> TOP) and i + 1 < len(bh)
                                   and bh[i + 1] == h + 1 else 0)
                            cnt = (p & (p >> 1)) | (adj << TOP)
                        count = ov.bit_count() - ((consec + 1) >> 1) + adj
                    elif p:
                        if lo < 0 or o.r0 >= 0:
                            lo = bisect_left(oh, h, olo if lo < 0 else lo, ohi)
                        else:
                            while lo < ohi and oh[lo] < h:
                                seen.add("forward merge")
                                lo += 1
                        hit = lo < ohi and oh[lo] == h
                        inner = win(h, op[lo]) if hit else 0
                        if rhs:
                            overlap = inner & (p >> 1)
                            adj = ((win(h - 1, op[lo - 1]) >> TOP) & 1
                                   if (p & 1) and lo > olo
                                   and oh[lo - 1] == h - 1 else 0)
                            cnt = ((overlap << 1) & LSB) | adj
                        else:
                            nx = lo + (1 if hit else 0)
                            overlap = p & (inner >> 1)
                            adj = (win(h + 1, op[nx]) & 1
                                   if (p >> TOP) and nx < ohi
                                   and oh[nx] == h + 1 else 0)
                            cnt = overlap | (adj << TOP)
                        count = overlap.bit_count() + adj
                    at = out_off[q] + i
                    keys[at] = q * key_stride + (h >> blk_bits)
                    counts[at] = count
                    if conts[q]:
                        cont_out[at] = cnt
            k ^= 1
    return keys, counts, cont_out


def k7_case(seed, blk_bits, Q):
    """Q queries of random direction, same-term and continuation flags on
    random lists: (planes, merge_step's arguments)."""
    rng = np.random.default_rng(seed)
    num_docs = max(4, 300 >> blk_bits)
    dens = rng.uniform(0.02, 0.9, 2 * Q)
    dens[rng.random(2 * Q) < 0.15] = 0.0   # empty slices
    hdrs, pays, offs, ns = random_lists(seed, 2 * Q, blk_bits, num_docs, dens)
    ns = [n if d > 0 else 0 for n, d in zip(ns, dens)]
    args = dict(base_off=offs[0::2], base_n=ns[0::2], other_off=offs[1::2],
                other_n=ns[1::2], other_pay_off=offs[1::2],
                sides=rng.choice(["rhs", "lhs"], Q).tolist(),
                sames=(rng.random(Q) < 0.3).tolist(),
                conts=(rng.random(Q) < 0.7).tolist())
    return hdrs, pays, num_docs, args


K7_SIZES = [  # (threads, items, cap, grid)
    (2, 2, 6, 1), (2, 2, 6, 3), (4, 2, 12, 5), (3, 1, 40, 2), (2, 4, 64, 64)]


@pytest.mark.parametrize("size", K7_SIZES)
@pytest.mark.parametrize("blk_bits,window", [
    (0, None), (2, None), (2, (1, 2)), (5, None), (5, (1, 2)), (8, None),
    (8, (1, 2))])
def test_k7_blocks_match_plain(blk_bits, window, size):
    seen = set()
    for seed in range(3):
        hdrs, pays, num_docs, a = k7_case(seed * 10 + blk_bits, blk_bits, 4)
        stride = num_docs
        threads, items, cap, grid = size
        got = k7_blocks(hdrs, pays, pays, a["base_off"], a["base_n"],
                        a["other_off"], a["other_n"], a["other_pay_off"],
                        a["sides"], a["sames"], a["conts"],
                        blk_bits=blk_bits, key_stride=stride, window=window,
                        threads=threads, items=items, cap=cap, grid=grid,
                        seen=seen)
        mb = {} if window is None else dict(min_blk=window[0],
                                            max_blk=window[1])
        want = kc.merge_step_plain(
            torch.from_numpy(hdrs), torch.from_numpy(pays),
            torch.from_numpy(pays), a["base_off"], a["base_n"],
            a["other_off"], a["other_n"], a["other_pay_off"],
            cont_side=a["sides"], same_term=a["sames"], blk_bits=blk_bits,
            key_stride=stride, **mb)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        need = np.repeat(a["conts"], a["base_n"])
        np.testing.assert_array_equal(got[2][need], want[2].numpy()[need])
    if size[2] <= 12:
        assert {"staged", "exact range in device memory",
                "search on entering a query"} <= seen


def test_k7_blocks_run_every_branch():
    """Across a few launches the emulation takes every branch the kernel
    has."""
    seen = set()
    for seed, (threads, items, cap, grid) in enumerate(K7_SIZES):
        hdrs, pays, num_docs, a = k7_case(100 + seed, 3, 6)
        k7_blocks(hdrs, pays, pays, a["base_off"], a["base_n"],
                  a["other_off"], a["other_n"], a["other_pay_off"],
                  a["sides"], a["sames"], a["conts"], blk_bits=3,
                  key_stride=num_docs, window=None, threads=threads,
                  items=items, cap=cap, grid=grid, seen=seen)
    assert seen == {"search on entering a query", "window from the previous end",
                    "above the window on entering", "run crosses queries",
                    "staged",
                    "exact range in device memory", "forward merge", "rhs",
                    "lhs", "rhs same-term", "lhs same-term"}


@pytest.mark.parametrize("cont_side", ["rhs", "lhs"])
def test_k7_blocks_match_jax(cont_side, seed=0):
    """One launch mixing a merge step and a same-term step of the same
    direction, held to the JAX package's ``_merge_step`` and
    ``_same_term_step`` query by query."""
    blk_bits = 2
    num_docs = 120
    hdrs, pays, offs, ns = random_lists(seed, 2, blk_bits, num_docs,
                                        [0.5, 0.4])
    base, other = (1, 0) if cont_side == "rhs" else (0, 1)
    got = k7_blocks(hdrs, pays, pays, [offs[base], offs[0]],
                    [ns[base], ns[0]], [offs[other], offs[0]],
                    [ns[other], ns[0]], [offs[other], offs[0]],
                    [cont_side] * 2, [False, True], [True, True],
                    blk_bits=blk_bits, key_stride=num_docs, window=None,
                    threads=2, items=2, cap=8, grid=3, seen=set())
    lists = [(hdrs[o: o + n], pays[o: o + n].view(np.uint32))
             for o, n in zip(offs, ns)]
    (lh, lp), (rh, rp) = lists
    want_d, want_c = jphrase._merge_step(
        jnp.asarray(lh), jnp.asarray(lp), jnp.asarray(rh), jnp.asarray(rp),
        cont_side, num_docs, blk_bits)
    want_sd, want_sc = jphrase._same_term_step(
        jnp.asarray(lh), jnp.asarray(lp), cont_side, num_docs, blk_bits)
    per_doc = np.zeros(2 * num_docs, np.float32)
    np.add.at(per_doc, got[0], got[1])
    np.testing.assert_array_equal(per_doc[:num_docs], np.asarray(want_d))
    np.testing.assert_array_equal(per_doc[num_docs:], np.asarray(want_sd))
    nb = ns[base]
    np.testing.assert_array_equal(got[2][:nb].astype(np.uint32),
                                  np.asarray(want_c[1]))
    np.testing.assert_array_equal(got[2][nb:].astype(np.uint32),
                                  np.asarray(want_sc[1]))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------
def dilate(y, length, shift):
    cur = 1
    while cur < length:
        k = min(cur, length - cur)
        y |= shift(y, k)
        cur += k
    return y


def present(x, w, mult):
    down = lambda y, k: y >> k  # noqa: E731
    if mult == 1:
        return dilate(x, w + 1, down)
    ok = 0
    for d in range(1, w + 1):
        ok |= dilate(x & (x >> d), w + 1 - d, down)
    return ok


def k9_blocks(hdrs, pays, offs, ns, w, mults, anchor, *, blk_bits, key_stride,
              window, words, threads, cap, staged, reg_terms, grid, seen):
    """K9's launch as span_join_kernel runs it: (keys, counts)."""
    hl, pl = hdrs.tolist(), pays.tolist()
    mask, win = blk_window(blk_bits, window)
    offs, ns = np.asarray(offs), np.asarray(ns)
    Q, T = offs.shape
    S = min(T, staged)
    C = -(-w // 18)
    S0, L = 18 * C - w, w + 18
    n_tiles = [-(-int(n) // threads) for n in ns[:, anchor]]
    tile_start = np.concatenate([[0], np.cumsum(n_tiles)[:-1]]).astype(int)
    tile_q = np.repeat(np.arange(Q), n_tiles).tolist()
    out_off = kc.prefix_offsets(ns[:, anchor]).tolist()
    M = int(ns[:, anchor].sum())
    keys = np.zeros(M, np.int64)
    counts = np.zeros(M, np.float32)
    regs = T <= reg_terms
    scratch = None if words or regs else np.zeros(5 * T * M, np.int64)
    seen.add("word path" if words else
             "walked, registers" if regs else "walked, scratch")

    def slot_of(u):
        return 0 if u == anchor else (u + 1 if u < anchor else u)

    def lists(q, u):
        o, n = int(offs[q, u]), int(ns[q, u])
        return hl[o: o + n], pl[o: o + n], n

    def rows_of(t):
        q = tile_q[t]
        i0 = (t - tile_start[q]) * threads
        return q, i0, min(i0 + threads, int(ns[q, anchor]))

    def open_term(u, t, prev_q, end, est):
        q, i0, i1 = rows_of(t)
        h, p, n_list = lists(q, u)
        is_staged = slot_of(u) < S
        s, n, r1 = 0, 0, -1
        if u == anchor:
            s = max(0, i0 - C)
            n = min(i1 + C, n_list) - s
        elif is_staged and q == prev_q:
            seen.add("window from the previous end")
            s, n = max(0, end - 2 * C), est
        elif is_staged:
            seen.add("search on entering a query")
            ah = lists(q, anchor)[0]
            s = bisect_left(h, ah[i0] - C)
            r1 = bisect_left(h, ah[i1 - 1] + C + 1)
            n = r1 - s + 1
        return Window(h, p, n_list, s, n, cap, r1, seen)

    def lane_word(v, idx, target, blk):
        h, p, _, hi = v
        if idx < hi and h[idx] < target:
            idx += 1
        if blk < 0 or blk > mask:
            return 0, idx
        if idx < hi and h[idx] == target:
            return win(target, p[idx]), idx
        return 0, idx

    for b in range(min(grid, len(tile_q))):
        t0, t1 = tile_run(b, min(grid, len(tile_q)), len(tile_q))
        if t0 >= t1:
            continue
        if len({tile_q[t] for t in range(t0, t1)}) > 1:
            seen.add("run crosses queries")
        wins = [[open_term(u, t0, -1, 0, 0) for u in range(T)], None]
        k = 0
        for t in range(t0, t1):
            q, i0, i1 = rows_of(t)
            wk = wins[k]
            aw = wk[anchor]
            a_in = aw.s + aw.n >= i1
            ah = aw.sh if a_in else aw.h
            first = ah[i0 - aw.s] if a_in else ah[i0]
            last = ah[i1 - 1 - aw.s] if a_in else ah[i1 - 1]
            nxt = [None] * T
            for u in range(T):
                wu = wk[u]
                start = wu.s
                if wu.r0 >= 0:
                    start, end = wu.r0, wu.r1
                elif slot_of(u) < S and wu.covers(last + C):
                    seen.add("staged")
                    # the anchor's next window needs no end
                    end = 0 if u == anchor else wu.s + bisect_left(
                        wu.sh, last + C + 1, 0, wu.n)
                else:
                    seen.add("staged, exact range" if slot_of(u) < S
                             else "unstaged term")
                    end = wu.exact(first - C, last + C + 1)
                    start = wu.r0
                if t + 1 < t1:
                    nxt[u] = open_term(u, t + 1, q, end,
                                       (end - start) + ((end - start) >> 2)
                                       + 16 + 2 * C)
            wins[k ^ 1] = nxt

            def at(u, i):
                return i - wk[u].base()

            def first_at(u, v, c):
                """The lower bound of h - c in term u's view: in the
                anchor's own list among the c words before the word."""
                if u != anchor:
                    return bisect_left(v[0], h - c, v[2], v[3])
                own = at(anchor, i)
                return bisect_left(v[0], h - c, max(0, own - c), own)

            for th in range(threads):
                i = i0 + th
                if i >= i1:
                    continue
                av = wk[anchor].view()
                h = av[0][at(anchor, i)]
                p = win(h, av[1][at(anchor, i)])
                blk = h & mask
                covered = 0
                if p and words:
                    ok = (1 << 64) - 1
                    for u in range(T):
                        v = wk[u].view()
                        idx = first_at(u, v, 1)
                        x = 0
                        for ln in range(3):
                            word, idx = lane_word(v, idx, h - 1 + ln,
                                                  blk - 1 + ln)
                            x |= word << (18 * ln)
                        ok &= present(x, w, int(mults[u]))
                    up = lambda y, k_: (y << k_) & ((1 << 64) - 1)  # noqa
                    covered = (dilate(ok, w + 1, up) & (p << 18)).bit_count()
                elif p:
                    if regs:
                        st = [[0] * 5 for _ in range(T)]

                        def get(u, f):
                            return st[u][f]

                        def put(u, f, val):
                            st[u][f] = val
                    else:
                        base = out_off[q] + i

                        def get(u, f):
                            return int(scratch[(u * 5 + f) * M + base])

                        def put(u, f, val):
                            scratch[(u * 5 + f) * M + base] = val
                    for u in range(T):
                        v = wk[u].view()
                        idx = first_at(u, v, C)
                        word, idx = lane_word(v, idx, h - C, blk - C)
                        put(u, 0, idx)
                        put(u, 1, word)
                        end, count, ln, frm = S0 + w + 1, 0, 0, S0
                        while True:
                            to = min(18, end - ln * 18)
                            count += (word & ((1 << to) - 1)
                                      & ~((1 << frm) - 1)).bit_count()
                            if end <= (ln + 1) * 18:
                                break
                            ln, frm = ln + 1, 0
                            word, idx = lane_word(v, idx, h - C + ln,
                                                  blk - C + ln)
                        put(u, 2, idx)
                        put(u, 3, word)
                        put(u, 4, count - int(mults[u]))
                    last_ok = -1
                    lane_l, bit_l, lane_e, bit_e = 0, S0, C, 1
                    for si in range(L):
                        if all(get(u, 4) >= 0 for u in range(T)):
                            last_ok = si
                        bb = si - w
                        if bb >= 0 and (p >> bb) & 1 and last_ok >= bb:
                            covered += 1
                        if si + 1 == L:
                            break
                        fl, fe = bit_l == 18, bit_e == 18
                        if fl:
                            lane_l, bit_l = lane_l + 1, 0
                        if fe:
                            lane_e, bit_e = lane_e + 1, 0
                        for u in range(T):
                            v = wk[u].view()
                            if fl:
                                word, idx = lane_word(v, get(u, 0),
                                                      h - C + lane_l,
                                                      blk - C + lane_l)
                                put(u, 1, word)
                                put(u, 0, idx)
                            if fe:
                                word, idx = lane_word(v, get(u, 2),
                                                      h - C + lane_e,
                                                      blk - C + lane_e)
                                put(u, 3, word)
                                put(u, 2, idx)
                            put(u, 4, get(u, 4) + ((get(u, 3) >> bit_e) & 1)
                                - ((get(u, 1) >> bit_l) & 1))
                        bit_l += 1
                        bit_e += 1
                keys[out_off[q] + i] = q * key_stride + (h >> blk_bits)
                counts[out_off[q] + i] = covered
            k ^= 1
    return keys, counts


def k9_case(seed, blk_bits, Q, T, w):
    """Q queries of T distinct terms each, every query's lists of its own
    density: (hdrs, pays, offs [Q, T], ns [Q, T], num_docs)."""
    rng = np.random.default_rng(seed)
    num_docs = max(4, 96 >> blk_bits)
    hs, ps, offs, ns, at = [], [], [], [], 0
    for q in range(Q):
        dens = rng.uniform(0.05, 0.8, T)
        if rng.random() < 0.2:
            dens[rng.integers(T)] = 0.0   # an empty slice
        h, p, o, n = random_lists(seed * 31 + q, T, blk_bits, num_docs,
                                  np.maximum(dens, 1e-9), dense_bits=w < 19)
        end = int(o[-1]) + int(n[-1])
        n = [x if d > 0 else 0 for x, d in zip(n, dens)]
        hs.append(h[:end])
        ps.append(p[:end])
        offs.append([at + int(x) for x in o])
        ns.append(n)
        at += end
    pad = K.bucket_of(max(1, int(np.max(ns)))) + 8   # as DeviceIndex
    hdrs = np.concatenate(hs + [np.full(pad, K.PAD_HDR32)]).astype(np.int32)
    pays = np.concatenate(ps + [np.zeros(pad)]).astype(np.int32)
    return hdrs, pays, np.asarray(offs), np.asarray(ns), num_docs


K9_SIZES = [  # (threads, cap, staged terms, register terms, grid)
    (4, 10, 2, 2, 1), (4, 10, 1, 4, 3), (8, 24, 4, 1, 5), (3, 64, 4, 4, 64)]
K9_SHAPES = [  # (multiplicities, anchor, w)
    ((1, 1), 0, 4), ((2, 1), 1, 18), ((1, 1, 1), 2, 2), ((2,), 0, 7),
    ((1, 3), 0, 5), ((1, 1), 1, 19), ((2, 1, 1), 0, 40),
    ((1, 1, 1, 1, 1), 3, 6)]


@pytest.mark.parametrize("size", K9_SIZES)
@pytest.mark.parametrize("mults,anchor,w", K9_SHAPES)
@pytest.mark.parametrize("blk_bits", [0, 3, 6])
def test_k9_blocks_match_plain(blk_bits, mults, anchor, w, size):
    threads, cap, staged, reg_terms, grid = size
    T = len(mults)
    hdrs, pays, offs, ns, num_docs = k9_case(
        blk_bits * 7 + w + T, blk_bits, 3, T, w)
    window = (1, 5) if blk_bits == 3 else None
    words = w <= 18 and max(mults) <= 2
    seen = set()
    got = k9_blocks(hdrs, pays, offs, ns, w, mults, anchor,
                    blk_bits=blk_bits, key_stride=num_docs, window=window,
                    words=words, threads=threads, cap=cap, staged=staged,
                    reg_terms=reg_terms, grid=grid, seen=seen)
    mb = {} if window is None else dict(min_blk=window[0], max_blk=window[1])
    want = kc.span_sparse_plain(torch.from_numpy(hdrs), torch.from_numpy(pays),
                                offs, ns, w, mults, anchor=anchor,
                                blk_bits=blk_bits, key_stride=num_docs, **mb)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    if words:   # the walked path gives the same counts
        walked = k9_blocks(hdrs, pays, offs, ns, w, mults, anchor,
                           blk_bits=blk_bits, key_stride=num_docs,
                           window=window, words=False, threads=threads,
                           cap=cap, staged=staged, reg_terms=reg_terms,
                           grid=grid, seen=seen)
        np.testing.assert_array_equal(walked[1], got[1])


def test_k9_blocks_run_every_branch():
    seen = set()
    for mults, anchor, w in K9_SHAPES:
        for threads, cap, staged, reg_terms, grid in K9_SIZES:
            hdrs, pays, offs, ns, num_docs = k9_case(
                w + len(mults), 3, 3, len(mults), w)
            k9_blocks(hdrs, pays, offs, ns, w, mults, anchor, blk_bits=3,
                      key_stride=num_docs, window=None,
                      words=w <= 18 and max(mults) <= 2, threads=threads,
                      cap=cap, staged=staged, reg_terms=reg_terms, grid=grid,
                      seen=seen)
    assert seen == {"search on entering a query",
                    "window from the previous end", "run crosses queries",
                    "above the window on entering",
                    "staged", "staged, exact range", "unstaged term",
                    "word path", "walked, registers", "walked, scratch"}


def test_k9_blocks_match_jax(mults=(2, 1), anchor=1, w=20, blk_bits=4):
    """A walked-path query against the JAX package's ``_span_impl`` (one
    compile of it; the plain version is held to it on every shape in
    tests/test_torch_sparse_slop.py)."""
    T = len(mults)
    hdrs, pays, offs, ns, num_docs = k9_case(40 + w, blk_bits, 1, T, w)
    if ns.min() == 0:
        ns = np.maximum(ns, 1)
    got = k9_blocks(hdrs, pays, offs, ns, w, mults, anchor,
                    blk_bits=blk_bits, key_stride=num_docs, window=None,
                    words=w <= 18 and max(mults) <= 2, threads=4, cap=12,
                    staged=2, reg_terms=2, grid=3, seen=set())
    per_doc = np.zeros(num_docs, np.float32)
    np.add.at(per_doc, got[0], got[1])
    want = jax_span_freqs(hdrs, pays, offs[0].tolist(), ns[0].tolist(),
                          anchor, mults, w, blk_bits, num_docs)
    np.testing.assert_array_equal(per_doc, want)
