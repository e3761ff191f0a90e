"""The program's own spans (``searcharray_tpu_torch.utils.profiling``)
for the span readers: those that overlap the run's window, clipped to it,
and each one's self time (its clipped duration less the clipped parts of
its child spans).  The port records spans while a profiler runs, so a
``--trace 1`` run on the card has them; an untraced run, a CPU run and a
port without the recorder have none, and the readers read nothing."""


def window_spans(run):
    """The spans that overlap ``run.window``, or None where there are
    none (or no call, or no recorder)."""
    if not run.calls:
        return None
    try:
        from searcharray_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    lo, hi = run.window
    got = [s for s in spans() if s.end_ns > lo and s.start_ns < hi]
    return got or None


def clipped(s, lo, hi):
    return max(0, min(s.end_ns, hi) - max(s.start_ns, lo))


def duration_ms(run, name):
    """Milliseconds a call spends in spans named ``name``, clipped to the
    window, per call of the window; None where no such span is there."""
    spans = window_spans(run)
    if spans is None:
        return None
    lo, hi = run.window
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    return sum(clipped(s, lo, hi) for s in mine) / run.n_calls / 1e6


def self_ms(run, prefix):
    """Milliseconds of self time a call spends in spans whose name starts
    with ``prefix``, per call of the window; None where there are
    none."""
    spans = window_spans(run)
    if spans is None:
        return None
    lo, hi = run.window
    covered = {}
    for s in spans:
        if s.parent:
            covered[s.parent] = covered.get(s.parent, 0) + clipped(s, lo, hi)
    mine = [s for s in spans if s.name.startswith(prefix)]
    if not mine:
        return None
    total = sum(clipped(s, lo, hi) - covered.get(s.id, 0) for s in mine)
    return total / run.n_calls / 1e6


def hit_pct(run, rows, fills):
    """100 (1 - fills / rows), both summed over the ``batch.plan`` spans
    that start in the window; None where they requested no row."""
    spans = window_spans(run)
    if spans is None:
        return None
    lo, hi = run.window
    plans = [s for s in spans if s.name == "batch.plan" and
             lo <= s.start_ns < hi]
    asked = sum(s.counts.get(rows, 0) for s in plans)
    if not asked:
        return None
    return 100.0 * (1.0 - sum(s.counts.get(fills, 0) for s in plans) / asked)


def innermost_intervals(spans, names, lo, hi):
    """The union of the times, within [lo, hi], at which a span named in
    ``names`` is the innermost open span of its thread: each such span's
    interval less its children's."""
    kids = {}
    for s in spans:
        if s.parent:
            kids.setdefault(s.parent, []).append(s)
    parts = []
    for s in spans:
        if s.name not in names:
            continue
        at, end = max(s.start_ns, lo), min(s.end_ns, hi)
        for c in sorted(kids.get(s.id, ()), key=lambda c: c.start_ns):
            if c.start_ns > at:
                parts.append((at, min(c.start_ns, end)))
            at = max(at, c.end_ns)
        if end > at:
            parts.append((at, end))
    out = []
    for s, e in sorted(p for p in parts if p[1] > p[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_ns(a, b):
    """Total overlap of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total
