"""Per ``edismax`` call, its wall time less the time inside the
``score_batch_device`` calls it makes (the composer's own host work:
parsing, composition launches, phase folds, the final copy's wait), in
ms, averaged over the window's calls.  Nothing to read where no field
call was recorded."""
import bisect

from benchmark.harness.record import FIELD_CALL


def read(run):
    fields = sorted((s, e) for n, s, e in run.spans if n == FIELD_CALL)
    if not fields or not run.calls:
        return None
    starts = [s for s, _ in fields]
    total = 0
    for c in run.calls:
        i = bisect.bisect_left(starts, c.start)
        inside = 0
        while i < len(fields) and fields[i][0] < c.end:
            inside += min(fields[i][1], c.end) - fields[i][0]
            i += 1
        total += (c.end - c.start) - inside
    return total / len(run.calls) / 1e6
