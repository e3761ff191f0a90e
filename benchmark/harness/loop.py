"""Closed-loop clients: each sends its next call when the previous reply
is in, from the window's start until the window's length has passed."""
from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, List

from benchmark.harness.record import CLIENT_CALL, CallRecord


def closed_loop(run_call: Callable, calls_of: Callable[[int, int], object],
                clients: int, seconds: float, spans: List = None
                ) -> tuple:
    """Run ``clients`` threads (the caller's thread where one) for
    ``seconds``: client c sends ``calls_of(c, i)`` for i = 0, 1, ...
    Returns (records, (start ns, end ns)): the window ends when the last
    client's last call returns.  With ``spans`` every call is also
    recorded there as a host span."""
    records: List[List[CallRecord]] = [[] for _ in range(clients)]
    start = threading.Barrier(clients + 1) if clients > 1 else None
    t0 = [0]

    def client(c: int) -> None:
        if start is not None:
            start.wait()
        stop = t0[0] + int(seconds * 1e9)
        i = 0
        mine = records[c]
        while True:
            call = calls_of(c, i)
            s = time.perf_counter_ns()
            rec = CallRecord(c, i, s, 0, call.n_queries)
            try:
                rec.answers = run_call(call)
            except Exception:     # a failed call is counted, not fatal
                rec.error = traceback.format_exc()
                print(rec.error, file=sys.stderr)
            rec.end = time.perf_counter_ns()
            if spans is not None:
                spans.append((CLIENT_CALL, s, rec.end))
            mine.append(rec)
            i += 1
            if rec.end >= stop:
                break

    if clients == 1:
        t0[0] = time.perf_counter_ns()
        client(0)
    else:
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        for t in threads:
            t.start()
        t0[0] = time.perf_counter_ns()
        start.wait()
        for t in threads:
            t.join()
    flat = [r for rs in records for r in rs]
    return flat, (t0[0], max(r.end for r in flat))
