"""Queries completed in the window over the window's seconds: one query
of a ``score_batch`` call counts one, one ``edismax`` call counts one."""


def read(run):
    return run.n_queries / run.window_s if run.calls else None
