"""Milliseconds a call holds the index locks (``SlotMaps.held``: planning
and enqueue of the batch driver), summed over the indexes a call holds:
the change of ``hold_seconds`` over the window, per call."""


def read(run):
    return run.hold_s * 1e3 / run.n_calls if run.calls else None
