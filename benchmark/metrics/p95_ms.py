"""95th percentile of the latency of a client call, over every call of the
window (of every client)."""
import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat else None
