"""Median latency of a client call, over every call of the window."""
import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 50)) if lat else None
