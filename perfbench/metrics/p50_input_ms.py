"""Median of every window input's latency."""

import numpy as np


def read(run):
    """Milliseconds."""
    lat = [s.latency for s in run.inputs]
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
