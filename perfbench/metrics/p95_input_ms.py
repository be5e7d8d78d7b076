"""95th percentile of every window input's latency (the engine's own
clock around work that ends in a host copy of each token)."""

import numpy as np


def read(run):
    """Milliseconds."""
    lat = [s.latency for s in run.inputs]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
