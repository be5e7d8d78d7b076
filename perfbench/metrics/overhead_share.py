"""Share of each tick's wall time outside its inputs' own latencies: the
scoring pass, the feedback and the server's bookkeeping (the paper's
controller overhead), summed over the window's ticks."""


def read(run):
    """Percent."""
    wall = sum(t.end - t.start for t in run.window_ticks)
    inner = sum(s.latency for t in run.window_ticks for s in t.inputs)
    return 100.0 * (wall - inner) / wall if wall > 0 else None
