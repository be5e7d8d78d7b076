"""Share of the traced stretch of whole ticks in which nothing ran on the
card."""


def read(run):
    """Percent."""
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
