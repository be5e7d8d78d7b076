"""Inputs served within their deadline, over the whole window's seconds."""


def read(run):
    """Good inputs a second."""
    good = sum(not s.missed for s in run.inputs)
    return good / run.window_s if run.window_s > 0 else None
