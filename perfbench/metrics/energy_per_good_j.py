"""The card's energy over the window (its own counter), over the inputs
served within their deadline."""


def read(run):
    """Joules a good input."""
    good = sum(not s.missed for s in run.inputs)
    if run.energy_j is None or good == 0:
        return None
    return run.energy_j / good
