"""Share of the window's inputs that missed their deadline."""


def read(run):
    """Percent."""
    inputs = run.inputs
    if not inputs:
        return None
    return 100.0 * sum(s.missed for s in inputs) / len(inputs)
