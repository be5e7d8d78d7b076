"""Mean delivered accuracy over every window input: the served level's
stated accuracy, ``q_fail`` on a miss."""


def read(run):
    """Percent."""
    acc = [s.accuracy for s in run.inputs]
    return 100.0 * sum(acc) / len(acc) if acc else None
