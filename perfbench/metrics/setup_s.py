"""Seconds from the process's start to the window's: imports, kernel
builds (first run only), weights, the server's profile and graph captures,
the warm-up ticks."""


def read(run):
    """Seconds."""
    return run.setup_s
