"""Failure injection for the kill-and-resume tests (port of
``repro.runtime.ft``).

Only :class:`InjectedFailure` is ported: the session gateway raises it at
a chosen round to exercise checkpointed resume.  The training supervisor
waits for training.
"""

from __future__ import annotations


class InjectedFailure(RuntimeError):
    """Raised to simulate a crash mid-run (a kill the run resumes from)."""
