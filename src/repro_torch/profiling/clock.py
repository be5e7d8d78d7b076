"""Fakes for the clock/sync seam of the measurement loop (port of
``repro.profiling.clock``).

:func:`repro_torch.core.profiles.measure_mean_latency` takes ``clock`` and
``sync`` callables.  Deterministic tests drive it with a manually advanced
:class:`FakeClock` and :class:`FakeTimedFn` callables that model
asynchronous dispatch: calling one advances the clock by its dispatch
cost and returns a handle; blocking on the handle advances by its compute
cost.  The production sync (:func:`repro_torch.core.profiles.default_sync`)
blocks on anything with ``block_until_ready()``, so the regression test of
the unsynced timing loop runs the real loop on these handles.
"""

from __future__ import annotations

import dataclasses


class FakeClock:
    """A manually advanced monotonic clock (seconds): calling it reads the
    time, and only :meth:`advance` moves it, so a fake-clock measurement
    is exactly the sum of the advances the fake callables made."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        """Read the current fake time."""
        return self.now

    def advance(self, dt: float) -> None:
        """Move time forward by ``dt`` seconds (must be >= 0)."""
        if dt < 0.0:
            raise ValueError(f"a clock cannot go back (dt={dt})")
        self.now += float(dt)


@dataclasses.dataclass
class _FakeReady:
    """The handle a :class:`FakeTimedFn` call returns: its work completes
    (the clock advances by the compute time) only when blocked on."""

    clock: FakeClock
    compute_s: float
    _done: bool = False

    def block_until_ready(self) -> "_FakeReady":
        """Advance the clock by the outstanding compute time, once."""
        if not self._done:
            self._done = True
            self.clock.advance(self.compute_s)
        return self


@dataclasses.dataclass
class FakeTimedFn:
    """A deterministic stand-in for an asynchronous callable: a call
    advances ``clock`` by ``dispatch_s`` and returns a handle, and syncing
    the handle advances by ``compute_s``.  An unsynced timing loop
    therefore measures ``dispatch_s`` per call and a synced one
    ``dispatch_s + compute_s``."""

    clock: FakeClock
    dispatch_s: float
    compute_s: float
    n_calls: int = 0

    def __call__(self) -> _FakeReady:
        """Dispatch: advance by the dispatch cost, return the handle."""
        self.n_calls += 1
        self.clock.advance(self.dispatch_s)
        return _FakeReady(self.clock, self.compute_s)


def fake_level_fns(clock: FakeClock, compute_s: list[float],
                   dispatch_s: float = 0.0) -> list[FakeTimedFn]:
    """One :class:`FakeTimedFn` per anytime level with the given compute
    schedule."""
    return [FakeTimedFn(clock, dispatch_s, float(c)) for c in compute_s]
