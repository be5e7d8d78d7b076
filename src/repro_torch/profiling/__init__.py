"""Live-profile harness (port of ``repro.profiling``): measured anytime
staircases for ALERT through an injectable clock/sync seam.

* :mod:`repro_torch.profiling.clock` -- the seam's fakes:
  :class:`FakeClock`, :class:`FakeTimedFn` (models asynchronous dispatch),
  fake level callables;
* :mod:`repro_torch.profiling.harness` -- callables -> anytime
  ``ProfileTable`` (synced timing, monotone Eq. 10 clamp, analytic power
  buckets) and per-level ``ServeEngine.generate`` closures;
* :mod:`repro_torch.profiling.live` -- the table of a reduced anytime
  model from given weights and measured accuracies, with fake or
  engine-measured latencies (training is not ported yet).
"""

from repro_torch.profiling.clock import FakeClock, FakeTimedFn, fake_level_fns
from repro_torch.profiling.harness import (engine_level_fns,
                                           monotone_accuracies,
                                           profile_anytime_measured)
from repro_torch.profiling.live import (TrainedAnytime, level_flop_fractions,
                                        live_profile_table)

__all__ = [
    "FakeClock", "FakeTimedFn", "fake_level_fns",
    "engine_level_fns", "monotone_accuracies", "profile_anytime_measured",
    "TrainedAnytime", "level_flop_fractions", "live_profile_table",
]
