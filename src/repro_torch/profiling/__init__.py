"""Live-profile harness (port of ``repro.profiling``): measured anytime
staircases for ALERT through an injectable clock/sync seam.

* :mod:`repro_torch.profiling.clock` -- the seam's fakes:
  :class:`FakeClock`, :class:`FakeTimedFn` (models asynchronous dispatch),
  fake level callables;
* :mod:`repro_torch.profiling.harness` -- callables -> anytime
  ``ProfileTable`` (synced timing, monotone Eq. 10 clamp, analytic power
  buckets) and per-level ``ServeEngine.generate`` closures;
* :mod:`repro_torch.profiling.live` -- the reduced ``alert_anytime``
  pipeline: joint training (:func:`train_reduced_anytime`), per-level
  held-out accuracy, fake or engine-measured latencies, one table the
  traffic stack consumes.
"""

from repro_torch.profiling.clock import FakeClock, FakeTimedFn, fake_level_fns
from repro_torch.profiling.harness import (engine_level_fns,
                                           monotone_accuracies,
                                           profile_anytime_measured)
from repro_torch.profiling.live import (TrainedAnytime, level_flop_fractions,
                                        live_profile_table,
                                        train_reduced_anytime)

__all__ = [
    "FakeClock", "FakeTimedFn", "fake_level_fns",
    "engine_level_fns", "monotone_accuracies", "profile_anytime_measured",
    "TrainedAnytime", "level_flop_fractions", "live_profile_table",
    "train_reduced_anytime",
]
