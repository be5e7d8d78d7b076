"""The port's small public APIs against the JAX package's on the CPU:
``StripeSpec.uniform`` and ``StripeSpec.single``, ``ProfileTable.names``,
``SlowdownFilter.predict_latency``, ``batched_predict_energy`` (all host
Python and numpy on both sides, so equal bit for bit), and the
profiling package's export of ``train_reduced_anytime``."""

import numpy as np
import pytest

from repro.core import kalman as jk
from repro.core import nesting as jn
from repro.core import power as jp
from repro.core import profiles as jpr
from repro_torch.core import kalman as tk
from repro_torch.core import nesting as tn
from repro_torch.core import power as tp
from repro_torch.core import profiles as tpr


@pytest.mark.parametrize("total,levels", [(768, 4), (64, 1), (96, 3),
                                          (12, 12)])
def test_stripe_spec_uniform_matches_reference(total, levels):
    got = tn.StripeSpec.uniform(total, levels)
    want = jn.StripeSpec.uniform(total, levels)
    assert got.boundaries == want.boundaries
    assert got.stripe_sizes() == want.stripe_sizes()
    assert [got.width(k) for k in range(1, levels + 1)] == \
        [want.width(k) for k in range(1, levels + 1)]


def test_stripe_spec_uniform_refuses_a_ragged_split():
    for mod in (tn, jn):
        with pytest.raises(ValueError, match="not divisible by levels=3"):
            mod.StripeSpec.uniform(100, 3)


@pytest.mark.parametrize("total", [1, 32768])
def test_stripe_spec_single_matches_reference(total):
    got, want = tn.StripeSpec.single(total), jn.StripeSpec.single(total)
    assert got.boundaries == want.boundaries == (0, total)
    assert got.levels == want.levels == 1
    np.testing.assert_array_equal(got.level_of_channel(),
                                  want.level_of_channel())


def test_profile_table_names_match_reference():
    cands = [("gemma3-1b", 2e12, 3e9, 0.70, False, None, 0),
             ("anytime-l1", 1e12, 1e9, 0.72, True, "anytime", 1),
             ("anytime-l2", 4e12, 2e9, 0.80, True, "anytime", 2)]
    pm_t, pm_j = tp.PowerModel(), jp.PowerModel()
    got = tpr.profile_from_roofline(
        [tpr.Candidate(n, f, b, a, is_anytime_level=any_,
                       anytime_group=g, level=lv)
         for n, f, b, a, any_, g, lv in cands], pm_t, n_power_buckets=4)
    want = jpr.profile_from_roofline(
        [jpr.Candidate(n, f, b, a, is_anytime_level=any_,
                       anytime_group=g, level=lv)
         for n, f, b, a, any_, g, lv in cands], pm_j, n_power_buckets=4)
    assert got.names == want.names == [c[0] for c in cands]


def test_predict_latency_matches_reference():
    """The same observations through both filters, then the prediction
    at several profiled latencies (``tests/test_kalman.py``'s use)."""
    rng = np.random.default_rng(0)
    got, want = tk.SlowdownFilter(), jk.SlowdownFilter()
    for i in range(25):
        obs, prof = float(rng.uniform(0.5, 3.0)), float(rng.uniform(0.5, 2))
        missed = bool(i % 7 == 3)
        got.observe(obs, prof, deadline_missed=missed)
        want.observe(obs, prof, deadline_missed=missed)
        for t in (0.01, 0.25, 1.0, 7.5):
            assert got.predict_latency(t) == want.predict_latency(t)
    mean, std = got.predict_latency(2.0)
    assert mean == got.mu * 2.0 and std == got.std * 2.0


@pytest.mark.parametrize("period", [0.05, 0.4, 10.0])
def test_batched_predict_energy_matches_reference(period):
    """Vectorised Eq. 9 over a [K, L] grid against the reference's and
    against the scalar ``predict_energy`` cell by cell (slack clamped at
    zero where a latency overruns the period)."""
    rng = np.random.default_rng(1)
    lat = rng.uniform(0.01, 0.5, (5, 8))
    caps = tp.PowerModel().buckets(8)
    got = tp.batched_predict_energy(caps, lat, 0.3, period)
    want = jp.batched_predict_energy(caps, lat, 0.3, period)
    np.testing.assert_array_equal(got, want)
    for (i, j), e in np.ndenumerate(got):
        assert e == pytest.approx(tp.predict_energy(caps[j], lat[i, j], 0.3,
                                                    period), rel=1e-15)


def test_profiling_exports_train_reduced_anytime():
    """``repro_torch.profiling`` exports ``train_reduced_anytime``, as the
    reference's package does (``examples/live_profile_demo.py`` imports
    it from there)."""
    import repro.profiling as jprof
    import repro_torch.profiling as tprof
    from repro_torch.profiling import train_reduced_anytime
    from repro_torch.profiling.live import train_reduced_anytime as live

    assert train_reduced_anytime is live
    assert set(jprof.__all__) <= set(tprof.__all__)
