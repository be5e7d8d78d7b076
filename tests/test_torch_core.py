"""Port parity of the ALERT core (profiles, power, Kalman filters and
banks, windowed goals, the S=1 controller, nesting) against the JAX
reference on the CPU.  Inputs come from seeded numpy streams and go
through both packages."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core import controller as jc
from repro.core import kalman as jk
from repro.core import nesting as jn
from repro.core import power as jp
from repro.core import profiles as jpr
from repro_torch.core import batched as tb
from repro_torch.core import controller as tc
from repro_torch.core import kalman as tk
from repro_torch.core import nesting as tn
from repro_torch.core import power as tp
from repro_torch.core import profiles as tpr

# Filter recurrences: the reference runs them through XLA, which may fuse
# a multiply and an add into one FMA; the port rounds each op.  That is at
# most a few ulp per step, far inside 1e-13 relative.
FILTER_RTOL = 1e-13


def jax_table(t: tpr.ProfileTable) -> jpr.ProfileTable:
    """The reference's ProfileTable holding the port table's numbers."""
    cands = [jpr.Candidate(**dataclasses.asdict(c)) for c in t.candidates]
    return jpr.ProfileTable(cands, t.power_caps.copy(), t.latency.copy(),
                            t.run_power.copy(), q_fail=t.q_fail)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_profile_table_and_weights_bitwise(seed):
    t = tpr.synthetic_table(seed)
    j = jax_table(t)
    assert np.array_equal(t.accuracies, j.accuracies)
    assert t.staircase_rows() == j.staircase_rows()
    assert t.anytime_groups() == j.anytime_groups()
    w_t = tb.BatchedAlertEngine._staircase_weight_matrix(t)
    w_j = jb.BatchedAlertEngine._staircase_weight_matrix(j)
    assert w_t.dtype == np.float64 and np.array_equal(w_t, w_j)
    idx = [0, 3, 8, 9, 10]
    st, sj = t.subset(idx), j.subset(idx)
    assert np.array_equal(st.latency, sj.latency)
    assert np.array_equal(st.run_power, sj.run_power)
    assert st.staircase_rows() == sj.staircase_rows()
    assert np.array_equal(
        tb.BatchedAlertEngine._staircase_weight_matrix(st),
        jb.BatchedAlertEngine._staircase_weight_matrix(sj))


def test_power_model_and_eq9_bitwise():
    pt, pj = tp.PowerModel(), jp.PowerModel()
    assert np.array_equal(pt.buckets(7), pj.buckets(7))
    for cap in np.linspace(40.0, 230.0, 23):
        f = pt.speed_fraction(cap)
        assert f == pj.speed_fraction(cap)
        assert pt.power_at_fraction(f) == pj.power_at_fraction(f)
    assert tp.predict_energy(150.0, 0.2, 0.3, 0.5) == \
        jp.predict_energy(150.0, 0.2, 0.3, 0.5)


def test_measure_mean_latency_with_injected_clock():
    ticks = iter(np.arange(100) * 0.5)
    calls = []
    out = tpr.measure_mean_latency(
        [lambda: calls.append(1)] * 2, warmup=1, iters=4,
        clock=lambda: next(ticks), sync=lambda v: v)
    assert len(calls) == 10
    assert np.array_equal(out, [0.125, 0.125])


def test_scalar_filters_match():
    rng = np.random.default_rng(3)
    st, sj = tk.SlowdownFilter(), jk.SlowdownFilter()
    it, ij = tk.IdlePowerFilter(), jk.IdlePowerFilter()
    for _ in range(200):
        obs, prof = rng.uniform(0.01, 2.0), rng.uniform(0.01, 1.0)
        miss = bool(rng.random() < 0.2)
        assert st.observe(obs, prof, miss) == sj.observe(obs, prof, miss)
        idle, act = rng.uniform(5, 60), rng.uniform(60, 200)
        assert it.observe(idle, act) == ij.observe(idle, act)
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    assert st.std == sj.std


def _assert_banks_close(t_slow, t_idle, j_slow, j_idle):
    for name in ("mu", "sigma", "gain", "process_noise"):
        np.testing.assert_allclose(getattr(t_slow, name).numpy(),
                                   np.asarray(getattr(j_slow, name)),
                                   rtol=FILTER_RTOL, atol=0)
    for name in ("phi", "variance"):
        np.testing.assert_allclose(getattr(t_idle, name).numpy(),
                                   np.asarray(getattr(j_idle, name)),
                                   rtol=FILTER_RTOL, atol=0)
    assert np.array_equal(t_slow.n_updates.numpy(),
                          np.asarray(j_slow.n_updates))
    assert np.array_equal(t_idle.n_updates.numpy(),
                          np.asarray(j_idle.n_updates))


@pytest.mark.parametrize("fused", [True, False])
def test_filter_banks_track_reference_every_step(fused):
    rng = np.random.default_rng(11)
    s = 37
    t_slow = tk.SlowdownFilterBank(s, device="cpu")
    t_idle = tk.IdlePowerFilterBank(s, device="cpu")
    j_slow, j_idle = jk.SlowdownFilterBank(s), jk.IdlePowerFilterBank(s)
    for step in range(40):
        obs = rng.uniform(0.01, 2.0, s)
        prof = rng.uniform(0.01, 1.0, s)
        miss = rng.random(s) < 0.2
        mask = rng.random(s) < 0.8
        idle = rng.uniform(5, 60, s)
        active = rng.uniform(60, 200, s)
        if fused:
            tk.observe_fleet(t_slow, t_idle, obs, prof, deadline_missed=miss,
                             idle_power=idle, active_power=active, mask=mask)
            jk.observe_fleet(j_slow, j_idle, obs, prof, deadline_missed=miss,
                             idle_power=idle, active_power=active, mask=mask)
        else:
            t_slow.observe(obs, prof, miss, mask=mask)
            j_slow.observe(obs, prof, miss, mask=mask)
            t_idle.observe(idle, active, mask=mask)
            j_idle.observe(idle, active, mask=mask)
        _assert_banks_close(t_slow, t_idle, j_slow, j_idle)
        if step == 15:
            for bank in (t_slow, t_idle, j_slow, j_idle):
                bank.reset_lanes([2, 5, 30])
            _assert_banks_close(t_slow, t_idle, j_slow, j_idle)
        if step == 25:
            for bank in (t_slow, t_idle, j_slow, j_idle):
                bank.grow(s + 11)
            s += 11
            _assert_banks_close(t_slow, t_idle, j_slow, j_idle)
    np.testing.assert_allclose(t_slow.std.numpy(), np.asarray(j_slow.std),
                               rtol=FILTER_RTOL, atol=0)


def test_bank_lane_bookkeeping_exact():
    bank = tk.SlowdownFilterBank(6, mu0=1.5, device="cpu")
    bank.observe(np.full(6, 0.9), np.full(6, 0.3))
    bank.reset_lanes([1, 4])
    mu = bank.mu.numpy()
    assert mu[1] == 1.5 and mu[4] == 1.5 and mu[0] != 1.5
    assert bank.n_updates.tolist() == [1, 0, 1, 1, 0, 1]
    bank.grow(9)
    assert bank.n_streams == 9
    assert bank.sigma.numpy()[6:].tolist() == [0.1] * 3
    assert bank.n_updates.tolist() == [1, 0, 1, 1, 0, 1, 0, 0, 0]
    with pytest.raises(ValueError, match="positive"):
        bank.observe(np.ones(9), np.zeros(9))


@pytest.mark.parametrize("window", [1, 2, 5, 10, 17])
def test_windowed_goal_bank_bitwise(window):
    rng = np.random.default_rng(window)
    s = 13
    goals = rng.uniform(0.5, 0.9, s)
    t = tb.WindowedGoalBank(goals, s, window, device="cpu")
    j = jb.WindowedGoalBank(goals, s, window)
    for step in range(3 * window + 4):
        mask = rng.random(t.goal.shape[0]) < 0.75
        delivered = rng.uniform(0.0, 1.0, t.goal.shape[0])
        t.record(delivered, mask=mask)
        j.record(delivered, mask=mask)
        if step == 3:
            new = np.asarray(j.goal).copy()
            new[[0, 4]] = 0.66
            t.set_goals(new)
            j.set_goals(new)
        if step == 5:
            t.reset_lanes([1, 7], goal=0.8)
            j.reset_lanes([1, 7], goal=0.8)
        if step == 6:
            t.grow(s + 3)
            j.grow(s + 3)
        assert np.array_equal(t.current_goal().numpy(), j.current_goal())


def test_windowed_goal_scalar_matches():
    rng = np.random.default_rng(5)
    t, j = tc.WindowedAccuracyGoal(0.8, 7), jc.WindowedAccuracyGoal(0.8, 7)
    for _ in range(30):
        d = rng.uniform(0.3, 1.0)
        t.record(d)
        j.record(d)
        assert t.current_goal() == j.current_goal()


@pytest.mark.parametrize("goal", ["min_energy", "max_accuracy"])
def test_controller_loop_matches(goal):
    """The S=1 controller, stepped over a seeded measurement stream: the
    same picks and relax strings, predictions within 1e-12 relative."""
    table = tpr.synthetic_table(4)
    tg = tc.Goal.MINIMIZE_ENERGY if goal == "min_energy" \
        else tc.Goal.MAXIMIZE_ACCURACY
    jg = jc.Goal.MINIMIZE_ENERGY if goal == "min_energy" \
        else jc.Goal.MAXIMIZE_ACCURACY
    ct = tc.AlertController(table, tg, overhead=0.002, device="cpu")
    cj = jc.AlertController(jax_table(table), jg, overhead=0.002)
    rng = np.random.default_rng(9)
    med = float(np.median(table.latency))
    for _ in range(12):
        dl = float(rng.uniform(0.3, 2.0) * med)
        kw = dict(accuracy_goal=float(rng.uniform(0.5, 0.9))) \
            if goal == "min_energy" else \
            dict(energy_goal=float(rng.uniform(0.2, 1.5) * 100 * med))
        dt = ct.select(tc.Constraints(deadline=dl, **kw))
        dj = cj.select(jc.Constraints(deadline=dl, **kw))
        assert (dt.model_index, dt.power_index, dt.feasible, dt.relaxed) == \
            (dj.model_index, dj.power_index, dj.feasible, dj.relaxed)
        for f in ("predicted_latency", "predicted_accuracy",
                  "predicted_energy"):
            np.testing.assert_allclose(getattr(dt, f), getattr(dj, f),
                                       rtol=1e-12, atol=0)
        obs = float(rng.uniform(0.5, 1.5) * table.latency[dt.model_index,
                                                          dt.power_index])
        for c in (ct, cj):
            c.observe(obs, deadline_missed=obs > dl, idle_power=30.0,
                      delivered_accuracy=0.7)
    et, ej = ct.estimate(0.5 * med), cj.estimate(0.5 * med)
    np.testing.assert_allclose(et.accuracy, ej.accuracy, rtol=1e-12)
    np.testing.assert_allclose(et.energy, ej.energy, rtol=1e-12)


# Nesting: float32, the two frameworks sum in different orders.
NEST_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", [None, 1, 2, 3])
def test_nested_norm_linear_and_prefix_rmsnorm_match(level):
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    d_in, d_out, levels = 32, 48, 3
    h = rng.standard_normal((2, 5, d_in)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, d_in).astype(np.float32)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    si_t, so_t = tn.StripeSpec.pow2(d_in, levels), \
        tn.StripeSpec.pow2(d_out, levels)
    si_j, so_j = jn.StripeSpec.pow2(d_in, levels), \
        jn.StripeSpec.pow2(d_out, levels)
    assert si_t.boundaries == si_j.boundaries
    for backend in ("blocks", "masked"):
        got = tn.nested_norm_linear(torch.from_numpy(h), torch.from_numpy(g),
                                    torch.from_numpy(w), si_t, so_t,
                                    level=level, backend=backend)
        ref = jn.nested_norm_linear(jnp.asarray(h), jnp.asarray(g),
                                    jnp.asarray(w), si_j, so_j, level=level,
                                    backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **NEST_TOL)
    lvl = level or levels
    got = tn.prefix_rmsnorm(torch.from_numpy(h), torch.from_numpy(g), si_t,
                            lvl)
    ref = jn.prefix_rmsnorm(jnp.asarray(h), jnp.asarray(g), si_j, lvl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **NEST_TOL)
    assert np.array_equal(tn.block_triangular_mask(si_t, so_t),
                          jn.block_triangular_mask(si_j, so_j))
