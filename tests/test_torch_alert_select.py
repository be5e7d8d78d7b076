"""The port's ``alert_select`` (its plain version on the CPU) against the
reference scoring engine, ``BatchedAlertEngine(backend="xla")`` and the
Pallas kernel in interpret mode (``backend="pallas"``).  The CUDA kernel
is held to the plain version in ``test_torch_cuda.py``.

Pick contract against the reference: the port computes erf and the
staircase sum in its own order and rounding, so predicted accuracies may
differ from XLA's in the last ulp.  A relaxed Eq. 4 lane ranks cells by
``-accuracy``, where one ulp can decide between near-equal cells; such a
lane may pick differently when the two picks' accuracies lie within 2
ulp.  Everything else is exact: feasibility, relax codes, dead-lane
outputs, and every other pick.  Predictions agree to 1e-12 relative
wherever the picks agree.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core import profiles as jpr
from repro_torch.core import batched as tb
from repro_torch.core import profiles as tpr
from repro_torch.kernels import alert_select as ks

PRED_RTOL = 1e-12
S = 4097


def jax_table(t):
    cands = [jpr.Candidate(**dataclasses.asdict(c)) for c in t.candidates]
    return jpr.ProfileTable(cands, t.power_caps.copy(), t.latency.copy(),
                            t.run_power.copy(), q_fail=t.q_fail)


def fleet_state(table, s, seed, dead_frac=0.1):
    """Mixed-goal fleet state; dead lanes hold NaN/inf/huge garbage."""
    rng = np.random.default_rng(seed)
    med_lat = float(np.median(table.latency))
    med_en = float(np.median(table.run_power)) * med_lat
    st = dict(
        mu=rng.uniform(0.5, 3.0, s), sigma=rng.uniform(0.01, 0.5, s),
        phi=rng.uniform(0.05, 0.8, s),
        deadline=rng.uniform(0.1, 3.0, s) * med_lat,
        accuracy_goal=rng.uniform(0.2, 1.1, s),
        energy_goal=rng.uniform(0.0, 2.5, s) * med_en,
        goal_kind=rng.integers(0, 2, s),
        active=rng.random(s) >= dead_frac)
    dead = ~st["active"]
    garbage = rng.choice([np.nan, np.inf, -np.inf, 1e300], size=s)
    for k in ("mu", "sigma", "phi", "deadline", "accuracy_goal",
              "energy_goal"):
        st[k][dead] = garbage[dead]
    return st


def select(engine, st, predictions=True):
    return engine.select(st["mu"], st["sigma"], st["phi"], st["deadline"],
                         accuracy_goal=st["accuracy_goal"],
                         energy_goal=st["energy_goal"],
                         goal_kind=st["goal_kind"], active=st["active"],
                         predictions=predictions)


def assert_pick_contract(got, ref, active, predictions=True):
    """The pick contract of the module docstring (the 2-ulp accuracy
    check of differing picks is :func:`within_2ulp_accuracy`); returns
    the lanes whose picks differ."""
    np.testing.assert_array_equal(got.feasible, ref.feasible)
    np.testing.assert_array_equal(got.relaxed_code, ref.relaxed_code)
    same = (got.model_index == ref.model_index) & \
        (got.power_index == ref.power_index)
    diff = np.nonzero(~same)[0]
    assert active[diff].all(), "dead lanes must pick (0, 0) exactly"
    assert np.all(ref.relaxed_code[diff] == jb.RELAXED_ACCURACY), diff
    for name in ("predicted_latency", "predicted_accuracy",
                 "predicted_energy"):
        g, r = getattr(got, name), getattr(ref, name)
        if not predictions:
            assert np.all(g == 0.0)
        np.testing.assert_allclose(g[same], r[same], rtol=PRED_RTOL, atol=0)
    dead = ~active
    assert np.all(got.model_index[dead] == 0)
    assert np.all(got.power_index[dead] == 0)
    assert not got.feasible[dead].any()
    return diff


def within_2ulp_accuracy(engine_j, st, lanes, got, ref):
    """Both picks' reference accuracies on the differing lanes lie within
    2 ulp of each other."""
    if not len(lanes):
        return
    t = np.maximum(st["deadline"][lanes] - engine_j.overhead, 1e-9)
    est = engine_j.estimate(st["mu"][lanes], st["sigma"][lanes],
                            st["phi"][lanes], t)
    r = np.arange(len(lanes))
    a = est.accuracy[r, got.model_index[lanes], got.power_index[lanes]]
    b = est.accuracy[r, ref.model_index[lanes], ref.power_index[lanes]]
    assert np.all(np.abs(a - b) <= 2 * np.spacing(np.maximum(
        np.abs(a), np.abs(b)))), (a, b)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("paper_faithful", [True, False])
@pytest.mark.parametrize("predictions", [True, False])
def test_plain_version_matches_reference(reference, paper_faithful,
                                         predictions):
    table = tpr.synthetic_table(0)   # K = 12 (8 single + 4 levels), L = 8
    overhead = 0.05 * float(np.median(table.latency))
    st = fleet_state(table, S, seed=100 + 2 * paper_faithful + predictions)
    t_eng = tb.BatchedAlertEngine(table, None, overhead=overhead,
                                  paper_faithful_energy=paper_faithful,
                                  device="cpu")
    j_eng = jb.BatchedAlertEngine(jax_table(table), None, overhead=overhead,
                                  paper_faithful_energy=paper_faithful,
                                  backend=reference)
    launches = ks.alert_select.launches
    got = select(t_eng, st, predictions)
    assert ks.alert_select.launches == launches == 0
    ref = select(j_eng, st, predictions)
    diff = assert_pick_contract(got, ref, st["active"], predictions)
    within_2ulp_accuracy(j_eng, st, diff, got, ref)
    assert t_eng.backend == "torch"


@pytest.mark.parametrize("goal", ["min_energy", "max_accuracy"])
def test_homogeneous_select_matches_reference(goal):
    from repro.core.controller import Goal as JGoal
    from repro_torch.core.controller import Goal as TGoal

    table = tpr.synthetic_table(1)
    st = fleet_state(table, 513, seed=7, dead_frac=0.0)
    kw = dict(accuracy_goal=st["accuracy_goal"]) if goal == "min_energy" \
        else dict(energy_goal=st["energy_goal"])
    tg = TGoal.MINIMIZE_ENERGY if goal == "min_energy" \
        else TGoal.MAXIMIZE_ACCURACY
    jg = JGoal.MINIMIZE_ENERGY if goal == "min_energy" \
        else JGoal.MAXIMIZE_ACCURACY
    t_eng = tb.BatchedAlertEngine(table, tg, overhead=0.001, device="cpu")
    j_eng = jb.BatchedAlertEngine(jax_table(table), jg, overhead=0.001)
    got = t_eng.select(st["mu"], st["sigma"], st["phi"], st["deadline"],
                       **kw)
    ref = j_eng.select(st["mu"], st["sigma"], st["phi"], st["deadline"],
                       **kw)
    diff = assert_pick_contract(got, ref, np.ones(513, bool))
    within_2ulp_accuracy(j_eng, st, diff, got, ref)


@pytest.mark.parametrize("paper_faithful", [True, False])
def test_estimate_grid_matches_reference(paper_faithful):
    table = tpr.synthetic_table(2)
    st = fleet_state(table, 64, seed=3)
    t_eng = tb.BatchedAlertEngine(table, None, device="cpu",
                                  paper_faithful_energy=paper_faithful)
    j_eng = jb.BatchedAlertEngine(jax_table(table), None,
                                  paper_faithful_energy=paper_faithful)
    args = (st["mu"], st["sigma"], st["phi"], st["deadline"])
    got = t_eng.estimate(*args, active=st["active"])
    ref = j_eng.estimate(*args, active=st["active"])
    for name in ("lat_mean", "lat_std", "accuracy", "energy", "p_finish"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=PRED_RTOL, atol=1e-15)


def test_nan_on_a_live_lane_matches_reference():
    """A live lane whose state is NaN: an Eq. 4 lane scores ``-accuracy``
    = NaN, so the reference argmin returns K*L (model index K, power
    index 0); an Eq. 5 lane's NaN best accuracy masks every cell to inf,
    so it picks cell 0.  Gathers over NaN cells are NaN."""
    table = tpr.synthetic_table(0)
    st = fleet_state(table, 16, seed=5, dead_frac=0.0)
    st["mu"][[3, 9]] = np.nan
    st["goal_kind"][[3, 9]] = [tb.GOAL_MIN_ENERGY, tb.GOAL_MAX_ACCURACY]
    t_eng = tb.BatchedAlertEngine(table, None, device="cpu")
    j_eng = jb.BatchedAlertEngine(jax_table(table), None)
    got, ref = select(t_eng, st), select(j_eng, st)
    k = table.latency.shape[0]
    assert got.model_index[3] == k and got.model_index[9] == 0
    for name in ("model_index", "power_index", "feasible", "relaxed_code"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    np.testing.assert_array_equal(np.isnan(got.predicted_accuracy),
                                  np.isnan(ref.predicted_accuracy))


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    table = tpr.synthetic_table(0)
    eng = tb.BatchedAlertEngine(table, None, device="cpu")
    st = fleet_state(table, 33, seed=1)
    f = lambda k: torch.from_numpy(np.ascontiguousarray(st[k], np.float64))
    args = [f(k) for k in ("mu", "sigma", "phi", "deadline",
                           "accuracy_goal", "energy_goal")] + [
        torch.from_numpy(st["goal_kind"].astype(np.int32)),
        torch.from_numpy(st["active"].astype(np.int32))]
    args[1] = torch.clamp_min(args[1], 1e-6)
    kw = dict(latency=eng._latency, run_power=eng._run_power,
              weights=eng._weights, q_fail=eng._q_fail)
    before = ks.alert_select.launches
    out = ks.alert_select(*args, **kw)
    plain = ks.alert_select_plain(*args, **kw)
    assert ks.alert_select.launches == before == 0
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert out[0].dtype == torch.int32 and out[5].dtype == torch.bool
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ks.alert_select(*[a.to("meta") for a in args],
                        **{k: (v.to("meta") if torch.is_tensor(v) else v)
                           for k, v in kw.items()})


def test_engine_backend_follows_device():
    table = tpr.synthetic_table(0)
    assert tb.BatchedAlertEngine(table, device="cpu").backend == "torch"
    with pytest.raises(ValueError, match="does not run"):
        tb.BatchedAlertEngine(table, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tb.BatchedAlertEngine(table, backend="xla", device="cpu")


@pytest.mark.parametrize("predictions", [True, False])
def test_cost_model_counts_like_reference(predictions):
    from repro.kernels.alert_select import alert_select_cost as ref_cost

    got = ks.alert_select_cost(65536, 12, 8, predictions=predictions)
    ref = ref_cost(65536, 12, 8, predictions=predictions)
    assert got["flops"] == ref["flops"]
    assert got["transcendentals"] == ref["transcendentals"]
    assert got["bytes_accessed"] == 65536 * 96
