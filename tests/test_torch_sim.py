"""The port's fleet simulator (``repro_torch.serving.sim``) against the
reference's (``repro.serving.sim``) on the CPU, on the same tables,
traces and constraints.

Traces, delivery and the oracles are host numpy in both packages and must
agree bitwise.  The ALERT schemes run the port's ``alert_select`` plain
version against the reference's XLA engine under the pick contract of
``tests/test_torch_alert_select.py``: a pick may differ only on a
``RELAXED_ACCURACY`` lane whose two picks' accuracies lie within 2 ulp.
The reference's Kalman steps may also round a fused multiply-add once
where the port rounds twice, so the filter states may differ by an ulp.
A run is therefore held bitwise, lane by lane, up to the first tick at
which the lane's pick differs, and that pick must satisfy the contract.
Eq. 5 fleets (the golden scenario among them) must match exactly, and
with the reference's picks fed into the port every result matches
bitwise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmarks.common import deadline_range, family_table
from repro.core import batched as jb
from repro.core import controller as jc
from repro.core import profiles as jpr
from repro.serving import sim as js
from repro_torch.core import batched as tb
from repro_torch.core import controller as tc
from repro_torch.core import profiles as tpr
from repro_torch.core.power import PowerModel
from repro_torch.serving import sim as ts

CPU = torch.device("cpu")
FIELDS = ("energy", "accuracy", "latency", "missed")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_traces.json")
ALERT_SCHEMES = ("alert", "alert_plus", "alert_trad", "alert_dnn",
                 "alert_power")


def port_table(t: jpr.ProfileTable) -> tpr.ProfileTable:
    """The port's ProfileTable holding the reference table's numbers."""
    cands = [tpr.Candidate(**dataclasses.asdict(c)) for c in t.candidates]
    return tpr.ProfileTable(cands, t.power_caps.copy(), t.latency.copy(),
                            t.run_power.copy(), q_fail=t.q_fail)


def goals(name):
    return getattr(jc.Goal, name), getattr(tc.Goal, name)


def constraints(table, name, accuracy_goal=0.8, which=1):
    """Both packages' Constraints: Eq. 4 with ``accuracy_goal`` or Eq. 5
    at 170 W, at the ``which``-th of three deadlines."""
    dl = float(deadline_range(table, 3)[which])
    if name == "MINIMIZE_ENERGY":
        jcons = jc.Constraints(deadline=dl, accuracy_goal=accuracy_goal)
    else:
        jcons = jc.Constraints.from_power_budget(dl, 170.0)
    return jcons, tc.Constraints(**dataclasses.asdict(jcons))


def trace_pair(env, seed, **kw):
    return (js.EnvironmentTrace(js.ENVS[env], seed=seed, **kw),
            ts.EnvironmentTrace(ts.ENVS[env], seed=seed, **kw))


def spec_pair(jt, specs):
    """Both packages' StreamSpecs from ``(env, seed, goal name, which
    deadline, arrival, trace kwargs)`` tuples."""
    j_specs, t_specs = [], []
    for env, seed, name, which, arrival, kw in specs:
        jtr, ttr = trace_pair(env, seed, **kw)
        jg, tg = goals(name)
        jcons, tcons = constraints(jt, name, 0.7 + 0.05 * which, which)
        j_specs.append(js.StreamSpec(jtr, jg, jcons, arrival=arrival))
        t_specs.append(ts.StreamSpec(ttr, tg, tcons, arrival=arrival))
    return j_specs, t_specs


CHURN = [("cpu", 11, "MINIMIZE_ENERGY", 0, 0, dict(deadline_cv=0.1)),
         ("memory", 22, "MAXIMIZE_ACCURACY", 2, 37, {}),
         ("default", 33, "MINIMIZE_ENERGY", 1, 5, dict(length_cv=0.1)),
         ("memory", 44, "MAXIMIZE_ACCURACY", 1, 90,
          dict(length_cv=0.2, deadline_cv=0.1))]


class Recording:
    """Every ``select`` of both packages' sims during a test, through
    subclasses of the engine classes the two modules of ``modules`` (the
    reference's, the port's; by default the sims) name."""

    def __init__(self, monkeypatch, inject=False, modules=(js, ts)):
        self.ref, self.port = [], []
        rec = self

        class Ref(jb.BatchedAlertEngine):
            def select(self, mu, sigma, phi, deadline, **kw):
                out = super().select(mu, sigma, phi, deadline, **kw)
                rec.ref.append(dict(
                    engine=self, mu=np.array(mu), sigma=np.array(sigma),
                    phi=np.array(phi), deadline=np.array(deadline),
                    active=np.array(kw["active"]), out=out))
                return out

        class Port(tb.BatchedAlertEngine):
            def select(self, *args, **kw):
                out = super().select(*args, **kw)
                if inject:   # the reference's pick at this tick
                    r = rec.ref[len(rec.port)]["out"]
                    out = dataclasses.replace(
                        out, model_index=r.model_index,
                        power_index=r.power_index)
                rec.port.append(out)
                return out

        monkeypatch.setattr(modules[0], "BatchedAlertEngine", Ref)
        monkeypatch.setattr(modules[1], "BatchedAlertEngine", Port)

    def picks(self, side):
        runs = self.ref if side == "ref" else self.port
        outs = [r["out"] for r in runs] if side == "ref" else runs
        return (np.stack([o.model_index for o in outs]),
                np.stack([o.power_index for o in outs]))


def assert_follows_reference(rec, got, want):
    """``got`` (the port) equals ``want`` (the reference) bitwise, lane by
    lane, up to the lane's first differing pick, which must satisfy the
    pick contract.  Results may be a FleetResult or a TraceResult (one
    lane).  Returns the lanes whose picks differed."""
    jm, jp = rec.picks("ref")
    tm, tp = rec.picks("port")
    assert jm.shape == tm.shape
    ticks, lanes = jm.shape
    differ = (jm.astype(np.int64) != tm) | (jp.astype(np.int64) != tp)
    diverged = []
    for s in range(lanes):
        hit = np.nonzero(differ[:, s])[0]
        first = int(hit[0]) if len(hit) else ticks
        for f in FIELDS:
            a = np.atleast_2d(getattr(got, f))[s, :first]
            b = np.atleast_2d(getattr(want, f))[s, :first]
            np.testing.assert_array_equal(a, b, err_msg=f"lane {s} {f}")
        if first == ticks:
            continue
        diverged.append(s)
        assert_pick_follows_contract(rec, first, s)
    return diverged


def assert_pick_follows_contract(rec, n, s):
    """Select call ``n``'s pick on lane ``s`` may differ from the
    reference's only under the pick contract: an active
    ``RELAXED_ACCURACY`` lane whose two picks' accuracies, as the
    reference estimates them at its own inputs, lie within 2 ulp."""
    r, p = rec.ref[n], rec.port[n]
    assert r["active"][s]
    assert r["out"].relaxed_code[s] == jb.RELAXED_ACCURACY, (s, n)
    eng = r["engine"]
    t = np.maximum(r["deadline"][s:s + 1] - eng.overhead, 1e-9)
    est = eng.estimate(r["mu"][s:s + 1], r["sigma"][s:s + 1],
                       r["phi"][s:s + 1], t)
    a = est.accuracy[0, r["out"].model_index[s], r["out"].power_index[s]]
    b = est.accuracy[0, p.model_index[s], p.power_index[s]]
    assert abs(a - b) <= 2 * np.spacing(max(abs(a), abs(b))), (a, b)


def assert_results_equal(got, want, fields=FIELDS + ("budget",)):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


# --------------------------------------------------------------------- #
# Traces, results, delivery, oracles                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("env", ["default", "cpu", "memory"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("cv", [(0.0, 0.0), (0.2, 0.1)])
def test_environment_trace_bitwise(env, seed, cv):
    j, t = trace_pair(env, seed, length_cv=cv[0], deadline_cv=cv[1])
    for f in ("xi", "lam", "deadline_scale", "phase_id"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t.n == j.n and t.seed == j.seed == seed
    assert t.realized_scale(17) == j.realized_scale(17)


def test_environment_trace_from_generator():
    t = ts.EnvironmentTrace(ts.ENVS["memory"],
                            seed=np.random.default_rng(13), deadline_cv=0.1)
    j = js.EnvironmentTrace(js.ENVS["memory"], seed=13, deadline_cv=0.1)
    assert t.seed is None
    np.testing.assert_array_equal(t.xi, j.xi)
    np.testing.assert_array_equal(t.deadline_scale, j.deadline_scale)


@pytest.mark.parametrize("case", ["min_energy", "budget", "scalar_goal"])
def test_trace_result_violates(case):
    rng = np.random.default_rng(5)
    n = 120
    arrays = (rng.uniform(5, 30, n), rng.uniform(0.5, 0.9, n),
              rng.uniform(0.01, 0.2, n), rng.random(n) < 0.2)
    budget = rng.uniform(10, 25, n) if case == "budget" else None
    name = "MINIMIZE_ENERGY" if case == "min_energy" else \
        "MAXIMIZE_ACCURACY"
    jg, tg = goals(name)
    kw = dict(accuracy_goal=0.72) if case == "min_energy" else \
        dict(energy_goal=18.0)
    jr = js.TraceResult(*arrays, budget=budget)
    tr = ts.TraceResult(*arrays, budget=budget)
    for window, tol in ((10, 0.1), (10, 0.0), (5, 0.3)):
        assert tr.violates(tg, tc.Constraints(1.0, **kw), window, tol) == \
            jr.violates(jg, jc.Constraints(1.0, **kw), window, tol)
    assert (tr.mean_energy, tr.mean_error, tr.miss_rate) == \
        (jr.mean_energy, jr.mean_error, jr.miss_rate)


@pytest.mark.parametrize("task", ["image", "nlp"])
def test_deliver_and_delivery_tensors_bitwise(task):
    jt = family_table(task)
    jtr, ttr = trace_pair("memory", 1, length_cv=0.1, deadline_cv=0.1)
    jsim, tsim = js.InferenceSim(jt, jtr), \
        ts.InferenceSim(port_table(jt), ttr, device=CPU)
    jcons, tcons = constraints(jt, "MAXIMIZE_ACCURACY")
    for a, b in zip(tsim._delivery_tensors(tcons),
                    jsim._delivery_tensors(jcons)):
        np.testing.assert_array_equal(a, b)
    k, l = jt.latency.shape
    rng = np.random.default_rng(2)
    for _ in range(64):
        i, j, n = rng.integers(k), rng.integers(l), rng.integers(jtr.n)
        dl = float(jcons.deadline * jtr.deadline_scale[n])
        assert tsim._deliver(i, j, ttr.realized_scale(n), dl) == \
            jsim._deliver(i, j, jtr.realized_scale(n), dl)


@pytest.mark.parametrize("task", ["image", "nlp"])
@pytest.mark.parametrize("name", ["MINIMIZE_ENERGY", "MAXIMIZE_ACCURACY"])
@pytest.mark.parametrize("scheme", ["oracle", "oracle_static"])
def test_oracles_bitwise(task, name, scheme):
    jt = family_table(task)
    jtr, ttr = trace_pair("cpu", 3, deadline_cv=0.1)
    jg, tg = goals(name)
    jcons, tcons = constraints(jt, name, 0.75)
    want = js.InferenceSim(jt, jtr).run_scheme(scheme, jg, jcons)
    got = ts.InferenceSim(port_table(jt), ttr, device=CPU).run_scheme(
        scheme, tg, tcons)
    assert_results_equal(got, want)
    assert got.scheme == want.scheme and got.config == want.config


def test_unknown_scheme_raises():
    jt = family_table("image")
    sim = ts.InferenceSim(port_table(jt), trace_pair("default", 0)[1],
                          device=CPU)
    with pytest.raises(ValueError, match="oracle_dynamic"):
        sim.run_scheme("oracle_dynamic", tc.Goal.MAXIMIZE_ACCURACY,
                       constraints(jt, "MAXIMIZE_ACCURACY")[1])


# --------------------------------------------------------------------- #
# The ALERT schemes and the fleet                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scheme", ALERT_SCHEMES)
@pytest.mark.parametrize("name", ["MINIMIZE_ENERGY", "MAXIMIZE_ACCURACY"])
def test_alert_schemes_follow_reference(monkeypatch, scheme, name):
    jt = family_table("image")
    jtr, ttr = trace_pair("memory", 1, deadline_cv=0.1)
    jg, tg = goals(name)
    jcons, tcons = constraints(jt, name)
    rec = Recording(monkeypatch)
    want = js.InferenceSim(jt, jtr).run_scheme(scheme, jg, jcons)
    got = ts.InferenceSim(port_table(jt), ttr, device=CPU).run_scheme(
        scheme, tg, tcons)
    assert got.scheme == scheme
    diverged = assert_follows_reference(rec, got, want)
    if name == "MAXIMIZE_ACCURACY":   # Eq. 5: no pick may differ
        assert not diverged
    if not diverged:
        assert_results_equal(got, want)


@pytest.mark.parametrize("env", ["default", "cpu", "memory"])
def test_fleetsim_reproduces_golden_traces(env):
    """The checked-in golden alert numbers, with ``==``: whole closed-loop
    trajectories, where one flipped pick would move them."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    jt = family_table("image")
    cons = tc.Constraints.from_power_budget(
        float(deadline_range(jt, 3)[1]), golden["budget_w"])
    assert golden["goal"] == tc.Goal.MAXIMIZE_ACCURACY.value
    trace = ts.EnvironmentTrace(ts.ENVS[env], seed=golden["seed"])
    fleet = ts.FleetSim(port_table(jt), [trace], device=CPU)
    res = fleet.run_alert(tc.Goal.MAXIMIZE_ACCURACY, cons).stream(0)
    want = golden["envs"][env]["alert"]
    assert res.mean_energy == want["mean_energy"]
    assert res.mean_error == want["mean_error"]
    assert res.miss_rate == want["miss_rate"]
    assert fleet.engine.backend == "torch"
    oracle = ts.InferenceSim(port_table(jt), trace, device=CPU).run_oracle(
        tc.Goal.MAXIMIZE_ACCURACY, cons)
    for key, value in golden["envs"][env]["oracle"].items():
        np.testing.assert_allclose(getattr(oracle, key), value, rtol=1e-9,
                                   atol=1e-12)


def test_fleet_lockstep_equals_independent_streams(monkeypatch):
    jt = family_table("nlp")
    tt = port_table(jt)
    jcons, tcons = constraints(jt, "MINIMIZE_ENERGY", 0.7)
    rec = Recording(monkeypatch)
    want = js.FleetSim.from_phases(jt, js.ENVS["cpu"], 3, seed=20) \
        .run_alert(jc.Goal.MINIMIZE_ENERGY, jcons)
    fleet = ts.FleetSim.from_phases(tt, ts.ENVS["cpu"], 3, seed=20,
                                    device=CPU)
    got = fleet.run_alert(tc.Goal.MINIMIZE_ENERGY, tcons)
    assert got.n_streams == 3
    assert_follows_reference(rec, got, want)
    for s in range(3):
        single = ts.InferenceSim(
            tt, ts.EnvironmentTrace(ts.ENVS["cpu"], seed=20 + s),
            device=CPU).run_alert(tc.Goal.MINIMIZE_ENERGY, tcons)
        assert_results_equal(got.stream(s), single)
    alt = ts.InferenceSim(tt, ts.EnvironmentTrace(ts.ENVS["cpu"], seed=20),
                          device=CPU).run_alert_fleet(
        tc.Goal.MINIMIZE_ENERGY, tcons, 3, seed=20)
    assert_results_equal(alt, got, FIELDS + ("active",))


def test_heterogeneous_fleet_slices_equal_independent_runs(monkeypatch):
    """Four tenants with their own environments, goals, deadlines and
    arrivals (one leaves early, two join late): every stream's slice of
    the fleet equals its own single-stream run, and the fleet follows the
    reference."""
    jt = family_table("image")
    tt = port_table(jt)
    j_specs, t_specs = spec_pair(jt, CHURN)
    rec = Recording(monkeypatch)
    want = js.FleetSim.from_specs(jt, j_specs).run_specs(j_specs,
                                                         overhead=1e-4)
    fleet = ts.FleetSim.from_specs(tt, t_specs, device=CPU)
    got = fleet.run_specs(t_specs, overhead=1e-4)
    assert_follows_reference(rec, got, want)
    for f in ("arrivals", "lengths", "active", "has_budget", "budget"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for s, sp in enumerate(t_specs):
        single = ts.InferenceSim(tt, sp.trace, device=CPU).run_alert(
            sp.goal, sp.constraints, overhead=1e-4)
        part = got.stream(s)
        assert part.energy.shape == (sp.trace.n,)
        assert_results_equal(part, single)


def test_run_fleet_matches_from_specs():
    jt = family_table("nlp")
    tt = port_table(jt)
    _, t_specs = spec_pair(jt, CHURN[:2])
    a = ts.run_fleet(tt, t_specs, device=CPU)
    b = ts.FleetSim.from_specs(tt, t_specs, device=CPU).run_specs(t_specs)
    assert_results_equal(a, b, FIELDS + ("budget", "active"))
    assert len(a.results) == 2


@pytest.mark.parametrize("case", ["accuracy_goal", "energy_goal",
                                  "faults", "specs", "arrivals",
                                  "negative"])
def test_validation_errors(case):
    tt = port_table(family_table("image"))
    tr = ts.EnvironmentTrace(ts.ENVS["default"], seed=0)
    fleet = ts.FleetSim(tt, [tr], device=CPU)
    if case == "accuracy_goal":
        with pytest.raises(ValueError, match="accuracy_goal"):
            fleet.run_streams([tc.Goal.MINIMIZE_ENERGY],
                              [tc.Constraints(deadline=1.0)])
    elif case == "energy_goal":
        with pytest.raises(ValueError, match="energy_goal"):
            fleet.run_streams([tc.Goal.MAXIMIZE_ACCURACY],
                              [tc.Constraints(deadline=1.0)])
    elif case == "faults":
        with pytest.raises(ValueError, match="covers 2 lanes"):
            fleet.run_alert(tc.Goal.MAXIMIZE_ACCURACY,
                            tc.Constraints(1.0, energy_goal=5.0),
                            faults=StubFaults(2, 0))
    elif case == "specs":
        with pytest.raises(ValueError, match="2 specs"):
            fleet.run_specs([ts.StreamSpec(tr, tc.Goal.MINIMIZE_ENERGY,
                                           tc.Constraints(1.0, 0.5))] * 2)
    elif case == "arrivals":
        with pytest.raises(ValueError, match="arrivals"):
            ts.FleetSim(tt, [tr], arrivals=[0, 3], device=CPU)
    else:
        with pytest.raises(ValueError, match=">= 0"):
            ts.FleetSim(tt, [tr], arrivals=[-1], device=CPU)


def test_fleet_defaults_to_the_card(monkeypatch):
    """No device means the card: without CUDA the run raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt = port_table(family_table("image"))
    fleet = ts.FleetSim(tt, [ts.EnvironmentTrace(ts.ENVS["default"])])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet.run_alert(tc.Goal.MAXIMIZE_ACCURACY,
                        tc.Constraints(1.0, energy_goal=5.0))


class StubFaults:
    """The duck-typed fault hook: ``n_lanes`` lanes, lane ``lane`` dead
    for ticks 30-59 and every lane slowed 2.5x for ticks 100-139."""

    def __init__(self, n_lanes, lane):
        self.n_lanes, self.lane = n_lanes, lane

    def dead_at(self, t):
        out = np.zeros(self.n_lanes, bool)
        out[self.lane] = 30 <= t < 60
        return out

    def slow_at(self, t):
        return np.full(self.n_lanes, 2.5 if 100 <= t < 140 else 1.0)


def test_faults_hook_matches_reference(monkeypatch):
    jt = family_table("image")
    specs = [s for s in CHURN if s[2] == "MAXIMIZE_ACCURACY"]
    j_specs, t_specs = spec_pair(jt, specs)
    rec = Recording(monkeypatch)
    want = js.run_fleet(jt, j_specs, faults=StubFaults(2, 0))
    got = ts.run_fleet(port_table(jt), t_specs, device=CPU,
                       faults=StubFaults(2, 0))
    assert not assert_follows_reference(rec, got, want)
    assert_results_equal(got, want)
    # Lane 0 arrives at tick 37: its inputs of ticks 37-59 are lost, a
    # miss with no accuracy and no energy.
    assert got.missed[0, 37:60].all()
    assert not got.accuracy[0, 37:60].any()
    assert not got.energy[0, 37:60].any()


def test_eq4_first_divergence_rule(monkeypatch):
    """An Eq. 4 stream whose relaxed picks tie to the last ulp (on an x86
    CPU the picks of tick 96 differ, both at accuracy 0.71626530346409
    within 1 ulp): the port follows the reference bitwise up to the first
    differing pick, and that pick satisfies the contract."""
    jt = family_table("nlp")
    jtr, ttr = trace_pair("memory", 1, deadline_cv=0.1)
    jcons, tcons = constraints(jt, "MINIMIZE_ENERGY", 0.7)
    rec = Recording(monkeypatch)
    want = js.InferenceSim(jt, jtr).run_alert(jc.Goal.MINIMIZE_ENERGY, jcons)
    got = ts.InferenceSim(port_table(jt), ttr, device=CPU).run_alert(
        tc.Goal.MINIMIZE_ENERGY, tcons)
    assert assert_follows_reference(rec, got, want) in ([], [0])


@pytest.mark.parametrize("task", ["image", "nlp"])
def test_injected_picks_give_the_reference_result(monkeypatch, task):
    """The reference's picks fed into the port's delivery and feedback:
    every FleetResult array bitwise equal."""
    jt = family_table(task)
    j_specs, t_specs = spec_pair(jt, CHURN + [
        ("memory", 1, "MINIMIZE_ENERGY", 1, 3, dict(deadline_cv=0.1))])
    rec = Recording(monkeypatch, inject=True)
    want = js.run_fleet(jt, j_specs)
    got = ts.run_fleet(port_table(jt), t_specs, device=CPU)
    assert len(rec.port) == len(rec.ref) == got.energy.shape[1]
    assert_results_equal(got, want, FIELDS + ("budget", "active"))


# --------------------------------------------------------------------- #
# deliver_step                                                           #
# --------------------------------------------------------------------- #
def delivery_inputs(jt, seed, n=256):
    st = jt.staircase_tensors()
    k, l = jt.latency.shape
    is_any = np.zeros(k, bool)
    for g in jt.anytime_groups().values():
        is_any[g] = True
    rng = np.random.default_rng(seed)
    lanes = (rng.integers(0, k, n), rng.integers(0, l, n),
             rng.uniform(0.5, 2.0, n),
             rng.uniform(0.01, 2.0 * float(jt.latency.max()), n))
    consts = dict(latency_kl=jt.latency, run_power_kl=jt.run_power,
                  q_fail=float(jt.q_fail), is_anytime_k=is_any,
                  lvl_lat_kml=st.lvl_lat, lvl_valid_km=st.lvl_valid,
                  lvl_acc_km=st.lvl_acc)
    return st, is_any, lanes, consts


@pytest.mark.parametrize("task", ["image", "nlp"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("forced", [False, True])
def test_deliver_step_bitwise(task, seed, forced):
    """``deliver_step`` on CPU tensors equals the port's and the
    reference's ``deliver_tick`` and the reference's ``deliver_step``
    under x64, every field.  ``forced``: the ``alert_dnn`` case, the
    executed power forced to the top cap, so the controller's pick's
    profiled latency (``profiled_pick``) is not the executed config's;
    the reference's ``deliver_step`` has no such input."""
    import jax
    from jax.experimental import enable_x64

    jt = family_table(task)
    tt = port_table(jt)
    st, is_any, lanes, consts = delivery_inputs(jt, seed)
    i, j, scale, dvec = lanes
    prof = jt.latency[i, j]
    if forced:
        j = np.full_like(j, jt.latency.shape[1] - 1)
        lanes = (i, j, scale, dvec)
        assert not np.array_equal(prof, jt.latency[i, j])
    want = js.deliver_tick(jt, st, i, j, scale, dvec, 0.25, is_any, prof)
    mine = ts.deliver_tick(tt, tt.staircase_tensors(), i, j, scale, dvec,
                           0.25, is_any, prof)
    got = ts.deliver_step(*(torch.as_tensor(x) for x in lanes), 0.25,
                          profiled_pick=prof if forced else None, **consts)
    with enable_x64():
        ref = jax.jit(lambda ii, jj, sc, dv, fz: js.deliver_step(
            ii, jj, sc, dv, 0.25, f_zero=fz, **consts))(i, j, scale, dvec,
                                                        0.0)
    fields = [f.name for f in dataclasses.fields(ts.DeliveredTick)]
    for name, g, r in zip(fields, got, ref):
        assert g.device == CPU
        np.testing.assert_array_equal(g.numpy(), getattr(want, name), name)
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(want, name), name)
        if not forced:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)


# --------------------------------------------------------------------- #
# Profiles and constraints                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("task", ["image", "nlp"])
def test_staircase_tensors_bitwise(task):
    jt = family_table(task)
    tt = port_table(jt)
    a, b = tt.staircase_tensors(), jt.staircase_tensors()
    for f in ("lvl_lat", "lvl_acc", "lvl_valid", "n_levels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert tt.staircase_tensors() is a      # built once


@pytest.mark.parametrize("idx,shared", [([0, 2, 5, 6, 7, 8], True),
                                        ([1, 3, 4], True),
                                        ([0, 6, 7], False),
                                        ([8, 5, 0], False)])
def test_subset_shares_or_rebuilds_staircases(idx, shared):
    """A subset that keeps every kept candidate's level prefix slices the
    parent's cached tensors; one that cuts a group mid-prefix builds its
    own.  Either way the tensors equal the reference's."""
    jt = family_table("image")
    tt = port_table(jt)
    parent = tt.staircase_tensors()
    jt.staircase_tensors()
    sub_t, sub_j = tt.subset(idx), jt.subset(idx)
    cached = getattr(sub_t, "_staircase_cache", None)
    assert (cached is not None) == shared
    if shared:
        np.testing.assert_array_equal(cached.lvl_lat, parent.lvl_lat[idx])
    a, b = sub_t.staircase_tensors(), sub_j.staircase_tensors()
    for f in ("lvl_lat", "lvl_acc", "lvl_valid", "n_levels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(sub_t.latency, sub_j.latency)


@pytest.mark.parametrize("overhead", [0.0, 1e-3])
def test_profile_from_roofline_bitwise(overhead):
    from repro.core.power import PowerModel as JPowerModel

    jt = family_table("nlp")
    cands_t = [tpr.Candidate(**dataclasses.asdict(c))
               for c in jt.candidates]
    t = tpr.profile_from_roofline(cands_t, PowerModel(60.0, 200.0), 6,
                                  q_fail=0.02, overhead=overhead)
    j = jpr.profile_from_roofline(jt.candidates, JPowerModel(60.0, 200.0),
                                  6, q_fail=0.02, overhead=overhead)
    for f in ("power_caps", "latency", "run_power"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert t.q_fail == j.q_fail
    for f, b, s in ((1e12, 1e9, 0.5), (1e9, 1e12, 0.3), (0.0, 0.0, 1.0)):
        assert tpr.roofline_latency(f, b, s, 197e12, 819e9) == \
            jpr.roofline_latency(f, b, s, 197e12, 819e9)


def test_from_power_budget():
    for dl, p, q in ((0.25, 170.0, None), (1.3e-3, 60.0, 0.8)):
        t = tc.Constraints.from_power_budget(dl, p, q)
        j = jc.Constraints.from_power_budget(dl, p, q)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_smoke_golden_table_and_deadline_bitwise():
    """``scenarios.golden_table()`` and ``golden_deadline()`` (which the
    smoke and the card tests build without the reference) equal the
    reference benchmarks' ``family_table("image")`` and
    ``deadline_range``."""
    from repro_torch.serving.scenarios import golden_deadline, golden_table

    t, j = golden_table(), family_table("image")
    assert [dataclasses.asdict(c) for c in t.candidates] == \
        [dataclasses.asdict(c) for c in j.candidates]
    for f in ("power_caps", "latency", "run_power"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert t.q_fail == j.q_fail
    assert t.latency.shape == (9, 8)
    for n in (3, 5):
        np.testing.assert_array_equal(golden_deadline(t, n),
                                      deadline_range(j, n))
