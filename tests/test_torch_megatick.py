"""The port's megatick (``repro_torch.traffic.megatick``) and the pieces
of its round body against the reference's on the CPU.

The round body's pieces take the same inputs as the reference's and give
the same bits: ``select_step_impl`` against the engine's ``select``,
``fused_fleet_step``, ``_goal_record_step`` and
``goal_current_step_hostsum`` against the reference's jax functions (run
op by op, as the host banks run them), ``power_subset`` with its
staircase cache.  The megatick (its chunk run eagerly on the CPU) is
bitwise the port's ``SessionGateway`` on every field, the paging and
round counts, through paging, overload under both policies with a flat
program count, every fault kind and the gateway golden (``==``).
Against the reference's ``MegatickGateway`` it follows the pick contract
of ``tests/test_torch_alert_select.py`` and matches bitwise with the
reference's picks injected.
"""

import numpy as np
import pytest
import torch

from benchmarks.common import deadline_range
from repro.core import batched as jb
from repro.core import controller as jc
from repro.core import kalman as jk
from repro.serving import sim as js
from repro.traffic import faults as jf
from repro.traffic import workloads as jw
from repro.traffic.megatick import MegatickGateway as JMegatick
from repro_torch.core import batched as tb
from repro_torch.core import kalman as tk
from repro_torch.core.controller import Constraints, Goal
from repro_torch.serving import scenarios as scn
from repro_torch.serving import sim as ts
from repro_torch.traffic import faults as tf
from repro_torch.traffic import gateway as tg
from repro_torch.traffic import workloads as tw
from repro_torch.traffic.megatick import MegatickGateway
from tests.make_golden_traces import gateway_config, summarize_gateway
from tests.test_torch_sim import port_table
from tests.test_torch_traffic import (FIELDS, GOLDEN, assert_bitwise,
                                      convert_faults, convert_sessions,
                                      short_trace, tables)  # noqa: F401

CPU = torch.device("cpu")


def f64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def jnp_eager(fn, *args, **kw):
    """A reference jax function run op by op (no jit: no op fuses) under
    x64, its outputs as numpy."""
    import jax.numpy as jnp
    from jax.experimental import enable_x64

    with enable_x64():
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args), **kw)
        return tuple(np.asarray(o) for o in out) \
            if isinstance(out, tuple) else np.asarray(out)


# --------------------------------------------------------------------- #
# The round body's pieces                                                #
# --------------------------------------------------------------------- #
def lane_inputs(table, s, seed):
    rng = np.random.default_rng(seed)
    lat = float(np.median(table.latency))
    return dict(
        mu=rng.uniform(0.6, 1.6, s), sigma=rng.uniform(0.0, 0.3, s),
        phi=rng.uniform(0.05, 0.6, s),
        deadline=rng.uniform(0.3, 3.0, s) * lat,
        acc_goal=rng.uniform(0.6, 0.9, s),
        en_goal=rng.uniform(0.2, 2.0, s) * lat * 150.0,
        gk=rng.integers(0, 2, s), act=rng.random(s) < 0.8)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("overhead", [0.0, 0.002])
def test_select_step_impl_matches_select(tables, seed, overhead):
    """The device select step gives :meth:`select`'s decisions
    (``predictions=False``) bitwise, sigma floored as ``select`` floors
    it (sigma 0 lanes included), and returns tensors, not numpy."""
    _, tt = tables
    eng = tb.BatchedAlertEngine(tt, None, overhead=overhead, device=CPU)
    x = lane_inputs(tt, 301, seed)
    x["sigma"][::7] = 0.0
    want = eng.select(x["mu"], x["sigma"], x["phi"], x["deadline"],
                      accuracy_goal=x["acc_goal"],
                      energy_goal=x["en_goal"], goal_kind=x["gk"],
                      active=x["act"], predictions=False)
    got = eng.select_step_impl()(
        f64(x["mu"]), f64(x["sigma"]), f64(x["phi"]), f64(x["deadline"]),
        f64(x["acc_goal"]), f64(x["en_goal"]), torch.from_numpy(x["gk"]),
        torch.from_numpy(x["act"]))
    assert all(isinstance(o, torch.Tensor) for o in got)
    names = ("model_index", "power_index", "predicted_latency",
             "predicted_accuracy", "predicted_energy", "feasible",
             "relaxed_code")
    for name, a in zip(names, got):
        np.testing.assert_array_equal(a.numpy(), getattr(want, name),
                                      err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_fleet_step_matches_reference(seed):
    rng = np.random.default_rng(seed)
    s = 513
    slow, idle = tk.SlowdownFilterBank(1, device=CPU), \
        tk.IdlePowerFilterBank(1, device=CPU)
    jslow, jidle = jk.SlowdownFilterBank(1), jk.IdlePowerFilterBank(1)
    assert slow.step_params() == jslow.step_params()
    assert idle.step_params() == jidle.step_params()
    args = [rng.uniform(0.5, 2.0, s), rng.uniform(0.01, 0.5, s),
            rng.uniform(0.1, 0.9, s), rng.uniform(0.1, 0.5, s),
            rng.uniform(0.001, 0.05, s), rng.uniform(0.001, 0.05, s),
            rng.random(s) < 0.3, rng.random(s) < 0.8]
    tail = [rng.uniform(0.05, 0.6, s), rng.uniform(0.001, 0.02, s),
            rng.uniform(1.0, 50.0, s), rng.uniform(60.0, 200.0, s)]
    got = tk.fused_fleet_step(
        *(torch.from_numpy(a) for a in args), *slow.step_params(),
        *(torch.from_numpy(a) for a in tail), *idle.step_params())
    want = jnp_eager(jk.fused_fleet_step, *args, *jslow.step_params(),
                     *tail, *jidle.step_params())
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    # and per lane the host banks' observe_fleet
    slow, idle = tk.SlowdownFilterBank(s, device=CPU), \
        tk.IdlePowerFilterBank(s, device=CPU)
    for name, v in zip(("mu", "sigma", "gain", "process_noise"), args[:4]):
        setattr(slow, name, torch.from_numpy(v.copy()))
    idle.phi, idle.variance = (torch.from_numpy(v.copy())
                               for v in tail[:2])
    tk.observe_fleet(slow, idle, args[4], args[5],
                     deadline_missed=args[6], idle_power=tail[2],
                     active_power=tail[3], mask=args[7])
    for a, b in zip(got, (slow.mu, slow.sigma, slow.gain,
                          slow.process_noise, idle.phi, idle.variance)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [1, 2, 5, 10, 17, 130])
def test_goal_steps_match_reference_and_bank(window):
    """``_goal_record_step`` and ``goal_current_step_hostsum`` equal the
    reference's functions and the port's bank, bitwise, at depths where
    the pairwise sum's shape changes."""
    rng = np.random.default_rng(window)
    s = 64
    bank = tb.WindowedGoalBank(rng.uniform(0.5, 0.9, s), s, window,
                               device=CPU)
    depth = max(window - 1, 0)
    buf = np.zeros((s, max(depth, 1)))
    pos = np.zeros(s, np.int64)
    count = np.zeros(s, np.int64)
    for _ in range(7):
        d = rng.uniform(0.0, 1.0, s)
        m = rng.random(s) < 0.7
        bank.record(d, mask=m)
        if depth:
            got = tb._goal_record_step(
                torch.from_numpy(buf.copy()), torch.from_numpy(pos),
                torch.from_numpy(count), torch.from_numpy(d),
                torch.from_numpy(m), depth)
            want = jnp_eager(jb._goal_record_step, buf, pos, count, d, m,
                             depth)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)
            buf, pos, count = (a.numpy() for a in got)
    goal = bank.goal.numpy()
    got = tb.goal_current_step_hostsum(
        torch.from_numpy(goal), torch.from_numpy(buf),
        torch.from_numpy(count), window)
    want = jnp_eager(jb.goal_current_step_hostsum, goal, buf, count,
                     window, 0.0)   # the reference's runtime zero
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), bank.current_goal().numpy())


@pytest.mark.parametrize("cols", [[7], [0, 3], [1, 2, 5, 7]])
@pytest.mark.parametrize("cached", [True, False])
def test_power_subset_matches_reference(tables, cols, cached):
    """Column-sliced tables equal the reference's; a cached parent
    staircase is carried over column-sliced (no rebuild), an uncached
    parent leaves the subset to build its own, with the same numbers."""
    jt, _ = tables
    tt = port_table(jt)
    if cached:
        tt.staircase_tensors()
        jt.staircase_tensors()
    sub, jsub = tt.power_subset(cols), jt.power_subset(cols)
    assert (getattr(sub, "_staircase_cache", None) is not None) == cached
    for f in ("power_caps", "latency", "run_power"):
        np.testing.assert_array_equal(getattr(sub, f), getattr(jsub, f))
    assert sub.q_fail == jsub.q_fail
    assert [c.name for c in sub.candidates] == \
        [c.name for c in jsub.candidates]
    a, b = sub.staircase_tensors(), jsub.staircase_tensors()
    for f in ("lvl_lat", "lvl_acc", "lvl_valid", "n_levels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    rebuilt = port_table(jt).power_subset(cols).staircase_tensors()
    np.testing.assert_array_equal(a.lvl_lat, rebuilt.lvl_lat)


def test_deliver_step_with_device_constants(tables):
    """Table constants as tensors on the lane device (copied nothing) and
    q_fail as a scalar operand: the same bits as with numpy constants."""
    _, tt = tables
    st = tt.staircase_tensors()
    k, l = tt.latency.shape
    rng = np.random.default_rng(4)
    n = 200
    i, j = rng.integers(0, k, n), rng.integers(0, l, n)
    scale = rng.uniform(0.5, 2.0, n)
    dvec = rng.uniform(0.01, 2.0 * float(tt.latency.max()), n)
    is_any = np.zeros(k, bool)
    is_any[-4:] = True
    np_consts = dict(latency_kl=tt.latency, run_power_kl=tt.run_power,
                     q_fail=tt.q_fail, is_anytime_k=is_any,
                     lvl_lat_kml=st.lvl_lat, lvl_valid_km=st.lvl_valid,
                     lvl_acc_km=st.lvl_acc)
    dev_consts = {name: torch.as_tensor(v) if isinstance(v, np.ndarray)
                  else v for name, v in np_consts.items()}
    lanes = [torch.from_numpy(a) for a in (i, j, scale, dvec)]
    want = ts.deliver_step(*lanes, 0.25, **np_consts)
    got = ts.deliver_step(*lanes, 0.25, **dev_consts)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------- #
# The megatick against the port's host gateway                           #
# --------------------------------------------------------------------- #
def paging_sessions(jt, tick, dl):
    """The reference's ``_paging_sessions`` (6 sessions over 3 lanes,
    paging every round), in the port's types."""
    sessions = []
    for sid in range(6):
        tr = short_trace(ts.ENVS["cpu"] if sid % 2 else ts.ENVS["memory"],
                         40 + sid, 25, deadline_cv=0.1)
        arrivals = (2 * np.arange(25) + (sid % 2)) * tick
        goal = Goal.MINIMIZE_ENERGY if sid % 3 else Goal.MAXIMIZE_ACCURACY
        cons = Constraints(deadline=dl, accuracy_goal=0.8) if sid % 3 \
            else Constraints.from_power_budget(dl, 170.0)
        sessions.append(tw.Session(sid, "t", goal, cons, arrivals, tr))
    return sessions


def overload_sessions(jt, load, n_lanes=16, s=64):
    dl = float(deadline_range(jt, 5)[3])
    cons = Constraints(deadline=dl, accuracy_goal=0.78)
    mix = [tw.TenantSpec("minE", Goal.MINIMIZE_ENERGY, cons,
                         tw.PoissonProcess(load * (n_lanes / dl) / s),
                         n_sessions=s, phases=ts.CPU_ENV)]
    return tw.build_sessions(mix, 10 * dl, seed=11), dl


def test_bitwise_through_paging(tables):
    jt, tt = tables
    dl = float(deadline_range(jt, 5)[3])
    tick = dl * 2.5
    sessions = paging_sessions(jt, tick, dl)
    host = tg.SessionGateway(tt, 3, tick=tick, device=CPU).run(sessions)
    mega = MegatickGateway(tt, 3, tick=tick, chunk=16, device=CPU)
    res = mega.run(sessions)
    assert host.pages_in > 50, "the workload must page"
    assert_bitwise(res, host)
    assert res.n_compiles == (0, 1) and host.n_compiles == (0, 0)
    assert res.select_launches == 0     # the CPU runs the plain version


def test_overload_both_policies_flat_programs(tables):
    """Backpressure, fail-fast and same-session deferral on the planner:
    bitwise under 2x and 8x overload for both policies, one chunk program
    a policy across the loads."""
    jt, tt = tables
    n_lanes = 16
    mega = MegatickGateway(tt, n_lanes, max_queue=4 * n_lanes, chunk=32,
                           tick=float(deadline_range(jt, 5)[3]),
                           device=CPU)
    for load in (2.0, 8.0):
        sessions, dl = overload_sessions(jt, load)
        host = tg.SessionGateway(tt, n_lanes, tick=dl,
                                 max_queue=4 * n_lanes, device=CPU)
        res_h = host.run(sessions, tw.generate_requests(sessions))
        res_m = mega.run(sessions, tw.generate_requests(sessions))
        assert (res_h.status == tg.REJECTED_INFEASIBLE).any() or \
            res_h.reject_rate > 0, "overload must shed"
        assert_bitwise(res_m, res_h)
        kw = dict(policy="static", static_config=(2, 1))
        assert_bitwise(mega.run(sessions, tw.generate_requests(sessions),
                                **kw),
                       host.run(sessions, tw.generate_requests(sessions),
                                **kw))
    assert mega.n_compiles() == (0, 2)


@pytest.mark.parametrize("kind", list(tf.FAULT_KINDS))
def test_fault_kinds_bitwise(tables, kind):
    """Every fault kind (the reference's TestMegatickFaultParity): the
    planner reads the schedule at the host loop's instants and the body
    carries the death mask."""
    jt, tt = tables
    sessions, n_lanes, dl = gateway_config(jt)
    sessions = convert_sessions(sessions)
    fs = tf.scenario(kind, n_lanes, start=3 * dl, horizon=12 * dl,
                     seed=11, n_devices=4)
    rh = tg.SessionGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                           device=CPU).run(
        sessions, tw.generate_requests(sessions), faults=fs)
    rm = MegatickGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                         chunk=8, device=CPU).run(
        sessions, tw.generate_requests(sessions), faults=fs)
    assert_bitwise(rm, rh)


def test_fault_lane_count_validated(tables):
    jt, tt = tables
    sessions, n_lanes, dl = gateway_config(jt)
    sessions = convert_sessions(sessions)
    mega = MegatickGateway(tt, n_lanes, tick=dl, device=CPU)
    with pytest.raises(ValueError, match="lanes"):
        mega.run(sessions, faults=tf.FaultSchedule(n_lanes + 1))


def test_fine_tick_refused(tables):
    jt, tt = tables
    dl = float(deadline_range(jt, 5)[3])
    tr = short_trace(ts.ENVS["default"], 2, 4)
    sess = [tw.Session(0, "t", Goal.MINIMIZE_ENERGY,
                       Constraints(deadline=dl, accuracy_goal=0.7),
                       np.arange(4) * dl, tr)]
    with pytest.raises(ValueError, match="SessionGateway"):
        MegatickGateway(tt, 2, tick=dl / 4, device=CPU).run(sess)


@pytest.mark.parametrize("bad", [dict(policy="nope"),
                                 dict(policy="static")])
def test_bad_policy_raises(tables, bad):
    jt, tt = tables
    sessions, n_lanes, dl = gateway_config(jt)
    with pytest.raises(ValueError):
        MegatickGateway(tt, n_lanes, tick=dl, device=CPU).run(
            convert_sessions(sessions), **bad)


def test_golden_equal(tables):
    """``golden_traces.json["gateway"]`` with ``==``, at chunks that
    split the run differently."""
    import json

    jt, tt = tables
    with open(GOLDEN) as f:
        want = json.load(f)["gateway"]
    sessions, n_lanes, dl = gateway_config(jt)
    sessions = convert_sessions(sessions)
    for chunk in (1, 5, 64):
        gw = MegatickGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                             chunk=chunk, device=CPU)
        assert summarize_gateway(gw.run(
            sessions, tw.generate_requests(sessions))) == want, chunk


def test_reused_gateway_and_empty_workload(tables):
    """A second run starts from fresh state (bitwise the first), and a
    workload with no requests returns an empty result."""
    jt, tt = tables
    sessions, n_lanes, dl = gateway_config(jt)
    sessions = convert_sessions(sessions)
    gw = MegatickGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                         chunk=8, device=CPU)
    first = gw.run(sessions, tw.generate_requests(sessions))
    assert_bitwise(gw.run(sessions, tw.generate_requests(sessions)), first)
    empty = gw.run(sessions, [])
    assert empty.offered == 0 and empty.n_rounds == 0
    assert gw.n_compiles() == (0, 1)


def test_smoke_workloads_are_the_reference_benches(tables):
    """``serving/scenarios.py``'s megatick workloads are the reference
    benches' (``bench_megatick``, ``bench_obs``), cut in sessions and
    rounds here: the same sessions, arrivals and traces."""
    jt, _ = tables
    table = scn.golden_table()
    for n_sessions, n_lanes, rounds, seed in ((600, 32, 6, scn.MEGATICK_SEED),
                                             (300, 16, 4, scn.OBS_SEED)):
        got, dl = scn.saturating_sessions(table, n_sessions, n_lanes,
                                          rounds, seed)
        jdl = float(deadline_range(jt, 5)[3])
        assert dl == jdl
        cons = jc.Constraints(deadline=jdl, accuracy_goal=0.78)
        mix = [jw.TenantSpec("min-energy", jc.Goal.MINIMIZE_ENERGY, cons,
                             jw.PoissonProcess(1.0 * (n_lanes / jdl)
                                               / n_sessions),
                             n_sessions=n_sessions, phases=js.CPU_ENV)]
        want = jw.build_sessions(mix, rounds * jdl, seed=seed)
        assert len(got) == len(want) == n_sessions
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.arrivals, b.arrivals)
            np.testing.assert_array_equal(a.trace.xi, b.trace.xi)
    assert (scn.MEGATICK_SESSIONS, scn.MEGATICK_LANES,
            scn.MEGATICK_ROUNDS) == (100_000, 4096, 48)
    assert (scn.OBS_SESSIONS, scn.OBS_LANES, scn.OBS_ROUNDS) == \
        (20_000, 1024, 24)


# --------------------------------------------------------------------- #
# The megatick against the reference's                                   #
# --------------------------------------------------------------------- #
class Injected(MegatickGateway):
    """A port megatick that keeps each round's select inputs and picks
    and, given ``inject`` (the reference megatick's result), replaces
    the model and power picks with the reference's."""

    def __init__(self, *args, inject=None, **kw):
        super().__init__(*args, **kw)
        self.inject, self.log = inject, []

    def _plan(self, *args, **kw):
        self.plan = super()._plan(*args, **kw)
        return self.plan

    def _pick(self, ch, r, *lanes):
        out = list(super()._pick(ch, r, *lanes))
        k = self._round_base + r
        act = lanes[7].numpy()
        self.log.append(dict(
            inputs=[x.numpy().copy() for x in lanes[:4]], act=act.copy(),
            i=out[0].numpy().copy(), j=out[1].numpy().copy(),
            relaxed=out[6].numpy().copy()))
        if self.inject is not None:
            rows = self.plan.row[k]
            for n, field in ((0, "model_index"), (1, "power_index")):
                want = np.where(act, getattr(self.inject, field)[rows], 0)
                out[n] = torch.from_numpy(want.astype(np.int32))
        return tuple(out)


def megatick_pair(tables, jsessions, n_lanes, tick, *, faults=None,
                  inject=False, **kw):
    jt, tt = tables
    want = JMegatick(jt, n_lanes, tick=tick, max_queue=4 * n_lanes,
                     chunk=16).run(jsessions,
                                   jw.generate_requests(jsessions),
                                   faults=faults, **kw)
    sessions = convert_sessions(jsessions)
    gw = Injected(tt, n_lanes, tick=tick, max_queue=4 * n_lanes, chunk=16,
                  device=CPU, inject=want if inject else None)
    got = gw.run(sessions, tw.generate_requests(sessions),
                 faults=convert_faults(faults), **kw)
    return got, want, gw


def assert_follows_reference(jt, got, want, gw):
    """``got`` equals ``want`` bitwise in every request served before the
    first round whose picks differ, and that round's differing picks
    meet the pick contract at the round's inputs (the port's, equal to
    the reference's up to that round).  Returns that round or None."""
    plan = gw.plan
    first = None
    for k in range(plan.n_active):
        a = plan.act[k]
        rows = plan.row[k][a]
        differ = (want.model_index[rows] != got.model_index[rows]) | \
            (want.power_index[rows] != got.power_index[rows])
        if differ.any():
            first = k
            break
    if first is None:
        assert_bitwise(got, want)
        return None
    lanes = np.nonzero(plan.act[first])[0][differ]
    rec = gw.log[first]
    eng = jb.BatchedAlertEngine(jt, None)
    mu, sd, phi, dl = rec["inputs"]
    rows = plan.row[first][lanes]
    for lane, row in zip(lanes, rows):
        assert rec["relaxed"][lane] == jb.RELAXED_ACCURACY
        est = eng.estimate(mu[lane:lane + 1], sd[lane:lane + 1],
                           phi[lane:lane + 1],
                           np.maximum(dl[lane:lane + 1], 1e-9))
        a = est.accuracy[0, want.model_index[row], want.power_index[row]]
        b = est.accuracy[0, got.model_index[row], got.power_index[row]]
        assert abs(a - b) <= 2 * np.spacing(max(abs(a), abs(b)))
    t_first = plan.now[first]
    decided = want.start < t_first
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[decided],
                                      getattr(want, f)[decided], f)
    return first


def reference_workload(jt, name):
    if name == "overload":
        dl = float(deadline_range(jt, 5)[3])
        cons = jc.Constraints(deadline=dl, accuracy_goal=0.78)
        mix = [jw.TenantSpec("minE", jc.Goal.MINIMIZE_ENERGY, cons,
                             jw.PoissonProcess(8.0 * 16 / dl / 64),
                             n_sessions=64, phases=js.CPU_ENV)]
        return jw.build_sessions(mix, 10 * dl, seed=11), 16, dl, None
    sessions, n_lanes, dl = gateway_config(jt)
    faults = None if name == "golden" else jf.scenario(
        name, n_lanes, start=4 * dl, horizon=12 * dl, seed=11, n_devices=4)
    return sessions, n_lanes, dl, faults


@pytest.mark.parametrize("name", ["golden", "overload", "device_loss",
                                  "brownout"])
@pytest.mark.parametrize("policy", ["alert", "static"])
def test_megatick_follows_reference(tables, name, policy):
    """Under the pick contract, then bitwise with the reference's picks
    injected (a static run has no picks to differ: bitwise outright)."""
    jt, _ = tables
    jsessions, n_lanes, dl, faults = reference_workload(jt, name)
    kw = dict(policy="static", static_config=(2, 3)) \
        if policy == "static" else {}
    got, want, gw = megatick_pair(tables, jsessions, n_lanes, dl,
                                  faults=faults, **kw)
    assert got.offered == want.offered > 50
    first = assert_follows_reference(jt, got, want, gw)
    if policy == "static" or name == "golden":
        assert first is None
    if policy == "alert":
        got, want, _ = megatick_pair(tables, jsessions, n_lanes, dl,
                                     faults=faults, inject=True)
        assert_bitwise(got, want)
