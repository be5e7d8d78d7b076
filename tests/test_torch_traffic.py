"""The port's traffic subsystem (``repro_torch.traffic``) against the
reference's (``repro.traffic``) on the CPU, on the same tables, seeds and
workloads, at the reference tests' sizes.

Workloads and fault schedules are host numpy in both packages and must
agree bitwise.  The gateway scores rounds with the port's ``alert_select``
plain version against the reference's XLA engine under the pick contract
of ``tests/test_torch_alert_select.py``: a pick may differ only on a
``RELAXED_ACCURACY`` lane whose two picks' accuracies lie within 2 ulp.
One differing pick moves every later round (lanes free up at other
times), so a run is held bitwise in every request decided before the
first round whose picks differ, that pick is held to the contract, and
with the reference's picks fed into the port every result matches
bitwise.  The goldens of ``tests/golden_traces.json`` hold with ``==``.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmarks.common import deadline_range, family_table
from repro.checkpoint import io as jio
from repro.core import controller as jc
from repro.runtime.ft import InjectedFailure as JInjectedFailure
from repro.serving import sim as js
from repro.traffic import faults as jf
from repro.traffic import gateway as jg
from repro.traffic import workloads as jw
from repro_torch.checkpoint import io as tio
from repro_torch.core import batched as tb
from repro_torch.core import controller as tc
from repro_torch.runtime.elastic import dead_lane_mask
from repro_torch.runtime.ft import InjectedFailure
from repro_torch.serving import scenarios as scn
from repro_torch.serving import sim as ts
from repro_torch.traffic import faults as tf
from repro_torch.traffic import gateway as tg
from repro_torch.traffic import workloads as tw
from tests.make_golden_traces import (gateway_config, straggler_config,
                                      summarize_gateway)
from tests.test_torch_sim import (Recording, assert_pick_follows_contract,
                                  port_table)

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_traces.json")
#: Every per-request field a GatewayResult carries.
FIELDS = ("sid", "index", "arrival", "status", "start", "latency",
          "sojourn", "missed", "accuracy", "energy", "model_index",
          "power_index")


@pytest.fixture(scope="module")
def tables():
    jt = family_table("image")
    return jt, port_table(jt)


def deadline(jt) -> float:
    return float(deadline_range(jt, 5)[3])


def assert_bitwise(got, want, rows=None):
    """Every per-request field (over ``rows``, default all), the round
    count, the paging counters and the horizon equal."""
    sel = slice(None) if rows is None else rows
    bad = [f for f in FIELDS if not np.array_equal(
        getattr(got, f)[sel], getattr(want, f)[sel])]
    assert not bad, f"results diverge on {bad}"
    if rows is None:
        assert got.n_rounds == want.n_rounds
        assert (got.pages_in, got.pages_out) == (want.pages_in,
                                                 want.pages_out)
        assert got.horizon == want.horizon


# --------------------------------------------------------------------- #
# Both packages' sessions from one description                          #
# --------------------------------------------------------------------- #
def convert_spec(spec: jw.TenantSpec) -> tw.TenantSpec:
    """The port's TenantSpec holding the reference spec's values."""
    proc = getattr(tw, type(spec.process).__name__)(
        **dataclasses.asdict(spec.process))
    return tw.TenantSpec(
        spec.name, tc.Goal(spec.goal.value),
        tc.Constraints(**dataclasses.asdict(spec.constraints)), proc,
        n_sessions=spec.n_sessions,
        phases=tuple(ts.Phase(**dataclasses.asdict(p))
                     for p in spec.phases))


def convert_sessions(sessions) -> list:
    """The port's sessions for the reference's ``sessions`` (same
    arrivals; environment traces rebuilt from the same seeds)."""
    out = []
    for s in sessions:
        tr = s.trace
        trace = ts.EnvironmentTrace(
            tuple(ts.Phase(**dataclasses.asdict(p)) for p in tr.phases),
            seed=tr.seed, length_cv=tr.length_cv,
            deadline_cv=tr.deadline_cv)
        for f in ("xi", "lam", "deadline_scale"):
            np.testing.assert_array_equal(getattr(trace, f), getattr(tr, f))
        out.append(tw.Session(
            s.sid, s.tenant, tc.Goal(s.goal.value),
            tc.Constraints(**dataclasses.asdict(s.constraints)),
            s.arrivals.copy(), trace))
    return out


def convert_faults(fs):
    """The port's FaultSchedule for the reference's (the same events and
    the same pre-drawn jitter)."""
    if fs is None:
        return None
    events = [getattr(tf, type(ev).__name__)(**dataclasses.asdict(ev))
              for ev in fs.events]
    out = tf.FaultSchedule(fs.n_lanes, events)
    out._jitter = fs._jitter.copy()
    return out


def overload_workload(jt):
    """The reference's ``TestGatewayOverload`` workload: 64 Eq. 4
    sessions at ~8x the capacity of 16 lanes, tick T_goal/4."""
    dl = deadline(jt)
    n_lanes, s = 16, 64
    mix = [jw.TenantSpec("minE", jc.Goal.MINIMIZE_ENERGY,
                         jc.Constraints(deadline=dl, accuracy_goal=0.78),
                         jw.PoissonProcess(8.0 * (n_lanes / dl) / s),
                         n_sessions=s, phases=js.CPU_ENV)]
    return jw.build_sessions(mix, 10 * dl, seed=11), n_lanes, dl / 4


# --------------------------------------------------------------------- #
# Workloads                                                              #
# --------------------------------------------------------------------- #
PROCESSES = {
    "poisson": ("PoissonProcess", dict(rate=3.0)),
    "mmpp": ("MMPPProcess", dict(rate_low=0.5, rate_high=6.0,
                                 dwell_low=4.0, dwell_high=2.0)),
    "diurnal": ("DiurnalProcess", dict(rate=2.0, amplitude=0.6,
                                       period=15.0, phase=0.3)),
    "flash": ("FlashCrowdProcess", dict(rate=1.0, spike_rate=9.0,
                                        spike_start=10.0, spike_len=5.0)),
}


@pytest.mark.parametrize("name", sorted(PROCESSES))
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("factor", [1.0, 2.5])
def test_arrival_processes_bitwise(name, seed, factor):
    cls, kw = PROCESSES[name]
    jp = getattr(jw, cls)(**kw).scaled(factor)
    tp = getattr(tw, cls)(**kw).scaled(factor)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    got = tp.times(40.0, np.random.default_rng(seed))
    want = jp.times(40.0, np.random.default_rng(seed))
    assert got.size > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate,horizon", [(0.0, 5.0), (2.0, 0.0),
                                          (0.3, 7.0), (50.0, 3.0)])
def test_poisson_times_bitwise(rate, horizon):
    got = tw._poisson_times(rate, horizon, np.random.default_rng(3))
    want = jw._poisson_times(rate, horizon, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("n", [0, 1, 7, 400, 1001])
def test_phases_sized_equal(n):
    got = tw._phases_sized(ts.CPU_ENV, n)
    want = jw._phases_sized(js.CPU_ENV, n)
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("cv", [(0.0, 0.0), (0.2, 0.1)])
def test_sessions_and_requests_bitwise(seed, cv):
    """A two-tenant mix over every process: arrivals, traces and the
    flattened request list equal field for field."""
    jmix = [jw.TenantSpec("minE", jc.Goal.MINIMIZE_ENERGY,
                          jc.Constraints(deadline=0.2, accuracy_goal=0.78),
                          jw.MMPPProcess(1.0, 5.0, 3.0, 1.0),
                          n_sessions=5, phases=js.CPU_ENV),
            jw.TenantSpec("maxA", jc.Goal.MAXIMIZE_ACCURACY,
                          jc.Constraints.from_power_budget(0.3, 170.0),
                          jw.DiurnalProcess(2.0, period=10.0),
                          n_sessions=4, phases=js.MEMORY_ENV),
            jw.TenantSpec("flash", jc.Goal.MINIMIZE_ENERGY,
                          jc.Constraints(deadline=0.25, accuracy_goal=0.7),
                          jw.FlashCrowdProcess(0.5, 6.0, 5.0, 4.0),
                          n_sessions=3)]
    tmix = [convert_spec(t) for t in jmix]
    want = jw.build_sessions(jmix, 30.0, seed=seed, length_cv=cv[0],
                             deadline_cv=cv[1])
    got = tw.build_sessions(tmix, 30.0, seed=seed, length_cv=cv[0],
                            deadline_cv=cv[1])
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert (a.sid, a.tenant, a.goal.value, a.n_requests) == \
            (b.sid, b.tenant, b.goal.value, b.n_requests)
        np.testing.assert_array_equal(a.arrivals, b.arrivals)
        for f in ("xi", "lam", "deadline_scale", "phase_id"):
            np.testing.assert_array_equal(getattr(a.trace, f),
                                          getattr(b.trace, f))
        if a.n_requests:
            assert a.rel_deadline(a.n_requests - 1) == \
                b.rel_deadline(b.n_requests - 1)
    greq, wreq = tw.generate_requests(got), jw.generate_requests(want)
    assert len(greq) == len(wreq) > 100
    for a, b in zip(greq, wreq):
        assert (a.deadline, a.arrival, a.req_id, a.sid, a.index, a.tenant,
                a.rel_deadline) == (b.deadline, b.arrival, b.req_id, b.sid,
                                    b.index, b.tenant, b.rel_deadline)


# --------------------------------------------------------------------- #
# Fault schedules and the detector                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", jf.FAULT_KINDS)
@pytest.mark.parametrize("seed", [0, 11, "generator"])
@pytest.mark.parametrize("jitter_cv", [0.0, 0.3])
def test_fault_schedule_bitwise(kind, seed, jitter_cv):
    """``slow_at`` and ``dead_at`` at every round instant of a run,
    bitwise, for int and Generator seeds."""
    def make(mod):
        s = np.random.default_rng(4) if seed == "generator" else seed
        return mod.scenario(kind, 12, start=0.7, horizon=6.1, seed=s,
                            magnitude=1.5, jitter_cv=jitter_cv,
                            n_devices=4)
    got, want = make(tf), make(jf)
    np.testing.assert_array_equal(got._jitter, want._jitter)
    assert got.has_faults and want.has_faults
    tick = 0.137
    for k in range(60):
        now = k * tick
        np.testing.assert_array_equal(got.slow_at(now), want.slow_at(now))
        np.testing.assert_array_equal(got.dead_at(now), want.dead_at(now))


def test_mixed_events_bitwise():
    """Every event class in one schedule, a revived device among them."""
    def events(mod):
        return [mod.LaneStraggler(lane=2, start=1.0, magnitude=2.0,
                                  ramp_s=0.0),
                mod.LaneStraggler(lane=5, start=0.5, magnitude=1.0,
                                  ramp_s=3.0),
                mod.DeviceLoss(at=2.0, lanes=(6, 7), restore_at=4.0),
                mod.DVFSDrift(start=1.5, rate_per_s=0.4, cap=1.8),
                mod.Brownout(start=0.2, period=1.1, duty=0.3,
                             slowdown=1.7, until=5.0)]
    got = tf.FaultSchedule(8, events(tf), seed=3, jitter_cv=0.2)
    want = jf.FaultSchedule(8, events(jf), seed=3, jitter_cv=0.2)
    for now in np.linspace(0.0, 6.0, 97):
        np.testing.assert_array_equal(got.slow_at(now), want.slow_at(now))
        np.testing.assert_array_equal(got.dead_at(now), want.dead_at(now))
    assert not tf.FaultSchedule(8).has_faults


@pytest.mark.parametrize("bad", ["straggler", "loss", "kind"])
def test_fault_validation(bad):
    with pytest.raises(ValueError) as got:
        if bad == "straggler":
            tf.FaultSchedule(4, [tf.LaneStraggler(lane=4, start=0.0)])
        elif bad == "loss":
            tf.FaultSchedule(4, [tf.DeviceLoss(at=0.0, lanes=(1, 9))])
        else:
            tf.scenario("meteor_strike", 8, start=0.0, horizon=1.0)
    with pytest.raises(ValueError) as want:
        if bad == "straggler":
            jf.FaultSchedule(4, [jf.LaneStraggler(lane=4, start=0.0)])
        elif bad == "loss":
            jf.FaultSchedule(4, [jf.DeviceLoss(at=0.0, lanes=(1, 9))])
        else:
            jf.scenario("meteor_strike", 8, start=0.0, horizon=1.0)
    assert str(got.value) == str(want.value)


def test_detector_equals_reference():
    """The detector on the same posterior sequence trips the same lanes
    at the same times (a lane drifting away from a noisy fleet)."""
    rng = np.random.default_rng(9)
    got, want = tf.KalmanLaneDetector(10), jf.KalmanLaneDetector(10)
    for k in range(40):
        mu = rng.normal(1.0, 0.02, 10)
        mu[3] += 0.05 * k
        std = rng.uniform(0.01, 0.05, 10)
        active = rng.random(10) < 0.9
        a = got.observe(mu, std, active, 0.1 * k)
        b = want.observe(mu, std, active, 0.1 * k)
        np.testing.assert_array_equal(a, b)
    for f in ("alarm_counts", "tripped", "first_trip_time"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.tripped[3] and got.recommendation(3) == "reshard"
    assert got.detection_latency(3, 0.0) == want.detection_latency(3, 0.0)


# --------------------------------------------------------------------- #
# The gateway against the reference                                      #
# --------------------------------------------------------------------- #
def run_pair(monkeypatch, tables, sessions, n_lanes, tick, *, inject=False,
             faults=None, max_queue="4x", **kw):
    """The reference's and the port's gateway on the same workload:
    ``(port result, reference result, recording)``."""
    jt, tt = tables
    rec = Recording(monkeypatch, inject=inject, modules=(jg, tg))
    mq = 4 * n_lanes if max_queue == "4x" else max_queue
    want = jg.SessionGateway(jt, n_lanes, tick=tick, max_queue=mq,
                             **kw).run(sessions,
                                       jw.generate_requests(sessions),
                                       faults=faults)
    tsess = convert_sessions(sessions)
    got = tg.SessionGateway(tt, n_lanes, tick=tick, max_queue=mq,
                            device=CPU, **kw).run(
        tsess, tw.generate_requests(tsess), faults=convert_faults(faults))
    return got, want, rec


def assert_gateway_follows_reference(rec, got, want):
    """``got`` equals ``want`` bitwise in every request decided before
    the first round whose picks differ, and that round's differing picks
    satisfy the pick contract.  Returns that round (None: every pick and
    every result equal)."""
    jm, jp = rec.picks("ref")
    tm, tp = rec.picks("port")
    n = min(len(jm), len(tm))
    differ = (jm[:n].astype(np.int64) != tm[:n]) | \
        (jp[:n].astype(np.int64) != tp[:n])
    rounds = np.nonzero(differ.any(axis=1))[0]
    if not len(rounds) and len(jm) == len(tm):
        assert_bitwise(got, want)
        return None
    first = int(rounds[0]) if len(rounds) else n
    for s in np.nonzero(differ[first])[0] if first < n else ():
        assert_pick_follows_contract(rec, first, int(s))
    t_first = np.unique(want.start[want.served])[first]
    decided = (want.status != tg.REJECTED_BACKPRESSURE) & \
        (want.start < t_first)
    assert np.array_equal(
        decided, (got.status != tg.REJECTED_BACKPRESSURE) &
        (got.start < t_first))
    assert_bitwise(got, want, decided)
    return first


@pytest.mark.parametrize("workload", ["golden", "overload",
                                      "overload_no_admission",
                                      "device_loss", "brownout"])
def test_gateway_follows_reference(monkeypatch, tables, workload):
    """Overloaded workloads, admission on and off, clean and faulted:
    the port follows the reference under the pick contract, and with the
    reference's picks injected every result is bitwise equal."""
    jt, _ = tables
    kw, faults = {}, None
    if workload == "golden" or workload in ("device_loss", "brownout"):
        sessions, n_lanes, dl = gateway_config(jt)
        tick = dl
        if workload != "golden":
            faults = jf.scenario(workload, n_lanes, start=4 * dl,
                                 horizon=12 * dl, seed=11, n_devices=4)
    else:
        sessions, n_lanes, tick = overload_workload(jt)
        if workload == "overload_no_admission":
            kw = dict(max_queue=None, min_feasible_latency=0.0)
    got, want, rec = run_pair(monkeypatch, tables, sessions, n_lanes, tick,
                              faults=faults, **kw)
    assert got.offered == want.offered > 100
    first = assert_gateway_follows_reference(rec, got, want)
    if workload == "golden":   # the golden workload matches outright
        assert first is None
    monkeypatch.undo()
    got, want, rec = run_pair(monkeypatch, tables, sessions, n_lanes, tick,
                              faults=faults, inject=True, **kw)
    assert_bitwise(got, want)
    assert got.select_launches == 0    # the CPU runs the plain version


def test_gateway_golden_equal(tables):
    """``golden_traces.json["gateway"]`` with ``==``, directly."""
    jt, tt = tables
    with open(GOLDEN) as f:
        want = json.load(f)["gateway"]
    sessions, n_lanes, dl = gateway_config(jt)
    tsess = convert_sessions(sessions)
    gw = tg.SessionGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                           device=CPU)
    assert summarize_gateway(gw.run(tsess, tw.generate_requests(tsess))) \
        == want
    assert gw.engine.backend == "torch"


@pytest.fixture(scope="module")
def straggler_run(tables):
    jt, tt = tables
    sessions, n_lanes, dl, faults = straggler_config(jt)
    tsess = convert_sessions(sessions)
    det = tf.KalmanLaneDetector(n_lanes)
    gw = tg.SessionGateway(tt, n_lanes, tick=dl, device=CPU)
    res = gw.run(tsess, tw.generate_requests(tsess),
                 faults=convert_faults(faults), detector=det)
    return tsess, n_lanes, dl, convert_faults(faults), res, det


def test_straggler_golden_equal(straggler_run):
    """``golden_traces.json["straggler"]`` with ``==``: only the faulted
    lane trips, at the recorded time and latency in rounds."""
    _, _, dl, _, _, det = straggler_run
    with open(GOLDEN) as f:
        g = json.load(f)["straggler"]
    assert [int(x) for x in np.nonzero(det.tripped)[0]] == \
        g["tripped_lanes"]
    lane = g["fault_lane"]
    assert float(det.first_trip_time[lane]) == g["first_trip_time_s"]
    start = g["fault_start_rounds"] * dl
    assert det.detection_latency(lane, start) / dl == \
        g["detection_latency_rounds"]
    assert det.recommendation(lane) == "reshard"


def test_detector_is_pure_observer(tables, straggler_run):
    sessions, n_lanes, dl, faults, res, _ = straggler_run
    gw = tg.SessionGateway(tables[1], n_lanes, tick=dl, device=CPU)
    assert_bitwise(gw.run(sessions, tw.generate_requests(sessions),
                          faults=faults), res)


@pytest.mark.parametrize("faulted", [False, True])
def test_detector_silent_without_lane_fault(tables, straggler_run,
                                            faulted):
    """No trip on the clean trace (the golden's zero false positives),
    and none under global DVFS drift, which ALERT absorbs (mean mu well
    above nominal)."""
    sessions, n_lanes, dl, _, _, _ = straggler_run
    fs = tf.scenario("dvfs_drift", n_lanes, start=5 * dl, horizon=40 * dl,
                     magnitude=1.0) if faulted else None
    det = tf.KalmanLaneDetector(n_lanes)
    gw = tg.SessionGateway(tables[1], n_lanes, tick=dl, device=CPU)
    gw.run(sessions, tw.generate_requests(sessions), faults=fs,
           detector=det)
    assert int(det.tripped.sum()) == 0
    assert det.recommendation(0) == "tolerate"
    if faulted:
        assert float(gw.slow.mu.mean()) > 1.5
    else:
        assert np.isnan(det.detection_latency(0, 0.0))


# --------------------------------------------------------------------- #
# The gateway on its own                                                 #
# --------------------------------------------------------------------- #
def short_trace(env, seed, n, deadline_cv=0.0):
    tr = ts.EnvironmentTrace(env, seed=seed, deadline_cv=deadline_cv)
    tr.n = n
    tr.xi, tr.lam = tr.xi[:n], tr.lam[:n]
    tr.deadline_scale = tr.deadline_scale[:n]
    return tr


def test_low_load_bitwise_equals_fleetsim_through_paging(tables):
    """6 sessions over 3 lanes at zero queueing delay: each session's
    outcomes are bitwise equal to an independent port FleetSim run, though
    its state pages in and out of recycled lanes between rounds."""
    jt, tt = tables
    dl = deadline(jt)
    tick = dl * 2.5
    sessions = []
    for sid in range(6):
        tr = short_trace(ts.ENVS["cpu"] if sid % 2 else ts.ENVS["memory"],
                         40 + sid, 25, deadline_cv=0.1)
        arrivals = (2 * np.arange(25) + (sid % 2)) * tick
        goal = tc.Goal.MINIMIZE_ENERGY if sid % 3 else \
            tc.Goal.MAXIMIZE_ACCURACY
        cons = tc.Constraints(deadline=dl, accuracy_goal=0.8) \
            if sid % 3 else tc.Constraints.from_power_budget(dl, 170.0)
        sessions.append(tw.Session(sid, "t", goal, cons, arrivals, tr))
    res = tg.SessionGateway(tt, 3, tick=tick, device=CPU).run(sessions)
    assert res.served.all()
    assert res.pages_in > 50 and res.pages_out > 50
    for s in sessions:
        fr = ts.FleetSim(tt, [s.trace], device=CPU).run_streams(
            [s.goal], [s.constraints])
        got, want = res.stream(s.sid), fr.stream(0)
        for f in ("energy", "accuracy", "latency", "missed"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f),
                                          err_msg=f"sid {s.sid} {f}")


def test_reused_gateway_is_reset_between_runs(tables):
    jt, tt = tables
    dl = deadline(jt)
    sess = [tw.Session(0, "t", tc.Goal.MINIMIZE_ENERGY,
                       tc.Constraints(deadline=dl, accuracy_goal=0.75),
                       np.arange(10) * dl,
                       short_trace(ts.ENVS["cpu"], 9, 10))]
    gw = tg.SessionGateway(tt, 2, tick=dl, device=CPU)
    a, b = gw.run(sess), gw.run(sess)
    assert_bitwise(a, b)


def test_static_policy_matches_fixed_config_delivery(tables):
    jt, tt = tables
    dl = deadline(jt)
    tr = short_trace(ts.ENVS["default"], 2, 8)
    sess = [tw.Session(0, "t", tc.Goal.MINIMIZE_ENERGY,
                       tc.Constraints(deadline=dl, accuracy_goal=0.7),
                       np.arange(8) * dl, tr)]
    res = tg.SessionGateway(tt, 2, tick=dl, device=CPU).run(
        sess, policy="static", static_config=(1, 2))
    assert res.served.all()
    assert np.all(res.model_index == 1) and np.all(res.power_index == 2)
    np.testing.assert_array_equal(
        res.stream(0).latency, np.minimum(tt.latency[1, 2] * tr.xi * tr.lam,
                                          dl))
    assert res.select_launches == 0


def test_device_loss_quarantines_lanes(monkeypatch, tables):
    """Losing the last of four devices pages its residents out, leaves
    exactly its lane group dead and changes the run."""
    jt, tt = tables
    sessions, n_lanes, dl = gateway_config(jt)
    tsess = convert_sessions(sessions)
    fs = tf.scenario("device_loss", n_lanes, start=4 * dl,
                     horizon=12 * dl, n_devices=4)
    gw = tg.SessionGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                           device=CPU)
    clean = gw.run(tsess, tw.generate_requests(tsess))
    res = gw.run(tsess, tw.generate_requests(tsess), faults=fs)
    np.testing.assert_array_equal(gw._dead, dead_lane_mask(n_lanes, 4, [3]))
    assert int(res.served.sum()) > 0
    assert not np.array_equal(clean.status, res.status) or \
        (res.pages_in, res.pages_out) != (clean.pages_in, clean.pages_out)
    empty = gw.run(tsess, tw.generate_requests(tsess),
                   faults=tf.FaultSchedule(n_lanes))
    assert_bitwise(empty, clean)


@pytest.fixture(scope="module")
def golden_port(tables):
    """The golden workload on the port: sessions and its clean run."""
    jt, tt = tables
    sessions, n_lanes, dl = gateway_config(jt)
    tsess = convert_sessions(sessions)
    ref = tg.SessionGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                            device=CPU).run(tsess,
                                            tw.generate_requests(tsess))
    return tsess, n_lanes, dl, ref


def port_gw(tables, n_lanes, dl):
    return tg.SessionGateway(tables[1], n_lanes, tick=dl,
                             max_queue=4 * n_lanes, device=CPU)


@pytest.mark.parametrize("faulted", [False, True])
def test_kill_resume_is_bitwise(tables, golden_port, tmp_path, faulted):
    """A run killed at iteration 7 (snapshots every 3) resumes from the
    atomic checkpoint and ends bitwise equal to the uninterrupted run,
    with and without a brownout schedule."""
    sessions, n_lanes, dl, ref = golden_port
    fs = tf.scenario("brownout", n_lanes, start=3 * dl, horizon=12 * dl,
                     seed=11) if faulted else None
    if faulted:
        ref = port_gw(tables, n_lanes, dl).run(
            sessions, tw.generate_requests(sessions), faults=fs)
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFailure):
        port_gw(tables, n_lanes, dl).run(
            sessions, tw.generate_requests(sessions), faults=fs,
            checkpoint_dir=ck, checkpoint_every=3, kill_at_round=7)
    assert tio.latest_step(ck) == 6
    res = port_gw(tables, n_lanes, dl).resume(
        sessions, tw.generate_requests(sessions), checkpoint_dir=ck,
        faults=fs)
    assert_bitwise(res, ref)


def test_resume_rejects_different_workload(tables, golden_port, tmp_path):
    sessions, n_lanes, dl, _ = golden_port
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFailure):
        port_gw(tables, n_lanes, dl).run(
            sessions, tw.generate_requests(sessions), checkpoint_dir=ck,
            checkpoint_every=3, kill_at_round=7)
    with pytest.raises(ValueError, match="identical workload"):
        port_gw(tables, n_lanes, dl).resume(
            sessions, tw.generate_requests(sessions)[:-5],
            checkpoint_dir=ck)


def test_reference_checkpoint_resumes_in_the_port(tables, tmp_path):
    """The reference's gateway checkpoint, written at iteration 7 of the
    golden workload, resumes in the port and ends equal to the
    reference's uninterrupted run; the port's checkpoint resumes in the
    reference likewise."""
    jt, tt = tables
    sessions, n_lanes, dl = gateway_config(jt)
    tsess = convert_sessions(sessions)

    def jgw():
        return jg.SessionGateway(jt, n_lanes, tick=dl,
                                 max_queue=4 * n_lanes)

    want = jgw().run(sessions, jw.generate_requests(sessions))
    ck = str(tmp_path / "ref")
    with pytest.raises(JInjectedFailure):
        jgw().run(sessions, jw.generate_requests(sessions),
                  checkpoint_dir=ck, checkpoint_every=7, kill_at_round=8)
    assert jio.latest_step(ck) == 7
    got = port_gw(tables, n_lanes, dl).resume(
        tsess, tw.generate_requests(tsess), checkpoint_dir=ck)
    assert_bitwise(got, want)
    ck = str(tmp_path / "port")
    with pytest.raises(InjectedFailure):
        port_gw(tables, n_lanes, dl).run(
            tsess, tw.generate_requests(tsess), checkpoint_dir=ck,
            checkpoint_every=7, kill_at_round=8)
    layout = [[(r["name"], r["path"], r["dtype"]) for r in
               jio.load_manifest(d)["leaves"]]
              for d in (ck, str(tmp_path / "ref"))]
    assert layout[0] == layout[1]
    assert_bitwise(jgw().resume(sessions, jw.generate_requests(sessions),
                                checkpoint_dir=ck), want)


# --------------------------------------------------------------------- #
# Errors                                                                 #
# --------------------------------------------------------------------- #
def one_session(dl, n=4, sid=0):
    return tw.Session(sid, "t", tc.Goal.MINIMIZE_ENERGY,
                      tc.Constraints(deadline=dl, accuracy_goal=0.7),
                      np.arange(n) * dl,
                      short_trace(ts.ENVS["default"], 3, n))


def test_duplicate_request_object_rejected(tables):
    dl = deadline(tables[0])
    sess = [one_session(dl)]
    reqs = tw.generate_requests(sess)
    with pytest.raises(ValueError, match="distinct object"):
        tg.SessionGateway(tables[1], 2, tick=dl, device=CPU).run(
            sess, reqs + [reqs[0]])


def test_page_in_underflow_raises(tables):
    dl = deadline(tables[0])
    sessions = {sid: one_session(dl, sid=sid) for sid in range(3)}
    gw = tg.SessionGateway(tables[1], 2, tick=dl, device=CPU)
    gw._busy_until[:] = 1e9          # every lane mid-service
    with pytest.raises(RuntimeError, match="page-in underflow"):
        gw._page_in([0, 1, 2], sessions, round_k=0, now=0.0)


def test_lane_count_mismatch_raises(tables):
    dl = deadline(tables[0])
    sess = [one_session(dl)]
    gw = tg.SessionGateway(tables[1], 8, tick=dl, device=CPU)
    with pytest.raises(ValueError, match="covers 9 lanes but the gateway "
                                         "has 8"):
        gw.run(sess, faults=tf.FaultSchedule(9))


@pytest.mark.parametrize("policy", ["static", "oracle"])
def test_bad_policy_raises(tables, policy):
    gw = tg.SessionGateway(tables[1], 2, device=CPU)
    with pytest.raises(ValueError, match="static_config" if policy ==
                       "static" else "oracle"):
        gw.run([], policy=policy)


def test_gateway_defaults_to_the_card(monkeypatch, tables):
    """No device means the card: without CUDA the gateway raises instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.SessionGateway(tables[1], 4)


# --------------------------------------------------------------------- #
# The gateway workloads of serving/scenarios.py (chip_smoke.py phase 31)  #
# --------------------------------------------------------------------- #
def test_smoke_workloads_are_the_reference_configs(tables):
    """The golden and straggler workloads built by the port alone are
    ``tests/make_golden_traces.py``'s, array for array, and
    ``gateway_summary`` is its ``summarize_gateway``."""
    jt, tt = tables
    want, n_lanes, dl = gateway_config(jt)
    got, n2, dl2 = scn.golden_gateway_workload(tt)
    jwant, jn, jdl, jfs = straggler_config(jt)
    sgot, sn, sdl, sfs = scn.straggler_workload(tt)
    assert (n2, dl2, sn, sdl) == (n_lanes, dl, jn, jdl)
    for a_list, b_list in ((got, want), (sgot, jwant)):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert (a.sid, a.tenant, a.goal.value) == \
                (b.sid, b.tenant, b.goal.value)
            assert dataclasses.asdict(a.constraints) == \
                dataclasses.asdict(b.constraints)
            np.testing.assert_array_equal(a.arrivals, b.arrivals)
            for f in ("xi", "lam", "deadline_scale"):
                np.testing.assert_array_equal(getattr(a.trace, f),
                                              getattr(b.trace, f))
    for now in np.arange(40) * dl:
        np.testing.assert_array_equal(sfs.slow_at(now), jfs.slow_at(now))
    res = tg.SessionGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                            device=CPU).run(got)
    assert scn.gateway_summary(res) == summarize_gateway(res)


def test_smoke_traffic_workload_is_bench_traffic(tables):
    """``traffic_sessions`` at each load is ``bench_traffic``'s: the load
    sweep's ``build_sessions`` of the scaled mix, seeded 5 + 7919 i."""
    jt, tt = tables
    dl = deadline(jt)
    base = 0.5 * (256 / dl) / 1024
    mix = [jw.TenantSpec("min-energy", jc.Goal.MINIMIZE_ENERGY,
                         jc.Constraints(deadline=dl, accuracy_goal=0.78),
                         jw.PoissonProcess(base), n_sessions=1024,
                         phases=js.CPU_ENV)]
    for li, load in enumerate(scn.TRAFFIC_LOADS[:2]):
        want = jw.build_sessions([t.scaled(load) for t in mix], 30 * dl,
                                 seed=5 + 7919 * li)
        got, dl2, cons = scn.traffic_sessions(tt, load)
        assert dl2 == dl and cons.accuracy_goal == 0.78
        assert len(got) == len(want) == 1024
        np.testing.assert_array_equal(
            np.concatenate([s.arrivals for s in got]),
            np.concatenate([s.arrivals for s in want]))


def flip_run(tt, kind):
    """A 16-lane overload run on the CPU standing in for the card, whose
    engine, from its 10th select on, changes one decision once: on an
    active relaxed Eq. 4 lane to another cell whose accuracy lies within
    2 ulp (``"near_tie"``) or further (``"arbitrary"``), or on an active
    lane that is not relaxed (``"not_relaxed"``).  Returns ``(make, run,
    result, log, flipped)``: ``make(device)`` builds a plain gateway,
    ``log`` is the run's ``chip_smoke.select_log`` and ``flipped`` the
    select the decision changed at."""
    import chip_smoke

    from repro_torch.core.batched import RELAXED_ACCURACY

    mix, dl, _ = scn.traffic_mix(tt, 64, 16, 8.0)
    sessions = tw.build_sessions(mix, 10 * dl, seed=11)
    calls, flipped = [], []

    def make(dev):
        return tg.SessionGateway(tt, 16, tick=dl / 4, max_queue=64,
                                 device=dev)

    def run(gw):
        return gw.run(sessions, tw.generate_requests(sessions))

    class Flip(tb.BatchedAlertEngine):
        def select(self, mu, sigma, phi, dvec, **kw):
            out = super().select(mu, sigma, phi, dvec, **kw)
            calls.append(None)
            if len(calls) < 10 or flipped:
                return out
            acc = self.estimate(mu, sigma, phi,
                                np.maximum(dvec - self.overhead, 1e-9)).accuracy
            relaxed = out.relaxed_code == RELAXED_ACCURACY
            for s in np.nonzero(kw["active"] & (relaxed == (
                    kind != "not_relaxed")))[0]:
                a = acc[s, out.model_index[s], out.power_index[s]]
                ulp = np.abs(acc[s] - a) / np.spacing(np.maximum(
                    np.abs(acc[s]), abs(a)))
                ulp[out.model_index[s], out.power_index[s]] = np.nan
                cells = np.argwhere(ulp <= 2 if kind == "near_tie"
                                    else ulp > 2)
                if len(cells):
                    model, power = out.model_index.copy(), \
                        out.power_index.copy()
                    model[s], power[s] = cells[0]
                    flipped.append(len(calls) - 1)
                    return dataclasses.replace(out, model_index=model,
                                               power_index=power)
            return out

    gw = make(CPU)
    gw.engine.__class__ = Flip
    with chip_smoke.select_log(gw) as log:
        got = run(gw)
    assert flipped, f"no lane to flip ({kind})"
    return make, run, got, log, flipped[0]


@pytest.mark.parametrize("kind", ["near_tie", "arbitrary", "not_relaxed"])
def test_smoke_hold_to_cpu_rule(tables, kind):
    """``chip_smoke.hold_to_cpu`` on a run whose engine changed one
    decision (:func:`flip_run`), as the card's kernel may against the
    CPU's plain version: a flip to a cell within 2 ulp of accuracy on an
    active relaxed Eq. 4 lane passes, once the CPU run with the card's
    decisions injected is bitwise equal; an arbitrary flip, or any flip on
    a lane that is not relaxed, fails."""
    import chip_smoke

    make, run, got, log, n = flip_run(tables[1], kind)
    if kind == "arbitrary":
        with pytest.raises(chip_smoke.SmokeFailure, match="pick contract"):
            chip_smoke.hold_to_cpu(make, run, got, log, "flip")
        return
    if kind == "not_relaxed":
        with pytest.raises(chip_smoke.SmokeFailure, match="relaxed"):
            chip_smoke.hold_to_cpu(make, run, got, log, "flip")
        return
    out = chip_smoke.hold_to_cpu(make, run, got, log, "flip")
    assert not out["bitwise"] and out["differing_selects"] == [n]
    assert out["differing_lanes"] == 1 and out["max_ulp"] <= 2


def test_smoke_hold_to_cpu_bitwise_run(tables):
    """A run that matches the CPU's holds with ``bitwise`` set and every
    select compared."""
    import chip_smoke

    mix, dl, _ = scn.traffic_mix(tables[1], 64, 16, 8.0)
    sessions = tw.build_sessions(mix, 10 * dl, seed=11)

    def make(dev):
        return tg.SessionGateway(tables[1], 16, tick=dl / 4, max_queue=64,
                                 device=dev)

    def run(gw):
        return gw.run(sessions, tw.generate_requests(sessions))

    got, log = chip_smoke.held_run(make(CPU), run, [])
    out = chip_smoke.hold_to_cpu(make, run, got, log, "same")
    assert out["bitwise"] and out["selects"] == got.n_rounds
    assert out["differing_selects"] == [] and out["max_ulp"] == 0.0


def test_smoke_select_log_holds_the_kernel_to_its_plain_version(tables):
    """``chip_smoke.select_log(hold_plain=True)`` fails a kernel whose
    picks differ from ``alert_select_plain``'s on the same tensors at any
    select: here one whose model pick on lane 0 is off by one from the
    5th call on."""
    import chip_smoke

    from repro_torch.kernels import alert_select as ks

    mix, dl, _ = scn.traffic_mix(tables[1], 64, 16, 8.0)
    sessions = tw.build_sessions(mix, 10 * dl, seed=11)
    gw = tg.SessionGateway(tables[1], 16, tick=dl / 4, max_queue=64,
                           device=CPU)
    calls = []

    def broken(*lanes, **kw):
        ints, f64 = ks.alert_select_packed(*lanes, **kw)
        calls.append(None)
        if len(calls) >= 5:
            ints = ints.clone()
            ints[0, 0] = (ints[0, 0] + 1) % 9
        return ints, f64

    gw.engine._kernel = types.SimpleNamespace(
        **{**vars(ks), "alert_select_packed": broken})
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="select 4: the kernel's picks differ from its "
                             "plain version's on the same cpu tensors at "
                             r"lanes \[0\]"):
        chip_smoke.held_run(gw, lambda g: g.run(
            sessions, tw.generate_requests(sessions)), [])
