"""The port's flight recorder (``repro_torch.obs``) against the
reference's (``repro.obs``) on the CPU, and its pure-observer contract on
both port gateways.

The registry, the span tracer and the ring are host Python in both
packages: the same calls must leave the same snapshots.  The ring's
per-round sums (``round_aggregates``) are computed on tensors in the port
and on jax arrays in the reference: counts exact, energy within 1e-12
relative.  On the serving path every result of a bare, a disabled and a
fully instrumented run is bitwise equal, the goldens hold with ``==``
while instrumented, and the rings of the two port gateways and of the
reference's gateway agree.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.obs import FlightRecorder as JRecorder
from repro.obs import metrics as jmetrics
from repro.obs.ring import round_aggregates as j_round_aggregates
from repro.traffic import gateway as jg
from repro.traffic import generate_requests as j_generate_requests
from repro_torch.obs import (FlightRecorder, MetricsRegistry, SpanTracer,
                             TelemetryRing, validate_jsonl)
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.report import main, render_recorder, render_run_dir
from repro_torch.obs.ring import round_aggregates
from repro_torch.traffic import faults as tf
from repro_torch.traffic import gateway as tg
from repro_torch.traffic import workloads as tw
from repro_torch.traffic.megatick import MegatickGateway
from tests.make_golden_traces import (gateway_config, straggler_config,
                                      summarize_gateway)
from tests.test_torch_traffic import (convert_faults, convert_sessions,
                                      tables)  # noqa: F401 (fixture)

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_traces.json")
RESULT_FIELDS = ("status", "start", "latency", "sojourn", "missed",
                 "accuracy", "energy", "model_index", "power_index")
GATEWAYS = {"host": tg.SessionGateway, "megatick": MegatickGateway}


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def workload(tables):
    jt, _ = tables
    sessions, n_lanes, dl = gateway_config(jt)
    return sessions, convert_sessions(sessions), n_lanes, dl


def make(kind, tt, n_lanes, dl, obs=None, **kw):
    extra = dict(chunk=8) if kind == "megatick" else {}
    return GATEWAYS[kind](tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                          device=CPU, obs=obs, **extra, **kw)


def assert_results_bitwise(a, b, ctx=""):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{ctx}:{f}")
    assert (a.n_rounds, a.pages_in, a.pages_out) == \
        (b.n_rounds, b.pages_in, b.pages_out), ctx


def timeless(snapshot):
    """A registry snapshot without its wall times."""
    return [{k: v for k, v in m.items()
             if not (m["type"] == "timer" and k.endswith("_s"))}
            for m in snapshot]


# --------------------------------------------------------------------- #
# Host-only instruments: the same calls, the same state                  #
# --------------------------------------------------------------------- #
def drive_registry(reg):
    c = reg.counter("served", gateway="host")
    c.inc(3)
    assert reg.counter("served", gateway="host") is c
    reg.counter("served", gateway="megatick").inc()
    reg.gauge("rate").set(0.25)
    h = reg.histogram("depth")
    h.observe_many([5.0, 1.0, 3.0])
    h.observe(7.0)
    reg.timer("plan").observe(0.5)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("served", gateway="host")
    return reg.snapshot()


def test_registry_snapshot_equals_reference():
    assert drive_registry(MetricsRegistry()) == \
        drive_registry(jmetrics.MetricsRegistry())


@pytest.mark.parametrize("mod", [tmetrics, jmetrics])
def test_histogram_bounded_sample(monkeypatch, mod):
    monkeypatch.setattr(mod, "HISTOGRAM_SAMPLE_CAP", 4)
    h = mod.Histogram()
    h.observe_many([5.0, 1.0, 3.0])
    h.observe(7.0)
    h.observe_many([9.0, 11.0])
    s = h.snapshot()
    assert s["count"] == 6 and s["sum"] == 36.0
    assert s["min"] == 1.0 and s["max"] == 11.0
    assert s["dropped_observations"] == 2
    assert s["p50"] == pytest.approx(4.0)


def test_timer_accumulates():
    t = tmetrics.PhaseTimer()
    t.observe(0.5)
    t.observe(0.25)
    with t.time():
        pass
    assert t.count == 3 and t.total_s == pytest.approx(0.75, abs=0.2)
    assert t.min_s <= t.last_s <= 0.2


def test_registry_save_load(tmp_path):
    reg = MetricsRegistry()
    drive_registry(reg)
    p = str(tmp_path / "m.json")
    reg.save(p)
    assert MetricsRegistry.load_snapshot(p) == reg.snapshot()


def test_spans_schema_exporters_and_drops(tmp_path):
    tr = SpanTracer(capacity=3)
    with tr.span("plan", rounds=3):
        pass
    with tr.span("plan"):
        pass
    tr.event("trip", lane=4)
    tr.event("dropped")
    assert tr.phase_totals()["plan"]["count"] == 2
    assert len(tr) == 3 and tr.dropped == 1
    p = str(tmp_path / "spans.jsonl")
    tr.write_jsonl(p)
    assert validate_jsonl(p) == 3
    c = str(tmp_path / "trace.json")
    tr.write_chrome_trace(c)
    with open(c) as f:
        evs = json.load(f)["traceEvents"]
    assert [e["ph"] for e in evs] == ["X", "X", "i"]
    with open(p) as f:
        lines = f.readlines()
    rec = json.loads(lines[1])
    rec["ph"] = "Z"
    with open(p, "w") as f:
        f.writelines([lines[0], json.dumps(rec) + "\n"])
    with pytest.raises(ValueError, match="bad ph"):
        validate_jsonl(p)


def push(ring, vals):
    n = len(vals)
    ring.push_rounds(now_s=vals, n_active=vals, n_feasible=vals,
                     n_relaxed=np.zeros(n), energy_j=vals,
                     n_missed=np.zeros(n))


@pytest.mark.parametrize("pushes", [[[1.0, 2.0, 3.0]],
                                    [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]],
                                    [list(np.arange(10.0))]])
def test_ring_equals_reference(tmp_path, pushes):
    from repro.obs.ring import TelemetryRing as JRing

    mine, ref = TelemetryRing(4), JRing(4)
    for vals in pushes:
        push(mine, vals)
        push(ref, vals)
    for f, v in ref.view().items():
        np.testing.assert_array_equal(mine.view()[f], v)
    assert mine.summary() == ref.summary()
    p = str(tmp_path / "ring.json")
    mine.save(p)
    assert TelemetryRing.load(p)["summary"] == ref.summary()
    with pytest.raises(ValueError, match="length mismatch"):
        mine.push_rounds(now_s=[1.0], n_active=[1.0, 2.0],
                         n_feasible=[1.0], n_relaxed=[0.0],
                         energy_j=[1.0], n_missed=[0.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_aggregates_against_reference(seed):
    """Counts exact, energy within 1e-12 relative, on the same lanes."""
    import jax.numpy as jnp
    from jax.experimental import enable_x64

    rng = np.random.default_rng(seed)
    n = 257
    act = rng.random(n) < 0.7
    feas = rng.random(n) < 0.6
    relaxed = rng.integers(0, 3, n).astype(np.int32)
    energy = rng.uniform(0.0, 5.0, n)
    missed = rng.random(n) < 0.2
    got = round_aggregates(*(torch.from_numpy(a) for a in
                             (act, feas, relaxed, energy, missed)))
    with enable_x64():
        want = [float(x) for x in j_round_aggregates(
            *(jnp.asarray(a) for a in (act, feas, relaxed, energy,
                                       missed)))]
    got = [float(x) for x in got]
    assert got[:3] == want[:3] and got[4] == want[4]
    assert got[3] == pytest.approx(want[3], rel=1e-12)
    assert all(x.dtype == torch.float64 for x in round_aggregates(
        *(torch.from_numpy(a) for a in (act, feas, relaxed, energy,
                                        missed))))


# --------------------------------------------------------------------- #
# The pure-observer contract on both port gateways                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", list(GATEWAYS))
def test_gateway_golden_with_full_instrumentation(tables, workload, golden,
                                                  kind):
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    obs = FlightRecorder()
    got = summarize_gateway(make(kind, tt, n_lanes, dl, obs).run(
        sessions, tw.generate_requests(sessions)))
    assert got == golden["gateway"]
    assert obs.ring.n_seen == got["n_rounds"]
    assert len(obs.metrics) > 0


def test_straggler_golden_with_full_instrumentation(tables, golden):
    jt, tt = tables
    sessions, n_lanes, dl, faults = straggler_config(jt)
    sessions = convert_sessions(sessions)
    obs = FlightRecorder()
    det = tf.KalmanLaneDetector(n_lanes, obs=obs)
    tg.SessionGateway(tt, n_lanes, tick=dl, device=CPU, obs=obs).run(
        sessions, tw.generate_requests(sessions),
        faults=convert_faults(faults), detector=det)
    want = golden["straggler"]
    assert [int(x) for x in np.nonzero(det.tripped)[0]] == \
        want["tripped_lanes"]
    assert float(det.first_trip_time[want["fault_lane"]]) == \
        want["first_trip_time_s"]
    n_trips = len(want["tripped_lanes"])
    assert obs.metrics.counter("detector_trips").value == n_trips
    assert obs.metrics.counter("fault_trips", gateway="host").value == \
        n_trips
    assert len([e for e in obs.spans.events
                if e["name"] in ("detector_trip", "fault_trip")]) == \
        2 * n_trips


@pytest.mark.parametrize("kind", list(GATEWAYS))
def test_bitwise_neutral_bare_disabled_instrumented(tables, workload, kind):
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    runs = {name: make(kind, tt, n_lanes, dl, obs).run(
        sessions, tw.generate_requests(sessions))
        for name, obs in (("bare", None),
                          ("disabled", FlightRecorder(enabled=False)),
                          ("instrumented", FlightRecorder()))}
    assert_results_bitwise(runs["bare"], runs["disabled"], "disabled")
    assert_results_bitwise(runs["bare"], runs["instrumented"],
                           "instrumented")


@pytest.mark.parametrize("kind", list(GATEWAYS))
@pytest.mark.parametrize("fault", ["device_loss", "brownout"])
def test_neutral_under_faults(tables, workload, kind, fault):
    """Instrumented runs under a fault schedule equal the bare run; the
    device loss shows up as one quarantine event."""
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    fs = tf.scenario(fault, n_lanes, start=4 * dl, horizon=12 * dl,
                     seed=11, n_devices=4)
    bare = make(kind, tt, n_lanes, dl).run(
        sessions, tw.generate_requests(sessions), faults=fs)
    obs = FlightRecorder()
    seen = make(kind, tt, n_lanes, dl, obs).run(
        sessions, tw.generate_requests(sessions), faults=fs)
    assert_results_bitwise(bare, seen, fault)
    events = [e for e in obs.spans.events if e["name"] == "quarantine"]
    assert len(events) == (1 if fault == "device_loss" else 0)


@pytest.mark.parametrize("kind", list(GATEWAYS))
def test_ring_reconciles_with_result(tables, workload, kind):
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    obs = FlightRecorder()
    res = make(kind, tt, n_lanes, dl, obs).run(
        sessions, tw.generate_requests(sessions))
    s = obs.ring.summary()
    assert s["rounds_seen"] == res.n_rounds
    assert s["lane_rounds_active"] == int(res.served.sum())
    assert s["missed"] == int(res.missed[res.served].sum())
    assert s["energy_j"] == pytest.approx(
        float(res.energy[res.served].sum()), rel=1e-12)


def test_port_rings_agree_with_each_other_and_the_reference(tables,
                                                            workload):
    """Same workload, three instrumented runs (the reference's host
    gateway and both port gateways): the same per-round counts; energy
    within 1e-12 relative."""
    jt, tt = tables
    jsessions, sessions, n_lanes, dl = workload
    jobs = JRecorder()
    jg.SessionGateway(jt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                      obs=jobs).run(jsessions,
                                    j_generate_requests(jsessions))
    want = jobs.ring.view()
    for kind in GATEWAYS:
        obs = FlightRecorder()
        make(kind, tt, n_lanes, dl, obs).run(
            sessions, tw.generate_requests(sessions))
        got = obs.ring.view()
        for f in ("now_s", "n_active", "n_feasible", "n_relaxed",
                  "n_missed"):
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"{kind} {f}")
        np.testing.assert_allclose(got["energy_j"], want["energy_j"],
                                   rtol=1e-12)


def test_metric_catalog_equals_reference(tables, workload):
    """The host gateway's counters, gauges and histograms (names, labels
    and values) equal the reference's on the golden workload, but for the
    compile gauges (the reference counts its jit caches, the port's host
    gateway compiles nothing while it runs)."""
    jt, tt = tables
    jsessions, sessions, n_lanes, dl = workload
    jobs = JRecorder()
    jg.SessionGateway(jt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                      obs=jobs).run(jsessions,
                                    j_generate_requests(jsessions))
    obs = FlightRecorder()
    make("host", tt, n_lanes, dl, obs).run(sessions,
                                           tw.generate_requests(sessions))
    mine = {(m["name"], json.dumps(m["labels"], sort_keys=True)): m
            for m in timeless(obs.metrics.snapshot())}
    ref = {(m["name"], json.dumps(m["labels"], sort_keys=True)): m
           for m in timeless(jobs.metrics.snapshot())}
    assert set(mine) == set(ref)
    for key, m in ref.items():
        if m["name"].startswith("n_compiles"):
            assert mine[key]["value"] == 0.0
        elif m["name"] == "kalman_innovation":
            # |z - mu|: the reference's Kalman steps may round an FMA.
            assert mine[key]["count"] == m["count"]
            assert mine[key]["sum"] == pytest.approx(m["sum"], rel=1e-12)
        else:
            assert mine[key] == m, key


def test_phase_timers_accumulate_across_runs(tables, workload):
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    gw = make("megatick", tt, n_lanes, dl)
    assert gw.last_plan_s == 0.0 and gw.last_scan_s == 0.0
    gw.run(sessions, tw.generate_requests(sessions))
    p1, s1 = gw.total_plan_s, gw.total_scan_s
    assert p1 > 0.0 and s1 > 0.0
    gw.run(sessions, tw.generate_requests(sessions))
    assert gw.total_plan_s > p1 and gw.total_scan_s > s1
    assert gw._plan_timer.count == 2
    obs = FlightRecorder()
    make("megatick", tt, n_lanes, dl, obs).run(
        sessions, tw.generate_requests(sessions))
    assert obs.metrics.timer("megatick_plan", gateway="megatick").count == 1


def test_queue_paging_and_innovation_metrics(tables, workload):
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    obs = FlightRecorder()
    res = make("host", tt, n_lanes, dl, obs).run(
        sessions, tw.generate_requests(sessions))
    m = obs.metrics
    lab = dict(gateway="host", policy="alert")
    assert m.counter("requests_offered", **lab).value == res.offered
    assert m.counter("requests_served", **lab).value == \
        int(res.served.sum())
    assert m.counter("pages_in", **lab).value == res.pages_in
    assert m.counter("queue_submitted").value > 0
    assert m.histogram("queue_depth", gateway="host").count > 0
    assert m.histogram("kalman_innovation", gateway="host").count == \
        int(res.served.sum())
    names = {e["name"] for e in obs.spans.events}
    assert {"serve_round", "page_in"} <= names


def test_checkpoint_spans(tables, workload, tmp_path):
    """``checkpoint_write`` while the run writes, ``checkpoint_restore``
    when it resumes; the resumed result equals the uninterrupted one."""
    from repro_torch.runtime.ft import InjectedFailure

    _, tt = tables
    _, sessions, n_lanes, dl = workload
    want = make("host", tt, n_lanes, dl).run(
        sessions, tw.generate_requests(sessions))
    obs = FlightRecorder()
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFailure):
        make("host", tt, n_lanes, dl, obs).run(
            sessions, tw.generate_requests(sessions), checkpoint_dir=ck,
            checkpoint_every=2, kill_at_round=6)
    got = make("host", tt, n_lanes, dl, obs).resume(
        sessions, tw.generate_requests(sessions), checkpoint_dir=ck)
    assert_results_bitwise(got, want, "resumed")
    totals = obs.spans.phase_totals()
    assert totals["checkpoint_write"]["count"] >= 3
    assert totals["checkpoint_restore"]["count"] == 1


def test_disabled_recorder_records_nothing(tables, workload):
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    for kind in GATEWAYS:
        obs = FlightRecorder(enabled=False)
        make(kind, tt, n_lanes, dl, obs).run(
            sessions, tw.generate_requests(sessions))
        assert len(obs.metrics) == 0 and len(obs.spans) == 0
        assert obs.ring.n_seen == 0


# --------------------------------------------------------------------- #
# The recording on disk and the report                                   #
# --------------------------------------------------------------------- #
def recorded(tables, workload):
    _, tt = tables
    _, sessions, n_lanes, dl = workload
    obs = FlightRecorder()
    make("megatick", tt, n_lanes, dl, obs).run(
        sessions, tw.generate_requests(sessions))
    return obs


def test_save_validates_and_renders(tables, workload, tmp_path):
    obs = recorded(tables, workload)
    paths = obs.save(str(tmp_path / "run"))
    assert validate_jsonl(paths["spans"]) == len(obs.spans)
    for text in (render_recorder(obs, trace_paths=paths),
                 render_run_dir(str(tmp_path / "run"))):
        assert "== metrics ==" in text and "== host phases ==" in text
        assert "telemetry ring" in text and "megatick_plan" in text


def test_report_cli(tables, workload, tmp_path, capsys):
    recorded(tables, workload).save(str(tmp_path / "run"))
    assert main([str(tmp_path / "run")]) == 0
    assert "flight recording" in capsys.readouterr().out
    assert main([]) == 2
    assert main([str(tmp_path / "nope")]) == 2


# --------------------------------------------------------------------- #
# Span ids, parents, requests and profiler ranges                        #
# --------------------------------------------------------------------- #
def test_spans_carry_ids_parents_and_requests(tmp_path):
    tr = SpanTracer()
    with tr.span("tick") as targs:
        tr.event("trip")
        with tr.span("input", request="0:3"):
            with tr.span("generate") as gargs:
                gargs["made"] = 2
            tr.event("capture")
        targs["live"] = 1
    with tr.span("tick"):
        pass
    ev = tr.events
    assert [e["name"] for e in ev] == ["trip", "generate", "capture",
                                        "input", "tick", "tick"]
    assert len({e["id"] for e in ev}) == len(ev)
    tick, inp, gen = ev[4], ev[3], ev[1]
    assert tick["parent"] is None and ev[5]["parent"] is None
    assert ev[0]["parent"] == inp["parent"] == tick["id"]
    assert gen["parent"] == ev[2]["parent"] == inp["id"]
    assert gen["args"] == {"request": "0:3", "made": 2}
    assert ev[2]["args"] == {"request": "0:3"}
    assert tick["args"] == {"live": 1} and ev[0]["args"] == {}
    assert tr.tree_totals("tick", 2) == tr.phase_totals()
    last = tr.tree_totals("tick", 1)
    assert list(last) == ["tick"] and last["tick"]["count"] == 1
    assert last["tick"]["total_s"] == ev[5]["dur_us"] * 1e-6
    assert tr.tree_totals("tick", 3) is None
    assert tr.tree_totals("input", 1).keys() == {"input", "generate"}
    p = str(tmp_path / "spans.jsonl")
    tr.write_jsonl(p)
    assert validate_jsonl(p) == 6
    with open(p) as f:
        meta = json.loads(f.readline())["_meta"]
    assert meta["version"] == 2 and meta["t0_unix_ns"] == tr.t0_unix_ns
    c = str(tmp_path / "trace.json")
    tr.write_chrome_trace(c)
    with open(c) as f:
        doc = json.load(f)
    assert doc["otherData"]["t0_unix_ns"] == tr.t0_unix_ns
    assert doc["traceEvents"][1]["args"]["parent"] == inp["id"]


def _rewrite(path, edit_meta=None, edit_rec=None):
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    if edit_meta:
        edit_meta(lines[0]["_meta"])
    if edit_rec:
        edit_rec(lines[1:])
    with open(path, "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)


@pytest.mark.parametrize("fault,dropped,match", [
    ("dangling", 0, "dangling parent"),
    ("dangling", 1, None),
    ("repeated", 0, "repeated id"),
    ("version1", 0, "header"),
])
def test_validate_jsonl_v2_rejects(tmp_path, fault, dropped, match):
    tr = SpanTracer()
    with tr.span("a"):
        with tr.span("b"):
            pass
    p = str(tmp_path / "s.jsonl")
    tr.write_jsonl(p)

    def recs(rs):
        if fault == "dangling":
            rs[0]["parent"] = 99
        elif fault == "repeated":
            rs[1]["id"] = rs[0]["id"]

    def meta(m):
        m["dropped"] = dropped
        if fault == "version1":
            m["version"] = 1

    _rewrite(p, meta, recs)
    if match is None:
        assert validate_jsonl(p) == 2
    else:
        with pytest.raises(ValueError, match=match):
            validate_jsonl(p)


def test_spans_are_profiler_ranges_only_while_it_records():
    tr = SpanTracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner"):
                torch.ones(2).sum()
    with tr.span("after"):
        pass
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("alert.")]
    assert sorted(names) == ["alert.inner", "alert.outer"]
    assert len(tr) == 3


def _ticks(tr, n):
    """``n`` ticks of a ``tick`` span over two ``step`` spans."""
    for _ in range(n):
        with tr.span("tick"):
            for _ in range(2):
                with tr.span("step"):
                    pass


@pytest.mark.parametrize("evict", [False, True])
def test_full_tracer_drops_new_or_evicts_old(tmp_path, evict):
    """Past its capacity a tracer drops new records (counted), or, when
    it evicts, forgets its oldest quarter and keeps the newest; either
    way what it writes validates, with no dangling parent."""
    tr = SpanTracer(capacity=8, evict=evict)
    _ticks(tr, 4)                          # 12 records into 8 slots
    assert len(tr) <= 8
    if evict:
        assert tr.dropped == 0 and tr.evicted == 4
        assert [e["name"] for e in tr.events] == \
            ["step", "tick"] + ["step", "step", "tick"] * 2
    else:
        assert tr.evicted == 0 and tr.dropped == 4
        assert [e["name"] for e in tr.events] == \
            ["step", "step", "tick"] * 2 + ["step", "step"]
    p = str(tmp_path / "s.jsonl")
    tr.write_jsonl(p)
    assert validate_jsonl(p) == len(tr)
    with open(p) as f:
        meta = json.loads(f.readline())["_meta"]
    assert (meta["dropped"], meta["evicted"]) == (tr.dropped, tr.evicted)


def test_evicting_tracer_totals_only_whole_ticks():
    """After an eviction the oldest kept tick may have lost its steps:
    ``tree_totals`` counts only the ticks after it, and keeps giving the
    newest ticks however long the tracer runs."""
    tr = SpanTracer(capacity=8, evict=True)
    _ticks(tr, 2)
    assert tr.tree_totals("tick", 2)["step"]["count"] == 4
    _ticks(tr, 2)          # evicts the first tick and a step of the second
    assert tr.evicted == 4
    assert [e["name"] for e in tr.events].count("tick") == 3
    assert tr.tree_totals("tick", 3) is None
    two = tr.tree_totals("tick", 2)
    assert two["tick"]["count"] == 2 and two["step"]["count"] == 4
    for _ in range(50):
        _ticks(tr, 1)
        newest = [e for e in tr.events if e["name"] == "tick"][-1]
        assert tr.tree_totals("tick", 1)["tick"]["total_s"] == \
            newest["dur_us"] * 1e-6
    assert tr.evicted > 0 and tr.dropped == 0


def test_last_s_is_the_span_that_ended_last():
    tr = SpanTracer()
    with tr.span("outer"):
        with tr.span("inner"):
            pass
        assert tr.last_s == tr.events[-1]["dur_us"] * 1e-6
    assert tr.last_s == tr.events[-1]["dur_us"] * 1e-6
    assert tr.events[-1]["name"] == "outer"


def test_process_recorder_evicts():
    from repro_torch.obs import PROCESS_RECORDER
    assert PROCESS_RECORDER.spans.evict
    assert not FlightRecorder().spans.evict
