"""The fleet server's and the engine's spans on the CPU (the port's
``FleetAlertServer(obs=)`` / ``ServeEngine(obs=)``).

The server of ``test_torch_serving.py`` (reduced anytime LM in float32,
fixed profile table, a stepping fake clock in ``generate``) serves its six
ticks bare, with ``FlightRecorder(enabled=False)``, with a recorder
attached and bare under the CPU profiler: every served input, pick, token
and the final filter and goal state must be bitwise equal.  Each tick is
one span tree (``serve_tick`` over ``select``, one ``input`` a live lane
holding the engine's ``generate`` with its ``upload``, ``step`` and
``token`` spans, and ``feedback``); under the profiler each span is one
``alert.<name>`` range nested as the spans are; the process recorder
keeps nothing unless the profiler records; and the benchmark's two span
metric files, loaded by path, read back the spans' own sums.
"""

import collections
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import batched as tb
from repro_torch.core import controller as tc
from repro_torch.obs import PROCESS_RECORDER, FlightRecorder
from repro_torch.serving import alert_server as ts
from tests.test_torch_serving import (ACCS, GEN_TOKENS, TENANTS,  # noqa: F401
                                      admit, engines, setup, table)

TICKS = 6


def serve(setup, obs=None, profile=False):  # noqa: F811
    """Six ticks of the test server (a retire and admit before tick 3);
    what it answered, picked, generated and left in its banks, and the
    profiler when ``profile``."""
    t_params = setup[3]
    _, t_eng = engines(setup)
    srv = ts.FleetAlertServer(t_eng, t_params, goal=tc.Goal.MINIMIZE_ENERGY,
                              level_accuracies=ACCS, n_streams=len(TENANTS),
                              profile_iters=1, gen_tokens=GEN_TOKENS,
                              prompt_len=4, start_active=False, obs=obs)
    srv.table = table()
    srv.scoring = tb.BatchedAlertEngine(srv.table, srv.goal, device="cpu")
    for tenant in TENANTS:
        admit(srv, tc, *tenant)
    picks, tokens = [], []
    gen, sel = srv.engine.generate, srv.scoring.select

    def generate(*a, **k):
        r = gen(*a, **k)
        tokens.append(r["tokens"])
        return r

    def select(*a, **k):
        d = sel(*a, **k)
        picks.append((d.model_index.copy(), d.power_index.copy()))
        return d

    srv.engine.generate, srv.scoring.select = generate, select
    prompts = [np.random.default_rng(s).integers(0, 256, (2, 4))
               .astype(np.int32) for s in range(len(TENANTS))]
    prof = None
    if profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        prof.__enter__()
    try:
        for tick in range(TICKS):
            if tick == 3:
                srv.retire(2)
                admit(srv, tc, "max", 0.045, None, 3.0)
            srv.serve_tick(prompts)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    state = {k: getattr(bank, k).clone() for bank, k in
             ((srv.slowdown, "mu"), (srv.slowdown, "sigma"),
              (srv.slowdown, "gain"), (srv.slowdown, "n_updates"),
              (srv.idle_power, "phi"), (srv.idle_power, "variance"))}
    goal = srv._goal_bank.export_lanes(np.arange(srv.n_streams))
    return dict(history=srv.history, picks=picks, tokens=tokens,
                state=state, goal=goal, prof=prof)


@pytest.fixture(scope="module")
def runs(setup):  # noqa: F811
    before = len(PROCESS_RECORDER.spans)
    out = {"bare": serve(setup),
           "disabled": serve(setup, FlightRecorder(enabled=False))}
    out["process_before"] = (before, len(PROCESS_RECORDER.spans))
    obs = FlightRecorder()
    out["attached"] = serve(setup, obs)
    out["attached"]["obs"] = obs
    out["process_mark"] = len(PROCESS_RECORDER.spans)
    out["profiled"] = serve(setup, profile=True)
    return out


@pytest.mark.parametrize("variant", ["disabled", "attached", "profiled"])
def test_server_is_a_pure_observer(runs, variant):
    a, b = runs["bare"], runs[variant]
    assert a["history"] == b["history"]
    assert len(a["picks"]) == len(b["picks"]) == TICKS
    for (ma, pa), (mb, pb) in zip(a["picks"], b["picks"]):
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(pa, pb)
    assert len(a["tokens"]) == len(b["tokens"])
    for x, y in zip(a["tokens"], b["tokens"]):
        np.testing.assert_array_equal(x, y)
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    for k, v in a["goal"].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(b["goal"][k]), err_msg=k)


def test_process_recorder_empty_without_profiler(runs):
    before, after = runs["process_before"]
    assert after == before
    assert runs["process_mark"] == before


def tick_trees(events):
    """{serve_tick record: [its children in start order]} and the
    children of every record by id."""
    kids = collections.defaultdict(list)
    for e in events:
        kids[e["parent"]].append(e)
    for v in kids.values():
        v.sort(key=lambda e: e["ts_us"])
    ticks = [e for e in events if e["name"] == "serve_tick"]
    return ticks, kids


def check_tree(ticks, kids, history):
    assert [t["args"]["tick"] for t in ticks] == list(range(TICKS))
    for t, outs in zip(ticks, history):
        assert t["parent"] is None and "request" not in t["args"]
        live = [s for s, o in enumerate(outs) if o is not None]
        assert t["args"]["live"] == len(live)
        names = [c["name"] for c in kids[t["id"]]]
        assert names == ["select"] + ["input"] * len(live) + ["feedback"]
        for c in kids[t["id"]]:
            if c["name"] != "input":
                assert kids[c["id"]] == [] and "request" not in c["args"]
        inputs = [c for c in kids[t["id"]] if c["name"] == "input"]
        for s, inp in zip(live, inputs):
            req = f"{t['args']['tick']}:{s}"
            assert inp["args"] == dict(lane=s, level=outs[s].level,
                                       request=req)
            (gen,) = kids[inp["id"]]
            assert gen["name"] == "generate"
            assert gen["args"]["request"] == req
            n = gen["args"]["tokens_made"]     # a deadline may cut it
            assert 1 <= n <= gen["args"]["tokens_wanted"] == GEN_TOKENS
            steps = kids[gen["id"]]
            assert [c["name"] for c in steps] == \
                ["upload"] + ["step", "token"] * n
            assert [c["args"]["stage"] for c in steps
                    if c["name"] == "step"] == \
                ["prefill"] + ["decode"] * (n - 1)
            for c in steps:
                assert c["args"]["request"] == req and kids[c["id"]] == []
                assert inp["ts_us"] <= c["ts_us"] and \
                    c["ts_us"] + c["dur_us"] <= inp["ts_us"] + inp["dur_us"]


def test_each_tick_is_one_span_tree(runs):
    obs = runs["attached"]["obs"]
    events = obs.spans.events
    ids = [e["id"] for e in events]
    assert len(ids) == len(set(ids))
    assert all(e["parent"] is None or e["parent"] in set(ids)
               for e in events)
    ticks, kids = tick_trees(events)
    check_tree(ticks, kids, runs["attached"]["history"])
    # The profile's generate calls are roots of their own.
    assert {e["name"] for e in kids[None]} == {"serve_tick", "generate"}


def test_profiled_ticks_record_into_the_process_recorder(runs):
    events = PROCESS_RECORDER.spans.events[runs["process_mark"]:]
    ticks, kids = tick_trees(events)
    check_tree(ticks, kids, runs["profiled"]["history"])


def test_each_span_is_one_profiler_range_nested_alike(runs):
    """One ``alert.<name>`` range a span, the k-th range of a name the
    k-th span of it, each child's range inside its parent's."""
    spans = PROCESS_RECORDER.spans.events[runs["process_mark"]:]
    ranges = collections.defaultdict(list)
    for e in runs["profiled"]["prof"].profiler.kineto_results.events():
        if e.name().startswith("alert."):
            ranges[e.name()[len("alert."):]].append(
                (e.start_ns(), e.end_ns()))
    by_name = collections.defaultdict(list)
    for e in spans:
        by_name[e["name"]].append(e)
    assert set(ranges) == set(by_name)
    where = {}
    for name, recs in by_name.items():
        assert len(ranges[name]) == len(recs), name
        for rec, rng in zip(sorted(recs, key=lambda e: e["ts_us"]),
                            sorted(ranges[name])):
            where[rec["id"]] = rng
    for e in spans:
        if e["parent"] is not None:
            (s, t), (ps, pt) = where[e["id"]], where[e["parent"]]
            assert ps <= s and t <= pt, e["name"]


def test_catalog_counts_the_ticks(runs):
    obs = runs["attached"]["obs"]
    served = [o for row in runs["attached"]["history"] for o in row
              if o is not None]
    m, lab = obs.metrics, dict(gateway="fleet_server")
    assert m.counter("requests_served", **lab).value == len(served)
    assert m.counter("deadline_misses", **lab).value == \
        sum(o.missed for o in served)
    assert m.counter("rounds_served", **lab).value == TICKS
    timer = m.timer("serve_tick", **lab)
    assert timer.count == TICKS
    # The timer reads the span's own duration.
    spans = [e["dur_us"] * 1e-6 for e in obs.spans.events
             if e["name"] == "serve_tick"]
    assert timer.total_s == pytest.approx(sum(spans), rel=1e-12)
    assert timer.last_s == spans[-1] and timer.max_s == max(spans)
    np.testing.assert_allclose(m.counter("energy_served_j", **lab).value,
                               sum(o.energy for o in served), rtol=1e-12)
    # Eager steps capture no graph.
    assert m.counter("graph_captures").value == 0
    assert not [e for e in obs.spans.events
                if e["name"] == "graph_capture"]


def subtree_sums(events, n):
    """Seconds by name under the last ``n`` serve_tick spans, walked here
    apart from the recorder's own helper."""
    ticks = [e for e in events if e["name"] == "serve_tick"][-n:]
    keep, out = {e["id"] for e in ticks}, collections.Counter()
    for e in sorted(events, key=lambda e: e["ts_us"]):
        if e["id"] in keep or e["parent"] in keep:
            keep.add(e["id"])
            out[e["name"]] += e["dur_us"] * 1e-6
    return out


METRICS = pathlib.Path(__file__).resolve().parents[1] / "perfbench" \
    / "metrics"


def read_metric(name, run):
    """The benchmark's metric file ``name``, loaded by its path, read on
    ``run``."""
    spec = importlib.util.spec_from_file_location(f"_metric_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def test_span_metrics_read_the_process_recorder(runs):
    run = types.SimpleNamespace(mix={"trace_ticks": 4})
    sums = subtree_sums(PROCESS_RECORDER.spans.events, 4)
    want = 100.0 * (sums["select"] + sums["feedback"]) / sums["serve_tick"]
    assert read_metric("controller_share", run) == pytest.approx(want,
                                                                 rel=1e-12)
    want = 100.0 * sums["step"] / sums["generate"]
    assert read_metric("launch_share", run) == pytest.approx(want,
                                                             rel=1e-12)
    run.mix["trace_ticks"] = len(PROCESS_RECORDER.spans) + 1
    assert read_metric("controller_share", run) is None
    assert read_metric("launch_share", run) is None

