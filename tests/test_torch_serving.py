"""The slice as a whole: the port's FleetAlertServer and AlertServer
against the JAX reference's, on the reduced anytime LM in float32 with the
reference's weights.

Both servers score from the same ProfileTable (numbers set here) and
both engines' ``generate`` read one stepping fake clock each, so every
latency, miss and pick is deterministic and must agree exactly.  The
realised energy reads the idle-power filter, whose state may differ from
the reference's by a few ulp (XLA may fuse a multiply-add), so energy and
the final filter state are held to rtol 1e-13.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import alert_anytime as j_cfgs
from repro.core import batched as jb
from repro.core import controller as jc
from repro.core import profiles as jpr
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.serving import alert_server as js
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import alert_anytime as t_cfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import batched as tb
from repro_torch.core import controller as tc
from repro_torch.core import profiles as tpr
from repro_torch.core.power import PowerModel
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import alert_server as ts
from repro_torch.serving.engine import ServeEngine as TServeEngine

RTOL = 1e-13
STEP = 0.01          # fake seconds per clock read
GEN_TOKENS = 4       # a complete generate reads the clock 5 times: 0.04 s
ACCS = [0.55, 0.7, 0.82]


class SteppingClock:
    """Returns 0, STEP, 2*STEP, ... on successive calls."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return (self.n - 1) * STEP


def table() -> tpr.ProfileTable:
    caps = np.array([80.0, 120.0, 160.0, 200.0])
    base = np.array([0.012, 0.026, 0.05])
    frac = np.array([0.45, 0.65, 0.85, 1.0])
    cands = [tpr.Candidate(f"level{k + 1}", 0.0, 0.0, ACCS[k], True,
                           "anytime", k + 1) for k in range(3)]
    return tpr.ProfileTable(cands, caps, base[:, None] / frac[None, :],
                            np.tile(60.0 + 140.0 * frac ** 3, (3, 1)),
                            q_fail=0.05)


def jax_table(t):
    cands = [jpr.Candidate(**dataclasses.asdict(c)) for c in t.candidates]
    return jpr.ProfileTable(cands, t.power_caps.copy(), t.latency.copy(),
                            t.run_power.copy(), q_fail=t.q_fail)


@pytest.fixture(scope="module")
def setup():
    j_cfg = j_cfgs.reduced().replace(dtype="float32")
    t_cfg = t_cfgs.reduced().replace(dtype="float32")
    j_params = jt.init_lm(jax.random.PRNGKey(1), j_cfg)
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def engines(setup):
    j_cfg, t_cfg, _, _ = setup
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=2)
    t_eng = TServeEngine(t_build(t_cfg), max_len=16, batch_size=2,
                         device="cpu")
    j_eng.generate = functools.partial(j_eng.generate, clock=SteppingClock())
    t_eng.generate = functools.partial(t_eng.generate, clock=SteppingClock())
    return j_eng, t_eng


TENANTS = [  # (goal, deadline, accuracy_goal, energy_goal)
    ("min", 0.05, 0.6, None), ("max", 0.05, None, 4.0),
    ("min", 0.025, 0.8, None), ("max", 0.035, None, 2.0),
    ("min", 0.08, 0.75, None), ("max", 0.05, None, 9.0),
]


def admit(srv, mod, goal, deadline, ag, eg):
    g = mod.Goal.MINIMIZE_ENERGY if goal == "min" \
        else mod.Goal.MAXIMIZE_ACCURACY
    return srv.admit(g, mod.Constraints(deadline=deadline, accuracy_goal=ag,
                                        energy_goal=eg))


def assert_served_equal(t_out, j_out):
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        assert (t is None) == (j is None)
        if t is None:
            continue
        for f in ("level", "power_cap", "latency", "missed", "accuracy",
                  "feasible"):
            assert getattr(t, f) == getattr(j, f), (f, t, j)
        np.testing.assert_allclose(t.energy, j.energy, rtol=RTOL, atol=0)


def fleet_pair(setup, j_obs=None, t_obs=None):
    """The reference's and the port's fleet servers over the same table,
    with the six tenants admitted, and their prompts."""
    _, _, j_params, t_params = setup
    j_eng, t_eng = engines(setup)
    kw = dict(level_accuracies=ACCS, n_streams=len(TENANTS),
              profile_iters=1, gen_tokens=GEN_TOKENS, prompt_len=4,
              start_active=False)
    j_srv = js.FleetAlertServer(j_eng, j_params,
                                goal=jc.Goal.MINIMIZE_ENERGY, obs=j_obs, **kw)
    t_srv = ts.FleetAlertServer(t_eng, t_params,
                                goal=tc.Goal.MINIMIZE_ENERGY, obs=t_obs, **kw)
    assert t_srv.scoring.backend == "torch"
    for srv, tbl, mod, eng_cls in ((j_srv, jax_table(table()), jc,
                                    jb.BatchedAlertEngine),
                                   (t_srv, table(), tc,
                                    tb.BatchedAlertEngine)):
        srv.table = tbl
        extra = {} if eng_cls is jb.BatchedAlertEngine else {"device": "cpu"}
        srv.scoring = eng_cls(tbl, srv.goal, **extra)
        for tenant in TENANTS:
            admit(srv, mod, *tenant)
    prompts = [np.random.default_rng(s).integers(0, 256, (2, 4))
               .astype(np.int32) for s in range(len(TENANTS))]
    return j_srv, t_srv, prompts


def tick_pair(j_srv, t_srv, prompts, tick):
    """Tick ``tick`` on both servers (lane 2 retired and re-admitted
    before tick 3); both answers."""
    if tick == 3:
        for srv, mod in ((j_srv, jc), (t_srv, tc)):
            srv.retire(2)
            assert admit(srv, mod, "max", 0.045, None, 3.0) == 2
    return t_srv.serve_tick(prompts), j_srv.serve_tick(prompts)


def test_fleet_server_six_ticks_match(setup):
    j_srv, t_srv, prompts = fleet_pair(setup)
    levels_seen = set()
    for tick in range(6):
        t_out, j_out = tick_pair(j_srv, t_srv, prompts, tick)
        assert_served_equal(t_out, j_out)
        levels_seen |= {o.level for o in t_out if o is not None}
    assert len(levels_seen) > 1
    assert any(o.missed for row in t_srv.history for o in row)
    for name in ("mu", "sigma"):
        np.testing.assert_allclose(getattr(t_srv.slowdown, name).numpy(),
                                   np.asarray(getattr(j_srv.slowdown, name)),
                                   rtol=RTOL, atol=0)
    np.testing.assert_allclose(t_srv.idle_power.phi.numpy(),
                               np.asarray(j_srv.idle_power.phi),
                               rtol=RTOL, atol=0)
    assert np.array_equal(t_srv.slowdown.n_updates.numpy(),
                          np.asarray(j_srv.slowdown.n_updates))


def test_fleet_server_catalog_matches_reference(setup):
    """With a recorder attached to each, the port's server counts what
    the reference's counts over the six ticks (energy within 1e-9
    relative), and a quarantine alike."""
    from repro.obs import FlightRecorder as JRecorder
    from repro_torch.obs import FlightRecorder

    j_obs, t_obs = JRecorder(), FlightRecorder()
    j_srv, t_srv, prompts = fleet_pair(setup, j_obs, t_obs)
    for tick in range(6):
        tick_pair(j_srv, t_srv, prompts, tick)
    for srv in (j_srv, t_srv):
        srv.fail_lanes([1, 4])
        srv.fail_lanes([])
    lab = dict(gateway="fleet_server")
    for name in ("requests_served", "deadline_misses", "rounds_served",
                 "quarantine_events", "lanes_quarantined"):
        assert t_obs.metrics.counter(name, **lab).value == \
            j_obs.metrics.counter(name, **lab).value, name
    assert t_obs.metrics.counter("deadline_misses", **lab).value > 0
    np.testing.assert_allclose(
        t_obs.metrics.counter("energy_served_j", **lab).value,
        j_obs.metrics.counter("energy_served_j", **lab).value,
        rtol=1e-9, atol=0)
    assert t_obs.metrics.timer("serve_tick", **lab).count == \
        j_obs.metrics.timer("serve_tick", **lab).count == 6
    quarantines = [[e["args"] for e in o.spans.events
                    if e["name"] == "quarantine"] for o in (t_obs, j_obs)]
    assert quarantines[0] == quarantines[1] == [{"lanes": [1, 4]}]


def test_fleet_server_grows_when_full(setup):
    _, _, _, t_params = setup
    _, t_eng = engines(setup)
    srv = ts.FleetAlertServer(t_eng, t_params, ACCS,
                              tc.Goal.MAXIMIZE_ACCURACY, n_streams=2,
                              profile_iters=1, gen_tokens=2, prompt_len=4)
    lane = srv.admit(constraints=tc.Constraints(deadline=1.0,
                                                energy_goal=5.0))
    assert lane == 2 and srv.n_streams == 4
    assert srv.slowdown.n_streams == 4 and srv.active.tolist() == \
        [True, True, True, False]
    srv.fail_lanes([0])
    assert srv.admit() == 3
    srv.revive_lanes([0])
    srv.retire(1)
    assert srv.admit() == 0


def test_alert_server_serve_one_matches(setup):
    _, _, j_params, t_params = setup
    j_eng, t_eng = engines(setup)
    kw = dict(profile_iters=1, gen_tokens=GEN_TOKENS, prompt_len=4)
    j_srv = js.AlertServer(j_eng, j_params, ACCS, jc.Goal.MINIMIZE_ENERGY,
                           **kw)
    t_srv = ts.AlertServer(t_eng, t_params, ACCS, tc.Goal.MINIMIZE_ENERGY,
                           **kw)
    j_srv.table, t_srv.table = jax_table(table()), table()
    j_srv.controller = jc.AlertController(j_srv.table, jc.Goal.MINIMIZE_ENERGY)
    t_srv.controller = tc.AlertController(t_srv.table,
                                          tc.Goal.MINIMIZE_ENERGY,
                                          device="cpu")
    prompt = np.random.default_rng(0).integers(0, 256, (2, 4)).astype(
        np.int32)
    for dl in (0.05, 0.03):
        t_o = t_srv.serve_one(prompt, tc.Constraints(deadline=dl,
                                                     accuracy_goal=0.7))
        j_o = j_srv.serve_one(prompt, jc.Constraints(deadline=dl,
                                                     accuracy_goal=0.7))
        assert_served_equal([t_o], [j_o])
    assert t_srv.controller.slowdown.mu == pytest.approx(
        j_srv.controller.slowdown.mu, rel=RTOL, abs=0)


class DriftingEngine:
    """A stand-in engine whose ``generate`` takes ``0.01 * level`` seconds
    plus a drift that grows by 1 ms a call, and records the levels it ran."""

    levels = [1, 2, 3]
    batch_size = 2
    model = type("M", (), {"cfg": t_cfgs.reduced()})()

    def __init__(self):
        self.calls, self.warmed = [], []

    def warmup(self, params, prompt_len):
        self.warmed.append(prompt_len)

    def generate(self, params, prompt, n_new, level=None):
        assert prompt.shape == (self.batch_size, 5) and n_new == 3
        self.calls.append(level)
        return {"latency": 0.01 * level + 1e-3 * len(self.calls)}


@pytest.mark.parametrize("rounds", [3, 6])
def test_profile_serve_table_interleaves_levels(rounds):
    """ALERT's table is profiled round by round with the level order
    turned each round, after one warm-up call per level, so a drift that
    grows over the profile falls on every level alike: the profiled steps
    between levels are the engine's own 10 ms."""
    eng = DriftingEngine()
    got = ts.serve_level_latencies(eng, None, rounds, prompt_len=5,
                                   gen_tokens=3)
    assert eng.warmed == [5] and got.shape == (3, rounds)
    order = [1, 2, 3] + [eng.levels[(i + r) % 3] for r in range(rounds)
                         for i in range(3)]
    assert eng.calls == order
    eng = DriftingEngine()
    tbl = ts.profile_serve_table(eng, None, ACCS, PowerModel(),
                                 profile_iters=rounds, prompt_len=5,
                                 gen_tokens=3)
    full = tbl.latency[:, -1]
    np.testing.assert_allclose(np.diff(full), [0.01, 0.01], rtol=1e-9)
    np.testing.assert_allclose(full, got.mean(axis=1), rtol=0, atol=0)
