"""The lane-sharded decision plane: the port's lane mesh, its engine,
banks and fleet server under ``mesh=`` against ``mesh=None`` and against
the JAX package, restores onto other meshes, the dry run and the scalar
reference (``test_torch_sharded.py`` holds the fleet paths end to end).

Meshes of 1 to 8 shards lie on the CPU (``make_lane_mesh(n,
device="cpu")``, the port's counterpart of the reference's faked host
devices), so every shard runs the same per-shard code a card would run.
The decision grid has no cross-lane op, so every sharded result is held
to the unsharded one with ``==``; against the reference the pick contract
of ``test_torch_alert_select.py`` applies where the scoring engine is
compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.controller_bench import random_state, random_table
from repro.core import batched as jb
from repro.core import controller as jc
from repro.core.reference import ScalarReferenceController as JScalarRef
from repro.launch.mesh import make_lane_mesh as j_make_lane_mesh
from repro_torch.checkpoint import io as tio
from repro_torch.core import batched as tb
from repro_torch.core import controller as tc
from repro_torch.core import kalman as tk
from repro_torch.core.reference import ScalarReferenceController
from repro_torch.kernels import alert_select as ks
from repro_torch.launch import mesh as tm
from repro_torch.launch.fleet_dryrun import run_fleet_dryrun
from repro_torch.runtime import elastic
from tests.test_torch_alert_select import (assert_pick_contract, fleet_state,
                                           jax_table, select,
                                           within_2ulp_accuracy)
from tests.test_torch_sim import port_table

CPU = torch.device("cpu")
FIELDS = ("model_index", "power_index", "predicted_latency",
          "predicted_accuracy", "predicted_energy", "feasible",
          "relaxed_code")


def cpu_mesh(n):
    return tm.make_lane_mesh(n, device="cpu")


def assert_batches_equal(got, want, lanes=slice(None)):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[lanes],
                                      getattr(want, f)[lanes], f)


# --------------------------------------------------------------------- #
# launch/mesh.py                                                         #
# --------------------------------------------------------------------- #
def test_lane_mesh_layout_and_refusals():
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis_names == (tm.LANE_AXIS,)
    assert mesh.devices == (CPU,) * 4 and mesh.home == CPU
    assert mesh.blocks(12) == [(0, 3), (3, 6), (6, 9), (9, 12)]
    np.testing.assert_array_equal(
        np.repeat(np.arange(4), 3), elastic.lane_groups(12, 4))
    with pytest.raises(ValueError, match="pad with dead lanes"):
        mesh.blocks(10)
    assert mesh == cpu_mesh(4) and mesh != cpu_mesh(2)
    with pytest.raises(ValueError, match="1-D mesh"):
        tm.LaneMesh([CPU], axis_names=("data", "model"))
    with pytest.raises(ValueError, match="1-D mesh"):
        tm.lane_shardings(tm.make_host_mesh(1, devices=[CPU]))
    assert tm.lane_pspec(mesh) == ("lanes",)
    assert elastic.remesh_lanes(mesh.devices[:2]) == cpu_mesh(2)


def test_lane_shard_map_runs_once_a_shard_on_block_views():
    """Each shard sees a view of its block (a storage offset, no copy) and
    its output lands in its block; LaneShards inputs pass their parts."""
    mesh = cpu_mesh(4)
    x = torch.arange(16, dtype=torch.float64)
    y = mesh.split(torch.arange(16, 32, dtype=torch.float64))
    seen = []

    def fn(a, b):
        seen.append((a.storage_offset(), a.data_ptr() - x.data_ptr()))
        return torch.stack([a, b]), torch.stack([a + b])

    packed, total = tm.lane_shard_map(fn, mesh, n_in=2, n_out=2,
                                      out_axis=1)(x, y)
    assert [o for o, _ in seen] == [0, 4, 8, 12]
    assert [d for _, d in seen] == [0, 32, 64, 96]    # views of x
    assert packed.shape == (2, 16) and torch.equal(packed[0], x)
    assert torch.equal(total[0], x + torch.arange(16, 32.0))
    sums, = tm.lane_shard_map(lambda a: a * 2, mesh, n_in=1, n_out=1)(x)
    assert torch.equal(sums, 2 * x)
    with pytest.raises(TypeError, match="expected 2 inputs"):
        tm.lane_shard_map(fn, mesh, n_in=2, n_out=2)(x)
    with pytest.raises(TypeError, match="expected 3"):
        tm.lane_shard_map(fn, mesh, n_in=2, n_out=3)(x, y)


def test_lane_shards_gather_and_placements():
    mesh = cpu_mesh(4)
    host = np.arange(24.0).reshape(8, 3)
    sh = mesh.split(host)
    assert sh.shape == (8, 3) and sh.dtype == torch.float64
    assert [p.shape for p in sh.parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(np.asarray(sh), host)
    np.testing.assert_array_equal(tm.take_lanes(sh, [7, 0, 5]),
                                  host[[7, 0, 5]])
    put = tm.put_lanes(sh, [1, 6], 9.0)
    want = host.copy()
    want[[1, 6]] = 9.0
    np.testing.assert_array_equal(put.numpy(), want)
    assert put.parts[1] is sh.parts[1]          # untouched shards stay
    lane, rep = tm.lane_shardings(mesh)
    np.testing.assert_array_equal(lane.place(sh).numpy(), host)
    copies = rep.place(host)
    assert len(copies) == 4 and all(torch.equal(c, torch.from_numpy(host))
                                    for c in copies)
    with pytest.raises(ValueError, match="sharded over"):
        cpu_mesh(2).split(sh)


@pytest.mark.parametrize("mp,n,shape", [(1, 1, (1, 1)), (2, 1, (1, 1)),
                                        (2, 4, (2, 2)), (3, 4, (4, 1)),
                                        (8, 4, (1, 4))])
def test_make_host_mesh_shrinks_like_the_reference(mp, n, shape):
    mesh = tm.make_host_mesh(mp, devices=[CPU] * n)
    assert mesh.shape == shape and mesh.size == n
    assert mesh.axis_names == ("data", "model")


# --------------------------------------------------------------------- #
# The engine                                                             #
# --------------------------------------------------------------------- #
def engine_state(s, seed):
    """``fleet_state`` (dead lanes holding NaN/inf garbage) with two live
    NaN lanes of each goal."""
    st = fleet_state(tb_table(), s, seed)
    live = np.nonzero(st["active"])[0][:4]
    st["mu"][live] = np.nan
    st["goal_kind"][live] = [0, 1, 0, 1]
    return st


def tb_table():
    from repro_torch.core import profiles as tpr

    return tpr.synthetic_table(0)


def padded(st, s_all):
    """``st`` padded with always-dead lanes to ``s_all``."""
    out = {}
    for k, v in st.items():
        fill = np.zeros(s_all - v.shape[0], dtype=v.dtype)
        out[k] = np.concatenate([v, fill])
    return out


@pytest.fixture(scope="module")
def jax_selects():
    """The JAX engine on its own one-device lane mesh, once per case."""
    cache = {}

    def get(s, kind, predictions):
        key = (s, kind, predictions)
        if key not in cache:
            st = engine_state(s, seed=s)
            goal = {"hetero": None, "min": jc.Goal.MINIMIZE_ENERGY,
                    "max": jc.Goal.MAXIMIZE_ACCURACY}[kind]
            eng = jb.BatchedAlertEngine(jax_table(tb_table()), goal,
                                        overhead=0.001,
                                        mesh=j_make_lane_mesh(1))
            cache[key] = (eng, run_select(eng, st, kind, predictions))
        return cache[key]

    return get


def run_select(eng, st, kind, predictions):
    if kind == "hetero":
        return select(eng, st, predictions)
    kw = {"accuracy_goal": st["accuracy_goal"]} if kind == "min" \
        else {"energy_goal": st["energy_goal"]}
    return eng.select(st["mu"], st["sigma"], st["phi"], st["deadline"],
                      predictions=predictions, **kw)


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("kind,predictions", [("hetero", True),
                                              ("hetero", False),
                                              ("min", True),
                                              ("max", False)])
def test_sharded_engine_equals_unsharded_and_reference(jax_selects, n, s,
                                                       kind, predictions):
    goal = {"hetero": None, "min": tc.Goal.MINIMIZE_ENERGY,
            "max": tc.Goal.MAXIMIZE_ACCURACY}[kind]
    st = engine_state(s, seed=s)
    one = tb.BatchedAlertEngine(tb_table(), goal, overhead=0.001,
                                device="cpu")
    shard = tb.BatchedAlertEngine(tb_table(), goal, overhead=0.001,
                                  mesh=cpu_mesh(n))
    want = run_select(one, st, kind, predictions)
    s_all = s + (-s) % n
    if kind != "hetero" and s_all != s:
        with pytest.raises(ValueError, match="pad with dead lanes"):
            run_select(shard, st, kind, predictions)
        return
    if s_all != s:
        with pytest.raises(ValueError, match="divisible"):
            run_select(shard, st, kind, predictions)
    launches = ks.alert_select.launches
    got = run_select(shard, padded(st, s_all), kind, predictions)
    assert ks.alert_select.launches == launches   # the CPU runs no kernel
    assert_batches_equal(got, want, slice(0, s))
    assert not got.feasible[s:].any() and not got.model_index[s:].any()
    j_eng, ref = jax_selects(s, kind, predictions)
    active = st["active"] if kind == "hetero" else np.ones(s, bool)
    diff = assert_pick_contract(
        dataclasses.replace(got, **{f: getattr(got, f)[:s]
                                    for f in FIELDS}), ref, active,
        predictions)
    within_2ulp_accuracy(j_eng, st, diff, want, ref)


def test_select_step_impl_sharded_equals_unsharded():
    st = engine_state(96, seed=3)
    args = [torch.as_tensor(st[k]) for k in (
        "mu", "sigma", "phi", "deadline", "accuracy_goal", "energy_goal",
        "goal_kind", "active")]
    want = tb.BatchedAlertEngine(tb_table(), None, device="cpu") \
        .select_step_impl()(*args)
    got = tb.BatchedAlertEngine(tb_table(), None, mesh=cpu_mesh(4)) \
        .select_step_impl()(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_engine_device_must_be_the_mesh_home():
    with pytest.raises(ValueError, match="home"):
        tb.BatchedAlertEngine(tb_table(), None, mesh=cpu_mesh(2),
                              device="meta")


# --------------------------------------------------------------------- #
# The banks                                                              #
# --------------------------------------------------------------------- #
def bank_feed(rng, s):
    return dict(obs=rng.uniform(0.01, 1.0, s), prof=rng.uniform(0.01, 1.0, s),
                miss=rng.random(s) < 0.2, m=rng.random(s) < 0.9,
                ip=rng.uniform(10, 50, s), ap=rng.uniform(60, 200, s))


def observe(slow, idle, f):
    tk.observe_fleet(slow, idle, f["obs"], f["prof"],
                     deadline_missed=f["miss"], idle_power=f["ip"],
                     active_power=f["ap"], mask=f["m"])


def bank_state(slow, idle):
    out = {name: np.asarray(getattr(slow, name).cpu())
           for name in slow._state_names + ("n_updates",)}
    out.update({"idle." + name: np.asarray(getattr(idle, name).cpu())
                for name in idle._state_names + ("n_updates",)})
    return out


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_filter_banks_equal_unsharded(n):
    """observe_fleet, the banks' own observe, reset_lanes, grow (in mesh
    multiples), export/import round trips and shrink: bitwise."""
    s = 24
    rng = np.random.default_rng(n)
    host = (tk.SlowdownFilterBank(s, device="cpu"),
            tk.IdlePowerFilterBank(s, device="cpu"))
    mesh = cpu_mesh(n)
    shard = (tk.SlowdownFilterBank(s, mesh=mesh),
             tk.IdlePowerFilterBank(s, mesh=mesh))
    assert isinstance(shard[0].mu, tm.LaneShards)
    assert [p.shape[0] for p in shard[0].mu.parts] == [s // n] * n
    for t in range(8):
        f = bank_feed(rng, shard[0].n_streams)
        for slow, idle in (host, shard):
            if t == 2:
                slow.observe(f["obs"], f["prof"], f["miss"], f["m"])
                idle.observe(f["ip"], f["ap"], f["m"])
            else:
                observe(slow, idle, f)
            if t == 3:
                slow.reset_lanes([2, 5, s - 1])
                idle.reset_lanes([0, 7])
            if t == 4:
                slow.grow(2 * s)
                idle.grow(2 * s)
            if t == 5:
                lanes = [s + 1, 3, 17]
                snap = (slow.export_lanes(lanes), idle.export_lanes(lanes))
                slow.import_lanes([9, 0, 30], snap[0])
                idle.import_lanes([9, 0, 30], snap[1])
        a, b = bank_state(*host), bank_state(*shard)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], f"{t} {key}")
    np.testing.assert_array_equal(np.asarray(shard[0].std.cpu()),
                                  host[0].std.numpy())
    for slow in (host[0], shard[0]):
        slow.shrink(s)
    np.testing.assert_array_equal(shard[0].mu.numpy(), host[0].mu.numpy())


def test_bank_capacity_multiple_and_mesh_checks():
    mesh = cpu_mesh(8)
    for make in (lambda: tk.SlowdownFilterBank(12, mesh=mesh),
                 lambda: tk.IdlePowerFilterBank(12, mesh=mesh),
                 lambda: tb.WindowedGoalBank(0.8, 12, mesh=mesh)):
        with pytest.raises(ValueError, match="multiple"):
            make()
    slow = tk.SlowdownFilterBank(8, mesh=mesh)
    goal = tb.WindowedGoalBank(0.8, 8, mesh=mesh)
    for bank in (slow, goal):
        with pytest.raises(ValueError, match="multiple"):
            bank.grow(12)
    with pytest.raises(ValueError, match="same mesh"):
        tk.observe_fleet(slow, tk.IdlePowerFilterBank(8, mesh=cpu_mesh(4)),
                         np.ones(8), np.ones(8), idle_power=np.ones(8),
                         active_power=np.ones(8))


@pytest.mark.parametrize("window", [1, 5])
def test_sharded_goal_bank_equals_reference_host_bank(window):
    """The reference's sharded goal bank fails on jax 0.9, so the port's
    sharded bank is held to the reference's host bank: bitwise goals,
    windows and paging snapshots."""
    s = 16
    rng = np.random.default_rng(2)
    ref = jb.WindowedGoalBank(0.8, s, window=window)
    got = tb.WindowedGoalBank(0.8, s, window=window, mesh=cpu_mesh(4))
    for t in range(10):
        acc = rng.uniform(0.4, 1.0, s)
        m = rng.random(s) < 0.85
        ref.record(acc, mask=m)
        got.record(acc, mask=m)
        if t == 3:
            ref.reset_lanes([1, 4], goal=[0.9, 0.6])
            got.reset_lanes([1, 4], goal=[0.9, 0.6])
        if t == 5:
            goals = np.where(rng.random(s) < 0.3, 0.7, 0.8)
            ref.set_goals(goals)
            got.set_goals(goals)
        if t == 6:
            snap = ref.export_lanes([2, 9])
            mine = got.export_lanes([2, 9])
            for k in snap:
                np.testing.assert_array_equal(mine[k], snap[k], k)
            ref.import_lanes([11, 0], snap)
            got.import_lanes([11, 0], snap)
        cur = got.current_goal()
        assert isinstance(cur, tm.LaneShards)
        np.testing.assert_array_equal(cur.numpy(), ref.current_goal())
    ref.grow(24, goal_fill=0.5)
    got.grow(24, goal_fill=0.5)
    np.testing.assert_array_equal(got.current_goal().numpy(),
                                  ref.current_goal())


# --------------------------------------------------------------------- #
# FleetAlertServer                                                       #
# --------------------------------------------------------------------- #
def dense_configs():
    from repro.configs.base import ModelConfig as JConfig
    from repro_torch.configs.base import ModelConfig as TConfig

    kw = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=4, head_dim=8, d_ff=64, vocab=64, nest_levels=2,
              dtype="float32", attn_chunk=32)
    return JConfig(**kw), TConfig(**kw)


def two_level_table():
    from repro_torch.core import profiles as tpr

    caps = np.array([80.0, 120.0, 160.0, 200.0])
    frac = np.array([0.45, 0.65, 0.85, 1.0])
    cands = [tpr.Candidate(f"level{k + 1}", 0.0, 0.0, acc, True, "anytime",
                           k + 1) for k, acc in enumerate((0.6, 0.9))]
    lat = np.array([0.02, 0.05])[:, None] / frac[None, :]
    return tpr.ProfileTable(cands, caps, lat,
                            np.tile(60.0 + 140.0 * frac ** 3, (2, 1)),
                            q_fail=0.05)


def test_sharded_fleet_server_grows_in_mesh_multiples():
    """The reference's 8-device server case on an 8-shard CPU mesh,
    served tick for tick against the reference server with ``mesh=None``
    (its sharded case fails on jax 0.9): 3 streams become 8 lanes, churn
    reuses lane 1, every live stream is served, nothing is built."""
    import functools

    import jax
    from repro.models.registry import build_model as j_build
    from repro.serving import alert_server as jsrv
    from repro.serving.engine import ServeEngine as JServeEngine
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels.build import loaded
    from repro_torch.models.registry import build_model as t_build
    from repro_torch.serving import alert_server as tsrv
    from repro_torch.serving.engine import ServeEngine as TServeEngine
    from tests.test_torch_serving import SteppingClock, assert_served_equal
    from tests.test_torch_serving import jax_table as serve_jax_table

    j_cfg, t_cfg = dense_configs()
    j_model = j_build(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    j_eng = JServeEngine(j_model, max_len=32, batch_size=2)
    t_eng = TServeEngine(t_build(t_cfg), max_len=32, batch_size=2,
                         device="cpu")
    j_eng.generate = functools.partial(j_eng.generate, clock=SteppingClock())
    t_eng.generate = functools.partial(t_eng.generate, clock=SteppingClock())
    mesh = cpu_mesh(8)
    kw = dict(level_accuracies=[0.6, 0.9], goal=None, n_streams=3,
              profile_iters=1, gen_tokens=3, prompt_len=4)
    kw_j, kw_t = dict(kw, goal=jc.Goal.MAXIMIZE_ACCURACY), \
        dict(kw, goal=tc.Goal.MAXIMIZE_ACCURACY)
    j_srv = jsrv.FleetAlertServer(j_eng, j_params, **kw_j)
    t_srv = tsrv.FleetAlertServer(t_eng, t_params, mesh=mesh, **kw_t)
    assert t_srv.n_streams == 8 and not t_srv.active[3:].any()
    assert t_srv.slowdown.n_streams == 8
    # One two-level ProfileTable for both servers.
    tbl = two_level_table()
    j_srv.table = serve_jax_table(tbl)
    j_srv.scoring = jb.BatchedAlertEngine(j_srv.table, j_srv.goal)
    t_srv.table = tbl
    t_srv.scoring = tb.BatchedAlertEngine(tbl, t_srv.goal, mesh=mesh)
    prompt = np.zeros((2, 4), np.int32)
    budget = float(np.median(tbl.run_power)) * \
        float(np.max(tbl.latency)) * 2.0
    j_c = jc.Constraints(deadline=10.0, energy_goal=budget)
    t_c = tc.Constraints(deadline=10.0, energy_goal=budget)
    built, compiles = loaded(), t_eng.n_compiles()
    t_out = t_srv.serve_tick([prompt] * 8, [t_c] * 8)
    assert_served_equal(t_out[:3], j_srv.serve_tick([prompt] * 3,
                                                    [j_c] * 3))
    assert sum(o is not None for o in t_out) == 3
    for srv, mod in ((j_srv, jc), (t_srv, tc)):
        srv.retire(1)
        assert srv.admit(goal=mod.Goal.MINIMIZE_ENERGY) == 1
    j_min = jc.Constraints(deadline=10.0, accuracy_goal=0.7,
                           energy_goal=budget)
    t_min = tc.Constraints(deadline=10.0, accuracy_goal=0.7,
                           energy_goal=budget)
    t_out = t_srv.serve_tick([prompt] * 8, [t_c, t_min, t_c] + [t_c] * 5)
    assert_served_equal(t_out[:3], j_srv.serve_tick([prompt] * 3,
                                                    [j_c, j_min, j_c]))
    assert t_out[1] is not None and t_out[3:] == [None] * 5
    assert loaded() == built and t_eng.n_compiles() == compiles
    for _ in range(5):
        t_srv.admit()
    assert t_srv.n_streams == 8
    t_srv.admit()
    assert t_srv.n_streams == 16
    assert t_srv.slowdown.mu.mesh == mesh
    assert [p.shape[0] for p in t_srv.slowdown.mu.parts] == [2] * 8


# --------------------------------------------------------------------- #
# Elastic restore and the dry run                                        #
# --------------------------------------------------------------------- #
def test_restore_onto_other_meshes_is_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    lanes = rng.standard_normal(32)
    buf = rng.standard_normal((32, 3))
    counts = rng.integers(0, 9, 32)
    table = rng.standard_normal((4, 5))
    saved = {"lanes": cpu_mesh(8).split(lanes), "buf": buf,
             "counts": torch.as_tensor(counts), "table": table}
    tio.save(str(tmp_path / "ck"), saved, step=3)
    like = {"lanes": np.zeros(32), "buf": np.zeros((32, 3)),
            "counts": torch.zeros(32, dtype=torch.int64),
            "table": np.zeros((4, 5))}
    for n in (8, 4, 1):
        lane, rep = tm.lane_shardings(cpu_mesh(n))
        tree, step = tio.restore(str(tmp_path / "ck"), like, shardings={
            "lanes": lane, "buf": lane, "counts": lane, "table": rep})
        assert step == 3
        for key, want in (("lanes", lanes), ("buf", buf),
                          ("counts", counts)):
            assert isinstance(tree[key], tm.LaneShards)
            assert len(tree[key].parts) == n
            np.testing.assert_array_equal(tree[key].numpy(), want)
        assert len(tree["table"]) == n
        for copy in tree["table"]:
            np.testing.assert_array_equal(copy.numpy(), table)
    tree, _ = tio.restore(str(tmp_path / "ck"),
                          dict(like, lanes=cpu_mesh(2).split(np.zeros(32))),
                          shardings=dict.fromkeys(like, CPU))
    np.testing.assert_array_equal(tree["lanes"].numpy(), lanes)
    tree, _ = tio.restore(str(tmp_path / "ck"),
                          dict(like, lanes=cpu_mesh(2).split(np.zeros(32))))
    assert tree["lanes"].mesh == cpu_mesh(2)


def test_reshard_state_places_by_rule():
    state = {"a": np.arange(8.0), "b": [np.ones(4), np.zeros((4, 2))],
             "c": None}
    mesh = cpu_mesh(4)
    spec = tm.lane_pspec(mesh)
    out = elastic.reshard_state(
        state, mesh, lambda path, leaf: spec if path[0] == "a" else ())
    assert isinstance(out["a"], tm.LaneShards)
    np.testing.assert_array_equal(out["a"].numpy(), state["a"])
    assert isinstance(out["b"], list) and len(out["b"][1]) == 4
    assert out["c"] is None


def test_fleet_dryrun_on_four_cpu_shards():
    rec = run_fleet_dryrun(256, 3, 16, n_devices=4, device="cpu")
    assert rec["picks_match_single_device"]
    assert rec["builds_flat_under_churn"]
    assert rec["n_devices"] == 4 and rec["n_streams"] == 256
    assert rec["state_sharding"]["blocks"][1] == [64, 128]
    assert rec["decisions_per_sec"] > 0


# --------------------------------------------------------------------- #
# The scalar reference controller                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_reference_equals_jax_reference(seed):
    """Decision for decision, bitwise, over a seeded feedback loop on
    random profiles: the same NumPy/scipy arithmetic on both sides."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        jt = random_table(rng)
        tt = port_table(jt)
        med_lat = float(np.median(jt.latency))
        med_en = float(np.median(jt.run_power)) * med_lat
        for jg, tgl in ((jc.Goal.MINIMIZE_ENERGY, tc.Goal.MINIMIZE_ENERGY),
                        (jc.Goal.MAXIMIZE_ACCURACY,
                         tc.Goal.MAXIMIZE_ACCURACY)):
            overhead = float(rng.uniform(0, 0.1) * med_lat)
            ref = JScalarRef(jt, jg, overhead=overhead)
            got = ScalarReferenceController(tt, tgl, overhead=overhead)
            for _ in range(40):
                dl = float(rng.uniform(0.2, 3.0) * med_lat)
                kw = {"accuracy_goal": float(rng.uniform(0.3, 1.05))} \
                    if jg is jc.Goal.MINIMIZE_ENERGY else \
                    {"energy_goal": float(rng.uniform(0.0, 2.5) * med_en)}
                a = ref.select(jc.Constraints(deadline=dl, **kw))
                b = got.select(tc.Constraints(deadline=dl, **kw))
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
                lat = float(rng.lognormal(0.0, 0.3)) * \
                    float(jt.latency[a.model_index, a.power_index])
                fb = dict(deadline_missed=lat > dl,
                          idle_power=float(rng.uniform(10, 60)),
                          delivered_accuracy=float(rng.uniform(0.3, 1.0)))
                ref.observe(lat, **fb)
                got.observe(lat, **fb)
            assert got.slowdown.mu == ref.slowdown.mu
            assert got.idle_power.phi == ref.idle_power.phi


@pytest.mark.parametrize("goal", ["MINIMIZE_ENERGY", "MAXIMIZE_ACCURACY"])
def test_engine_matches_port_scalar_reference(goal):
    """The port's engine against the port's scalar reference, as the
    reference's ``test_random_sweep_decisions_identical`` holds its
    pair: identical picks, feasibility and relaxation, estimates within
    1e-12."""
    rng = np.random.default_rng(42)
    tgl = getattr(tc.Goal, goal)
    for _ in range(8):
        tt = port_table(random_table(rng))
        med_lat = float(np.median(tt.latency))
        med_en = float(np.median(tt.run_power)) * med_lat
        overhead = float(rng.uniform(0, 0.1) * med_lat)
        engine = tb.BatchedAlertEngine(tt, tgl, overhead=overhead,
                                       mesh=cpu_mesh(4))
        s = 12
        mus, sds, phis = random_state(rng, s)
        deadlines = rng.uniform(0.2, 3.0, s) * med_lat
        goals = rng.uniform(0.3, 1.05, s) if goal == "MINIMIZE_ENERGY" \
            else rng.uniform(0.0, 2.5, s) * med_en
        key = "accuracy_goal" if goal == "MINIMIZE_ENERGY" \
            else "energy_goal"
        batch = engine.select(mus, sds, phis, deadlines, **{key: goals})
        est = engine.estimate(mus, sds, phis,
                              np.maximum(deadlines - overhead, 1e-9))
        for i in range(s):
            ref = ScalarReferenceController(tt, tgl, overhead=overhead)
            ref.slowdown.mu, ref.slowdown.sigma = float(mus[i]), \
                float(sds[i])
            ref.idle_power.phi = float(phis[i])
            d = ref.select(tc.Constraints(deadline=float(deadlines[i]),
                                          **{key: float(goals[i])}))
            assert d.model_index == int(batch.model_index[i])
            assert d.power_index == int(batch.power_index[i])
            assert d.feasible == bool(batch.feasible[i])
            assert d.relaxed == tb.RELAXED_NAMES[int(batch.relaxed_code[i])]
            e = ref.estimate(max(float(deadlines[i]) - overhead, 1e-9))
            np.testing.assert_allclose(est.accuracy[i], e.accuracy, rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(est.energy[i], e.energy, rtol=1e-12,
                                       atol=1e-12)
