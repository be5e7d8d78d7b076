"""The lane-sharded decision plane end to end: FleetSim, the session
gateway and the megatick under ``mesh=`` against ``mesh=None``, the
checked-in goldens and the JAX package (``test_torch_mesh.py`` holds the
mesh, the engine, the banks and the fleet server).

Every mesh lies on the CPU (``make_lane_mesh(n, device="cpu")``), so each
shard runs the per-shard code a card runs; every sharded result is held
to the unsharded one with ``==``.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from benchmarks.common import deadline_range, family_table
from repro.core import controller as jc
from repro.launch.mesh import make_lane_mesh as j_make_lane_mesh
from repro.serving import sim as js
from repro_torch.core import controller as tc
from repro_torch.launch import mesh as tm
from repro_torch.runtime import elastic
from repro_torch.runtime.ft import InjectedFailure
from repro_torch.serving import sim as ts
from repro_torch.traffic import gateway as tg
from repro_torch.traffic import workloads as tw
from repro_torch.traffic.megatick import MegatickGateway
from tests.make_golden_traces import gateway_config
from tests.test_torch_megatick import overload_sessions
from tests.test_torch_sim import port_table
from tests.test_torch_traffic import (GOLDEN, assert_bitwise,
                                      convert_sessions)

CPU = torch.device("cpu")


def cpu_mesh(n):
    return tm.make_lane_mesh(n, device="cpu")


# --------------------------------------------------------------------- #
# FleetSim and run_fleet                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("env", ["default", "cpu", "memory"])
def test_sharded_fleetsim_reproduces_golden_traces(env):
    """S=1 padded to 8 lanes over 8 shards: the checked-in golden numbers
    with ``==``, as the unsharded run gives them."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    jt = family_table("image")
    cons = tc.Constraints.from_power_budget(
        float(deadline_range(jt, 3)[1]), golden["budget_w"])
    trace = ts.EnvironmentTrace(ts.ENVS[env], seed=golden["seed"])
    fleet = ts.FleetSim(port_table(jt), [trace], device=CPU)
    res = fleet.run_alert(tc.Goal.MAXIMIZE_ACCURACY, cons,
                          mesh=cpu_mesh(8)).stream(0)
    want = golden["envs"][env]["alert"]
    assert res.mean_energy == want["mean_energy"]
    assert res.mean_error == want["mean_error"]
    assert res.miss_rate == want["miss_rate"]
    assert fleet.engine.mesh.size == 8


def fleet_specs(mod_sim, mod_ctl, table, dl):
    specs = []
    for s in range(3):
        tr = mod_sim.EnvironmentTrace(
            (mod_sim.Phase(25), mod_sim.Phase(25, slowdown=1.5)),
            seed=40 + s, deadline_cv=0.1)
        goal, cons = (
            (mod_ctl.Goal.MINIMIZE_ENERGY,
             mod_ctl.Constraints(deadline=dl, accuracy_goal=0.8))
            if s % 2 else
            (mod_ctl.Goal.MAXIMIZE_ACCURACY,
             mod_ctl.Constraints.from_power_budget(dl, 170.0)))
        specs.append(mod_sim.StreamSpec(trace=tr, goal=goal,
                                        constraints=cons, arrival=5 * s))
    return specs


def test_run_fleet_three_streams_equals_reference_mesh():
    """The reference's 3-stream ``run_fleet`` case: every shard count
    equals the unsharded port and the reference on its lane mesh."""
    jt = family_table("image")
    dl = float(deadline_range(jt, 3)[1])
    want = js.run_fleet(jt, fleet_specs(js, jc, jt, dl),
                        mesh=j_make_lane_mesh(1))
    tt = port_table(jt)
    one = ts.run_fleet(tt, fleet_specs(ts, tc, tt, dl), device=CPU)
    for n in (2, 4):
        got = ts.run_fleet(tt, fleet_specs(ts, tc, tt, dl),
                           mesh=cpu_mesh(n))
        for f in ("energy", "accuracy", "latency", "missed"):
            np.testing.assert_array_equal(getattr(got, f), getattr(one, f))
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          f)


# --------------------------------------------------------------------- #
# Elastic restore: the gateway and the megatick                          #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def golden_gateway():
    jt = family_table("image")
    sessions, n_lanes, dl = gateway_config(jt)
    tsess = convert_sessions(sessions)
    tt = port_table(jt)
    ref = tg.SessionGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                            device=CPU).run(tsess,
                                            tw.generate_requests(tsess))
    return tt, tsess, n_lanes, dl, ref


def test_gateway_killed_on_4_shards_resumes_on_2_and_none(golden_gateway,
                                                          tmp_path):
    tt, sessions, n_lanes, dl, ref = golden_gateway

    def gw(mesh):
        kw = {"mesh": mesh} if mesh is not None else {"device": CPU}
        return tg.SessionGateway(tt, n_lanes, tick=dl,
                                 max_queue=4 * n_lanes, **kw)

    four = cpu_mesh(4)
    assert_bitwise(gw(four).run(sessions, tw.generate_requests(sessions)),
                   ref)
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFailure):
        gw(four).run(sessions, tw.generate_requests(sessions),
                     checkpoint_dir=ck, checkpoint_every=3, kill_at_round=7)
    for k, mesh in enumerate((elastic.remesh_lanes(four.devices[:2]),
                              None)):
        # A resumed run checkpoints as it goes: each resumes from its own
        # copy of the killed run's checkpoint.
        mine = str(tmp_path / f"ck{k}")
        shutil.copytree(ck, mine)
        g = gw(mesh)
        res = g.resume(sessions, tw.generate_requests(sessions),
                       checkpoint_dir=mine)
        assert_bitwise(res, ref)
        if mesh is not None:
            assert g.slow.mu.mesh == mesh


def test_sharded_megatick_equals_unsharded_and_host_gateway():
    jt = family_table("image")
    tt = port_table(jt)
    n_lanes = 16
    sessions, dl = overload_sessions(jt, 2.0, n_lanes=n_lanes)
    host = tg.SessionGateway(tt, n_lanes, tick=dl, max_queue=4 * n_lanes,
                             device=CPU).run(
        sessions, tw.generate_requests(sessions))
    kw = dict(tick=dl, max_queue=4 * n_lanes, chunk=32)
    one = MegatickGateway(tt, n_lanes, device=CPU, **kw).run(
        sessions, tw.generate_requests(sessions))
    gw = MegatickGateway(tt, n_lanes, mesh=cpu_mesh(4), **kw)
    got = gw.run(sessions, tw.generate_requests(sessions))
    assert_bitwise(got, one)
    assert_bitwise(got, host)
    assert gw.engine.mesh.size == 4 and got.n_compiles == (0, 1)
    with pytest.raises(ValueError, match="divisible"):
        MegatickGateway(tt, 6, mesh=cpu_mesh(4), **kw)
