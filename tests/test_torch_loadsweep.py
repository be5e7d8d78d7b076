"""The port's load sweep (``repro_torch.traffic.loadsweep``) against the
reference's on the CPU: the baselines' configurations and tables equal
the reference's, ``sweep_loads(gateway="megatick")`` records equal the
host gateway's float for float (apart from the ``gateway`` tag and the
program count, flat across the loads), the records equal the
reference's sweep, and an instrumented sweep records the same numbers as
a bare one.
"""

import numpy as np
import pytest
import torch

from benchmarks.common import deadline_range
from repro.core import controller as jc
from repro.serving import sim as js
from repro.traffic import loadsweep as jl
from repro.traffic import workloads as jw
from repro_torch.core.controller import Constraints, Goal
from repro_torch.obs import FlightRecorder
from repro_torch.serving import sim as ts
from repro_torch.traffic import loadsweep as tl
from repro_torch.traffic import workloads as tw
from tests.test_torch_traffic import tables  # noqa: F401 (fixture)

CPU = torch.device("cpu")
SCHEMES = ("alert", "oracle_static", "alert_no_admission", "app_only",
           "sys_only")


def mixes(jt, n_lanes=8, n_sessions=16, fill=2.0):
    dl = float(deadline_range(jt, 5)[3])
    rate = fill * (n_lanes / dl) / n_sessions
    jmix = [jw.TenantSpec("minE", jc.Goal.MINIMIZE_ENERGY,
                          jc.Constraints(deadline=dl, accuracy_goal=0.78),
                          jw.PoissonProcess(rate), n_sessions=n_sessions,
                          phases=js.CPU_ENV)]
    tmix = [tw.TenantSpec("minE", Goal.MINIMIZE_ENERGY,
                          Constraints(deadline=dl, accuracy_goal=0.78),
                          tw.PoissonProcess(rate), n_sessions=n_sessions,
                          phases=ts.CPU_ENV)]
    kw = dict(n_lanes=n_lanes, horizon=8 * dl, seed=3,
              max_queue=4 * n_lanes, tick=dl)
    return jmix, tmix, kw


def without(rows, *keys):
    return [{**r, "schemes": {s: {k: v for k, v in rec.items()
                                  if k not in keys}
                              for s, rec in r["schemes"].items()}}
            for r in rows]


def test_baselines_equal_reference(tables):
    jt, tt = tables
    dl = float(deadline_range(jt, 5)[3])
    assert tl.hindsight_static_config(
        tt, ts.CPU_ENV, Goal.MINIMIZE_ENERGY,
        Constraints(deadline=dl, accuracy_goal=0.78), seed=5) == \
        jl.hindsight_static_config(
            jt, js.CPU_ENV, jc.Goal.MINIMIZE_ENERGY,
            jc.Constraints(deadline=dl, accuracy_goal=0.78), seed=5)
    for fn in ("app_only_table", "sys_only_table"):
        got, want = getattr(tl, fn)(tt), getattr(jl, fn)(jt)
        for f in ("power_caps", "latency", "run_power"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        a, b = got.staircase_tensors(), want.staircase_tensors()
        for f in ("lvl_lat", "lvl_acc", "lvl_valid", "n_levels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("loads", [(0.5, 4.0), (2.0, 8.0)])
def test_megatick_sweep_equals_host_sweep(tables, loads):
    """Every scheme, every load: the same floats through both gateways;
    the megatick builds one chunk program a scheme for the whole
    sweep."""
    _, tt = tables
    jt, _ = tables
    _, tmix, kw = mixes(jt)
    host = tl.sweep_loads(tt, tmix, loads, schemes=SCHEMES, device=CPU,
                          **kw)
    mega = tl.sweep_loads(tt, tmix, loads, schemes=SCHEMES, device=CPU,
                          gateway="megatick", **kw)
    assert without(host, "gateway", "n_compiles") == \
        without(mega, "gateway", "n_compiles")
    for rh, rm in zip(host, mega):
        for scheme in SCHEMES:
            sh, sm = rh["schemes"][scheme], rm["schemes"][scheme]
            assert (sh["gateway"], sm["gateway"]) == ("host", "megatick")
            assert sh["n_compiles"] == [0, 0]
            assert sm["n_compiles"] == [0, 1], scheme


def test_sweep_equals_reference(tables):
    """The port's host and megatick sweeps record the reference's numbers
    (the reference's host sweep counts its jit caches in
    ``n_compiles``)."""
    jt, tt = tables
    jmix, tmix, kw = mixes(jt)
    want = jl.sweep_loads(jt, jmix, [0.5, 4.0], **kw)
    for gateway in ("host", "megatick"):
        got = tl.sweep_loads(tt, tmix, [0.5, 4.0], gateway=gateway,
                             device=CPU, **kw)
        assert without(got, "gateway", "n_compiles") == \
            without(want, "gateway", "n_compiles"), gateway


def test_bad_gateway_and_mixed_static_raise(tables):
    jt, tt = tables
    _, tmix, kw = mixes(jt)
    with pytest.raises(ValueError, match="gateway"):
        tl.sweep_loads(tt, tmix, [1.0], gateway="nope", device=CPU, **kw)
    with pytest.raises(ValueError, match="single-tenant"):
        tl.sweep_loads(tt, tmix * 2, [1.0], device=CPU, **kw)


@pytest.mark.parametrize("gateway", ["host", "megatick"])
def test_instrumented_sweep_unchanged_and_flat(tables, gateway):
    jt, tt = tables
    _, tmix, kw = mixes(jt, n_lanes=4, n_sessions=8, fill=1.0)
    bare = tl.sweep_loads(tt, tmix, [0.5, 4.0], gateway=gateway,
                          device=CPU, **kw)
    obs = FlightRecorder()
    seen = tl.sweep_loads(tt, tmix, [0.5, 4.0], gateway=gateway, obs=obs,
                          device=CPU, **kw)
    assert bare == seen
    assert len(obs.metrics) > 0 and obs.ring.n_seen > 0
    for scheme in seen[0]["schemes"]:
        first = seen[0]["schemes"][scheme]["n_compiles"]
        assert first == seen[-1]["schemes"][scheme]["n_compiles"]
        assert first[0] == 0 and first[1] <= 1
