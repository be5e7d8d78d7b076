"""The port's float64 ``erf`` and ``exp`` (``repro_torch.kernels.
alert_select``): one fixed sequence of correctly rounded IEEE operations,
so the CPU and the card give the same bits (the card side is
``tests/test_torch_cuda.py``).  Here: within 1 ulp of ``math.erf`` and
``math.exp``, their special values, and the plain version using them
rather than ``torch.erf`` / ``torch.exp``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import alert_select as ks

F64 = torch.float64


def ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want) / np.spacing(np.maximum(np.abs(want),
                                                      np.finfo(float).tiny))


def test_erf_within_one_ulp_on_the_eq7_range():
    """200,001 points of [-8, 8], every branch of fdlibm's erf."""
    z = torch.linspace(-8.0, 8.0, 200_001, dtype=F64)
    got = ks.erf(z).numpy()
    want = np.array([math.erf(v) for v in z.numpy()])
    assert ulps(got, want).max() <= 1.0


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-40.0, 0.0),
                                   (-745.5, 5.0)])
def test_exp_within_one_ulp(lo, hi):
    """The range the plain version feeds it (erf's tail and the
    E[min(t, T)] density, both at most 0) and around it; results below
    the normal range within one unit of the last subnormal place."""
    x = torch.linspace(lo, hi, 100_001, dtype=F64)
    got = ks.exp(x).numpy()
    want = np.array([math.exp(v) for v in x.numpy()])
    normal = want >= np.finfo(float).tiny
    assert ulps(got[normal], want[normal]).max() <= 1.0
    assert (np.abs(got[~normal] - want[~normal]) <= 5e-324).all()


def test_special_values():
    x = torch.tensor([0.0, -0.0, 1e-310, -1e-310, 1e-20, math.inf,
                      -math.inf, 0.84375, 1.25, 6.0, -6.0, 1 / 0.35],
                     dtype=F64)
    got = ks.erf(x)
    want = [math.erf(v) for v in x.tolist()]
    assert ulps(got.numpy(), want).max() <= 1.0
    assert math.copysign(1.0, float(got[1])) == -1.0      # erf(-0) = -0
    assert torch.isnan(ks.erf(torch.tensor([math.nan], dtype=F64))).all()
    e = ks.exp(torch.tensor([0.0, -0.0, math.inf, -math.inf, 710.0, -746.0,
                             1e-300, math.nan], dtype=F64))
    assert e[:6].tolist() == [1.0, 1.0, math.inf, 0.0, math.inf, 0.0]
    assert float(e[6]) == 1.0 and math.isnan(float(e[7]))


@pytest.mark.parametrize("paper_faithful", [True, False])
def test_plain_version_uses_the_port_functions(monkeypatch, tables,
                                               paper_faithful):
    """``alert_select_plain`` and ``estimate_grid`` never call
    ``torch.erf`` or ``torch.exp``."""
    from chip_smoke import fleet_inputs
    from repro_torch.core.batched import BatchedAlertEngine

    _, tt = tables
    eng = BatchedAlertEngine(tt, None, overhead=0.001,
                             paper_faithful_energy=paper_faithful,
                             device=torch.device("cpu"))
    args = fleet_inputs(tt, 64, seed=3, device=torch.device("cpu"))
    kw = dict(latency=eng._latency, run_power=eng._run_power,
              weights=eng._weights, q_fail=eng._q_fail,
              overhead=eng.overhead, paper_faithful_energy=paper_faithful)
    want = ks.alert_select_plain(*args, **kw)

    def refused(*a, **k):
        raise AssertionError("torch.erf / torch.exp called")

    monkeypatch.setattr(torch, "erf", refused)
    monkeypatch.setattr(torch, "exp", refused)
    got = ks.alert_select_plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def tables():
    from benchmarks.common import family_table
    from tests.test_torch_sim import port_table

    jt = family_table("image")
    return jt, port_table(jt)
