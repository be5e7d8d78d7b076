"""The port's profiling harness against the JAX package on the CPU.

With fake clocks and the same fake times and accuracies, the port's
``profile_anytime_measured``, ``profile_measured`` and
``live_profile_table(mode="fake")`` build tables equal to the
reference's, bitwise (the arithmetic is the same float64 numpy).  The
unsynced-loop regression runs the real timing loop on the fake
asynchronous handles through the production sync.  ``engine_level_fns``
drives the port's CPU ``ServeEngine`` with the ``kernel`` nest backend.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import alert_anytime as j_cfgs
from repro.core.power import PowerModel as JPowerModel
from repro.core.profiles import profile_measured as j_profile_measured
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.profiling import FakeClock as JFakeClock
from repro.profiling import TrainedAnytime as JTrained
from repro.profiling import engine_level_fns as j_engine_level_fns
from repro.profiling import fake_level_fns as j_fake_level_fns
from repro.profiling import level_flop_fractions as j_fractions
from repro.profiling import live_profile_table as j_live_table
from repro.profiling import profile_anytime_measured as j_profile_anytime
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import alert_anytime as t_cfgs
from repro_torch.convert import params_from_jax
from repro_torch.core.power import PowerModel
from repro_torch.core.profiles import (default_sync, measure_mean_latency,
                                       profile_measured)
from repro_torch.kernels import nested_matmul as nm
from repro_torch.models.registry import build_model as t_build
from repro_torch.profiling import (FakeClock, FakeTimedFn, TrainedAnytime,
                                   engine_level_fns, fake_level_fns,
                                   level_flop_fractions, live_profile_table,
                                   monotone_accuracies,
                                   profile_anytime_measured)
from repro_torch.serving.engine import ServeEngine

PM, JPM = PowerModel(p_idle=60.0, p_tdp=200.0), \
    JPowerModel(p_idle=60.0, p_tdp=200.0)


def assert_tables_equal(got, want):
    """Bitwise equality of two ProfileTables (port vs reference)."""
    assert len(got.candidates) == len(want.candidates)
    for a, b in zip(got.candidates, want.candidates):
        for f in ("name", "flops", "bytes_hbm", "accuracy",
                  "is_anytime_level", "anytime_group", "level"):
            assert getattr(a, f) == getattr(b, f), f
    for f in ("power_caps", "latency", "run_power"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert got.q_fail == want.q_fail


# --------------------------------------------------------------------- #
# the unsynced-loop regression (reference tests/test_profiling.py)       #
# --------------------------------------------------------------------- #
def test_unsynced_loop_under_measures():
    clock = FakeClock()
    dispatch, compute = 2e-4, 8e-3
    fn = FakeTimedFn(clock, dispatch, compute)
    old = measure_mean_latency([fn], warmup=1, iters=4, clock=clock,
                               sync=lambda x: x)[0]
    fn2 = FakeTimedFn(clock, dispatch, compute)
    new = measure_mean_latency([fn2], warmup=1, iters=4, clock=clock)[0]
    assert old == pytest.approx(dispatch)
    assert new == pytest.approx(dispatch + compute)
    assert new / old > 10


def test_default_sync_blocks_fake_handles():
    clock = FakeClock()
    h = FakeTimedFn(clock, 0.0, 1e-3)()
    assert default_sync(h) is h
    assert clock() == pytest.approx(1e-3)
    default_sync(h)                       # a handle completes once
    assert clock() == pytest.approx(1e-3)


def test_default_sync_waits_for_the_card_on_real_values():
    """A value without ``block_until_ready`` is synced with
    ``torch.cuda.synchronize``: it raises where CUDA is missing instead of
    skipping the wait."""
    value = np.zeros(3)
    if torch.cuda.is_available():
        assert default_sync(value) is value
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            default_sync(value)


def test_warmup_is_synced_too():
    clock = FakeClock()
    fn = FakeTimedFn(clock, 1e-4, 5e-3)
    base = measure_mean_latency([fn], warmup=3, iters=2, clock=clock)[0]
    assert base == pytest.approx(5.1e-3)


def test_fake_clock_refuses_to_go_back():
    with pytest.raises(ValueError):
        FakeClock().advance(-1.0)


# --------------------------------------------------------------------- #
# tables equal to the reference's                                        #
# --------------------------------------------------------------------- #
def test_profile_measured_equals_reference():
    clock, jclock = FakeClock(), JFakeClock()
    fns = fake_level_fns(clock, [4e-3, 1.6e-2], dispatch_s=1e-4)
    jfns = j_fake_level_fns(jclock, [4e-3, 1.6e-2], dispatch_s=1e-4)
    got = profile_measured(fns, ["a", "b"], [0.5, 0.8], PM,
                           n_power_buckets=4, warmup=1, iters=3, clock=clock)
    want = j_profile_measured(jfns, ["a", "b"], [0.5, 0.8], JPM,
                              n_power_buckets=4, warmup=1, iters=3,
                              clock=jclock)
    assert_tables_equal(got, want)
    assert got.latency[:, -1] == pytest.approx([4.1e-3, 1.61e-2])
    assert all(fn.n_calls == 4 for fn in fns)


@pytest.mark.parametrize("compute,accs,buckets", [
    ([1e-3, 2e-3, 4e-3], [0.4, 0.35, 0.7], 5),
    ([3e-4, 7e-4, 1.9e-3, 5.2e-3], [0.2, 0.5, 0.6, 0.61], 8),
    ([2.5e-2], [0.6], 3),
])
def test_profile_anytime_measured_equals_reference(compute, accs, buckets):
    clock, jclock = FakeClock(), JFakeClock()
    got = profile_anytime_measured(
        fake_level_fns(clock, compute, dispatch_s=3e-5), accs, PM,
        n_power_buckets=buckets, q_fail=0.05, clock=clock)
    want = j_profile_anytime(
        j_fake_level_fns(jclock, compute, dispatch_s=3e-5), accs, JPM,
        n_power_buckets=buckets, q_fail=0.05, clock=jclock)
    assert_tables_equal(got, want)
    assert clock() == jclock()
    assert np.array_equal(monotone_accuracies(accs), got.accuracies)


def test_zero_latency_raises():
    clock = FakeClock()
    with pytest.raises(ValueError, match="sync seam"):
        profile_anytime_measured(fake_level_fns(clock, [0.0]), [0.5], PM,
                                 clock=clock)
    with pytest.raises(ValueError):
        profile_anytime_measured(fake_level_fns(clock, [1.0]), [0.5, 0.6],
                                 PM, clock=clock)


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_level_flop_fractions_equal_reference(which):
    t_cfg = t_cfgs.reduced() if which == "reduced" else t_cfgs.CONFIG
    j_cfg = j_cfgs.reduced() if which == "reduced" else j_cfgs.CONFIG
    got, want = level_flop_fractions(t_cfg), j_fractions(j_cfg)
    assert got == want
    assert got[-1] == 1.0 and all(np.diff(got) > 0)


@pytest.mark.parametrize("base_s,buckets", [(0.05, 8), (0.011, 4)])
def test_live_profile_table_fake_equals_reference(base_s, buckets):
    accs = [0.143, 0.454, 0.449]           # an inversion to clamp
    t_tr = TrainedAnytime(model=None, cfg=t_cfgs.reduced(), params=None,
                          accuracies=accs, final_loss=float("nan"),
                          q_fail=1 / 32)
    j_tr = JTrained(model=None, cfg=j_cfgs.reduced(), params=None,
                    accuracies=accs, final_loss=float("nan"), q_fail=1 / 32)
    got = live_profile_table(t_tr, base_s=base_s, n_power_buckets=buckets)
    want = j_live_table(j_tr, base_s=base_s, n_power_buckets=buckets)
    assert_tables_equal(got, want)
    clk = FakeClock(start=3.0)
    again = live_profile_table(t_tr, base_s=base_s, n_power_buckets=buckets,
                               clock=clk)
    assert np.allclose(again.latency, got.latency, rtol=1e-12, atol=0)
    assert clk() > 3.0
    with pytest.raises(ValueError, match="mode must be"):
        live_profile_table(t_tr, mode="guess")


# --------------------------------------------------------------------- #
# real timing of the port's engine on the CPU, kernel nest backend       #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engines():
    j_cfg = j_cfgs.reduced().replace(dtype="float32")
    t_cfg = t_cfgs.reduced().replace(dtype="float32",
                                     nest_backend="kernel")
    j_params = jt.init_lm(jax.random.PRNGKey(0), j_cfg)
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=2)
    t_eng = ServeEngine(t_build(t_cfg), max_len=16, batch_size=2,
                        device="cpu")
    return j_eng, t_eng, j_params, t_params


def test_engine_level_fns_drive_kernel_backend(engines):
    j_eng, t_eng, j_params, t_params = engines
    before = nm.nested_matmul.launches
    fns = engine_level_fns(t_eng, t_params, prompt_len=5, gen_tokens=3,
                           seed=2)
    jfns = j_engine_level_fns(j_eng, j_params, prompt_len=5, gen_tokens=3,
                              seed=2)
    assert len(fns) == len(jfns) == t_eng.model.cfg.nest_levels
    for fn, jfn in zip(fns, jfns):
        toks = fn()
        assert toks.shape == (2, 3) and toks.dtype == np.int32
        np.testing.assert_array_equal(toks, np.asarray(jfn()))
    assert nm.nested_matmul.launches == before     # CPU: plain version
    table = profile_anytime_measured(fns, [0.3, 0.5, 0.7], PM, warmup=1,
                                     iters=1, sync=lambda v: v)
    assert np.all(table.latency > 0)
    assert table.anytime_groups() == {"anytime": [0, 1, 2]}


def test_live_profile_table_measured_on_cpu(engines):
    _, t_eng, _, t_params = engines
    tr = TrainedAnytime(model=t_eng.model, cfg=t_eng.model.cfg,
                        params=t_params, accuracies=[0.2, 0.4, 0.7],
                        final_loss=float("nan"), q_fail=0.1)
    table = live_profile_table(tr, mode="measured", warmup=1, iters=1,
                               n_power_buckets=4, gen_tokens=2)
    fake = live_profile_table(tr, n_power_buckets=4)
    assert np.all(table.latency > 0)
    assert table.accuracies.tolist() == fake.accuracies.tolist()
    assert np.array_equal(table.power_caps, fake.power_caps)
    assert np.array_equal(table.run_power, fake.run_power)
