"""Training's runtime on the CPU: the supervisor's checkpoint/restart
loop (``test_faults.py::TestSupervisor``'s three cases, ported), a real
train state killed and resumed bitwise, the launcher's ``main`` with
``--reduced``, ``--fail-at`` and ``--resume``, the live profile's
training loop held to the reference run live on this machine, and the
end-to-end example ``examples/serve_alert_torch.py`` at a small size.

The live profile: both packages train the reduced anytime LM in
bfloat16 from the reference's initial weights on the same batches, the
reference with ``unroll_layers=True`` (its layer scan would stack and so
decay the norms, see ``test_torch_train.py``).  bf16 rounds at other
places in the two frameworks, so the runs drift apart slowly: over 60
steps the per-step losses are held to rtol 2e-3 (2.2e-4 is the largest
seen) and the per-level accuracies to 0.01 absolute, 10 of the 1,024
eval positions (2 seen: argmaxes at a near tie).  60 steps, not the
profile's 250, to keep the test short: the levels are then still near
chance, so this holds the loop, not the staircase.
"""

import importlib.util
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.alert_anytime import reduced
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.profiling import live as t_live
from repro_torch.runtime.ft import InjectedFailure, Supervisor
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_anytime_loss_fn, make_train_step)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


# --------------------------------------------------------------------- #
# runtime/ft.py: TestSupervisor's cases, ported                          #
# --------------------------------------------------------------------- #
def toy_supervisor(ckpt_dir, **kw):
    def train_step(state, batch):
        w = state["w"] + batch
        return {"w": w, "m": state["m"] * 0.9 + 0.1 * batch}, \
            {"sum": float(w.sum())}

    def batch_at(step):
        return torch.full((3,), float(step + 1))

    return Supervisor(train_step=train_step, batch_at=batch_at,
                      ckpt_dir=ckpt_dir, **kw)


def toy_state():
    return {"w": torch.zeros(3), "m": torch.ones(3)}


def test_crash_before_first_checkpoint_restarts_from_entry(tmp_path):
    ref, step_ref = toy_supervisor(str(tmp_path / "a"), ckpt_every=50) \
        .run(toy_state(), 0, 10)
    got, step = toy_supervisor(str(tmp_path / "b"), ckpt_every=50) \
        .run(toy_state(), 0, 10, fail_at=4)
    assert step == step_ref == 10
    for k in ("w", "m"):
        assert torch.equal(ref[k], got[k])


def test_crash_after_checkpoint_resumes_bit_exact(tmp_path):
    ref, _ = toy_supervisor(str(tmp_path / "a"), ckpt_every=3) \
        .run(toy_state(), 0, 12)
    got, step = toy_supervisor(str(tmp_path / "b"), ckpt_every=3) \
        .run(toy_state(), 0, 12, fail_at=8)
    assert step == 12
    for k in ("w", "m"):
        assert torch.equal(ref[k], got[k])


def test_max_restarts_exceeded_reraises(tmp_path):
    sup = toy_supervisor(str(tmp_path / "c"), ckpt_every=50, max_restarts=0)
    with pytest.raises(InjectedFailure):
        sup.run(toy_state(), 0, 10, fail_at=2)


def test_entry_snapshot_is_a_copy(tmp_path):
    """A train step that updates its state in place must not reach the
    entry snapshot: a crash before the first checkpoint restarts from the
    values ``run`` entered with."""
    def in_place(state, batch):
        state["w"].add_(batch)
        return state, {}

    sup = Supervisor(in_place, lambda s: torch.ones(3), str(tmp_path / "d"),
                     ckpt_every=50)
    got, _ = sup.run({"w": torch.zeros(3)}, 0, 5, fail_at=3)
    assert torch.equal(got["w"], torch.full((3,), 5.0))


# --------------------------------------------------------------------- #
# a real train state killed and resumed                                  #
# --------------------------------------------------------------------- #
def real_run(ckpt_dir, steps, fail_at=None, dtype="bfloat16"):
    cfg = reduced().replace(dtype=dtype)
    model, opt = build_model(cfg), AdamW(lr=8e-3)
    state = init_train_state(model, cfg, opt,
                             torch.Generator().manual_seed(0), CPU)
    data = SyntheticLM(cfg.vocab, 16, 4)
    sup = Supervisor(make_train_step(model, cfg, opt,
                                     loss_fn=make_anytime_loss_fn(model, cfg)),
                     launch.batch_fn(data, CPU), ckpt_dir, ckpt_every=3)
    return sup.run(state, 0, steps, fail_at=fail_at)


def test_train_state_killed_and_resumed_bitwise(tmp_path):
    """bf16 params, float32 moments: a crash at step 7 resumes from the
    step-6 checkpoint, and the end state is bitwise the uninterrupted
    run's; the checkpoint holds the train state by its fields."""
    ref, step_ref = real_run(str(tmp_path / "a"), 10)
    got, step = real_run(str(tmp_path / "b"), 10, fail_at=7)
    assert step == step_ref == 10 and isinstance(got, TrainState)
    for a, b in zip(tree_leaves(ref), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    paths = [r["path"] for r in ckpt_io.load_manifest(
        str(tmp_path / "b"))["leaves"]]
    assert ".opt_state/.step" in paths and ".params/embed" in paths
    assert {r["dtype"] for r in ckpt_io.load_manifest(
        str(tmp_path / "b"))["leaves"] if r["path"].startswith(
            ".params")} == {"bfloat16"}


# --------------------------------------------------------------------- #
# launch/train.py                                                        #
# --------------------------------------------------------------------- #
def test_launcher_trains_crashes_and_resumes(tmp_path, capsys):
    base = ["--arch", "alert-anytime-120m", "--reduced", "--anytime",
            "--batch", "4", "--seq", "16", "--device", "cpu",
            "--ckpt-every", "3"]
    whole = launch.main(base + ["--steps", "8",
                                "--ckpt-dir", str(tmp_path / "a")])
    crashed = launch.main(base + ["--steps", "8", "--fail-at", "5",
                                  "--ckpt-dir", str(tmp_path / "b")])
    assert whole.end == crashed.end == 8
    # the restart reruns steps 3 and 4 from the step-3 checkpoint
    assert len(crashed.losses) == len(whole.losses) + 2
    assert crashed.losses[-3:] == whole.losses[-3:]
    for a, b in zip(tree_leaves(whole.state), tree_leaves(crashed.state)):
        assert torch.equal(a, b)
    assert whole.losses[-1] < whole.losses[0]
    assert len(whole.step_ms) == 8 and len(crashed.step_ms) == 10
    resumed = launch.main(base + ["--steps", "2", "--resume",
                                  "--ckpt-dir", str(tmp_path / "b")])
    assert resumed.start == 8 and resumed.end == 10
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "done at step 10" in out


@pytest.mark.parametrize("flags", [["--microbatches", "2", "--compress"],
                                   ["--vocab", "64"]])
def test_launcher_options(tmp_path, flags):
    run = launch.main(["--arch", "olmoe-1b-7b", "--reduced", "--batch", "4",
                       "--seq", "8", "--steps", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "c")] + flags)
    assert run.end == 2 and all(np.isfinite(run.losses))
    if "--compress" in flags:
        assert run.state.compress_state is not None


def test_launcher_trains_on_a_two_device_grid(monkeypatch, capsys,
                                              tmp_path):
    """``--model-parallel 2`` over a two-shard grid (both shards on the
    CPU) places the state by the sharding rules and trains, printing the
    reference's mesh line; it ends where one device's run ends."""
    from repro_torch.launch.mesh import GridShards, make_host_mesh

    two = make_host_mesh(2, devices=[torch.device("cpu")] * 2)
    monkeypatch.setattr(launch, "make_host_mesh",
                        lambda mp, devices: two)
    args = ["--arch", "alert-anytime-120m", "--reduced", "--batch", "2",
            "--seq", "8", "--steps", "2", "--device", "cpu"]
    run = launch.main(args + ["--model-parallel", "2",
                              "--ckpt-dir", str(tmp_path / "grid")])
    assert "mesh={'data': 1, 'model': 2}" in capsys.readouterr().out
    assert run.end == 2 and all(np.isfinite(run.losses))
    assert all(isinstance(x, GridShards) for x in tree_leaves(run.state))
    monkeypatch.undo()
    one = launch.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    assert run.losses == one.losses
    for a, b in zip(tree_leaves(run.state), tree_leaves(one.state)):
        assert torch.equal(a.full(), b)


def test_launcher_model_parallel_shrinks_on_one_device(tmp_path, capsys):
    """``--model-parallel 2`` on one device shrinks to 1 and trains, as
    the reference's ``make_host_mesh`` does, printing its mesh line."""
    run = launch.main(["--arch", "alert-anytime-120m", "--reduced",
                       "--batch", "2", "--seq", "8", "--steps", "1",
                       "--device", "cpu", "--model-parallel", "2",
                       "--ckpt-dir", str(tmp_path / "mp")])
    assert run.end == 1 and np.isfinite(run.losses[0])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# profiling/live.py: the training loop, live against the reference       #
# --------------------------------------------------------------------- #
LIVE_STEPS = 60


def test_train_reduced_anytime_follows_the_reference(monkeypatch):
    from repro.configs import alert_anytime as j_cfgs
    from repro.profiling import live as j_live

    j_cfg = j_cfgs.reduced().replace(unroll_layers=True)
    monkeypatch.setattr(j_live, "reduced", lambda: j_cfg)
    j_losses = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)

        def call(*args):
            state, metrics = jitted(*args)
            j_losses.append(float(metrics["loss"]))
            return state, metrics
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    want = j_live.train_reduced_anytime(train_steps=LIVE_STEPS)
    monkeypatch.setattr(jax, "jit", real_jit)

    params = params_from_jax(jax.tree.map(np.asarray, jt.init_lm(
        jax.random.PRNGKey(0), j_cfg)), reduced(), device="cpu")
    t_losses = []
    got = t_live.train_reduced_anytime(
        train_steps=LIVE_STEPS, device="cpu", params=params,
        on_metrics=lambda i, m: t_losses.append(float(m["loss"])))
    assert len(t_losses) == len(j_losses) == LIVE_STEPS
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3)
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=2e-3)
    np.testing.assert_allclose(got.accuracies, want.accuracies, atol=0.01)
    assert got.q_fail == want.q_fail
    for leaf in tree_leaves(got.params):
        assert leaf.dtype == torch.bfloat16
    table = t_live.live_profile_table(got)
    assert table.latency.shape[0] == reduced().nest_levels


# --------------------------------------------------------------------- #
# examples/serve_alert_torch.py                                          #
# --------------------------------------------------------------------- #
def test_serve_alert_example_runs_small(capsys, monkeypatch):
    """The example end to end at 40 training steps.  Its serving stages
    decide on measured latencies, which a loaded CPU makes noisy, so here
    the engine's ``generate`` reads a fake clock that each prefill or
    decode step advances by a fixed time for its level (1.0, 1.2 and 1.5
    ms: the levels' staircase): the deadlines and ALERT's picks are then
    the same on every run, and the tight phase must pick lower levels."""
    from repro_torch.profiling.clock import FakeClock
    from repro_torch.serving import engine as eng

    fake, cost = FakeClock(), [0.0]
    real_generate, real_step = eng.ServeEngine.generate, eng.Step.__call__

    def fake_generate(self, params, prompt, n_new, level=None,
                      deadline_s=None, clock=None):
        cost[0] = {1: 1.0e-3, 2: 1.2e-3, 3: 1.5e-3}[self._level(level)]
        return real_generate(self, params, prompt, n_new, level=level,
                             deadline_s=deadline_s, clock=fake)

    def timed_step(self):
        real_step(self)
        fake.advance(cost[0])

    monkeypatch.setattr(eng.ServeEngine, "generate", fake_generate)
    monkeypatch.setattr(eng.Step, "__call__", timed_step)
    spec = importlib.util.spec_from_file_location(
        "serve_alert_torch", ROOT / "examples" / "serve_alert_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--train-steps", "40", "--requests", "18",
                    "--device", "cpu"])
    text = capsys.readouterr().out
    assert "OK: ALERT adapted the anytime level" in text
    assert "OK: min-energy tenant averaged" in text
    assert out["losses"][-1] < out["losses"][0]
    assert out["mean_level"][1] < out["mean_level"][0]
    np.testing.assert_allclose(out["table_latency"], [4e-3, 4.8e-3, 6e-3])
    assert out["n_compiles"] == (3, 3)
