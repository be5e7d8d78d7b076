"""The serving launcher (``repro_torch.launch.serve``) and the seven
examples ``examples/*_torch.py`` ported in one slice, on the CPU at small
settings.

* The launcher restores the reference's initial weights (carried over
  with ``params_from_jax`` and saved with the port's checkpoint I/O) and
  must measure the reference's level accuracies on the same held-out
  batch; its serving loop runs on a fake clock (as
  ``tests/test_torch_train_runtime.py`` drives the serve example), so its
  report is the same on every run.  For ``rwkv6-3b`` it raises a
  ``ValueError`` where the reference's launcher raises one (the reduced
  config gets two nesting levels, which no RWKV layer has).
* Each example prints its ``OK`` line at small arguments; the four
  gateway demos read the image family's table, which
  ``tests/test_torch_batcher.py`` holds to ``benchmarks.common``.
* Without ``--device`` the launcher and every ``_torch`` example run on
  the card, so on a machine without one they raise rather than fall back
  to the CPU; ``multipod_dryrun_torch.py`` takes a device in its
  ``--fleet`` mode only, its model mode counting on ``meta``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models.registry import build_model as j_build
from repro.train.losses import token_accuracy as j_token_accuracy
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.profiling.clock import FakeClock
from repro_torch.serving import engine as eng

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch", "train_anytime_torch",
            "live_profile_demo_torch", "traffic_demo_torch",
            "faults_demo_torch", "obs_demo_torch", "kernel_demo_torch",
            "serve_alert_torch")


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fake_clock(monkeypatch):
    """The engine's ``generate`` on a fake clock that each prefill or
    decode step advances by a fixed time for its level (1.0, 1.2, 1.5
    ms), so profiled latencies and ALERT's picks are the same on every
    run."""
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


# --------------------------------------------------------------------- #
# the serving launcher                                                   #
# --------------------------------------------------------------------- #
def test_launcher_restores_the_references_weights(tmp_path, capsys,
                                                  fake_clock):
    j_cfg = jc.get_reduced("alert-anytime-120m").replace(dtype="float32",
                                                         vocab=32)
    t_cfg = get_reduced("alert-anytime-120m").replace(dtype="float32",
                                                      vocab=32)
    j_model = j_build(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    ckpt_io.save(str(tmp_path / "ck"), params_from_jax(
        jax.tree.map(np.asarray, j_params), t_cfg, device="cpu"), step=7)
    evalb = {k: jnp.asarray(v) for k, v in JSyntheticLM(
        vocab=32, seq_len=32, global_batch=4, noise=0.05).batch_at(
            10_000).items()}
    want = [float(j_token_accuracy(j_model.train_logits(
        j_params, evalb, level=k)[0], evalb["labels"]))
        for k in range(1, j_cfg.nest_levels + 1)]

    out = launch_serve.main(["--requests", "12", "--ckpt-dir",
                             str(tmp_path / "ck"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[serve] restored params from step 7" in text
    assert out["restored_step"] == 7
    # argmax accuracies over 4 x 32 positions: one flip at a near tie
    np.testing.assert_allclose(out["accuracies"], want, atol=1 / 128)
    np.testing.assert_allclose(out["table_latency"], [4e-3, 4.8e-3, 6e-3])
    assert out["requests"] == 12 and len(out["levels"]) == 12
    assert set(out["levels"]) <= {1, 2, 3}
    assert 0.0 <= out["miss_rate"] <= 1.0 and out["mean_energy"] > 0
    assert "[serve] 12 requests: delivered_acc=" in text
    assert (out["nest_backend"], out["attn_backend"]) == ("blocks", "ref")


def test_launcher_min_energy_and_fresh_init(capsys, fake_clock):
    """No checkpoint: fresh weights; the Eq. 5 goal."""
    out = launch_serve.main(["--requests", "6", "--goal", "min_energy",
                             "--device", "cpu"])
    assert out["restored_step"] is None and out["requests"] == 6
    assert "[serve] 6 requests:" in capsys.readouterr().out


def test_launcher_refuses_rwkv_as_the_reference_does():
    """The reference's launcher gives the reduced ``rwkv6-3b`` two nesting
    levels and fails in its first forward (``ValueError``: the level-1
    prefix does not fit the RWKV layers); the port's config refuses the
    same config with a ``ValueError``."""
    j_cfg = jc.get_reduced("rwkv6-3b").replace(dtype="float32", vocab=32,
                                               nest_levels=2)
    j_model = j_build(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    toks = jnp.zeros((2, 8), jnp.int32)
    with pytest.raises(ValueError):
        j_model.train_logits(j_params, {"tokens": toks}, level=1)
    with pytest.raises(ValueError, match="without width nesting"):
        launch_serve.main(["--arch", "rwkv6-3b", "--requests", "1",
                           "--device", "cpu"])


# --------------------------------------------------------------------- #
# the examples                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-3b"])
def test_quickstart_runs_small(arch, capsys):
    out = example("quickstart_torch").main(["--arch", arch, "--steps", "6",
                                            "--device", "cpu"])
    assert f"OK: {arch} trained 6 steps" in capsys.readouterr().out
    assert out["losses"][-1] < out["losses"][0]
    assert out["tokens"].shape == (2, 8)


def test_train_anytime_runs_small(capsys):
    out = example("train_anytime_torch").main(
        ["--joint-steps", "12", "--fail-at", "7", "--ckpt-every", "5",
         "--stage-steps", "2", "--device", "cpu"])
    assert "OK: joint training resumed after the crash to step 12" in \
        capsys.readouterr().out
    # steps 5 and 6 ran twice: the crash at 7 restarts from step 5's
    # checkpoint
    assert out["joint_end"] == 12 and len(out["joint_losses"]) == 14
    assert out["joint_losses"][5:7] == out["joint_losses"][7:9]
    assert len(out["stage_losses"]) == 3


@pytest.mark.parametrize("measured", [False, True])
def test_live_profile_demo_runs_small(measured, capsys):
    args = ["--train-steps", "4", "--device", "cpu"]
    out = example("live_profile_demo_torch").main(
        args + (["--measured"] if measured else []))
    assert "OK: ALERT served the live" in capsys.readouterr().out
    assert out["mode"] == ("measured" if measured else "fake")
    assert [r["load"] for r in out["rows"]] == [0.5, 2.0, 8.0]
    if not measured:   # 50 ms times each level's nested-FLOP fraction
        assert out["table_latency"][-1] == pytest.approx(0.05)


@pytest.mark.parametrize("name,argv,ok", [
    ("traffic_demo_torch", [], "OK: open-loop traffic served"),
    ("faults_demo_torch", [], "OK: chaos demo"),
    ("obs_demo_torch", [], "OK: obs demo"),
    ("kernel_demo_torch", ["--streams", "64", "--ticks", "3"],
     "OK: the alert_select kernel picks as its plain version")])
def test_gateway_demo_runs(name, argv, ok, capsys):
    out = example(name).main(argv + ["--device", "cpu"])
    assert ok in capsys.readouterr().out
    assert out["device"] == "cpu"


@pytest.mark.parametrize("name", EXAMPLES + ("launch.serve",))
def test_runs_on_the_card_unless_told_otherwise(name):
    """No ``--device``: the card, or an error where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    main = launch_serve.main if name == "launch.serve" else \
        example(name).main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])


def test_multipod_dryrun_model_mode_at_its_defaults(capsys):
    """``multipod_dryrun_torch.py`` at its defaults (``rwkv6-3b``
    ``long_500k`` on both grids): counted on ``meta``, no device taken;
    the reference example's lines for each record."""
    assert example("multipod_dryrun_torch").main([]) == 0
    out = capsys.readouterr().out
    for mesh, n in (("single", 256), ("multi", 512)):
        assert f"== rwkv6-3b__long_500k__{mesh}__baseline.json" in out
        assert f"devices={n} " in out
    assert out.count("flops/dev=") == 2 and out.count("memory: args=") == 2


def test_multipod_dryrun_fleet_mode(capsys):
    argv = ["--fleet", "--devices", "4", "--streams", "256", "--ticks", "3",
            "--churn", "16", "--device", "cpu"]
    assert example("multipod_dryrun_torch").main(argv) == 0
    out = capsys.readouterr().out
    assert '"picks_match_single_device": true' in out
    assert '"builds_flat_under_churn": true' in out


def test_multipod_dryrun_fleet_runs_on_the_card_unless_told_otherwise():
    """The fleet mode takes a device: the card without ``--device``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example("multipod_dryrun_torch").main(["--fleet"])
