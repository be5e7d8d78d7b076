"""The reference family against the program on the CPU at a tiny size,
both in float32: the nested LM's logits at every position of a prefill
(query heads grouped over fewer KV heads, as in the benchmark's
configuration), and served tokens (prefill, then cached decode through
the engine) that are the reference's own greedy picks.  The controller
reference against the program's scoring pass."""

import json
import time

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.conftest import BASE_CONFIG, TINY_ANYTIME, HOME
from perfbench.reference import alert, common, nested_dense

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ServeEngine



def _setup():
    fam = nested_dense
    cfg = json.loads((HOME / "configs" / f"{BASE_CONFIG}.json").read_text())
    cfg.update(TINY_ANYTIME, dtype="float32")
    fields = {f for f in ModelConfig.__dataclass_fields__}
    mc = ModelConfig(**{k: v for k, v in cfg.items() if k in fields})
    params = weights.make_params(fam.param_specs(cfg), 7, "cpu",
                                 torch.float32)
    return cfg, mc, params, fam


@pytest.mark.parametrize("level", [1, 2, 3])
def test_nested_logits_every_position(level):
    cfg, mc, params, fam = _setup()
    toks = torch.randint(0, cfg["vocab"], (2, 9),
                         generator=torch.Generator().manual_seed(level))
    with torch.inference_mode():
        want = tfm.lm_apply(params, mc, toks, mode="prefill",
                            level=level).logits
        got, _ = fam.logits(params, cfg, toks[None], level, 1, False)
    torch.testing.assert_close(got[0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_served_tokens_are_the_reference_picks(level):
    cfg, mc, params, fam = _setup()
    eng = ServeEngine(build_model(mc), max_len=8 + 6, batch_size=2,
                      device="cpu", graphs=False)
    prompt = np.random.default_rng(level).integers(
        0, cfg["vocab"], (2, 8)).astype(np.int32)
    toks = eng.generate(params, prompt, 6, level=level)["tokens"]
    ref, _ = fam.logits(params, cfg, torch.as_tensor(
        common.teacher_forced(prompt, toks)[None], dtype=torch.long),
        level, 8, False)
    worst = float(common.gaps(
        ref, torch.as_tensor(toks[None], dtype=torch.long)).max())
    assert worst < 1e-4


def test_controller_reference_against_the_program():
    from repro_torch.core.batched import BatchedAlertEngine
    from repro_torch.core.controller import Goal
    from repro_torch.core.power import PowerModel
    from repro_torch.core.profiles import (Candidate, ProfileTable,
                                          extrapolate_power_buckets)

    base = np.array([0.002, 0.0025, 0.003, 0.004])
    accs = [0.62, 0.71, 0.78, 0.83]
    caps, lat, pw = extrapolate_power_buckets(base, PowerModel(), 4)
    table = ProfileTable([Candidate(name=f"l{i}", flops=0.0, bytes_hbm=0.0,
                                    accuracy=a, is_anytime_level=True,
                                    anytime_group="anytime", level=i + 1)
                          for i, a in enumerate(accs)], caps, lat, pw,
                         q_fail=0.0)
    ref = alert.FleetReference(base, accs, 0.0, 4, 0.3, 8, 10)
    np.testing.assert_array_equal(ref.latency, lat)
    np.testing.assert_array_equal(ref.run_power, pw)
    eng = BatchedAlertEngine(table, Goal.MINIMIZE_ENERGY, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(20):
        mu, sigma = rng.uniform(0.8, 1.4, 8), rng.uniform(0.01, 0.3, 8)
        ref.mu, ref.sigma = mu, sigma
        ref.phi = rng.uniform(0.1, 0.4, 8)
        dl = rng.uniform(0.002, 0.012, 8)
        kind = rng.integers(0, 2, 8)
        ag, eg = rng.uniform(0.5, 0.85, 8), rng.uniform(0.2, 2.0, 8)
        d = eng.select(mu, sigma, ref.phi, dl, accuracy_goal=ag,
                       energy_goal=eg, goal_kind=kind,
                       active=np.ones(8, bool))
        i, j, lt, ac, en = ref.select(dl, ag, eg, kind)
        np.testing.assert_array_equal(d.model_index, i)
        np.testing.assert_array_equal(d.power_index, j)
        for a, b in ((d.predicted_latency, lt), (d.predicted_accuracy, ac),
                     (d.predicted_energy, en)):
            np.testing.assert_allclose(a, b, rtol=1e-14)
