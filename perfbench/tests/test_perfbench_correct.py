"""``correct`` at the tiny cell on the CPU: true for the program as it
is; false for the control (the reference in float8 products and the
controller in float32, put in the program's place and judged by the same
comparison), on each number by itself; and false for a run whose timed
path is broken underneath (a served token altered where it is produced;
half of the batch left out; the feedback step leaving the filter state
unchanged; the controller's pick altered where it is produced).  The look
for a card is skipped: ``run_cell`` runs on the CPU."""

import time

import numpy as np
import pytest

from perfbench import harness


def _run(root, cell="tiny-a", hook=None, control=False):
    return harness.run_cell(cell, 2 ** 31 + 9, 0.1, False, root=root,
                            device="cpu", t_start=time.perf_counter(),
                            control=control, hook=hook)


@pytest.fixture(scope="module")
def with_control(tiny_root):
    return _run(tiny_root, control=True)


def test_program_correct_control_not(with_control):
    r = with_control
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert not r["control"]["correct"]
    assert list(r["control"]["checks"]) == list(r["checks"])


@pytest.mark.parametrize("number", ["logit_gap", "pick_gap", "state_gap"])
def test_control_fails_each_number(with_control, number):
    c = with_control["control"]["checks"][number]
    assert c["value"] > c["limit"]
    p = with_control["checks"][number]
    assert p["value"] <= p["limit"]


def _alter_tokens(srv):
    gen = srv.engine.generate

    def generate(*a, **k):
        r = gen(*a, **k)
        r["tokens"] = r["tokens"].copy()
        r["tokens"][0, -1] = (r["tokens"][0, -1] + 1) % 256
        return r
    srv.engine.generate = generate


def _half_batch(srv):
    gen = srv.engine.generate

    def generate(params, prompt, n_new, **k):
        half = prompt.shape[0] // 2
        r = gen(params, np.concatenate([prompt[:half]] * 2), n_new, **k)
        return r
    srv.engine.generate = generate


def _state_unchanged(srv):
    import repro_torch.serving.alert_server as server
    srv._saved = server.observe_fleet
    server.observe_fleet = lambda *a, **k: None


def _alter_pick(srv):
    import dataclasses
    sel = srv.scoring.select

    def select(*a, **k):
        d = sel(*a, **k)
        i = (d.model_index + 1) % len(srv.engine.levels)
        return dataclasses.replace(d, model_index=i)
    srv.scoring.select = select


@pytest.mark.parametrize("fault,number", [
    (_alter_tokens, "logit_gap"),
    (_half_batch, "logit_gap"),
    (_state_unchanged, "state_gap"),
    (_alter_pick, "pick_gap"),
], ids=["token", "half_batch", "state", "pick"])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, fault, number):
    import repro_torch.serving.alert_server as server
    monkeypatch.setattr(server, "observe_fleet", server.observe_fleet)
    r = _run(tiny_root, hook=fault)
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny_root, cuda_device):
    r = harness.run_cell("tiny-a", 12, 0.5, True, root=tiny_root,
                         device=cuda_device, t_start=time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
