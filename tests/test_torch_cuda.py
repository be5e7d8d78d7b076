"""Tests of the port that need an NVIDIA GPU (marker ``cuda``; they skip
where ``torch.cuda.is_available()`` is false).  This module imports
neither jax nor the reference, so it runs on a machine with only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import fleet_inputs
from repro_torch.core.batched import BatchedAlertEngine
from repro_torch.core.profiles import synthetic_table
from repro_torch.kernels import alert_select as ks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _engine(device, paper_faithful=True):
    return BatchedAlertEngine(synthetic_table(0), None, overhead=0.001,
                              paper_faithful_energy=paper_faithful,
                              device=device)


def _consts(eng, **kw):
    return dict(latency=eng._latency, run_power=eng._run_power,
                weights=eng._weights, q_fail=eng._q_fail,
                overhead=eng.overhead, **kw)


@pytest.mark.parametrize("s", [1, 4097, 65536])
@pytest.mark.parametrize("paper_faithful", [True, False])
@pytest.mark.parametrize("predictions", [True, False])
def test_kernel_matches_plain(cuda_device, s, paper_faithful, predictions):
    """Picks, feasibility and relax codes exact, predictions bitwise: the
    kernel and the plain version round at the same places."""
    eng = _engine(cuda_device, paper_faithful)
    args = fleet_inputs(eng.table, s, seed=s, device=cuda_device)
    kw = _consts(eng, paper_faithful_energy=paper_faithful,
                 predictions=predictions)
    before = ks.alert_select.launches
    got = ks.alert_select(*args, **kw)
    torch.cuda.synchronize()
    assert ks.alert_select.launches == before + 1
    plain = ks.alert_select_plain(*args, **kw)
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cuda_engine_launches_the_kernel(cuda_device):
    eng = _engine(cuda_device)
    assert eng.backend == "cuda"
    st = np.random.default_rng(0)
    before = ks.alert_select.launches
    batch = eng.select(st.uniform(0.5, 2, 9), 0.1, 0.3,
                       st.uniform(0.1, 1, 9), accuracy_goal=0.7,
                       energy_goal=5.0, goal_kind=st.integers(0, 2, 9))
    assert ks.alert_select.launches == before + 1
    assert batch.model_index.shape == (9,)
    with pytest.raises(ValueError, match="does not run"):
        BatchedAlertEngine(eng.table, backend="torch", device=cuda_device)


def test_wrapper_rejects_bad_inputs(cuda_device):
    eng = _engine(cuda_device)
    args = fleet_inputs(eng.table, 16, seed=0, device=cuda_device)
    kw = _consts(eng)
    bad = list(args)
    bad[0] = bad[0].float()
    with pytest.raises(ValueError, match="mu must be"):
        ks.alert_select(*bad, **kw)
    bad = list(args)
    bad[6] = bad[6].long()
    with pytest.raises(ValueError, match="goal_kind must be"):
        ks.alert_select(*bad, **kw)
    bad = list(args)
    bad[2] = torch.stack([bad[2], bad[2]], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        ks.alert_select(*bad, **kw)
    big = synthetic_table(0, n_single=30, n_levels=4, n_power=8)
    big_eng = BatchedAlertEngine(big, None, device=cuda_device)
    with pytest.raises(ValueError, match="exceeds the kernel's limits"):
        ks.alert_select(*args, **_consts(big_eng))


def test_model_on_card_matches_cpu(cuda_device):
    """The reduced float32 model: card logits within 1e-4 of the CPU's
    (TF32 off; the card sums in another order)."""
    from chip_smoke import model_cpu_vs_card

    torch.backends.cuda.matmul.allow_tf32 = False
    assert model_cpu_vs_card(cuda_device) < 1e-4
