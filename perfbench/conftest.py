"""Fixtures of the benchmark's own tests: the ``cuda`` marker, a card
fixture that skips where there is none, and a copy of the benchmark with
a tiny cell that runs on the CPU in well under a second."""

import json
import shutil
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parent
REPO = HOME.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is "
        "not available")


@pytest.fixture
def cuda_device():
    """The card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: run on the GPU machine")
    return "cuda"


TINY_ANYTIME = dict(name="tiny-anytime", n_layers=2, d_model=64, n_heads=8,
                    n_kv_heads=4, head_dim=8, d_ff=128, vocab=256,
                    nest_levels=3, level_accuracies=[0.62, 0.71, 0.78])
TINY_MIX = dict(batch=2, prompt_len=8, gen_tokens=3, warmup_ticks=1,
                trace_ticks=1, check_inputs=6,
                limits={"logit_gap": 0.002, "pick_gap": 1e-9,
                        "state_gap": 1e-9})
BASE_CONFIG = "mistral-7b-v0.3-nested4"
BASE_MIX = "score"


def make_tiny(dst: Path) -> Path:
    """A checkout-like copy of the benchmark under ``dst`` whose
    ``BENCHMARK.json`` holds the cell ``tiny-a``: the benchmark's
    configuration cut to 2 layers of d 64 (8 query heads over 4 KV heads,
    3 levels) under its own mix at 2 rows of 8 prompt tokens and 3 out,
    the deadlines a second or more so that every input completes."""
    shutil.copytree(HOME, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((HOME / "configs" / f"{BASE_CONFIG}.json").read_text())
    cfg.update(TINY_ANYTIME)
    (dst / "perfbench" / "configs" / "tiny-anytime.json").write_text(
        json.dumps(cfg))
    bench["configs"] = [dict(name="tiny-anytime", source=cfg["source"],
                             reduced=[], why="CPU tests",
                             file="perfbench/configs/tiny-anytime.json")]
    mix = json.loads((HOME / "workloads" / f"{BASE_MIX}.json").read_text())
    mix.update(TINY_MIX, level_latency_ms=[1e3, 1e3, 1e3])
    (dst / "perfbench" / "workloads" / "tiny-a.json").write_text(
        json.dumps(mix))
    bench["workloads"] = [dict(name="tiny-a", config="tiny-anytime",
                               traffic="tiny-a", chips=1, why="CPU tests")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A benchmark copy with the tiny cell (shared, read only)."""
    return make_tiny(tmp_path_factory.mktemp("perfbench_tiny"))
