"""``run.py`` exits non-zero and prints no result without a card, and in a
directory that holds only the benchmark's own files."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent
ARGS = ["--workload", "mistral7b-nested.score", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def _run(root: Path):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=120)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA is not available" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(HOME, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
