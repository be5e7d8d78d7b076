"""The benchmark's files against BENCHMARK.json and its naming
rules; nothing under perfbench/ imports JAX or the JAX package; a new cell
and a new metric are picked up from added files alone."""

import ast
import hashlib
import json
import re
import time
from pathlib import Path

import pytest

from perfbench import harness

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HOME.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HOME)))
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_top_level_names_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.serving\nfrom repro.core import x\n")
    assert _imports(f) & FORBIDDEN == {"repro"}


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    assert {m["name"] for m in BENCH["end_to_end"]} >= {
        "goodput", "p95_input_ms", "energy_per_good_j",
        "delivered_accuracy", "setup_s"}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_workloads_name_configs_and_mixes():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cfg = json.loads((REPO / configs[w["config"]]["file"]).read_text())
        assert (HOME / "reference" / f"{cfg['reference']}.py").exists()
        mix = json.loads((HOME / "workloads" / f"{w['traffic']}.json")
                         .read_text())
        assert len(mix["level_latency_ms"]) == len(cfg["level_accuracies"])
        assert w["chips"] == 1


def test_metrics_resolve_to_files():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HOME / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert (HOME / "roofline" / f"{kernel}.py").exists()


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_cell_and_metric_are_found(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    mix = json.loads((root / "perfbench/workloads/tiny-a.json").read_text())
    mix["gen_tokens"] = 2
    (root / "perfbench/workloads/tiny-a2.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/tokens_out.py").write_text(
        '"""Served tokens in the window."""\n\n\n'
        "def read(run):\n"
        '    """Tokens."""\n'
        "    return float(sum(s.tokens.size for s in run.inputs))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny-a2", config="tiny-anytime",
                                   traffic="tiny-a2", chips=1, why="added"))
    bench["end_to_end"].append(dict(name="tokens_out", unit="tokens",
                                    better="higher", bound=0.05,
                                    source="host_clock",
                                    workloads=["tiny-a2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == [Path("BENCHMARK.json")]
    r = harness.run_cell("tiny-a2", 5, 0.2, False, root=root, device="cpu",
                         t_start=time.perf_counter())
    assert r["metrics"]["tokens_out"]["value"] > 0
    assert r["correct"]


def test_added_roofline_is_found(tiny_root, tmp_path):
    import importlib
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    (root / "perfbench/roofline/rwkv_scan.py").write_text(
        '"""A kernel added later."""\n\n'
        'KERNEL = "rwkv_scan"\n'
        'COUNTER = "repro_torch.kernels.rwkv_scan:rwkv_scan"\n\n\n'
        "def work(call):\n"
        '    """One call."""\n'
        "    return 1.0, 1.0\n")
    after = _digests(root)
    assert [p for p in before if before[p] != after[p]] == []
    found = harness.Bench(root).rooflines()
    assert set(found) == {"nested_matmul", "flash_attention", "rwkv_scan"}
    importlib.import_module("repro_torch.kernels.rwkv_scan")
    assert harness._launches(found)["rwkv_scan"] >= 0


def test_rooflines_name_the_program_counters():
    import importlib

    for kernel, mod in harness.Bench().rooflines().items():
        module, func = mod.COUNTER.split(":")
        assert func == kernel and mod.KERNEL in kernel
        assert hasattr(getattr(importlib.import_module(module), func),
                       "launches")
