"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the reference package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module)
    return names


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(n for n in imported_modules(path) if forbidden(n))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_without_loading_jax():
    """Importing the whole port (with the start-up hook of ``src`` active)
    loads neither jax nor the reference."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in PORT_FILES if p.name not in ("chip_smoke.py",
                                              "__init__.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro')]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
