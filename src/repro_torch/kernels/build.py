"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point; ``nvcc`` compiles it
into a shared library for ``sm_90a`` (Hopper) and :func:`load` opens it
with ``ctypes``.  Builds happen on first use, never at import, and go to
``_build/`` beside this file (listed in ``.gitignore``).  A library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused.  :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """One kernel library: where it is, the seconds its ``nvcc`` took
    (0.0 when an earlier build was reused) and the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills)."""

    name: str
    path: Path
    seconds: float
    log: str
    reused: bool


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH`` or under PyTorch's
    ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Content-addressed path of kernel ``name``'s shared library."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names) -> dict[str, BuildResult]:
    """Compile every kernel in ``names`` whose library is missing, with
    one ``nvcc`` process per source started together; raises with the
    compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            results[name] = BuildResult(name, path, 0.0, "", True)
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builders never see a
        #                        half-written library
        results[name] = BuildResult(name, path, time.perf_counter() - t0,
                                    log, False)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LOADED[name] = lib
    return lib
