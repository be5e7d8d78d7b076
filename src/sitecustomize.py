"""Interpreter start-up hook for processes run with ``PYTHONPATH=src``.

jax 0.9 removed ``jax.experimental.enable_x64`` in favour of
``jax.enable_x64``; the JAX reference package (``repro``) still imports the
old name.  This hook restores it: a meta-path finder waits for
``jax.experimental`` to be imported and, once that module has executed,
aliases ``enable_x64`` to ``jax.enable_x64`` when the name is missing.

The hook never imports jax itself, so processes that use only the PyTorch
port (``repro_torch``) stay jax-free.  As a ``sitecustomize`` module on
``PYTHONPATH`` it also reaches every subprocess that inherits that path.
"""

from __future__ import annotations

import importlib.abc
import sys

_TARGET = "jax.experimental"


def _alias_enable_x64(module) -> None:
    """Set ``module.enable_x64 = jax.enable_x64`` if the name is missing."""
    if "enable_x64" in vars(module):
        return
    jax = sys.modules.get("jax")
    new = getattr(jax, "enable_x64", None) if jax is not None else None
    if new is not None:
        module.enable_x64 = new


class _Loader(importlib.abc.Loader):
    """Wraps the real loader of ``jax.experimental``; aliases after exec."""

    def __init__(self, inner):
        self._inner = inner

    def create_module(self, spec):
        return self._inner.create_module(spec)

    def exec_module(self, module):
        self._inner.exec_module(module)
        _alias_enable_x64(module)


class _Finder(importlib.abc.MetaPathFinder):
    """Finds ``jax.experimental`` through the other finders, then wraps its
    loader; every other import passes through untouched."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != _TARGET:
            return None
        for finder in sys.meta_path:
            if finder is self or not hasattr(finder, "find_spec"):
                continue
            spec = finder.find_spec(fullname, path, target)
            if spec is not None:
                if spec.loader is not None:
                    spec.loader = _Loader(spec.loader)
                return spec
        return None


if not any(isinstance(f, _Finder) for f in sys.meta_path):
    sys.meta_path.insert(0, _Finder())
