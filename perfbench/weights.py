"""Seeded weights, made on the device in a few large draws.

The reference family of a configuration lists every weight as ``(path,
shape, std, kind)``.  All ``"matrix"`` weights are views of one buffer in
the served type, drawn from a standard normal by one call on a generator
seeded with ``--seed``, each then scaled by its ``std``; ``"router"``
weights (float32) share a second buffer and draw; ``"norm"`` weights are
ones.  The same tensors go to the program and, upcast layer by layer, to
the reference.
"""

from __future__ import annotations

import math

import torch

ALIGN = 64          # elements: every view starts 128-byte aligned


def _place(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _padded(shape) -> int:
    return -(-math.prod(shape) // ALIGN) * ALIGN


def _views(buf: torch.Tensor, specs: list) -> list:
    out, at = [], 0
    for _, shape, _, _ in specs:
        out.append(buf[at:at + math.prod(shape)].view(shape))
        at += _padded(shape)
    return out


def make_params(specs: list, seed: int, device, dtype: torch.dtype) -> dict:
    """The parameter tree of ``specs``, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params: dict = {}
    for kind, kind_dtype in (("matrix", dtype), ("router", torch.float32)):
        group = [s for s in specs if s[3] == kind]
        if not group:
            continue
        buf = torch.empty(sum(_padded(g[1]) for g in group),
                          dtype=kind_dtype, device=device)
        buf.normal_(generator=gen)
        for spec, view in zip(group, _views(buf, group)):
            if spec[2] != 1.0:
                view.mul_(spec[2])
            _place(params, spec[0], view)
    for path, shape, _, kind in specs:
        if kind == "norm":
            _place(params, path, torch.ones(shape, dtype=dtype,
                                            device=device))
    return params
