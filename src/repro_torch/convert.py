"""Carry weights of the JAX reference LM into the port.

``params_from_jax`` takes the pytree that ``repro.models.transformer.init_lm``
returns, with every leaf already a numpy array, and builds the port's
parameter dict (:mod:`repro_torch.models.transformer`).  The reference
stacks layers per period position for ``lax.scan``
(``params["group"]["pos<p>"]``, leading axis = repeat) and keeps
remainder layers as ``params["rem<i>"]``; layer ``rep * period + pos``
of the stack is unstacked into ``layers[rep * period + pos]`` and the
remainders follow.  Matrices keep the reference's ``[in, out]`` layout
(used as ``x @ W``), so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters from the reference's numpy pytree, on
    ``device`` (default ``"cuda"``), dtypes unchanged."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def tree(d):
        return {name: tree(v) if isinstance(v, dict) else t(v)
                for name, v in d.items()}

    layers = []
    group = np_params.get("group", {})
    n_pos = len(group)
    n_rep = 0
    if n_pos:
        first = group["pos0"]["mixer"]["wq"]
        n_rep = np.asarray(first).shape[0]
    for rep in range(n_rep):
        for pos in range(n_pos):
            stacked = group[f"pos{pos}"]
            layers.append({part: {name: t(np.asarray(w)[rep])
                                  for name, w in stacked[part].items()}
                           for part in ("mixer", "ffn")})
    i = 0
    while f"rem{i}" in np_params:
        layers.append(tree(np_params[f"rem{i}"]))
        i += 1
    if len(layers) != cfg.n_layers:
        raise ValueError(f"found {len(layers)} layers in the reference "
                         f"pytree, config {cfg.name!r} has {cfg.n_layers}")
    return {"embed": t(np_params["embed"]),
            "unembed": t(np_params["unembed"]),
            "final_norm": t(np_params["final_norm"]),
            "layers": layers}
