"""Carry weights of the JAX reference LM into the port.

``params_from_jax`` takes the pytree that ``repro.models.transformer.init_lm``
returns, with every leaf already a numpy array, and builds the port's
parameter dict (:mod:`repro_torch.models.transformer`).  The reference
stacks layers per period position for ``lax.scan``
(``params["group"]["pos<p>"]``, leading axis = repeat) and keeps
remainder layers as ``params["rem<i>"]``; layer ``rep * period + pos``
of the stack is unstacked into ``layers[rep * period + pos]`` and the
remainders follow (gemma3-1b: ``pos0..pos5`` x 4 repeats, then ``rem0``
and ``rem1``), so layer ``i`` lands where ``cfg.mixer_kind(i)`` expects
it.  Every leaf is carried, the q/k/v biases of a ``qkv_bias`` model
included.  A MoE layer's ``"ffn"`` holds the router ``[d, E]`` (float32
in a bf16 model, as the reference keeps it) and the expert stacks
``w_gate``/``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f, d]``; the
repeat axis in front of them is the one unstacked.  A Mamba layer's
``"mixer"`` holds its block, ``a_log``, ``d_skip``, ``conv_b`` and
``dt_bias`` float32 in a bf16 model as the reference keeps them (jamba's
reduced config: ``pos0..pos5`` x 1 and ``rem0``, ``rem1``; 16 layers of
the full one: ``pos0..pos7`` x 2).  An RWKV layer keeps its whole block
in ``"mixer"`` and has an empty ``"ffn"``.  A tied model
(``tie_embeddings``) has no ``unembed``.

An encoder-decoder's pytree (``repro.models.whisper.init_encdec``) stacks
its layers whole: ``params["encoder"]`` (``{"attn", "ffn"}``, leading
axis ``encoder_layers``) and ``params["decoder"]`` (``{"self", "cross",
"ffn"}``, leading axis ``n_layers``) are unstacked into lists of per-layer
dicts, and ``embed``, ``unembed``, ``final_norm`` and ``enc_final_norm``
are carried as they are (:mod:`repro_torch.models.whisper`).  Matrices
keep the reference's ``[in, out]`` layout (used as ``x @ W``), so nothing
is transposed.
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
        a = np.array(a)
        if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: by its bits
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    def tree(d, i=None):
        """``d`` with every leaf carried (of a stack: its entry ``i``)."""
        return {name: tree(v, i) if isinstance(v, dict) else
                t(v if i is None else np.asarray(v)[i])
                for name, v in d.items()}

    if "encoder" in np_params:
        stacks = {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
        out = {name: t(w) for name, w in np_params.items()
               if name not in stacks}
        for name, n in stacks.items():
            first = np.asarray(next(iter(
                np_params[name]["ffn"].values())))
            if first.shape[0] != n:
                raise ValueError(f"found {first.shape[0]} {name} layers in "
                                 f"the reference pytree, config "
                                 f"{cfg.name!r} has {n}")
            out[name] = [tree(np_params[name], i) for i in range(n)]
        return out

    layers = []
    group = np_params.get("group", {})
    n_pos = len(group)
    n_rep = 0
    if n_pos:
        first = next(iter(group["pos0"]["mixer"].values()))
        n_rep = np.asarray(first).shape[0]
    for rep in range(n_rep):
        for pos in range(n_pos):
            layers.append(tree(group[f"pos{pos}"], rep))
    i = 0
    while f"rem{i}" in np_params:
        layers.append(tree(np_params[f"rem{i}"]))
        i += 1
    if len(layers) != cfg.n_layers:
        raise ValueError(f"found {len(layers)} layers in the reference "
                         f"pytree, config {cfg.name!r} has {cfg.n_layers}")
    out = {"embed": t(np_params["embed"]),
           "final_norm": t(np_params["final_norm"]), "layers": layers}
    if "unembed" in np_params:
        out["unembed"] = t(np_params["unembed"])
    return out
