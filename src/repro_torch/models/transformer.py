"""Decoder-only LM (port of ``repro.models.transformer`` for the families
the port runs: the width-nested anytime LM, the dense LMs without nesting,
the mixture-of-experts LMs, the hybrid (Jamba) LMs, the vision-language
family's decoder and the RWKV-6 family).

Parameters are a plain dict: ``embed [V, d]``, ``unembed [d, V]`` (absent
in a model with ``tie_embeddings``, whose logits go through ``embed.T``,
as the reference's), ``final_norm [d]`` and ``layers``, a list with one
``{"mixer": ..., "ffn": ...}`` dict per layer (the reference stacks
layers per period position for ``lax.scan``; here they are a Python
loop).  ``cfg.mixer_kind(i)`` and ``cfg.ffn_kind(i)`` pick a layer's
kinds, as in the reference: ``"attn"`` and ``"attn_local"`` layers hold
attention params and a KV cache (``"attn_local"`` attends over
``cfg.sliding_window`` positions), ``"mamba"`` layers the Mamba block
(:mod:`repro_torch.models.mamba`) and a ``MambaState`` cache, and in
``"ffn"`` the SwiGLU params of a ``"dense"`` layer or the router and
expert stacks of a ``"moe"`` layer (:mod:`repro_torch.models.moe`);
``"rwkv"`` layers hold the time and channel mix in ``"mixer"``, an empty
``"ffn"``, and an ``RwkvState`` cache.  A model with ``nest_levels > 1``
runs the nested attention and SwiGLU, and ``level`` selects the level-k
prefix subnetwork: the whole pipeline runs on the ``d_k`` prefix of the
residual stream.  A model without nesting runs the dense blocks.

``lm_apply(mode="train")`` is the training forward: no caches, every
level's logits from one pass (``all_levels``), the MoE aux loss summed,
each layer recomputed in the backward pass under ``cfg.remat``
(:func:`remat`).  It runs no kernel (none has a backward): the
``blocks``/``masked`` projections, ``ref`` attention and RWKV's chunk
scan, as the reference trains.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nesting import StripeSpec, prefix_rmsnorm
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import embed_init, rms_norm


Cache = KVCache | mamba_mod.MambaState | rwkv_mod.RwkvState


class LMOutput(NamedTuple):
    logits: torch.Tensor | list[torch.Tensor]
    caches: list[Cache] | None
    aux_loss: torch.Tensor | None = None   # a train forward's MoE aux loss


def init_layer(cfg: ModelConfig, mixer: str, ffn: str,
               generator: torch.Generator, device: torch.device) -> dict:
    if mixer == "rwkv":
        return {"mixer": rwkv_mod.rwkv_init(cfg, generator, device),
                "ffn": {}}
    init_mixer = mamba_mod.mamba_init if mixer == "mamba" \
        else attn_mod.attn_init
    init_ffn = moe_mod.moe_init if ffn == "moe" else mlp_mod.mlp_init
    return {"mixer": init_mixer(cfg, generator, device),
            "ffn": init_ffn(cfg, generator, device)}


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device=None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; a fresh seed-0 generator when omitted).  On the ``meta``
    device every leaf is an empty tensor of its shape and dtype: abstract
    state with nothing allocated or drawn."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    params = {
        "embed": embed_init((cfg.vocab, cfg.d_model), dtype, generator, dev),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init((cfg.d_model, cfg.vocab), dtype,
                                       generator, dev) * cfg.d_model ** -0.5
    params["layers"] = [init_layer(cfg, mixer, ffn, generator, dev)
                        for mixer, ffn in cfg.layer_plan()]
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> list[Cache]:
    """One decode cache per layer: zeroed ``[B, max_len, n_kv, head_dim]``
    KV buffers for attention, a zero ``MambaState`` for Mamba and a zero
    ``RwkvState`` for RWKV."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    caches = []
    for i in range(cfg.n_layers):
        if cfg.mixer_kind(i) == "rwkv":
            caches.append(rwkv_mod.rwkv_init_state(cfg, batch, dev))
        elif cfg.mixer_kind(i) == "mamba":
            caches.append(mamba_mod.mamba_init_state(cfg, batch, dev))
        else:
            caches.append(KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                                  torch.zeros(shape, dtype=dtype,
                                              device=dev)))
    return caches


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, ffn: str,
         with_aux: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The residual stream after the FFN of a layer without nesting (the
    MoE FFN of a ``"moe"`` layer, else the dense SwiGLU) and the MoE aux
    loss (None unless ``with_aux``; 0 for a dense layer)."""
    if ffn == "moe":
        out, aux = moe_mod.moe(lp["ffn"], x, cfg, with_aux=with_aux)
        return x + out, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if with_aux else None
    return x + mlp_mod.mlp(lp["ffn"], x, cfg), aux


def apply_layer(lp: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, mixer: str, ffn: str, *, cache=None,
                cache_len=None, level: int | None = None,
                pos3d: torch.Tensor | None = None, train: bool = False):
    """One pre-norm block: attention (M-RoPE at ``pos3d`` where the config
    has ``m_rope``) or Mamba, then SwiGLU (nested when ``nest_levels >
    1``; an ``"attn_local"`` layer with its sliding window) or the MoE FFN
    of a ``"moe"`` layer; or the RWKV time mix (its chunk scan when
    ``train``, else ``rwkv_scan``) + channel mix.  Returns ``(x,
    new_cache, aux)``: a MoE layer's aux loss only when ``train`` (the
    reference's ``jit`` drops it from a serving forward as dead code),
    else None; 0 for a layer without MoE."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device) \
        if train else None
    if mixer == "mamba":
        m, new_cache = mamba_mod.mamba(lp["mixer"], x, cfg, state=cache)
        x, aux = _ffn(lp, x + m, cfg, ffn, train)
        return x, new_cache, aux
    if mixer == "rwkv":
        t, wkv, tail_t = rwkv_mod.rwkv_time_mix(
            lp["mixer"], x, cfg, state=cache,
            mode="train" if train else "prefill")
        x = x + t
        c, tail_c = rwkv_mod.rwkv_channel_mix(lp["mixer"], x, cfg,
                                              state=cache)
        return x + c, rwkv_mod.RwkvState(wkv, tail_t, tail_c), zero
    window = cfg.sliding_window if mixer == "attn_local" else None
    if cfg.nest_levels > 1:
        a, new_cache = attn_mod.nested_attention(
            lp["mixer"], x, positions, cfg, level=level, window=window,
            cache=cache, cache_len=cache_len)
        x = x + a
        return x + mlp_mod.nested_mlp(lp["ffn"], x, cfg, level=level), \
            new_cache, zero
    a, new_cache = attn_mod.attention(lp["mixer"], x, positions, cfg,
                                      window=window, cache=cache,
                                      cache_len=cache_len,
                                      positions_3d=pos3d)
    x, aux = _ffn(lp, x + a, cfg, ffn, train)
    return x, new_cache, aux


def token_positions(b: int, s: int, device,
                    cache_len: int | torch.Tensor | None) -> torch.Tensor:
    """``[B, s]`` positions of the tokens of one forward: ``0..s-1`` in a
    prefill (``cache_len`` None), ``cache_len`` in a decode step (an int,
    or a 0-d or ``[B]`` integer tensor read on the device, so a CUDA graph
    of the step replays at the tensor's current value)."""
    if cache_len is None:
        return torch.arange(s, device=device).expand(b, s)
    if isinstance(cache_len, torch.Tensor):
        return cache_len.to(torch.int32).reshape(-1, 1).expand(b, s)
    return torch.full((b, s), int(cache_len), dtype=torch.int32,
                      device=device)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="save_dots"``: keep
    the outputs of products without a batch dim (``mm``, ``addmm``, the
    reference's ``dots_with_no_batch_dims_saveable``), recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward pass (activation
    checkpointing, ``use_reentrant=False``) when ``cfg.remat`` is set and
    autograd is recording; ``cfg.remat_policy == "save_dots"`` keeps the
    products' outputs.  The values are those of ``fn(*args)``."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    kw = {}
    if cfg.remat_policy == "save_dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse a train forward that would reach a kernel: the kernels have
    no backward (nor have the reference's), so training runs the
    ``blocks``/``masked`` projections and ``ref`` attention, as the
    reference trains (an RWKV layer runs its chunk scan in mode
    ``"train"``, whatever the backends)."""
    if cfg.nest_backend == "kernel" or cfg.attn_backend == "kernel":
        raise ValueError(
            f"mode 'train' runs no kernel (they have no backward): use "
            f"nest_backend 'blocks' or 'masked' and attn_backend 'ref', not "
            f"{cfg.nest_backend!r} / {cfg.attn_backend!r}")


def lm_apply(params: dict, cfg: ModelConfig, tokens: torch.Tensor | None,
             *, mode: str = "prefill", caches: list | None = None,
             cache_len: int | torch.Tensor | None = None,
             level: int | None = None, pos3d: torch.Tensor | None = None,
             embeds: torch.Tensor | None = None, all_levels: bool = False,
             return_hidden: bool = False) -> LMOutput:
    """Forward pass at nesting ``level`` (default: the deepest; a model
    without nesting takes ``None``).

    * ``mode='train'``: no caches in or out; every MoE layer's aux loss
      is summed in layer order into ``aux_loss`` (float32), and with
      ``cfg.remat`` each layer is recomputed in the backward pass
      (:func:`remat`).  ``all_levels=True`` returns a list with one
      logits tensor per level from the one forward (the nesting
      property); ``return_hidden=True`` returns the final-normed hidden
      states in place of logits (the chunked loss projects them).  A
      kernel backend raises (:func:`check_trainable`); RWKV layers run
      their chunk scan.
    * ``mode='prefill'``: ``tokens [B, S]``, no caches in; the per-layer
      k/v of the prompt (or the Mamba and RWKV states after it) come back
      (the serving engine merges them into its decode buffers).
    * ``mode='decode'``: ``tokens [B, 1]`` with ``caches`` and
      ``cache_len``, an int, a 0-d integer tensor on the device (the
      serving engine's, which its CUDA graphs read at replay) or a ``[B]``
      integer tensor, one length per row; an attention step's k/v are
      written into the caches in place, a Mamba or RWKV layer returns a
      new state.

    ``pos3d [3, B, S]`` are M-RoPE's position streams (a config with
    ``m_rope``; without them its attention runs plain RoPE), and
    ``embeds [B, S, d]`` stand in for the token embeddings (the vision
    frontend's path; ``tokens`` may then be None), as in the reference.
    With ``cfg.prefill_last_only`` a prefill returns the last position's
    logits only.  A serving forward's ``aux_loss`` is None.

    Returns ``[B, S, V]`` logits of the chosen level.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    train = mode == "train"
    if train:
        check_trainable(cfg)
    b, s = tokens.shape if embeds is None else embeds.shape[:2]
    dev = tokens.device if embeds is None else embeds.device
    decode = mode == "decode"
    positions = token_positions(b, s, dev, cache_len if decode else None)
    x = params["embed"][tokens] if embeds is None else embeds
    nested = cfg.nest_levels > 1
    if nested:
        d_spec = StripeSpec.pow2(cfg.d_model, cfg.nest_levels)
        k = cfg.nest_levels if level is None else level
        if k < cfg.nest_levels:
            x = x[..., :d_spec.width(k)]
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=dev) \
        if train else None
    plan = cfg.layer_plan()
    for i, lp in enumerate(params["layers"]):
        if train:
            def layer(lp_, x_, kinds=plan[i]):
                x_, _, aux = apply_layer(lp_, x_, positions, cfg, *kinds,
                                         level=level, pos3d=pos3d,
                                         train=True)
                return x_, aux

            x, aux = remat(cfg, layer, lp, x)
            aux_total = aux_total + aux
            continue
        x, nc, _ = apply_layer(lp, x, positions, cfg, *plan[i],
                               cache=caches[i] if decode else None,
                               cache_len=cache_len if decode else None,
                               level=level, pos3d=pos3d)
        new_caches.append(nc)
    if mode == "prefill" and cfg.prefill_last_only:
        x = x[:, -1:, :]
    out_caches = None if train else new_caches
    if return_hidden:
        return LMOutput(rms_norm(x, params["final_norm"], cfg.norm_eps),
                        out_caches, aux_total)
    unembed = params.get("unembed")
    if unembed is None:
        unembed = params["embed"].T
    if not nested:
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return LMOutput(h @ unembed, out_caches, aux_total)
    levels = range(1, cfg.nest_levels + 1) if all_levels else [k]
    logits = [prefix_rmsnorm(x, params["final_norm"], d_spec, lv,
                             cfg.norm_eps) @ unembed[:d_spec.width(lv), :]
              for lv in levels]
    return LMOutput(logits if all_levels else logits[0], out_caches,
                    aux_total)
