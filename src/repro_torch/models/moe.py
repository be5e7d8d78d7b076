"""Mixture-of-experts FFN (port of ``repro.models.moe``): a float32 top-k
router and the GShard capacity dispatch.

Tokens are cut into groups of ``MOE_GROUP_SIZE`` (or all of them when
there are fewer).  Per group of ``S_g`` tokens each expert takes at most
``C = capacity(S_g, top_k, E, capacity_factor)`` of them; assignments past
that are dropped, slot 0 of every token before slot 1 of any, and in token
order within a slot.  Dispatch and combine are products with the
``[G, S_g, E, C]`` one-hot tensors, as in the reference, so the expert
products read every expert's weights whatever the routing.
``cfg.moe_dispatch == "gather"`` runs :func:`moe_gather` instead, which
sorts the (token, slot) pairs by expert and gathers them into the expert
buffer.

Everything runs on the tensor's device with shapes fixed by the input's,
so a CUDA graph can capture the block: no host read, no data-dependent
shape, no floating-point atomics.  The one-hot tensors are comparisons
with an ``arange`` (``F.one_hot`` reads its input's range back to the
host and refuses the dropped slot's ``-1``), and every sum of floats runs
in a fixed order, so a replay is bitwise equal to the eager call.  The
router is float32 in a bf16 model, and its logits are ``xn.float() @
router``: a router product in bf16 or TF32 would flip experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, rms_norm

MOE_GROUP_SIZE = 512  # tokens per dispatch group (see module docstring)


def moe_param_shapes(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": (d, e),
        "w_gate": (e, d, f),
        "w_up": (e, d, f),
        "w_down": (e, f, d),
        "norm": (d,),
    }


def moe_init(cfg: ModelConfig, generator: torch.Generator,
             device: torch.device) -> dict:
    """Random parameters; the router is float32 whatever ``cfg.dtype``."""
    dtype = getattr(torch, cfg.dtype)
    out = {}
    for name, shape in sorted(moe_param_shapes(cfg).items()):
        if name == "norm":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = dense_init(shape, torch.float32 if name == "router"
                                   else dtype, generator, device)
    return out


def capacity(group_size: int, top_k: int, n_experts: int,
             factor: float) -> int:
    return max(int(group_size * top_k / n_experts * factor), top_k)


def route_topk(logits: torch.Tensor, top_k: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gate values [T,k] normalised, expert ids [T,k], probs
    [T,E]).  Among equal probabilities the lower expert id comes first, as
    with the reference's ``lax.top_k``: ``torch.topk`` promises no order
    among ties, so the ids are the first ``top_k`` of a stable descending
    sort."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    return vals / vals.sum(dim=-1, keepdim=True), idx, probs


def _experts(params: dict, x_e: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over their buffers ``x_e [E, N, d]``."""
    h = F.silu(torch.einsum("end,edf->enf", x_e, params["w_gate"])) \
        * torch.einsum("end,edf->enf", x_e, params["w_up"])
    return torch.einsum("enf,efd->end", h, params["w_down"])


def moe_gather(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               with_aux: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Sort/gather dispatch (``moe_dispatch="gather"``): the (token, slot)
    pairs, slot-major, are sorted by expert id (stable), written into the
    ``[E*C, d]`` expert buffer (pairs past capacity go to a sentinel row
    that is dropped), and the expert outputs gathered back.  Same results
    as :func:`moe` when no expert overflows; under overflow the drop
    priority is the same (slot-major, then token order), over one group of
    all the tokens.  Each token's ``top_k`` contributions are summed in
    slot order in ``x.dtype`` (the reference scatter-adds them), so the sum
    is the same on every run.  Returns ``(out [B,S,d], aux)``; ``aux`` is
    None unless ``with_aux``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    c = capacity(t, k, e, cfg.capacity_factor)
    dev = x.device

    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    flat = xn.reshape(t, d)
    vals, idx, probs = route_topk(flat.float() @ params["router"], k)

    expert_flat = idx.T.reshape(-1)                    # [k*T], slot-major
    token_flat = torch.arange(t, device=dev).repeat(k)
    order = torch.argsort(expert_flat, stable=True)
    sorted_exp = expert_flat[order]
    first = torch.searchsorted(sorted_exp, sorted_exp, side="left")
    pos = torch.arange(k * t, device=dev) - first      # position in expert
    keep = pos < c
    dest = torch.where(keep, sorted_exp * c + pos, e * c)  # sentinel row

    buf = flat.new_zeros((e * c + 1, d))
    buf[dest] = flat[token_flat[order]]     # kept rows are distinct
    y_e = _experts(params, buf[:e * c].reshape(e, c, d))
    y_e = torch.cat([y_e.reshape(e * c, d), y_e.new_zeros((1, d))])

    dest_slot_major = torch.empty_like(dest)
    dest_slot_major[order] = dest
    contrib = (y_e[dest_slot_major] * vals.T.reshape(-1, 1).to(y_e.dtype)
               ).to(x.dtype).reshape(k, t, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for slot in range(k):
        out = out + contrib[slot]
    if not with_aux:
        return out.reshape(b, s, d), None

    kept = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, sorted_exp, keep.long())                    # integer: exact
    frac = kept.float() / t
    aux = e * torch.sum(frac / k * probs.mean(dim=0))
    return out.reshape(b, s, d), aux


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig,
        group_size: int = MOE_GROUP_SIZE, *, with_aux: bool = True
        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Returns (output [B,S,d], aux load-balancing loss scalar); ``aux`` is
    None unless ``with_aux`` (the serving path has no use for it)."""
    if cfg.moe_dispatch == "gather":
        return moe_gather(params, x, cfg, with_aux=with_aux)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    sg = min(group_size, t)
    if t % sg:
        raise ValueError(f"tokens {t} not divisible by group size {sg}")
    g = t // sg
    c = capacity(sg, k, e, cfg.capacity_factor)
    dev = x.device

    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    flat = xn.reshape(g, sg, d)
    logits = flat.float() @ params["router"]
    vals, idx, probs = route_topk(logits.reshape(t, e), k)
    idx = idx.reshape(g, sg, k).transpose(1, 2)        # [g, k, sg]
    vals = vals.reshape(g, sg, k).transpose(1, 2)

    # The reference walks the k slots in order and carries each expert's
    # count of kept tokens, so a token's position in its expert is its
    # rank among that expert's assignments in slot-major order (slot 0 of
    # every token first), and it is kept iff the rank is below C: one
    # cumulative sum over the slot-major assignments gives the same ranks.
    oh = idx[..., None] == torch.arange(e, device=dev)          # [g,k,sg,e]
    rank = torch.cumsum(oh.reshape(g, k * sg, e).to(torch.int32),
                        dim=1).reshape(g, k, sg, e) - 1
    keep = oh & (rank < c)
    # A (token, expert) pair is in at most one slot, so these reductions
    # over the slots pick that slot's entry exactly.
    pos = torch.where(keep, rank, -1).amax(dim=1)      # [g,sg,e]; -1: none
    gate = torch.where(keep, vals[..., None], 0.0).sum(dim=1)
    dispatch = (pos[..., None] == torch.arange(c, device=dev)).to(x.dtype)
    combine = dispatch.float() * gate[..., None]       # [g,sg,e,c] float32

    x_e = torch.einsum("gsec,gsd->egcd", dispatch, flat)
    y_e = _experts(params, x_e.reshape(e, g * c, d)).reshape(e, g, c, d)
    out = torch.einsum("egcd,gsec->gsd", y_e, combine.to(x.dtype))
    if not with_aux:
        return out.reshape(b, s, d), None

    # Load-balancing aux loss (Switch/GShard): E * sum_e f_e * P_e.
    frac_dispatched = (pos >= 0).float().mean(dim=1)            # [g,e]
    mean_prob = probs.reshape(g, sg, e).mean(dim=1)             # [g,e]
    aux = e * torch.mean(torch.sum(frac_dispatched * mean_prob, dim=-1))
    return out.reshape(b, s, d), aux
