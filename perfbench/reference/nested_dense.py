"""Plain reference of the width-nested anytime LM (paper Section 4).

A width-``D`` dimension is cut into K stripes of power-of-2 level widths.
Output stripe i of a projection reads only the input prefix of level
``min(i, K_in)``; before a projection each output stripe is divided by the
RMS of that input prefix ("prefix RMSNorm").  Level k runs the whole model
on the ``d_k`` prefix of the residual stream: k/K of the query and key
heads, the ``d_ff`` prefix of the SwiGLU, and the unembedding of the
``d_k`` prefix.  Attention is causal softmax with rotary positions.

The forward runs in float32 (TF32 off) over the served input's prompt and
served tokens, one causal pass, which equals the served prefill followed
by cached decode steps.  It reads the benchmark's own weights; nothing of
the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import (causal_attention, head_bounds, mm,
                                        q8, rms, rope, stripe_bounds)

PROJECTIONS = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")


def param_specs(cfg: dict) -> list:
    """``(path, shape, std, kind)`` of every weight: ``kind`` is
    ``"matrix"`` (drawn, scaled by ``std``) or ``"norm"`` (ones)."""
    d, v, f = cfg["d_model"], cfg["vocab"], cfg["d_ff"]
    hq = cfg["n_heads"] * cfg["head_dim"]
    hkv = cfg["n_kv_heads"] * cfg["head_dim"]
    specs = [(("embed",), (v, d), 1.0, "matrix"),
             (("unembed",), (d, v), d ** -0.5, "matrix"),
             (("final_norm",), (d,), 1.0, "norm")]
    wo_std = hq ** -0.5 / (2 * cfg["n_layers"]) ** 0.5
    for i in range(cfg["n_layers"]):
        mix, ffn = ("layers", i, "mixer"), ("layers", i, "ffn")
        specs += [(mix + ("norm",), (d,), 1.0, "norm"),
                  (mix + ("wq",), (d, hq), d ** -0.5, "matrix"),
                  (mix + ("wk",), (d, hkv), d ** -0.5, "matrix"),
                  (mix + ("wv",), (d, hkv), d ** -0.5, "matrix"),
                  (mix + ("wo",), (hq, d), wo_std, "matrix"),
                  (ffn + ("norm",), (d,), 1.0, "norm"),
                  (ffn + ("w_gate",), (d, f), d ** -0.5, "matrix"),
                  (ffn + ("w_up",), (d, f), d ** -0.5, "matrix"),
                  (ffn + ("w_down",), (f, d), f ** -0.5, "matrix")]
    return specs


def _bounds(cfg: dict):
    k, hd = cfg["nest_levels"], cfg["head_dim"]
    return (stripe_bounds(cfg["d_model"], k),
            head_bounds(cfg["n_heads"], hd, k),
            head_bounds(cfg["n_kv_heads"], hd, k),
            stripe_bounds(cfg["d_ff"], k))


def _nested(h, w, in_b, out_b, level, control, gamma=None, eps=0.0):
    """Block-triangular product of ``h`` with ``w``: output stripe i from
    the input prefix of level ``min(i, K_in)``, normalised by that
    prefix's RMS where ``gamma`` is given."""
    k_in = len(in_b) - 1
    outs = []
    for i in range(1, level + 1):
        lo, hi = out_b[i - 1], out_b[i]
        if hi == lo:
            continue
        hp = h[..., :in_b[min(i, k_in)]]
        if gamma is None:
            outs.append(mm(hp, w[:hp.shape[-1], lo:hi], control))
        else:
            y = mm(hp * gamma[:hp.shape[-1]], w[:hp.shape[-1], lo:hi],
                   control)
            outs.append(y * rms(hp, eps))
    return torch.cat(outs, dim=-1)


def _layer(x, lp, cfg, level, control):
    d_b, q_b, kv_b, f_b = _bounds(cfg)
    eps, hd = cfg["norm_eps"], cfg["head_dim"]
    mix = {n: t.float() for n, t in lp["mixer"].items()}
    ffn = {n: t.float() for n, t in lp["ffn"].items()}
    if control:
        for n in PROJECTIONS:
            mix[n] = q8(mix[n], 0)
        for n in MLP:
            ffn[n] = q8(ffn[n], 0)
    rows, length, _ = x.shape
    q = _nested(x, mix["wq"], d_b, q_b, level, control, mix["norm"], eps)
    k = _nested(x, mix["wk"], d_b, kv_b, level, control, mix["norm"], eps)
    v = _nested(x, mix["wv"], d_b, kv_b, level, control, mix["norm"], eps)
    nq, nkv = q.shape[-1] // hd, k.shape[-1] // hd
    theta = cfg["rope_theta"]
    o = causal_attention(rope(q.reshape(rows, length, nq, hd), theta),
                         rope(k.reshape(rows, length, nkv, hd), theta),
                         v.reshape(rows, length, nkv, hd))
    x = x + _nested(o.reshape(rows, length, nq * hd), mix["wo"], q_b, d_b,
                    level, control)
    gate = _nested(x, ffn["w_gate"], d_b, f_b, level, control, ffn["norm"],
                   eps)
    up = _nested(x, ffn["w_up"], d_b, f_b, level, control, ffn["norm"], eps)
    return x + _nested(F.silu(gate) * up, ffn["w_down"], f_b, d_b, level,
                       control)


def logits(params: dict, cfg: dict, toks: torch.Tensor, level: int,
           s0: int, control: bool):
    """Float32 logits ``[N, B, n, V]`` at the served positions of ``toks
    [N, B, L]`` (``L = s0 + n - 1``) at nesting ``level``, and the same
    from the control (float8 products) when ``control``."""
    n_in, b, length = toks.shape
    d_b = _bounds(cfg)[0]
    dk = d_b[level]
    emb = params["embed"][toks.reshape(n_in * b, length)][..., :dk].float()
    streams = [(emb, False)] + ([(emb.clone(), True)] if control else [])
    outs = []
    for x, ctl in streams:
        for lp in params["layers"]:
            x = _layer(x, lp, cfg, level, ctl)
        x = x[:, s0 - 1:]
        h = x * rms(x, cfg["norm_eps"]) * params["final_norm"][:dk].float()
        w = params["unembed"][:dk].float()
        lg = mm(h, q8(w, 0) if ctl else w, ctl)
        outs.append(lg.reshape(n_in, b, length - s0 + 1, -1))
    return outs[0], (outs[1] if control else None)


def _triangle(in_b, out_b, level) -> int:
    """Live weight elements of one nested projection at ``level``."""
    k_in = len(in_b) - 1
    return sum(in_b[min(i, k_in)] * (out_b[i] - out_b[i - 1])
               for i in range(1, level + 1))


def _projections(cfg: dict, level: int):
    """``(in bounds, out bounds)`` of the seven projections a layer runs."""
    d_b, q_b, kv_b, f_b = _bounds(cfg)
    return [(d_b, q_b), (d_b, kv_b), (d_b, kv_b), (q_b, d_b),
            (d_b, f_b), (d_b, f_b), (f_b, d_b)]


def forward_flops(cfg: dict, level: int, batch: int, new: int,
                  ctx: int) -> float:
    """Model FLOPs of one served forward at ``level``: ``new`` tokens a
    row after ``ctx`` cached ones, the live blocks of every projection,
    causal attention over the live (query, key) pairs, and the
    unembedding of the one position a row whose logits pick a token."""
    d_b, q_b, _, _ = _bounds(cfg)
    proj = sum(2 * _triangle(i, o, level) for i, o in
               _projections(cfg, level))
    pairs = sum(ctx + t + 1 for t in range(new))
    attn = 4 * q_b[level] * pairs
    unembed = 2 * d_b[level] * cfg["vocab"]
    return float(cfg["n_layers"] * batch * (new * proj + attn)
                 + batch * unembed)


def kernel_calls(cfg: dict, level: int, batch: int, new: int,
                 ctx: int) -> list:
    """The hand-written kernels one served forward launches, with the
    shapes their work formulas take."""
    _, q_b, kv_b, _ = _bounds(cfg)
    hd = cfg["head_dim"]
    calls = [("nested_matmul", {"m": batch * new, "in_bounds": i,
                                "out_bounds": o, "level": level,
                                "itemsize": 2})
             for i, o in _projections(cfg, level)]
    h, kv = q_b[level] // hd, kv_b[level] // hd
    if ctx == 0:
        calls.append(("flash_attention", {"b": batch, "s": new, "t": new,
                                          "h": h, "kv": kv, "hd": hd,
                                          "itemsize": 2}))
    else:
        calls.append(("decode_attention", {"b": batch, "h": h, "kv": kv,
                                           "hd": hd,
                                           "live": [ctx + 1] * batch,
                                           "itemsize": 2}))
    return calls * cfg["n_layers"]
