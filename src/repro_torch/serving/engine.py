"""Serving engine: batched prefill + cached greedy decode, one program
per anytime level (port of ``repro.serving.engine``).

PyTorch runs eagerly, so a "program per level" is simply ``lm_apply`` at
that level; caches are sized to the level's KV width, since the controller
fixes a request's level for its whole generation.  A model without
nesting (RWKV-6) has the one level ``None``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import Model


@dataclasses.dataclass
class ServeEngine:
    """Per-level serving of one model on ``device`` (default ``"cuda"``):
    prefill, then greedy cached decode."""

    model: Model
    max_len: int
    batch_size: int
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = self.model.cfg
        self.levels = list(range(1, cfg.nest_levels + 1)) \
            if cfg.nest_levels > 1 else [None]

    def init_caches(self, level: int | None = None):
        """Fresh KV decode caches of a nested model, sized to ``level``'s
        KV width."""
        from repro_torch.models.attention import head_stripe_specs

        cfg = self.model.cfg
        lvl = cfg.nest_levels if level is None else level
        _, _, kv_spec = head_stripe_specs(cfg)
        n_kv = kv_spec.width(lvl) // cfg.head_dim
        lvl_cfg = cfg.replace(n_kv_heads=max(n_kv, 1))
        return tfm.init_caches(lvl_cfg, self.batch_size, self.max_len,
                               device=self.device)

    def generate(self, params, prompt: np.ndarray, n_new: int,
                 level: int | None = None,
                 deadline_s: float | None = None,
                 clock=None) -> dict:
        """Greedy-decode ``n_new`` tokens after ``prompt [B, S0]``.

        ``level`` None runs the deepest level (a model without nesting has
        no other).  A deadline (seconds on ``clock``, default
        ``time.perf_counter``) makes generate return the tokens complete at
        expiry.  Each step's token is copied to the
        host before the next clock read, which waits for the card, so
        deadline checks and the reported latency include the compute.
        """
        if clock is None:
            clock = time.perf_counter
        t0 = clock()
        cfg = self.model.cfg
        lvl = level if level is not None or cfg.nest_levels == 1 \
            else cfg.nest_levels
        s0 = prompt.shape[1]
        with torch.inference_mode():
            tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                     device=self.device)
            out = tfm.lm_apply(params, cfg, tokens, mode="prefill",
                               level=lvl)
            # A model without nesting (RWKV-6) carries fixed-size states
            # that decode continues from as they are.
            caches = out.caches if cfg.nest_levels == 1 else \
                self._merge(self.init_caches(lvl), out.caches)
            next_tok = torch.argmax(out.logits[:, -1:], dim=-1)
            toks = [next_tok.cpu().numpy().astype(np.int32)]
            for i in range(n_new - 1):
                if deadline_s is not None and clock() - t0 > deadline_s:
                    break
                o = tfm.lm_apply(params, cfg, next_tok, mode="decode",
                                 caches=caches, cache_len=s0 + i, level=lvl)
                caches = o.caches
                next_tok = torch.argmax(o.logits[:, -1:], dim=-1)
                toks.append(next_tok.cpu().numpy().astype(np.int32))
        return {
            "tokens": np.concatenate(toks, axis=1),
            "latency": clock() - t0,
            "level": lvl,
            "complete": len(toks) == n_new,
        }

    @staticmethod
    def _merge(buffers, prefill):
        """Copy each layer's prefill k/v into the front of its decode
        buffers (in place) and return the buffers."""
        for buf, pre in zip(buffers, prefill):
            for b, p in zip(buf, pre):
                b[:, :p.shape[1]] = p.to(b.dtype)
        return buffers
