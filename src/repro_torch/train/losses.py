"""Training losses (port of ``repro.train.losses``): next-token
cross-entropy, whole or over sequence chunks, token accuracy, and the
anytime joint loss re-exported from :mod:`repro_torch.core.nesting`."""

from __future__ import annotations

import torch

from repro_torch.core.nesting import joint_anytime_loss

__all__ = ["cross_entropy", "chunked_cross_entropy", "token_accuracy",
           "joint_anytime_loss"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE, float32.  ``logits [B, S, V]`` (any float
    dtype), ``labels [B, S]`` (any integer dtype)."""
    lse = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lse, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def chunked_cross_entropy(hidden: torch.Tensor, unembed: torch.Tensor,
                          labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """CE from the final hidden states ``[B, S, d]`` without the whole
    ``[B, S, V]`` logits: one sequence chunk at a time, the chunks' float32
    sums of log-likelihoods accumulated in order, as the reference's
    ``lax.scan`` accumulates them."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk):
        logits = hidden[:, start:start + chunk] @ unembed
        lse = torch.log_softmax(logits.float(), dim=-1)
        yc = labels[:, start:start + chunk].long()
        total = total + torch.sum(torch.gather(lse, -1, yc[..., None]))
    return -total / torch.tensor(float(b * s), device=hidden.device)


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of positions whose argmax (the first among ties) is the
    label, float32."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels.long())
                      .float())
