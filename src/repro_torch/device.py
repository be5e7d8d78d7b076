"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).

    Raises when CUDA is asked for and missing: the port runs on the card
    unless the caller passes ``device="cpu"`` explicitly, so nothing falls
    back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the port on the CPU")
    return dev
