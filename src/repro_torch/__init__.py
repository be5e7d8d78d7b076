"""PyTorch/CUDA port of the ALERT reproduction (the JAX package ``repro``
is the reference).

The layout mirrors ``repro`` (``core/``, ``kernels/``, ``configs/``,
``models/``, ``serving/``) so each module's counterpart is found by name.
The port imports ``torch``, numpy and scipy only; it never imports jax or
the reference package.  Entry points take an explicit ``device`` that
defaults to ``"cuda"`` and raise when CUDA is missing unless the caller
passed ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
