"""Work formulas of the hand-written kernels, one file a kernel, and the
card's peaks.  ``<kernel>.py`` holds ``KERNEL`` (the text every device
kernel name of it contains), ``COUNTER`` (``"<module>:<function>"`` of
the program, whose ``launches`` counts the kernel's calls) and
``work(call) -> (flops, bytes)`` for one call, counting each input byte
read once and each output byte written once.  The harness finds every
file here by itself."""

# NVIDIA's data sheet for the H100 SXM, dense: bf16 tensor cores and HBM3.
PEAKS = {"H100": {"flops": 989e12, "bytes": 3.35e12}}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind``."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    raise KeyError(f"no peaks for {kind!r}")


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / peak["flops"], nbytes / peak["bytes"])
