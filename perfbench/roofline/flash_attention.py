"""Prefill attention of ``q [B, S, h, hd]`` over ``k, v [B, T, kv, hd]``,
causal: ``4 * hd`` FLOPs a head for each live (query, key) pair (QK^T and
PV); bytes q, k, v and the output once."""

KERNEL = "flash_attention"
COUNTER = "repro_torch.kernels.flash_attention:flash_attention"


def work(call: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of one causal call (``s == t``)."""
    b, s, t = call["b"], call["s"], call["t"]
    h, kv, hd = call["h"], call["kv"], call["hd"]
    live = sum(min(i + 1, t) for i in range(s))
    return (4.0 * b * h * hd * live,
            float(call["itemsize"] * (2 * b * s * h * hd
                                      + 2 * b * t * kv * hd)))
