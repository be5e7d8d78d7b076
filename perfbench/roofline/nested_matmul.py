"""Block-lower-triangular nested product ``x [M, K_in] @ w``: output stripe
i reads the input prefix of level ``min(i, K_in)``; ``level`` truncates
the output.  FLOPs are the live blocks' multiply-adds times two; bytes the
level-prefix ``x``, the live weight blocks and the output."""

KERNEL = "nested_matmul"
COUNTER = "repro_torch.kernels.nested_matmul:nested_matmul"


def _live(in_b, out_b, level) -> int:
    k_in = len(in_b) - 1
    return sum(in_b[min(i, k_in)] * (out_b[i] - out_b[i - 1])
               for i in range(1, level + 1))


def work(call: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of one call."""
    m, lvl = call["m"], call["level"]
    in_b, out_b = call["in_bounds"], call["out_bounds"]
    live = _live(in_b, out_b, lvl)
    x_cols = in_b[min(lvl, len(in_b) - 1)]
    n_cols = out_b[lvl]
    return (2.0 * m * live,
            float(call["itemsize"] * (m * x_cols + live + m * n_cols)))
