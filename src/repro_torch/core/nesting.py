"""Anytime width nesting, paper Section 4 (port of ``repro.core.nesting``).

A width-``D`` dimension is split into K stripes with power-of-2 level
widths; connectivity between striped dims is block-lower-triangular
(output stripe i reads input stripes j <= i), so the level-k prefix of the
full network is the standalone level-k subnetwork.  Pre-norm nesting
("prefix RMSNorm") divides each output stripe by the RMS of its input
prefix, so normalisation never lets an early stripe see a later one.

Matrices keep the reference's ``[in, out]`` layout and are applied as
``x @ W``.

Training (paper Section 4.3): :func:`joint_anytime_loss` weighs the
per-level losses of one forward pass, so one backward trains every level;
greedy stage-wise training puts all weight on one level
(:func:`greedy_stage_weights`) and freezes the earlier stripes
(:func:`freeze_prefix`).  Depth nesting (:class:`DepthSpec`,
:func:`depth_nested_apply`) interlaces layer subsets, each deeper level
doubling the layers run.  The ``blocks`` backend multiplies only the live blocks; the
``masked`` backend is the dense oracle with the dropped blocks zeroed;
the ``kernel`` backend runs the hand-written ``nested_matmul`` kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StripeSpec:
    """Partition of one dimension into nesting stripes: ``boundaries`` has
    K+1 entries, ``boundaries[k]`` = cumulative width of level k."""

    boundaries: tuple[int, ...]

    @staticmethod
    def pow2(total: int, levels: int) -> "StripeSpec":
        """Power-of-2 level widths per the paper."""
        if levels < 1:
            raise ValueError("levels must be >= 1")
        denom = 2 ** (levels - 1)
        if total % denom != 0:
            raise ValueError(f"total={total} not divisible by 2^(K-1)={denom}")
        bounds = [0] + [total * (2 ** (k - 1)) // denom
                        for k in range(1, levels + 1)]
        return StripeSpec(tuple(bounds))

    @staticmethod
    def uniform(total: int, levels: int) -> "StripeSpec":
        """Equal-width stripes (``total / levels`` channels a level)."""
        if total % levels != 0:
            raise ValueError(f"total={total} not divisible by levels={levels}")
        step = total // levels
        return StripeSpec(tuple(step * k for k in range(levels + 1)))

    @staticmethod
    def single(total: int) -> "StripeSpec":
        """One stripe (a dimension that is not nested, e.g. the vocab)."""
        return StripeSpec((0, total))

    @staticmethod
    def saturated(total: int, levels: int) -> "StripeSpec":
        """All width in stripe 1 (for dims that cannot be divided, e.g. a
        single GQA KV head)."""
        return StripeSpec((0,) + (total,) * levels)

    @property
    def levels(self) -> int:
        """Number of nesting levels K."""
        return len(self.boundaries) - 1

    @property
    def total(self) -> int:
        """Full (level-K) width."""
        return self.boundaries[-1]

    def width(self, level: int) -> int:
        """Cumulative width of ``level`` (1-based)."""
        return self.boundaries[level]

    def stripe_slice(self, k: int) -> slice:
        """Channels added at level k (1-based)."""
        return slice(self.boundaries[k - 1], self.boundaries[k])

    def stripe_sizes(self) -> list[int]:
        """Channels added at each level."""
        return [self.boundaries[k] - self.boundaries[k - 1]
                for k in range(1, self.levels + 1)]

    def level_of_channel(self) -> np.ndarray:
        """``[total]`` nesting level (1-based) of each channel."""
        out = np.zeros(self.total, dtype=np.int32)
        for k in range(1, self.levels + 1):
            out[self.boundaries[k - 1]:self.boundaries[k]] = k
        return out


def block_triangular_mask(in_spec: StripeSpec,
                          out_spec: StripeSpec) -> np.ndarray:
    """``[d_in, d_out]`` 0/1 mask keeping in-level <= out-level."""
    li = in_spec.level_of_channel()[:, None]
    lo = out_spec.level_of_channel()[None, :]
    return (li <= lo).astype(np.float32)


# Small constant tensors of the stripe geometry, made once per process
# and device: building them from host data inside every forward call
# would be a blocking host-to-device copy each time.  They are made
# outside inference mode so that any caller may use them.
@functools.lru_cache(maxsize=None)
def _prefix_ends(spec: "StripeSpec", k: int, device: torch.device):
    """(index of each level's last channel, level widths as float32)."""
    with torch.inference_mode(False):
        return (torch.tensor([spec.width(i) - 1 for i in range(1, k + 1)],
                             device=device),
                torch.tensor([float(spec.width(i)) for i in range(1, k + 1)],
                             dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _stripe_of_channel(spec: "StripeSpec", k: int,
                       device: torch.device) -> torch.Tensor:
    """0-based stripe of each of the first ``width(k)`` channels."""
    reps = np.asarray(spec.stripe_sizes()[:k])
    with torch.inference_mode(False):
        return torch.as_tensor(np.repeat(np.arange(k), reps), device=device)


@functools.lru_cache(maxsize=None)
def _input_level(in_levels: int, k: int,
                 device: torch.device) -> torch.Tensor:
    """0-based input prefix level ``min(i, K_in) - 1`` of output stripes
    1..k."""
    with torch.inference_mode(False):
        return torch.tensor([min(i, in_levels) - 1 for i in range(1, k + 1)],
                            device=device)


@functools.lru_cache(maxsize=None)
def _mask(in_spec: "StripeSpec", out_spec: "StripeSpec", dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(block_triangular_mask(in_spec, out_spec),
                               dtype=dtype, device=device)


def nested_linear_masked(x: torch.Tensor, w: torch.Tensor,
                         in_spec: StripeSpec,
                         out_spec: StripeSpec) -> torch.Tensor:
    """Dense matmul with the dropped blocks zeroed (the oracle)."""
    return x @ (w * _mask(in_spec, out_spec, w.dtype, w.device))


def nested_linear_blocks(x: torch.Tensor, w: torch.Tensor,
                         in_spec: StripeSpec, out_spec: StripeSpec,
                         level: int | None = None) -> torch.Tensor:
    """Block-triangular matmul over the live ``j <= i`` blocks only;
    ``level`` truncates the output (and the weights read) to that level.
    ``x`` may be a level-k prefix of the input width."""
    k_out = out_spec.levels if level is None else level
    needed = in_spec.width(min(k_out, in_spec.levels))
    if x.shape[-1] < needed:
        raise ValueError(f"x last dim {x.shape[-1]} < required prefix "
                         f"{needed} (level {k_out})")
    outs = []
    for i in range(1, k_out + 1):
        o_sl = out_spec.stripe_slice(i)
        if o_sl.stop == o_sl.start:
            continue
        w_in = in_spec.width(min(i, in_spec.levels))
        outs.append(x[..., :w_in] @ w[:w_in, o_sl])
    return torch.cat(outs, dim=-1)


def nested_linear(x: torch.Tensor, w: torch.Tensor, in_spec: StripeSpec,
                  out_spec: StripeSpec, level: int | None = None,
                  backend: str = "blocks") -> torch.Tensor:
    """Block-triangular nested matmul: ``backend`` ``"blocks"``,
    ``"masked"`` or ``"kernel"`` (same nesting semantics; ``level``
    truncates).  ``"kernel"`` flattens the leading dims of ``x`` and runs
    :func:`repro_torch.kernels.nested_matmul.nested_matmul` (the CUDA
    kernel on the card, its plain version on the CPU)."""
    if backend == "blocks":
        return nested_linear_blocks(x, w, in_spec, out_spec, level)
    if backend == "masked":
        y = nested_linear_masked(x, w, in_spec, out_spec)
        if level is not None:
            y = y[..., :out_spec.width(level)]
        return y
    if backend == "kernel":
        from repro_torch.kernels.nested_matmul import nested_matmul

        y = nested_matmul(x.reshape(-1, x.shape[-1]), w, in_spec, out_spec,
                          level)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    raise ValueError(f"unknown backend {backend!r}")


def prefix_rms_scales(h: torch.Tensor, spec: StripeSpec, eps: float = 1e-6,
                      level: int | None = None) -> torch.Tensor:
    """``r[..., i-1] = 1 / rms(h[..., :d_i])`` for levels 1..k (float32
    statistics, cast back to ``h.dtype``)."""
    k = spec.levels if level is None else level
    csum = torch.cumsum(h.float().square(), dim=-1)
    idx, widths = _prefix_ends(spec, k, h.device)
    prefix_sums = csum[..., idx]
    return torch.rsqrt(prefix_sums / widths + eps).to(h.dtype)


def scale_out_stripes(y: torch.Tensor, scales: torch.Tensor,
                      out_spec: StripeSpec,
                      level: int | None = None) -> torch.Tensor:
    """Multiply output stripe i by ``scales[..., i-1]``."""
    k = out_spec.levels if level is None else level
    return y * scales[..., _stripe_of_channel(out_spec, k, y.device)]


def nested_norm_linear(h: torch.Tensor, gamma: torch.Tensor,
                       w: torch.Tensor, in_spec: StripeSpec,
                       out_spec: StripeSpec, level: int | None = None,
                       eps: float = 1e-6,
                       backend: str = "blocks") -> torch.Tensor:
    """Fused prefix-RMSNorm + nested linear: ``u_i = ((gamma*h) W)_i /
    rms_i``, with output stripe i normalised by input prefix
    ``min(i, K_in)``."""
    scales = prefix_rms_scales(h, in_spec, eps=eps, level=level)
    y = nested_linear(h * gamma[:h.shape[-1]], w, in_spec, out_spec,
                      level=level, backend=backend)
    k = out_spec.levels if level is None else level
    lvl_map = _input_level(in_spec.levels, k, h.device)
    return scale_out_stripes(y, scales[..., lvl_map], out_spec, level=level)


def prefix_rmsnorm(h: torch.Tensor, gamma: torch.Tensor, spec: StripeSpec,
                   level: int, eps: float = 1e-6) -> torch.Tensor:
    """Prefix RMSNorm at one level (before the unembed)."""
    d = spec.width(level)
    hk = h[..., :d]
    var = torch.mean(hk.float().square(), dim=-1, keepdim=True)
    return (hk * torch.rsqrt(var + eps).to(h.dtype)) * gamma[:d]


def slice_linear_to_level(w: torch.Tensor, in_spec: StripeSpec,
                          out_spec: StripeSpec, level: int) -> torch.Tensor:
    """Weights of the standalone level-k subnetwork: the triangular
    prefix."""
    return w[:in_spec.width(min(level, in_spec.levels)),
             :out_spec.width(level)]


def freeze_prefix(w: torch.Tensor, in_spec: StripeSpec, out_spec: StripeSpec,
                  level: int) -> torch.Tensor:
    """Greedy training (paper Section 4.3): the block wholly inside levels
    below ``level`` is detached, so stage-k training leaves the earlier
    stripes' weights without a gradient (the reference's
    ``stop_gradient``)."""
    if level <= 1:
        return w
    di = in_spec.width(min(level - 1, in_spec.levels))
    do = out_spec.width(level - 1)
    top = torch.cat([w[:di, :do].detach(), w[:di, do:]], dim=1)
    return torch.cat([top, w[di:, :]], dim=0)


def joint_anytime_loss(per_level_losses: Sequence[torch.Tensor],
                       weights: Sequence[float] | None = None
                       ) -> torch.Tensor:
    """Weighted sum of the per-level losses (uniform by default), summed
    in level order; one backward pass trains every level."""
    k = len(per_level_losses)
    if weights is None:
        weights = [1.0 / k] * k
    if len(weights) != k:
        raise ValueError("len(weights) != number of levels")
    return torch.as_tensor(sum(w * l for w, l in zip(weights,
                                                      per_level_losses)))


def greedy_stage_weights(stage: int, levels: int) -> list[float]:
    """One-hot level weighting of greedy stage ``stage`` (1-based)."""
    return [1.0 if k == stage - 1 else 0.0 for k in range(levels)]


@dataclasses.dataclass(frozen=True)
class DepthSpec:
    """Interlaced depth-nesting plan over ``n_layers`` with ``levels``
    levels (paper Section 4.2.2, Fig. 8): level k runs the layers ``j``
    with ``j % 2^(K-k) == 0``, so each deeper level fills in the
    midpoints of the one before."""

    n_layers: int
    levels: int

    def level_of_layer(self, j: int) -> int:
        """Nesting level (1-based) of 0-based layer ``j``: the smallest k
        whose grid ``j % 2^(K-k) == 0`` holds it."""
        for k in range(1, self.levels + 1):
            if j % 2 ** (self.levels - k) == 0:
                return k
        return self.levels

    def layers_of_level(self, level: int) -> list[int]:
        """Every layer run at ``level`` (levels <= ``level``)."""
        s = 2 ** (self.levels - level)
        return [j for j in range(self.n_layers) if j % s == 0]

    def skip_sources(self, j: int) -> list[int]:
        """Predecessors of layer ``j`` at power-of-2 distances whose level
        is at most ``j``'s; ``-1`` is the input."""
        lj = self.level_of_layer(j)
        srcs = []
        d = 1
        while j - d >= -1:
            src = j - d
            if src == -1 or self.level_of_layer(src) <= lj:
                srcs.append(src)
            d *= 2
        return srcs


def depth_nested_apply(layer_fns: Sequence[Callable[[torch.Tensor],
                                                    torch.Tensor]],
                       x: torch.Tensor, spec: DepthSpec,
                       level: int | None = None) -> list[torch.Tensor]:
    """Run a depth-nested stack: ``layer_fns[j]`` maps the sum of its skip
    sources (in :meth:`DepthSpec.skip_sources` order) to its output.
    Returns the state after the last layer of each level up to ``level``
    (paper Eq. 10); a shallower level's activations do not depend on
    whether deeper levels run."""
    k = spec.levels if level is None else level
    buf: dict[int, torch.Tensor] = {-1: x}
    level_layers = {lv: spec.layers_of_level(lv) for lv in range(1, k + 1)}
    run = sorted({j for lv in range(1, k + 1) for j in level_layers[lv]})
    for j in run:
        srcs = [s for s in spec.skip_sources(j) if s in buf]
        agg = buf[srcs[0]]
        for s in srcs[1:]:
            agg = agg + buf[s]
        buf[j] = layer_fns[j](agg)
    return [buf[level_layers[lv][-1]] for lv in range(1, k + 1)]
