"""Live profile tables of a width-nested anytime LM (port of
``repro.profiling.live``, without training).

A :class:`TrainedAnytime` holds a model, its weights and its measured
per-level accuracies (training is not ported yet: the caller brings
both).  :func:`live_profile_table` attaches per-level latencies, either
deterministic fake measurements through the clock seam (compute time
proportional to each level's nested-FLOP fraction) or real ``generate``
times of a :class:`~repro_torch.serving.engine.ServeEngine` on the
weights' device, and emits the anytime ``ProfileTable`` through
:func:`~repro_torch.profiling.harness.profile_anytime_measured`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.nesting import StripeSpec
from repro_torch.core.power import PowerModel
from repro_torch.core.profiles import ProfileTable
from repro_torch.kernels.nested_matmul import nested_matmul_flops
from repro_torch.profiling.clock import FakeClock, fake_level_fns
from repro_torch.profiling.harness import (engine_level_fns,
                                           profile_anytime_measured)


def level_flop_fractions(cfg) -> list[float]:
    """Per-level FLOP fraction of ``cfg``'s width-nested net: the
    block-triangular stripe schedule over ``d_model`` (what the
    ``nested_matmul`` kernel executes), normalised to the deepest level."""
    spec = StripeSpec.pow2(cfg.d_model, cfg.nest_levels)
    dense = nested_matmul_flops(1, spec, spec, level=cfg.nest_levels)
    return [nested_matmul_flops(1, spec, spec, level=k) / dense
            for k in range(1, cfg.nest_levels + 1)]


@dataclasses.dataclass
class TrainedAnytime:
    """An anytime LM with its evaluation results: ``model`` (a registry
    :class:`~repro_torch.models.registry.Model`), ``params`` on the device
    it is served from, and per-level ``accuracies`` (shallow to deep)."""

    model: object
    cfg: object
    params: object
    accuracies: list[float]
    final_loss: float
    q_fail: float             # random-guess accuracy on the eval task


def live_profile_table(trained: TrainedAnytime, *,
                       mode: str = "fake",
                       clock: FakeClock | None = None,
                       base_s: float = 0.05,
                       power_model: PowerModel | None = None,
                       n_power_buckets: int = 8,
                       warmup: int = 1, iters: int = 3,
                       prompt_len: int = 8, gen_tokens: int = 4,
                       ) -> ProfileTable:
    """Anytime table of ``trained``.

    ``mode="fake"``: level compute times are ``base_s`` times the level's
    nested-FLOP fraction, driven through :class:`FakeClock` callables and
    the real measurement loop (no wall clock).  ``mode="measured"``: real
    wall-clock ``generate`` times on the device of ``trained.params``
    (synced on the card; CPU work is synchronous).  Power buckets are
    extrapolated analytically either way.
    """
    if power_model is None:
        power_model = PowerModel(p_idle=60.0, p_tdp=200.0)
    cfg = trained.cfg
    q_fail = trained.q_fail
    if mode == "fake":
        clk = clock if clock is not None else FakeClock()
        fracs = level_flop_fractions(cfg)
        fns = fake_level_fns(clk, [f * base_s for f in fracs])
        return profile_anytime_measured(
            fns, trained.accuracies, power_model,
            n_power_buckets=n_power_buckets, warmup=warmup, iters=iters,
            q_fail=q_fail, clock=clk)
    if mode == "measured":
        from repro_torch.serving.engine import ServeEngine

        device = trained.params["embed"].device
        engine = ServeEngine(trained.model,
                             max_len=prompt_len + gen_tokens + 1,
                             batch_size=2, device=device)
        fns = engine_level_fns(engine, trained.params,
                               prompt_len=prompt_len, gen_tokens=gen_tokens)
        return profile_anytime_measured(
            fns, trained.accuracies, power_model,
            n_power_buckets=n_power_buckets, warmup=warmup, iters=iters,
            q_fail=q_fail,
            sync=(lambda v: v) if device.type == "cpu" else None)
    raise ValueError(f"mode must be 'fake' or 'measured', got {mode!r}")
