"""Live profile tables of a width-nested anytime LM (port of
``repro.profiling.live``).

:func:`train_reduced_anytime` joint-trains the reduced ``alert_anytime``
config on the synthetic task (paper Section 4.3: one backward pass for
every level) and measures each level's accuracy on held-out batches.  A
:class:`TrainedAnytime` holds the model, its weights and those
accuracies.  :func:`live_profile_table` attaches per-level latencies,
either deterministic fake measurements through the clock seam (compute
time proportional to each level's nested-FLOP fraction) or real
``generate`` times of a :class:`~repro_torch.serving.engine.ServeEngine`
on the weights' device, and emits the anytime ``ProfileTable`` through
:func:`~repro_torch.profiling.harness.profile_anytime_measured`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.alert_anytime import reduced
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
    it is served from, and per-level ``accuracies`` (shallow to deep),
    from :func:`train_reduced_anytime` or brought by the caller."""

    model: object
    cfg: object
    params: object
    accuracies: list[float]
    final_loss: float
    q_fail: float             # random-guess accuracy on the eval task


def train_reduced_anytime(train_steps: int = 250, seed: int = 0,
                          eval_batches: int = 2, data_vocab: int = 32,
                          device=None, params=None,
                          on_metrics=None) -> TrainedAnytime:
    """Joint-train the reduced ``alert_anytime`` config (its dtype,
    bfloat16) and measure each level's accuracy.

    The task is ``SyntheticLM(data_vocab, seq_len=cfg.attn_chunk,
    global_batch=16, noise=0.05, order=2)``, a ``data_vocab`` sub-range of
    the model's vocabulary (the full-width task is not learnable at this
    size in a profile's budget; the point is a separated accuracy
    staircase); the loss weighs the levels ``linspace(1, 2)``, normalised;
    ``AdamW(lr=8e-3)``; the weights are drawn from a seed-``seed``
    generator on ``device`` unless ``params`` are given (the tests start
    from the reference's); ``on_metrics(step, metrics)`` sees each step's
    metrics.  Accuracies are the mean over ``eval_batches``
    held-out batches (steps 10,000 on) of each level's token accuracy,
    unclamped (the harness clamps them monotone)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.losses import token_accuracy
    from repro_torch.train.step import (init_train_state,
                                        make_anytime_loss_fn,
                                        make_train_step)

    dev = resolve_device(device)
    cfg = reduced()
    model = build_model(cfg)
    if data_vocab > cfg.vocab:
        raise ValueError(f"data_vocab {data_vocab} > vocab {cfg.vocab}")
    data = SyntheticLM(vocab=data_vocab, seq_len=cfg.attn_chunk,
                       global_batch=16, noise=0.05, order=2)
    weights = np.linspace(1.0, 2.0, cfg.nest_levels)
    opt = AdamW(lr=8e-3)
    state = init_train_state(model, cfg, opt,
                             torch.Generator(device=dev).manual_seed(seed),
                             device=dev, params=params)
    step = make_train_step(model, cfg, opt, loss_fn=make_anytime_loss_fn(
        model, cfg, level_weights=list(weights / weights.sum())))

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(i).items()}

    loss = torch.zeros(())
    for i in range(train_steps):
        state, metrics = step(state, batch_at(i))
        loss = metrics["loss"]
        if on_metrics is not None:
            on_metrics(i, metrics)
    accs = np.zeros(cfg.nest_levels)
    with torch.no_grad():
        for b in range(eval_batches):
            evalb = batch_at(10_000 + b)
            for k in range(1, cfg.nest_levels + 1):
                logits, _ = model.train_logits(state.params, evalb, level=k)
                accs[k - 1] += float(token_accuracy(logits, evalb["labels"]))
    accs /= eval_batches
    return TrainedAnytime(model=model, cfg=cfg, params=state.params,
                          accuracies=[float(a) for a in accs],
                          final_loss=float(loss), q_fail=1.0 / data_vocab)


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
