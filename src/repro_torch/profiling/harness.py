"""Measured-staircase harness: callables -> anytime ``ProfileTable``
(port of ``repro.profiling.harness``).

:func:`profile_anytime_measured` times per-level callables with
:func:`repro_torch.core.profiles.measure_mean_latency` (synced inside the
timed region), clamps the accuracies monotone so Eq. 10's staircase
premise holds, and spreads the latencies over power buckets analytically
(:func:`repro_torch.core.profiles.extrapolate_power_buckets`).
:func:`engine_level_fns` gives the per-level ``generate`` closures of a
:class:`~repro_torch.serving.engine.ServeEngine` for real timing.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.core.power import PowerModel
from repro_torch.core.profiles import (Candidate, ProfileTable,
                                       extrapolate_power_buckets,
                                       measure_mean_latency)


def monotone_accuracies(accuracies: Sequence[float]) -> np.ndarray:
    """Running maximum of a per-level accuracy sequence, so a deeper level
    never claims less than its prefix (Eq. 10 prices partial work by the
    last completed level)."""
    return np.maximum.accumulate(np.asarray(accuracies, dtype=np.float64))


def profile_anytime_measured(fns: Sequence[Callable[[], object]],
                             accuracies: Sequence[float],
                             power_model: PowerModel,
                             *,
                             group: str = "anytime",
                             name_prefix: str = "level",
                             n_power_buckets: int = 8,
                             warmup: int = 2,
                             iters: int = 5,
                             q_fail: float = 0.0,
                             clock: Callable[[], float] | None = None,
                             sync: Callable[[object], object] | None = None,
                             ) -> ProfileTable:
    """Measure one anytime family's staircase and emit its table.

    ``fns[k]`` runs level k+1 (shallow to deep); ``accuracies[k]`` is its
    measured accuracy (clamped monotone here).  ``clock``/``sync`` default
    to ``time.perf_counter`` and
    :func:`~repro_torch.core.profiles.default_sync`.  Raises if a measured
    latency is not positive: the loop saw no time pass, so the sync did
    not block on the work.
    """
    if len(fns) != len(accuracies) or not fns:
        raise ValueError(f"{len(fns)} level callables for "
                         f"{len(accuracies)} accuracies")
    base = measure_mean_latency(fns, warmup=warmup, iters=iters,
                                clock=clock, sync=sync)
    if not np.all(base > 0):
        raise ValueError(
            f"measured non-positive level latency {base.tolist()}: the "
            "timing loop saw no time pass, so the sync seam did not block "
            "on the work")
    accs = monotone_accuracies(accuracies)
    caps, lat, pw = extrapolate_power_buckets(base, power_model,
                                              n_power_buckets)
    n = len(fns)
    cands = [Candidate(name=f"{name_prefix}{k + 1}", flops=0.0,
                       bytes_hbm=0.0, accuracy=float(accs[k]),
                       is_anytime_level=n > 1,
                       anytime_group=group if n > 1 else None,
                       level=k + 1)
             for k in range(n)]
    return ProfileTable(cands, caps, lat, pw, q_fail=q_fail)


def engine_level_fns(engine, params, *, prompt_len: int = 8,
                     gen_tokens: int = 4, seed: int = 0) -> list:
    """Per-level closures over ``engine.generate`` (prefill + greedy
    decode of one seeded prompt batch); each returns the tokens as a host
    array, so the card has finished the work when it returns.  The
    engine's steps for the prompt length are made here (on the card its
    CUDA graphs are captured), so no capture falls inside a timed call."""
    engine.warmup(params, prompt_len)
    rng = np.random.default_rng(seed)
    vocab = engine.model.cfg.vocab
    prompt = rng.integers(0, vocab, size=(engine.batch_size, prompt_len),
                          dtype=np.int32)
    return [
        (lambda lvl=lvl: engine.generate(params, prompt, gen_tokens,
                                         level=lvl)["tokens"])
        for lvl in engine.levels
    ]
