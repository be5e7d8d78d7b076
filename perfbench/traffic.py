"""The one traffic generator: every mix is a data file it reads.

A mix (``perfbench/workloads/<traffic>.json``) fixes the fleet: ``streams``
request streams, each sending one input per tick of ``batch`` rows of
``prompt_len`` uniform token ids and asking for ``gen_tokens`` tokens.
Stream ``s`` belongs to tenant ``s % len(tenants)``.  A tenant states its
goal (``min_energy``: Eq. 4 with ``accuracy_goal``; ``max_accuracy``: Eq. 5
with an energy budget of ``energy_frac`` of the full-clock power over the
deadline) and its deadline as ``deadline_x`` times the calibrated latency
of level ``of_level`` (the model's deepest where it has fewer).  The
calibrated latencies (``level_latency_ms``) are fixed numbers of the file,
measured once on the card; they are never measured again at run time.
``power_buckets`` and ``min_clock_fraction`` set the server's power
buckets (the card's cap cannot be set, so one bucket at the full clock:
the controller then picks levels only).

Prompts depend only on ``(seed, tick)``: every seed sends the same sizes
in the same order, and any tick's prompts can be drawn again later.
"""

from __future__ import annotations

import numpy as np

GOALS = {"min_energy": 0, "max_accuracy": 1}


def tenants(mix: dict) -> list:
    """``(goal code, deadline s, accuracy goal, energy goal J)`` of every
    stream."""
    lat = [ms / 1e3 for ms in mix["level_latency_ms"]]
    out = []
    for s in range(mix["streams"]):
        t = mix["tenants"][s % len(mix["tenants"])]
        dl = t["deadline_x"] * lat[min(t["of_level"], len(lat)) - 1]
        if t["goal"] == "min_energy":
            out.append((GOALS["min_energy"], dl, t["accuracy_goal"], None))
        else:
            out.append((GOALS["max_accuracy"], dl, None,
                        t["energy_frac"] * mix["full_power_w"] * dl))
    return out


def prompts(mix: dict, seed: int, tick: int, vocab: int) -> np.ndarray:
    """``[streams, batch, prompt_len]`` int32 prompts of one tick."""
    rng = np.random.default_rng([int(seed), int(tick)])
    return rng.integers(0, vocab, (mix["streams"], mix["batch"],
                                   mix["prompt_len"]), dtype=np.int32)
