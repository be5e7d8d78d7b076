"""The fleet simulator's scenarios: the image family's profile table, its
deadlines, the golden scenario of ``tests/golden_traces.json`` and a
heterogeneous, churning fleet of tenants.

The port's own copy of the reference benchmarks' ``family_table("image")``
and ``deadline_range``, number for number: latencies come from each
candidate's roofline terms under the power model, the anytime levels'
FLOP fractions from the width-nested matmul.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.controller import Constraints, Goal
from repro_torch.core.nesting import StripeSpec
from repro_torch.core.power import PowerModel
from repro_torch.core.profiles import (Candidate, ProfileTable,
                                       profile_from_roofline)
from repro_torch.kernels.nested_matmul import nested_matmul_flops
from repro_torch.serving.sim import ENVS, EnvironmentTrace, StreamSpec

# The image family (arch, task accuracy), one input of 512 tokens, the
# power model and its 8 buckets, and q_fail.
IMAGE_FAMILY = (("gemma3-1b", 0.700), ("qwen2-vl-2b", 0.760),
                ("rwkv6-3b", 0.790), ("qwen2.5-14b", 0.845),
                ("qwen2.5-32b", 0.875))
FAMILY_TOKENS = 512
ANYTIME_LEVELS = 4
IMAGE_Q_FAIL = 0.001
POWER_MODEL = PowerModel(p_idle=60.0, p_tdp=200.0)
N_POWER = 8
# The golden scenario: seed-1 traces, the middle of three deadlines,
# E_goal = 170 W * T_goal.
GOLDEN_SEED = 1
GOLDEN_BUDGET_W = 170.0


def _cost(arch: str) -> tuple[float, float]:
    """One input's FLOPs and HBM bytes (bf16 weights and activations)."""
    cfg = get_config(arch)
    flops = 2.0 * cfg.active_param_count() * FAMILY_TOKENS
    byts = 2.0 * cfg.param_count() + \
        2.0 * FAMILY_TOKENS * cfg.d_model * 2 * cfg.n_layers
    return flops, byts


def golden_table() -> ProfileTable:
    """K = 9 (five image models and four levels of an anytime version of
    the largest), L = 8 power buckets."""
    cands = [Candidate(arch, *_cost(arch), acc) for arch, acc in IMAGE_FAMILY]
    # Each level's FLOP fraction of the width-nested net: what
    # nested_matmul runs at that level.
    spec = StripeSpec.pow2(2 ** (ANYTIME_LEVELS + 2), ANYTIME_LEVELS)
    dense = 2 * spec.total * spec.total
    fracs = [nested_matmul_flops(1, spec, spec, level=k) / dense
             for k in range(1, ANYTIME_LEVELS + 1)]
    top_flops, top_bytes = _cost(IMAGE_FAMILY[-1][0])
    accs = np.interp(np.linspace(0, 1, ANYTIME_LEVELS) ** 0.5, [0, 1],
                     [IMAGE_FAMILY[0][1] - 0.015,
                      IMAGE_FAMILY[-1][1] - 0.004])
    for k, (fr, acc) in enumerate(zip(fracs, accs), start=1):
        cands.append(Candidate(
            f"anytime-l{k}", top_flops * fr, top_bytes * (0.3 + 0.7 * fr),
            float(acc), is_anytime_level=True, anytime_group="anytime",
            level=k))
    return profile_from_roofline(cands, POWER_MODEL,
                                 n_power_buckets=N_POWER, q_fail=IMAGE_Q_FAIL)


def golden_deadline(table: ProfileTable, n: int = 5) -> np.ndarray:
    """``n`` deadlines from 0.4x to 2x the full-power latency of the
    table's slowest anytime level (paper Table 3)."""
    groups = table.anytime_groups()
    top = max((i for g in groups.values() for i in g),
              key=lambda i: table.latency[i, -1])
    return table.latency[top, -1] * np.linspace(0.4, 2.0, n)


def fleet_specs(table: ProfileTable, lanes: int) -> list[StreamSpec]:
    """``lanes`` tenants: environments cycling default/cpu/memory, 400
    inputs each with ``seed = 1 + s`` and 10 % length and deadline
    variation, deadlines cycling the table's five, even lanes Eq. 4
    (Q_goal 0.78) and odd lanes Eq. 5 (170 W), arriving at tick
    ``s % 100``."""
    dls = golden_deadline(table, 5)
    envs = (ENVS["default"], ENVS["cpu"], ENVS["memory"])
    specs = []
    for s in range(lanes):
        dl = float(dls[s % 5])
        if s % 2 == 0:
            goal, cons = Goal.MINIMIZE_ENERGY, Constraints(
                deadline=dl, accuracy_goal=0.78)
        else:
            goal, cons = Goal.MAXIMIZE_ACCURACY, \
                Constraints.from_power_budget(dl, GOLDEN_BUDGET_W)
        trace = EnvironmentTrace(envs[s % 3], seed=1 + s, length_cv=0.1,
                                 deadline_cv=0.1)
        specs.append(StreamSpec(trace, goal, cons, arrival=s % 100))
    return specs
