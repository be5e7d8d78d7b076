"""The fleet simulator's scenarios: the image family's profile table, its
deadlines, the golden scenarios of ``tests/golden_traces.json``, a
heterogeneous, churning fleet of tenants, and the session gateway's
workloads: its two goldens, the reference benchmark's recorded traffic
cells and its megatick and flight-recorder cells.

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
from repro_torch.serving.sim import (CPU_ENV, ENVS, MEMORY_ENV,
                                     EnvironmentTrace, StreamSpec)
from repro_torch.traffic import (FaultSchedule, LaneStraggler,
                                 PoissonProcess, TenantSpec, build_sessions)

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
# The reference benchmark's traffic cell: 1024 sessions over 256 lanes at
# loads 0.5-24 of the rate that fills half the lanes, load i seeded
# 5 + 7919 i (as its load sweep does).
TRAFFIC_SESSIONS, TRAFFIC_LANES, TRAFFIC_SEED = 1024, 256, 5
TRAFFIC_LOADS = (0.5, 2.0, 8.0, 24.0)
# The reference benchmark's megatick cell (bench_megatick): 100,000
# sessions over 4096 lanes at the rate that fills them, 48 rounds of
# T_goal, seed 9; and its flight-recorder cell (bench_obs): 20,000
# sessions over 1024 lanes, 24 rounds, seed 11.
MEGATICK_SESSIONS, MEGATICK_LANES, MEGATICK_ROUNDS, MEGATICK_SEED = \
    100_000, 4096, 48, 9
OBS_SESSIONS, OBS_LANES, OBS_ROUNDS, OBS_SEED = 20_000, 1024, 24, 11


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


def golden_gateway_workload(table: ProfileTable):
    """``tests/make_golden_traces.py``'s ``gateway_config``: 12 Eq. 4
    sessions (Q_goal 0.78, CPU contention) and 12 Eq. 5 sessions (170 W,
    memory contention) at twice the rate 8 lanes saturate, over 12 T_goal,
    seed 1.  Returns ``(sessions, n_lanes, T_goal)``."""
    deadline = float(golden_deadline(table, 5)[3])
    n_lanes, per_tenant = 8, 12
    rate = 2.0 * (n_lanes / deadline) / (2 * per_tenant)
    mix = [TenantSpec("minE", Goal.MINIMIZE_ENERGY,
                      Constraints(deadline=deadline, accuracy_goal=0.78),
                      PoissonProcess(rate), n_sessions=per_tenant,
                      phases=CPU_ENV),
           TenantSpec("maxA", Goal.MAXIMIZE_ACCURACY,
                      Constraints.from_power_budget(deadline,
                                                    GOLDEN_BUDGET_W),
                      PoissonProcess(rate), n_sessions=per_tenant,
                      phases=MEMORY_ENV)]
    return build_sessions(mix, 12 * deadline, seed=GOLDEN_SEED), n_lanes, \
        deadline


def straggler_workload(table: ProfileTable):
    """``tests/make_golden_traces.py``'s ``straggler_config``: 8 Eq. 4
    sessions on 8 lanes (no paging) over 40 T_goal, seed 7, lane 5 ramping
    to 3x slow from round 10 over 5 rounds.  Returns ``(sessions, n_lanes,
    T_goal, faults)``."""
    deadline = float(golden_deadline(table, 5)[3])
    n_lanes = 8
    mix = [TenantSpec("t", Goal.MINIMIZE_ENERGY,
                      Constraints(deadline=deadline, accuracy_goal=0.78),
                      PoissonProcess(0.8 / deadline), n_sessions=n_lanes,
                      phases=CPU_ENV)]
    faults = FaultSchedule(n_lanes, [LaneStraggler(
        lane=5, start=10 * deadline, magnitude=2.0, ramp_s=5 * deadline)],
        seed=0)
    return build_sessions(mix, 40 * deadline, seed=7), n_lanes, deadline, \
        faults


def traffic_mix(table: ProfileTable, n_sessions: int, n_lanes: int,
                fill: float):
    """One Eq. 4 tenant class (Q_goal 0.78, T_goal the fourth of the
    table's five deadlines, CPU contention) of ``n_sessions`` Poisson
    sessions whose rate fills ``fill`` of ``n_lanes`` lanes.  Returns
    ``(mix, T_goal, constraints)``."""
    dl = float(golden_deadline(table, 5)[3])
    cons = Constraints(deadline=dl, accuracy_goal=0.78)
    rate = fill * (n_lanes / dl) / n_sessions
    return [TenantSpec("min-energy", Goal.MINIMIZE_ENERGY, cons,
                       PoissonProcess(rate), n_sessions=n_sessions,
                       phases=CPU_ENV)], dl, cons


def traffic_sessions(table: ProfileTable, load: float,
                     n_sessions: int = TRAFFIC_SESSIONS,
                     n_lanes: int = TRAFFIC_LANES):
    """The reference benchmark's traffic cell at ``load`` (one of
    ``TRAFFIC_LOADS``) over 30 T_goal: ``(sessions, T_goal,
    constraints)``."""
    mix, dl, cons = traffic_mix(table, n_sessions, n_lanes, 0.5)
    li = TRAFFIC_LOADS.index(load)
    return build_sessions([t.scaled(load) for t in mix], 30 * dl,
                          seed=TRAFFIC_SEED + 7919 * li), dl, cons


def saturating_sessions(table: ProfileTable, n_sessions: int, n_lanes: int,
                        rounds: int, seed: int):
    """The reference benchmarks' megatick workloads (``bench_megatick``,
    ``bench_obs``): ``n_sessions`` Eq. 4 sessions at the rate that fills
    ``n_lanes`` lanes, over ``rounds`` T_goal, from ``seed``.  Returns
    ``(sessions, T_goal)``; the megatick runs them at ``tick = T_goal``
    with ``max_queue = 4 * n_lanes``."""
    mix, dl, _ = traffic_mix(table, n_sessions, n_lanes, 1.0)
    return build_sessions(mix, rounds * dl, seed=seed), dl


def gateway_summary(res) -> dict:
    """``tests/make_golden_traces.py``'s ``summarize_gateway`` of a
    ``GatewayResult``."""
    status = res.status
    return {
        "offered": int(status.size),
        "served": int((status == 0).sum()),
        "rejected_infeasible": int((status == 1).sum()),
        "rejected_backpressure": int((status == 2).sum()),
        "good": int(res.good.sum()),
        "goodput_rps": res.goodput,
        "energy_sum_j": float(res.energy[status == 0].sum()),
        "p50_sojourn_s": res.percentile_sojourn(50),
        "p99_sojourn_s": res.percentile_sojourn(99),
        "served_miss_rate": res.served_miss_rate,
        "n_rounds": res.n_rounds,
        "pages_in": res.pages_in,
        "pages_out": res.pages_out,
        "horizon_s": res.horizon,
    }
