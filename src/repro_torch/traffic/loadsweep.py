"""Offered-load sweep: goodput, p99 sojourn, energy and miss rates
against load (port of ``repro.traffic.loadsweep``).

For each load point the tenant mixture's arrival rates are multiplied by
the load factor, one workload is generated (seeded, so every scheme sees
the same requests), and each scheme serves it: the full ALERT controller,
the hindsight-static baseline (:func:`hindsight_static_config`, the best
single ``(model, power)`` pick of ``InferenceSim.run_oracle_static`` on
the tenant's nominal environment, executed through the same clock, queue
and delivery path), and optionally the shedding ablation and the paper's
application-only and system-only baselines.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.controller import Constraints, Goal
from repro_torch.core.profiles import ProfileTable
from repro_torch.serving.sim import EnvironmentTrace, InferenceSim, Phase
from repro_torch.traffic.gateway import SessionGateway
from repro_torch.traffic.workloads import TenantSpec, build_sessions, \
    generate_requests


def hindsight_static_config(table: ProfileTable,
                            phases: tuple[Phase, ...], goal: Goal,
                            cons: Constraints,
                            seed: int = 0) -> tuple[int, int]:
    """Best single traditional ``(model, power)`` config for this
    environment in hindsight — literally
    :meth:`~repro_torch.serving.sim.InferenceSim.run_oracle_static`'s pick
    (strict zero-violating-windows first, then the loose 10 % rule,
    then the goal's objective) on a nominal trace of ``phases``,
    returning the winning *indices* so the gateway can execute the
    config under real load."""
    trace = EnvironmentTrace(phases, seed=seed)
    res = InferenceSim(table, trace).run_oracle_static(goal, cons)
    return res.config


def app_only_table(table: ProfileTable) -> ProfileTable:
    """Application-only adaptation baseline (paper Table-style competitor).

    The controller keeps its full model/anytime-level freedom but the
    platform never actuates power: the table is pinned to the system
    default — the highest cap, race-to-idle, exactly what
    ``FleetSim.run_streams(power_control=False)`` executes.  Column
    slicing (:meth:`~repro_torch.core.profiles.ProfileTable.power_subset`)
    carries the padded staircase tensors over intact.
    """
    return table.power_subset([len(table.power_caps) - 1])


def sys_only_table(table: ProfileTable) -> ProfileTable:
    """System-only adaptation baseline (paper Table-style competitor).

    The application is frozen at its most-accurate configuration (the
    deployment default) and only the platform adapts — the controller
    keeps its full power freedom over a single-candidate table.  For an
    anytime family this cuts the staircase mid-prefix, which
    :meth:`~repro_torch.core.profiles.ProfileTable.subset` correctly degrades
    to a 1-level staircase: no early-exit credit, a missed deadline pays
    ``q_fail``, exactly the fixed-app semantics.
    """
    top = int(np.argmax(table.accuracies))
    return table.subset([top])


def sweep_loads(table: ProfileTable, mix: Sequence[TenantSpec],
                loads: Sequence[float], *, n_lanes: int,
                horizon: float, seed: int = 0,
                max_queue: int | None = None, tick: float | None = None,
                schemes: Sequence[str] = ("alert", "oracle_static"),
                deadline_cv: float = 0.0,
                gateway: str = "host", obs=None,
                device=None) -> list[dict]:
    """Sweep offered load over ``loads`` for each scheme.

    One :class:`~repro_torch.traffic.gateway.SessionGateway` a scheme
    serves every load point, so a chunk program built anywhere past the
    first load shows up in the recorded ``n_compiles``.  Returns one record per load point with offered
    rate, and per scheme: goodput, p50/p99 sojourn, served-miss /
    reject / SLO-miss rates, energy per request and per good request,
    paging and compile counters.

    Schemes: ``alert`` (full controller), ``oracle_static`` (hindsight
    single config), ``alert_no_admission`` (shedding ablation), and the
    paper's Table-style adaptation baselines ``app_only`` /``sys_only``
    (:func:`app_only_table` / :func:`sys_only_table` — the same alert
    controller run over power- or candidate-restricted tables, so ALERT's
    config space strictly contains both).

    ``gateway="megatick"`` serves every scheme through
    :class:`~repro_torch.traffic.megatick.MegatickGateway` instead:
    records equal float for float in the coarse-tick regime, one chunk
    program (on the card one CUDA graph) a scheme for the whole sweep.
    ``device`` is every gateway's (default the card).

    ``obs`` attaches one :class:`~repro_torch.obs.FlightRecorder` to EVERY
    scheme's gateway: the per-scheme metrics share one registry (label
    ``gateway=``/``policy=`` disambiguate), spans and the telemetry
    ring interleave in sweep order, and — the pure-observer contract —
    every recorded number is bitwise identical to the unobserved sweep.
    Each per-scheme record also carries the ``gateway`` tag and the
    uniform ``n_compiles`` pair (estimate-cache, select/scan-cache):
    flat accounting across the whole sweep is asserted by the
    reference's ``--traffic-smoke``.
    """
    if gateway == "megatick":
        from repro_torch.traffic.megatick import MegatickGateway as GW
    elif gateway == "host":
        GW = SessionGateway
    else:
        raise ValueError(f"gateway must be 'host' or 'megatick', "
                         f"got {gateway!r}")
    gw = GW(table, n_lanes, max_queue=max_queue, tick=tick, obs=obs,
            device=device) if "alert" in schemes else None
    gw_static = gw_noadm = None
    static_cfg: tuple[int, int] | None = None
    if "oracle_static" in schemes:
        if len(mix) > 1:
            raise ValueError("oracle_static baseline needs a "
                             "single-tenant mix (one static config)")
        static_cfg = hindsight_static_config(
            table, mix[0].phases, mix[0].goal, mix[0].constraints,
            seed=seed)
        gw_static = GW(table, n_lanes, max_queue=max_queue, tick=tick,
                       obs=obs, device=device)
    if "alert_no_admission" in schemes:
        # Ablation probe: same controller, admission control disabled
        # (no fail-fast, unbounded queue) — quantifies what shedding
        # buys.
        gw_noadm = GW(table, n_lanes, max_queue=None,
                      tick=tick, min_feasible_latency=0.0, obs=obs,
                      device=device)
    gw_app = gw_sys = None
    if "app_only" in schemes:
        # Paper Table-style competitor: DNN adaptation only, power pinned
        # at the system default.  Same controller, same gateway machinery,
        # over the column-restricted table — so megatick parity and
        # compile accounting hold by construction.
        gw_app = GW(app_only_table(table), n_lanes, max_queue=max_queue,
                    tick=tick, obs=obs, device=device)
    if "sys_only" in schemes:
        # Paper Table-style competitor: power adaptation only, application
        # frozen at its most-accurate config (single-candidate table).
        gw_sys = GW(sys_only_table(table), n_lanes, max_queue=max_queue,
                    tick=tick, obs=obs, device=device)
    rows = []
    for li, load in enumerate(loads):
        sessions = build_sessions([t.scaled(load) for t in mix], horizon,
                                  seed=seed + 7919 * li,
                                  deadline_cv=deadline_cv)
        requests = generate_requests(sessions)
        offered_rps = len(requests) / horizon
        row = {"load": float(load), "offered": len(requests),
               "offered_rps": offered_rps, "n_sessions": len(sessions),
               "n_lanes": n_lanes, "schemes": {}}
        for scheme in schemes:
            if scheme == "alert":
                res = gw.run(sessions, requests)
            elif scheme == "alert_no_admission":
                res = gw_noadm.run(sessions, requests)
            elif scheme == "oracle_static":
                res = gw_static.run(sessions, requests, policy="static",
                                    static_config=static_cfg)
            elif scheme == "app_only":
                res = gw_app.run(sessions, requests)
            elif scheme == "sys_only":
                res = gw_sys.run(sessions, requests)
            else:
                raise ValueError(scheme)
            row["schemes"][scheme] = {
                "goodput_rps": res.goodput,
                "good": int(res.good.sum()),
                "served": int(res.served.sum()),
                "p50_sojourn_s": res.percentile_sojourn(50),
                "p99_sojourn_s": res.percentile_sojourn(99),
                "served_miss_rate": res.served_miss_rate,
                "reject_rate": res.reject_rate,
                "slo_miss_rate": res.slo_miss_rate,
                "mean_energy_served_j": res.mean_energy_served,
                "energy_per_good_j": res.energy_per_good,
                "n_rounds": res.n_rounds,
                "pages_in": res.pages_in,
                "pages_out": res.pages_out,
                # (estimate, select/scan) programs: (0, 0) for the host
                # gateway, (0, 1) for a megatick scheme; flat across the
                # load points.
                "n_compiles": list(res.n_compiles),
                "gateway": gateway,
            }
        rows.append(row)
    return rows
