"""Open-loop request traffic through the session gateway on the
PyTorch/CUDA port (the port of ``examples/traffic_demo.py``, on
``repro_torch`` alone).

A mixed tenant population (steady Poisson minimize-energy sessions, a
bursty MMPP maximize-accuracy tenant, and a flash-crowd tenant that
multiplies the offered load mid-run) shares a small lane pool through
session paging: far more sessions than lanes, each session's Kalman and
goal state exported to the host store and imported into recycled lanes
between rounds, and EDF admission shedding hopeless requests.  Every
round is one ``select`` over the lanes: on a card one ``alert_select``
kernel launch.

    PYTHONPATH=src python examples/traffic_demo_torch.py [--sessions 48] \\
        [--lanes 8] [--device cpu]

The profile table and deadlines are the image family's
(``serving/scenarios.py``: ``golden_table()`` and ``golden_deadline()``,
the port's copy of the reference benchmarks' ``family_table("image")``
and ``deadline_range``).  Ends with an ``OK`` line.
"""

import argparse

import numpy as np

from repro_torch.core.controller import Constraints, Goal
from repro_torch.device import resolve_device
from repro_torch.serving.scenarios import golden_deadline, golden_table
from repro_torch.serving.sim import CPU_ENV, DEFAULT_ENV
from repro_torch.traffic import (FlashCrowdProcess, MMPPProcess,
                                 PoissonProcess, SessionGateway, TenantSpec,
                                 build_sessions, generate_requests)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=48,
                    help="total sessions across the three tenants")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--horizon", type=float, default=None,
                    help="workload horizon in seconds")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    table = golden_table()
    dl = float(golden_deadline(table, 5)[3])
    horizon = args.horizon if args.horizon is not None else 25 * dl
    n_each = max(args.sessions // 3, 1)
    per_rate = 0.35 * (args.lanes / dl) / args.sessions
    mix = [
        TenantSpec("steady-minE", Goal.MINIMIZE_ENERGY,
                   Constraints(deadline=dl, accuracy_goal=0.78),
                   PoissonProcess(per_rate), n_sessions=n_each,
                   phases=CPU_ENV),
        TenantSpec("bursty-maxQ", Goal.MAXIMIZE_ACCURACY,
                   Constraints.from_power_budget(dl, 170.0),
                   MMPPProcess(per_rate * 0.4, per_rate * 4.0,
                               dwell_low=8 * dl, dwell_high=3 * dl),
                   n_sessions=n_each, phases=DEFAULT_ENV),
        TenantSpec("flash-crowd", Goal.MINIMIZE_ENERGY,
                   Constraints(deadline=dl, accuracy_goal=0.72),
                   FlashCrowdProcess(per_rate, 60 * per_rate,
                                     spike_start=horizon * 0.4,
                                     spike_len=horizon * 0.2),
                   n_sessions=n_each, phases=DEFAULT_ENV),
    ]
    print(f"[1/3] building workload: {3 * n_each} sessions over "
          f"{args.lanes} lanes, horizon {horizon:.1f}s, "
          f"T_goal {dl * 1e3:.0f}ms...")
    sessions = build_sessions(mix, horizon, seed=7)
    requests = generate_requests(sessions)
    print(f"      {len(requests)} requests "
          f"({len(requests) / horizon:.0f} rps offered)")

    print(f"[2/3] serving through the session gateway on {device} (tick = "
          f"T_goal/4, EDF admission, bounded queue)...")
    gw = SessionGateway(table, args.lanes, tick=dl / 4,
                        max_queue=4 * args.lanes, device=device)
    res = gw.run(sessions, requests)

    print("[3/3] results:")
    by_tenant = {}
    for s in sessions:
        by_tenant.setdefault(s.tenant, []).append(s.sid)
    for tenant, sids in by_tenant.items():
        sel = np.isin(res.sid, sids)
        served = sel & res.served
        n_served = int(served.sum())
        miss = float(res.missed[served].mean()) if n_served else 0.0
        energy = float(res.energy[served].mean()) if n_served else 0.0
        soj = res.sojourn[served]
        p99 = float(np.percentile(soj, 99)) if n_served else 0.0
        print(f"  {tenant:12s} offered={int(sel.sum()):4d} "
              f"served={n_served:4d} miss={miss:.3f} "
              f"mean_E={energy:5.2f}J p99={p99 * 1e3:5.1f}ms")
    print(f"  total: goodput {res.goodput:.0f}/s, reject rate "
          f"{res.reject_rate:.3f}, served-miss {res.served_miss_rate:.3f}")
    print(f"  paging: {res.pages_in} pages in / {res.pages_out} out over "
          f"{res.n_rounds} rounds ({len(sessions)} sessions, "
          f"{args.lanes} lanes)")
    want = res.n_rounds if device.type == "cuda" else 0
    print(f"  alert_select launches: {res.select_launches} "
          f"({res.n_rounds} rounds)")
    if res.select_launches != want:
        raise AssertionError(f"alert_select launched {res.select_launches} "
                             f"times over {res.n_rounds} rounds, wanted "
                             f"{want}")
    if not res.pages_in > 0:
        raise AssertionError("the demo should exercise paging")
    if not res.goodput > 0:
        raise AssertionError("no good request served")
    print("OK: open-loop traffic served, one select a round.")
    return {"device": str(device), "requests": len(requests),
            "goodput": res.goodput, "reject_rate": res.reject_rate,
            "served_miss_rate": res.served_miss_rate,
            "pages_in": res.pages_in, "n_rounds": res.n_rounds,
            "select_launches": res.select_launches}


if __name__ == "__main__":
    main()
