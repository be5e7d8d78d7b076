"""End to end on the PyTorch/CUDA port: ALERT scheduling a real anytime
model's measured staircase through the session gateway (the port of
``examples/live_profile_demo.py``, on ``repro_torch`` alone).

Pipeline:
  1. jointly train the reduced ``alert_anytime`` width-nested LM and
     measure each level's held-out accuracy (``train_reduced_anytime``);
  2. build the live ProfileTable through the profiling harness: by
     default with deterministic fake-clock latencies (each level's
     nested-FLOP fraction), with ``--measured`` the wall clock of
     ``ServeEngine.generate`` at each level (on a card the engine runs the
     kernels, ``nest_backend="kernel"`` and ``attn_backend="kernel"``,
     from CUDA graphs);
  3. sweep offered load through the session gateway three ways on the
     same seeded workload: the full ALERT controller (level x power),
     application-only adaptation (levels only, power at the default) and
     system-only adaptation (power only, the most accurate level);
  4. report goodput, energy per good request and SLO misses per scheme
     and load, and end with an ``OK`` line once ALERT has served good
     requests at every load.

    PYTHONPATH=src python examples/live_profile_demo_torch.py [--measured] \\
        [--train-steps 250] [--device cpu]
"""

import argparse
import dataclasses

from repro_torch.core.controller import Constraints, Goal
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.profiling import live_profile_table, train_reduced_anytime
from repro_torch.serving.sim import DEFAULT_ENV
from repro_torch.traffic import PoissonProcess, TenantSpec, sweep_loads


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--measured", action="store_true",
                    help="time the engine's real per-level generate calls "
                         "instead of the deterministic fake clock")
    ap.add_argument("--train-steps", type=int, default=250)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"[1/3] joint-training the reduced alert_anytime family on "
          f"{device}...")
    trained = train_reduced_anytime(train_steps=args.train_steps,
                                    device=device)
    print("      level accuracies: "
          + " ".join(f"L{k + 1}={a:.3f}"
                     for k, a in enumerate(trained.accuracies)))

    mode = "measured" if args.measured else "fake"
    served = trained
    if args.measured and device.type == "cuda":
        cfg = trained.cfg.replace(nest_backend="kernel",
                                  attn_backend="kernel")
        served = dataclasses.replace(trained, model=build_model(cfg),
                                     cfg=cfg)
    print(f"[2/3] building the live ProfileTable ({mode} latencies, "
          f"{served.cfg.nest_backend} projections, {served.cfg.attn_backend} "
          f"attention, analytic 1/f power buckets)...")
    table = live_profile_table(served, mode=mode)
    for k, name in enumerate(table.names):
        print(f"      {name}: lat@full={table.latency[k, -1] * 1e3:.2f} ms"
              f"  acc={table.accuracies[k]:.3f}")

    print("[3/3] load sweep: alert vs app-only vs sys-only adaptation...")
    top = float(table.latency[-1, -1])
    dl = 2.0 * top
    n_lanes, n_sessions = 32, 128
    cons = Constraints(deadline=dl, accuracy_goal=0.40)
    mix = [TenantSpec("min-energy", Goal.MINIMIZE_ENERGY, cons,
                      PoissonProcess(0.5 * (n_lanes / dl) / n_sessions),
                      n_sessions=n_sessions, phases=DEFAULT_ENV)]
    rows = sweep_loads(table, mix, [0.5, 2.0, 8.0], n_lanes=n_lanes,
                       horizon=20 * dl, seed=13, max_queue=4 * n_lanes,
                       tick=dl / 4,
                       schemes=("alert", "app_only", "sys_only"),
                       device=device)
    for r in rows:
        print(f"  load {r['load']:4.1f} (offered {r['offered']})")
        for s, d in r["schemes"].items():
            print(f"    {s:9s} goodput={d['goodput_rps']:7.1f}/s  "
                  f"energy/good={d['energy_per_good_j']:7.3f} J  "
                  f"slo-miss={d['slo_miss_rate']:.3f}")
    idle = [r["load"] for r in rows
            if not r["schemes"]["alert"]["goodput_rps"] > 0]
    if idle:
        raise AssertionError(f"ALERT served no good request at loads "
                             f"{idle}")
    print(f"OK: ALERT served the live {mode} staircase of "
          f"{len(table.names)} levels at {len(rows)} loads, beside the "
          f"app-only and sys-only baselines.")
    return {"device": str(device), "mode": mode,
            "accuracies": trained.accuracies,
            "table_latency": table.latency[:, -1].tolist(), "rows": rows}


if __name__ == "__main__":
    main()
