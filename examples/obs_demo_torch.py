"""The flight recorder on the whole serving path of the PyTorch/CUDA
port (the port of ``examples/obs_demo.py``, on ``repro_torch`` alone).

One seeded overload workload is served twice, through the host
:class:`~repro_torch.traffic.SessionGateway` and the device-resident
:class:`~repro_torch.traffic.megatick.MegatickGateway` (on a card its
rounds replay as one CUDA graph a chunk over ``alert_select``), each
with a :class:`~repro_torch.obs.FlightRecorder` attached:

1. the metrics registry fills with the serving path's catalog (SLO-miss
   rate, energy per good request, queue depth, shedding, paging, Kalman
   innovation, the gateways' counters);
2. the span tracer records the host phases (planner, scan dispatch,
   paging, serve rounds) and exports a JSONL stream and a
   Chrome/Perfetto ``trace.json``;
3. the telemetry ring keeps per-round aggregates (on the megatick
   computed in the round body from values it already holds);

then the pure-observer contract is checked: every result array bitwise
equal to an unobserved run's, and the ring's totals reconcile with the
result.  The bundle is saved and rendered back through
:func:`repro_torch.obs.report.render_recorder`.  Raises if
instrumentation moves a single bit; prints ``OK`` otherwise.

    PYTHONPATH=src python examples/obs_demo_torch.py [--device cpu]

The profile table and deadlines are the image family's
(``serving/scenarios.py``: ``golden_table()`` and ``golden_deadline()``).
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.controller import Constraints, Goal
from repro_torch.device import resolve_device
from repro_torch.obs import FlightRecorder, validate_jsonl
from repro_torch.obs.report import render_recorder
from repro_torch.serving.scenarios import golden_deadline, golden_table
from repro_torch.serving.sim import CPU_ENV
from repro_torch.traffic import (PoissonProcess, SessionGateway, TenantSpec,
                                 build_sessions, generate_requests)
from repro_torch.traffic.megatick import MegatickGateway

FIELDS = ("status", "start", "latency", "sojourn", "missed", "accuracy",
          "energy", "model_index", "power_index")


def main(argv=None) -> dict:
    """Run the flight-recorder demo (see the module docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    table = golden_table()
    dl = float(golden_deadline(table, 5)[3])
    n_lanes = 8
    mix = [TenantSpec("t", Goal.MINIMIZE_ENERGY,
                      Constraints(deadline=dl, accuracy_goal=0.78),
                      PoissonProcess(2.0 / dl), n_sessions=2 * n_lanes,
                      phases=CPU_ENV)]
    sessions = build_sessions(mix, 24 * dl, seed=11)
    requests = generate_requests(sessions)
    print(f"workload: {len(requests)} requests over {n_lanes} lanes, "
          f"T_goal={dl * 1e3:.0f}ms, ~2x overload, on {device}")

    summary, obs = {}, None
    for name, GW in (("host", SessionGateway),
                     ("megatick", MegatickGateway)):
        print(f"\n[{name}] serving instrumented vs bare...")
        fr = FlightRecorder()
        res = GW(table, n_lanes, tick=dl, max_queue=4 * n_lanes, obs=fr,
                 device=device).run(sessions, requests)
        bare = GW(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                  device=device).run(sessions, requests)
        bad = [f for f in FIELDS
               if not np.array_equal(np.asarray(getattr(res, f)),
                                     np.asarray(getattr(bare, f)))]
        if bad:
            raise AssertionError(f"{name}: the recorder perturbed {bad}")
        s = fr.ring.summary()
        if s["rounds_seen"] != res.n_rounds or \
                s["missed"] != int(res.missed[res.served].sum()):
            raise AssertionError(f"{name}: the ring does not reconcile: "
                                 f"{s} against {res.n_rounds} rounds")
        print(f"  pure observer: {len(FIELDS)} result arrays bitwise "
              f"equal to the bare run; ring reconciles "
              f"({s['rounds_seen']} rounds, {s['missed']} misses, "
              f"{s['energy_j']:.1f} J); alert_select launches "
              f"{res.select_launches}")
        print(f"  recorded: {len(fr.metrics)} metrics, "
              f"{len(fr.spans)} spans, ring feasible-frac "
              f"{s['feasible_frac']:.3f} / relaxed-frac "
              f"{s['relaxed_frac']:.3f}")
        summary[name] = {"rounds": res.n_rounds, "missed": s["missed"],
                         "metrics": len(fr.metrics), "spans": len(fr.spans),
                         "select_launches": res.select_launches}
        obs = fr

    with tempfile.TemporaryDirectory() as td:
        run_dir = os.path.join(td, "flight")
        paths = obs.save(run_dir)
        n = validate_jsonl(paths["spans"])
        print(f"\nsaved bundle to {sorted(os.listdir(run_dir))} "
              f"({n} span records validate against the JSONL schema; "
              f"open trace.json in chrome://tracing or Perfetto)")
        print("\n" + render_recorder(obs, trace_paths=paths))
    print("\nOK: obs demo, the recorder is a pure observer on both "
          "gateways.")
    return {"device": str(device), "requests": len(requests), **summary}


if __name__ == "__main__":
    main()
