"""A fault-volatile fleet on the PyTorch/CUDA port: chaos injection,
Kalman-bank detection, quarantine and bit-exact checkpointed resume (the
port of ``examples/faults_demo.py``, on ``repro_torch`` alone).

One seeded serving run through the session gateway, attacked three ways:

1. a lane straggler ramps one lane to 3x slow-down mid-run; the
   :class:`~repro_torch.traffic.faults.KalmanLaneDetector`, reading
   ALERT's own Eq. 7 posterior (not an oracle flag), trips exactly that
   lane and recommends a reshard, while a clean control run stays silent;
2. a device loss kills a contiguous lane group; the gateway pages the
   dead lanes' session state out to the host store and serves on the
   survivors, one ``select`` a round still (on a card one
   ``alert_select`` launch);
3. the run is killed mid-way (an injected failure between rounds) and
   resumed from its atomic checkpoint (:mod:`repro_torch.checkpoint.io`);
   the resumed result must equal an uninterrupted run's, field for field.

Raises if detection misses, the select count is off, or the resumed
trajectory diverges; prints ``OK`` otherwise.

    PYTHONPATH=src python examples/faults_demo_torch.py [--device cpu]

The profile table and deadlines are the image family's
(``serving/scenarios.py``: ``golden_table()`` and ``golden_deadline()``).
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.controller import Constraints, Goal
from repro_torch.device import resolve_device
from repro_torch.runtime.ft import InjectedFailure
from repro_torch.serving.scenarios import golden_deadline, golden_table
from repro_torch.serving.sim import CPU_ENV
from repro_torch.traffic import (FaultSchedule, KalmanLaneDetector,
                                 LaneStraggler, PoissonProcess,
                                 SessionGateway, TenantSpec, build_sessions,
                                 generate_requests, scenario)

FIELDS = ("status", "start", "latency", "sojourn", "missed", "accuracy",
          "energy", "model_index", "power_index")


def main(argv=None) -> dict:
    """Run the chaos demo (see the module docstring)."""
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
                      PoissonProcess(0.8 / dl), n_sessions=n_lanes,
                      phases=CPU_ENV)]
    sessions = build_sessions(mix, 40 * dl, seed=7)

    def gateway():
        return SessionGateway(table, n_lanes, tick=dl, device=device)

    print(f"[1/3] straggler detection on {device}: lane 5 ramps to 3x "
          f"slow-down from round 10 (T_goal={dl * 1e3:.0f}ms, {n_lanes} "
          f"lanes)...")
    faults = FaultSchedule(n_lanes, [LaneStraggler(
        lane=5, start=10 * dl, magnitude=2.0, ramp_s=5 * dl)], seed=0)
    det = KalmanLaneDetector(n_lanes)
    gateway().run(sessions, generate_requests(sessions), faults=faults,
                  detector=det)
    tripped = [int(x) for x in np.nonzero(det.tripped)[0]]
    lat = det.detection_latency(5, 10 * dl) / dl
    print(f"      tripped lanes {tripped} after {lat:.0f} rounds "
          f"-> {det.recommendation(5)!r}")
    if tripped != [5]:
        raise AssertionError(f"detector tripped {tripped}, wanted [5]")
    clean = KalmanLaneDetector(n_lanes)
    gateway().run(sessions, generate_requests(sessions), detector=clean)
    if int(clean.tripped.sum()):
        raise AssertionError("false positive on the clean run")
    print("      clean control run: zero false positives")

    print("[2/3] device loss: the last lane group dies mid-run; "
          "survivors absorb the fleet...")
    loss = scenario("device_loss", n_lanes, start=10 * dl,
                    horizon=40 * dl, n_devices=4)
    r = gateway().run(sessions, generate_requests(sessions), faults=loss)
    want = r.n_rounds if device.type == "cuda" else 0
    if r.select_launches != want:
        raise AssertionError(f"alert_select launched {r.select_launches} "
                             f"times over {r.n_rounds} rounds")
    print(f"      served {int(r.served.sum())}/{r.offered} on the "
          f"surviving lanes, pages out {r.pages_out}, alert_select "
          f"launches {r.select_launches} over {r.n_rounds} rounds")

    print("[3/3] kill/resume: checkpoint every 3 rounds, kill at "
          "round 12, resume from the atomic snapshot...")
    ref = gateway().run(sessions, generate_requests(sessions))
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck")
        try:
            gateway().run(sessions, generate_requests(sessions),
                          checkpoint_dir=ck, checkpoint_every=3,
                          kill_at_round=12)
            raise AssertionError("the injected kill never fired")
        except InjectedFailure as e:
            print(f"      killed: {e}")
        res = gateway().resume(sessions, generate_requests(sessions),
                               checkpoint_dir=ck)
    bad = [f for f in FIELDS
           if not np.array_equal(getattr(ref, f), getattr(res, f))]
    if bad or ref.n_rounds != res.n_rounds:
        raise AssertionError(f"the resumed run diverges on {bad}")
    print(f"      resumed bitwise-identical to the uninterrupted run "
          f"({len(FIELDS)} fields, {ref.n_rounds} rounds)")
    print("OK: chaos demo, all three attacks handled.")
    return {"device": str(device), "tripped": tripped,
            "detection_rounds": lat, "served_after_loss": int(r.served.sum()),
            "offered": r.offered, "rounds": ref.n_rounds}


if __name__ == "__main__":
    main()
