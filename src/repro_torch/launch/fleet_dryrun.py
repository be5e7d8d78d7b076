"""Decision-plane dry run: the lane-sharded fleet engine end to end (port
of ``repro.launch.fleet_dryrun``).

Build a 1-D lane mesh, drive a mixed-goal, churning fleet through the
sharded ``BatchedAlertEngine`` and filter banks for a few ticks, check
pick parity against the single-device engine and that churn builds
nothing (no kernel build and no graph capture after the first tick), and
report the mesh's layout and the throughput as JSON.

The mesh spans every visible card by default; ``--devices N --device
cuda:0`` (or ``cpu``) lays N shards on one device, the port's counterpart
of the reference's faked host devices::

    PYTHONPATH=src python -m repro_torch.launch.fleet_dryrun \\
        --devices 8 --streams 4096 --ticks 12 --device cpu

It runs on the card unless given ``--device cpu``, and exits 1 on a
parity or flatness failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _builds() -> int:
    """Kernel libraries built or loaded by this process so far (the
    engine captures no graph, so these are all it could build)."""
    from repro_torch.kernels.build import loaded

    return len(loaded())


def run_fleet_dryrun(n_streams: int, ticks: int, churn: int, seed: int = 0,
                     *, n_devices: int | None = None, device=None) -> dict:
    """Drive the sharded engine and banks for ``ticks`` churning ticks and
    return the record (see the module docstring).  ``n_devices`` and
    ``device`` go to :func:`~repro_torch.launch.mesh.make_lane_mesh`;
    the single-device engine runs on the mesh's home device."""
    import numpy as np
    import torch

    from repro_torch.core.batched import BatchedAlertEngine
    from repro_torch.core.kalman import (IdlePowerFilterBank,
                                         SlowdownFilterBank, observe_fleet)
    from repro_torch.core.power import PowerModel
    from repro_torch.core.profiles import Candidate, profile_from_roofline
    from repro_torch.launch.mesh import make_lane_mesh

    # Self-contained profile: a small traditional family and one anytime
    # group, roofline latencies (the reference's table).
    cands = [Candidate(f"d{i}", flops=(i + 1) * 2e12,
                       bytes_hbm=(i + 1) * 4e9,
                       accuracy=0.55 + 0.08 * i) for i in range(3)]
    cands += [Candidate(f"any-l{m}", flops=(m + 1) * 1e12,
                        bytes_hbm=(m + 1) * 2e9,
                        accuracy=0.5 + 0.11 * m, is_anytime_level=True,
                        anytime_group="g", level=m) for m in range(1, 4)]
    table = profile_from_roofline(cands, PowerModel(), n_power_buckets=8)

    mesh = make_lane_mesh(n_devices, device=device)
    n_dev = mesh.size
    if n_streams % n_dev:
        n_streams += n_dev - n_streams % n_dev
    rng = np.random.default_rng(seed)
    s = n_streams
    med_lat = float(np.median(table.latency))
    d = rng.uniform(0.5, 3.0, s) * med_lat
    qg = rng.uniform(0.5, 0.9, s)
    eg = rng.uniform(0.5, 3.0, s) * float(np.median(table.run_power)
                                          * med_lat)
    gk = rng.integers(0, 2, s)
    act = rng.random(s) < 0.95

    engine = BatchedAlertEngine(table, None, mesh=mesh)
    single = BatchedAlertEngine(table, None, device=mesh.home)
    slow = SlowdownFilterBank(s, mesh=mesh)
    idle = IdlePowerFilterBank(s, mesh=mesh)
    kw = dict(accuracy_goal=qg, energy_goal=eg, predictions=False)

    b_sh = engine.select(slow.mu, slow.sigma, idle.phi, d, goal_kind=gk,
                         active=act, **kw)
    b_1d = single.select(np.ones(s), np.full(s, 0.1), np.full(s, 0.3), d,
                         goal_kind=gk, active=act, **kw)
    parity = bool(np.array_equal(b_sh.model_index, b_1d.model_index)
                  and np.array_equal(b_sh.power_index, b_1d.power_index))
    builds0 = _builds()

    t0 = time.perf_counter()
    for _ in range(ticks):
        live = np.nonzero(act)[0]
        dep = rng.choice(live, size=min(churn, live.size), replace=False)
        act[dep] = False
        arr = rng.choice(np.nonzero(~act)[0],
                         size=min(churn, s - int(act.sum())),
                         replace=False)
        slow.reset_lanes(arr)
        idle.reset_lanes(arr)
        gk[arr] = rng.integers(0, 2, arr.size)
        act[arr] = True
        batch = engine.select(slow.mu, slow.sigma, idle.phi, d,
                              goal_kind=gk, active=act, **kw)
        prof = table.latency[batch.model_index, batch.power_index]
        observe_fleet(slow, idle, prof * rng.lognormal(0.0, 0.1, s), prof,
                      idle_power=0.25 * np.ones(s),
                      active_power=np.ones(s), mask=act)
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    return {
        "status": "ok",
        "n_devices": n_dev,
        "mesh_axes": list(mesh.axis_names),
        "n_streams": s,
        "ticks": ticks,
        "churn_per_tick": churn,
        "state_sharding": {"devices": [str(x) for x in mesh.devices],
                           "blocks": [list(b) for b in mesh.blocks(s)]},
        "picks_match_single_device": parity,
        "builds_flat_under_churn": _builds() == builds0,
        "decisions_per_sec": s * ticks / dt,
    }


def main(argv=None) -> int:
    """CLI entry point (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="lane shards (default: one a visible card; with "
                    "--device, that many on the one device)")
    ap.add_argument("--streams", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--churn", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="lay every shard on this device (cpu, cuda:0)")
    args = ap.parse_args(argv)
    rec = run_fleet_dryrun(args.streams, args.ticks, args.churn,
                           n_devices=args.devices, device=args.device)
    print(json.dumps(rec, indent=2))
    return 0 if rec["picks_match_single_device"] and \
        rec["builds_flat_under_churn"] else 1


if __name__ == "__main__":
    sys.exit(main())
