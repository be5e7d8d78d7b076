"""The hand-written decision kernel against its plain version on the
PyTorch/CUDA port (the port of ``examples/kernel_demo.py``, on
``repro_torch`` alone).

One churning fleet, tick by tick, through two scoring engines:
``BatchedAlertEngine`` on the card, whose every ``select`` is one launch
of the ``alert_select`` CUDA kernel (the Eq. 7/10 staircase probes, Eq. 9
energy, the Eq. 4/5 feasibility and Section 3.3 relaxation and the
``[K*L]`` argmin fused in one pass over ``[S, K, L]``), and the same
engine on the CPU, which runs the kernel's plain PyTorch version.  A
goal-mixed fleet of ``--streams`` lanes goes through select and feedback
(``observe_fleet`` on the card) ticks with 10 % lane churn; every tick
the two must pick bitwise the same configurations, and the kernel must
launch once a select while the lanes recycle.  Per-tick host times are
printed for both.  With ``--device cpu`` both engines run the plain
version.

    PYTHONPATH=src python examples/kernel_demo_torch.py [--streams 512] \\
        [--ticks 8] [--device cpu]

The profile table and deadlines are the image family's
(``serving/scenarios.py``: ``golden_table()`` and ``golden_deadline()``).
Ends with an ``OK`` line.
"""

import argparse
import time

import numpy as np

from repro_torch.core.batched import BatchedAlertEngine
from repro_torch.core.kalman import (IdlePowerFilterBank, SlowdownFilterBank,
                                     observe_fleet)
from repro_torch.device import resolve_device
from repro_torch.kernels import alert_select as ks
from repro_torch.serving.scenarios import golden_deadline, golden_table


def main(argv=None) -> dict:
    """Run the churning pick-parity demo (see the module docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    s = args.streams
    table = golden_table()
    k, l = table.latency.shape
    dls = golden_deadline(table, 5)
    med_en = float(np.median(table.run_power) * np.median(table.latency))
    rng = np.random.default_rng(0)

    what = "the kernel" if device.type == "cuda" else "the plain version"
    print(f"[1/3] engines over the 'image' family table (K={k} configs x "
          f"L={l} power caps), S={s} lanes: {device} ({what}) and cpu "
          f"(the plain version)...")
    eng = BatchedAlertEngine(table, None, device=device)
    plain = BatchedAlertEngine(table, None, device="cpu")

    slow = SlowdownFilterBank(s, device=device)
    idle = IdlePowerFilterBank(s, device=device)
    act = rng.random(s) < 0.9
    gk = rng.integers(0, 2, s)
    d = rng.choice(dls, s)
    kw = dict(accuracy_goal=rng.uniform(0.5, 0.9, s),
              energy_goal=rng.uniform(0.5, 3.0, s) * med_en,
              predictions=False)
    for e in (eng, plain):          # warm both paths outside the ticks
        e.select(slow.mu, slow.sigma, idle.phi, d, goal_kind=gk,
                 active=act, **kw)
    launches0 = ks.alert_select.launches

    print(f"[2/3] {args.ticks} churning ticks (10 %/tick, mixed "
          f"Eq. 4/Eq. 5 tenants), pick parity asserted per tick:")
    n_churn = max(s // 10, 1)
    idle_p, active_p = 0.25 * np.ones(s), np.ones(s)
    for tick in range(args.ticks):
        # churn: retire/admit a tenth of the fleet into recycled lanes
        lanes = rng.integers(0, s, n_churn)
        slow.reset_lanes(lanes)
        idle.reset_lanes(lanes)
        gk[lanes] = rng.integers(0, 2, n_churn)
        d[lanes] = rng.choice(dls, n_churn)
        act[lanes] = rng.random(n_churn) < 0.9
        t0 = time.perf_counter()
        bk = eng.select(slow.mu, slow.sigma, idle.phi, d, goal_kind=gk,
                        active=act, **kw)
        t_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        bp = plain.select(slow.mu, slow.sigma, idle.phi, d, goal_kind=gk,
                          active=act, **kw)
        t_p = time.perf_counter() - t0
        same = (np.array_equal(bk.model_index, bp.model_index)
                and np.array_equal(bk.power_index, bp.power_index)
                and np.array_equal(bk.feasible, bp.feasible)
                and np.array_equal(bk.relaxed_code, bp.relaxed_code))
        if not same:
            raise AssertionError(f"tick {tick}: the kernel's picks differ "
                                 f"from the plain version's")
        # shared feedback so both engines score the same state next tick
        prof = table.latency[bk.model_index, bk.power_index]
        observe_fleet(slow, idle, prof * rng.lognormal(0.0, 0.1, s), prof,
                      idle_power=idle_p, active_power=active_p, mask=act)
        print(f"  tick {tick}: {device.type} {t_k * 1e3:6.2f} ms | cpu "
              f"{t_p * 1e3:6.2f} ms | picks bitwise-identical: {same}")

    launches = ks.alert_select.launches - launches0
    want = args.ticks if device.type == "cuda" else 0
    if launches != want:
        raise AssertionError(f"alert_select launched {launches} times in "
                             f"{args.ticks} ticks, wanted {want}")
    print(f"[3/3] alert_select launched {launches} times in {args.ticks} "
          f"ticks: one a select while lanes recycle (goal flips, lane "
          f"reuse and deadline changes are runtime tensors)")
    print("OK: the alert_select kernel picks as its plain version, tick "
          "for tick.")
    return {"device": str(device), "streams": s, "ticks": args.ticks,
            "launches": launches}


if __name__ == "__main__":
    main()
