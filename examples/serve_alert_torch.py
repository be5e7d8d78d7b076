"""End to end on the PyTorch/CUDA port: train a small anytime model,
then serve it with batched requests under the ALERT runtime (the port of
``examples/serve_alert.py``, on ``repro_torch`` alone).

Pipeline:
  1. jointly train a width-nested (K=3) anytime LM on the synthetic task
     (paper Section 4.3: one backward pass for all levels), on the
     ``blocks`` projections and ``ref`` attention (no kernel has a
     backward);
  2. measure each level's accuracy on held-out data;
  3. serve the trained weights under the ALERT controller (Kalman
     slow-down filter, Eq. 6; staircase accuracy, Eq. 10; Eq. 4/5
     selection) over a stream of batched requests with deadlines that
     tighten mid-stream; on a card the engine runs every kernel
     (``nest_backend="kernel"``, ``attn_backend="kernel"``) from CUDA
     graphs;
  4. report per-phase level choices, deadline-miss rate and delivered
     accuracy, and check that the levels drop under tight deadlines;
  5. multiplex a churning, goal-heterogeneous mini-fleet onto the same
     engine through ``FleetAlertServer``: one scoring call per tick,
     admit/retire between ticks, and no new step made (no CUDA graph
     captured) while lanes recycle.

    PYTHONPATH=src python examples/serve_alert_torch.py [--requests 60] \\
        [--train-steps 200] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import Constraints, Goal
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels import alert_select as ks
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.serving.alert_server import AlertServer, FleetAlertServer
from repro_torch.serving.batcher import DeadlineBatcher, Request
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.losses import token_accuracy
from repro_torch.train.step import (init_train_state, make_anytime_loss_fn,
                                    make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    levels = 3
    cfg = ModelConfig(name="alert-serve", family="dense", n_layers=2,
                      d_model=64, n_heads=8, n_kv_heads=8, head_dim=8,
                      d_ff=128, vocab=32, nest_levels=levels,
                      dtype="float32", attn_chunk=64)
    model = build_model(cfg)
    data = SyntheticLM(vocab=32, seq_len=64, global_batch=16, noise=0.05,
                       order=2)

    def on_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    # 1. joint anytime training -------------------------------------- #
    print(f"[1/5] joint-training {levels}-level anytime LM "
          f"({args.train_steps} steps) on {device}...")
    opt = AdamW(lr=8e-3)
    state = init_train_state(model, cfg, opt,
                             torch.Generator(device=device).manual_seed(0),
                             device=device)
    step = make_train_step(model, cfg, opt, loss_fn=make_anytime_loss_fn(
        model, cfg, level_weights=[0.25, 0.3, 0.45]))
    losses = []
    for i in range(args.train_steps):
        state, metrics = step(state, on_device(data.batch_at(i)))
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    print(f"      final joint loss {losses[-1]:.3f}")

    # 2. per-level accuracy (real, held-out) ------------------------- #
    accs = []
    evalb = on_device(data.batch_at(10_000))
    with torch.no_grad():
        for k in range(1, levels + 1):
            logits, _ = model.train_logits(state.params, evalb, level=k)
            accs.append(float(token_accuracy(logits, evalb["labels"])))
    print("[2/5] level accuracies: "
          + " ".join(f"L{k + 1}={a:.3f}" for k, a in enumerate(accs)))

    # 3. ALERT serving loop ------------------------------------------ #
    serve_cfg = cfg.replace(nest_backend="kernel", attn_backend="kernel") \
        if device.type == "cuda" else cfg
    print(f"[3/5] profiling levels + starting ALERT loop "
          f"({serve_cfg.nest_backend} projections, {serve_cfg.attn_backend} "
          f"attention)...")
    engine = ServeEngine(build_model(serve_cfg), max_len=32, batch_size=4,
                         device=device)
    params = state.params
    server = AlertServer(engine, params, accs, Goal.MAXIMIZE_ACCURACY,
                         prompt_len=8, gen_tokens=4)
    print("      profiled level latencies (s): "
          + " ".join(f"{t:.4f}" for t in server.table.latency[:, -1]))

    batcher = DeadlineBatcher(batch_size=4)
    rng = np.random.default_rng(0)
    now = 0.0
    results = []
    # Regime deadlines from the measured level latencies: loose fits the
    # deepest level comfortably, tight only the mid and shallow levels.
    lat = server.table.latency[:, -1]
    loose_dl = float(lat[-1]) * 1.4
    tight_dl = float(np.clip(lat[len(lat) // 2] * 1.15,
                             lat[0] * 1.2, lat[-1] * 0.95))
    print(f"      deadlines: loose={loose_dl:.4f}s tight={tight_dl:.4f}s")
    for i in range(args.requests):
        tight = args.requests // 3 <= i < 2 * args.requests // 3
        deadline = (tight_dl if tight else loose_dl) * \
            rng.uniform(0.95, 1.15)
        batcher.submit(Request(deadline=now + deadline, arrival=now))
        got = batcher.next_batch(now)
        if got is None:
            continue
        _, batch_deadline = got
        prompt = np.asarray(data.batch_at(20_000 + i)["tokens"][:4, :8])
        cons = Constraints.from_power_budget(batch_deadline - now,
                                             power_budget=150.0)
        r = server.serve_one(prompt, cons)
        results.append((tight, r))
        now += r.latency

    # 4. report ------------------------------------------------------- #
    print("[4/5] results:")
    for phase, name in ((False, "loose-deadline"), (True, "tight-deadline")):
        rs = [r for t, r in results if t == phase]
        if not rs:
            continue
        print(f"  {name:15s} n={len(rs):3d} "
              f"mean_level={np.mean([r.level for r in rs]):.2f} "
              f"delivered_acc={np.mean([r.accuracy for r in rs]):.3f} "
              f"miss_rate={np.mean([r.missed for r in rs]):.2f} "
              f"energy={np.mean([r.energy for r in rs]):.1f}J")
    lv_loose = float(np.mean([r.level for t, r in results if not t]))
    lv_tight = float(np.mean([r.level for t, r in results if t]))
    if not lv_tight <= lv_loose + 1e-9:
        raise AssertionError("ALERT should drop levels under tight "
                             "deadlines")
    print("OK: ALERT adapted the anytime level to the deadline regime.")

    # 5. churning heterogeneous mini-fleet -------------------------- #
    print("[5/5] fleet: 3 lanes, mixed goals, churn between ticks...")
    fleet = FleetAlertServer(engine, params, accs, Goal.MAXIMIZE_ACCURACY,
                             n_streams=3, profile_iters=1, gen_tokens=4)
    budget = float(np.median(fleet.table.run_power)) * loose_dl * 1.5
    c_max = Constraints(deadline=loose_dl, energy_goal=budget)
    c_min = Constraints(deadline=loose_dl, accuracy_goal=min(accs) + 0.02,
                        energy_goal=budget)
    made = engine.n_compiles()
    select_before = ks.alert_select.launches
    # lane 1 switches tenancy mid-run: retire the max-accuracy stream,
    # admit a minimize-energy one in its place (a recycled lane)
    fleet.retire(1)
    lane = fleet.admit(goal=Goal.MINIMIZE_ENERGY)
    if lane != 1:
        raise AssertionError(f"the freed lane 1 was not reused ({lane})")
    prompt = np.asarray(data.batch_at(30_000)["tokens"][:4, :8])
    served = {0: [], 1: [], 2: []}
    ticks = 6
    for _ in range(ticks):
        outs = fleet.serve_tick([prompt] * 3, [c_max, c_min, c_max])
        for s, o in enumerate(outs):
            if o is not None:
                served[s].append(o)
    for s, rs in served.items():
        goal = "min-energy" if s == lane else "max-accuracy"
        print(f"  lane {s} ({goal:12s}): n={len(rs)} "
              f"mean_level={np.mean([r.level for r in rs]):.2f} "
              f"energy={np.mean([r.energy for r in rs]):.1f}J "
              f"acc={np.mean([r.accuracy for r in rs]):.3f}")
    selects = ks.alert_select.launches - select_before
    print(f"  engine steps made (prefill, decode): {made} before the "
          f"ticks, {engine.n_compiles()} after; alert_select launched "
          f"{selects} times in {ticks} ticks")
    if engine.n_compiles() != made:
        raise AssertionError("fleet churn must not make (capture) new "
                             "engine steps")
    e_min = float(np.mean([r.energy for r in served[lane]]))
    e_max = float(np.mean([r.energy for s, rs in served.items()
                           if s != lane for r in rs]))
    print(f"OK: min-energy tenant averaged {e_min:.1f}J vs "
          f"{e_max:.1f}J for max-accuracy tenants.")
    return {"device": str(device), "losses": losses, "accuracies": accs,
            "mean_level": (lv_loose, lv_tight), "n_compiles": made,
            "select_launches": selects, "ticks": ticks,
            "table_latency": server.table.latency[:, -1].tolist()}


if __name__ == "__main__":
    main()
