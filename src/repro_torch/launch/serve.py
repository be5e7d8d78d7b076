"""Serving launcher on one device (port of ``repro.launch.serve``):
restore a trained checkpoint (or draw fresh weights) and run the ALERT
runtime over a synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch alert-anytime-120m --requests 40 [--ckpt-dir <dir>] \\
        [--goal max_acc|min_energy] [--deadline-scale 1.2] [--device cpu]

The flow is the reference's: the reduced config of ``--arch`` in float32
over a 32-token vocabulary (at least two nesting levels), checkpoint
restore through :mod:`repro_torch.checkpoint.io`, each level's accuracy
on held-out ``SyntheticLM`` data, an :class:`AlertServer` over a
:class:`ServeEngine` that profiles the levels, and ``--requests`` inputs
under ``Constraints.from_power_budget`` (``--goal max_acc``) or an
accuracy goal (``min_energy``), with a per-request and a final report.
On the card the engine serves on every kernel (``nest_backend="kernel"``,
``attn_backend="kernel"``) from CUDA graphs; the accuracies come from
``train_logits`` on the ``blocks``/``ref`` path.

``--reduced`` is accepted and always on, as in the reference (a
``store_true`` flag whose default is True).  An architecture whose
reduced config cannot take two nesting levels raises, as the reference's
launcher raises for it (``rwkv6-3b``, whose layers have no nested form).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.controller import Constraints, Goal
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serving.alert_server import AlertServer
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.losses import token_accuracy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="alert-anytime-120m",
                    choices=configs.ALL_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--goal", default="max_acc",
                    choices=["max_acc", "min_energy"])
    ap.add_argument("--deadline-scale", type=float, default=1.2,
                    help="deadline as a multiple of the deepest level's "
                         "profiled latency")
    ap.add_argument("--power-budget", type=float, default=150.0)
    ap.add_argument("--accuracy-goal", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_reduced(args.arch).replace(dtype="float32", vocab=32)
    if cfg.nest_levels <= 1:
        cfg = cfg.replace(nest_levels=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    restored_step = None
    if args.ckpt_dir and os.path.exists(args.ckpt_dir):
        try:
            params, restored_step = ckpt_io.restore(args.ckpt_dir, params)
            print(f"[serve] restored params from step {restored_step}")
        except (KeyError, ValueError, OSError) as e:
            print(f"[serve] checkpoint restore failed ({e!r}); serving "
                  f"fresh init")

    # each level's accuracy on held-out synthetic data
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32,
                       global_batch=args.batch, noise=0.05)
    evalb = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(10_000).items()}
    accs = []
    with torch.no_grad():
        for k in range(1, cfg.nest_levels + 1):
            logits, _ = model.train_logits(params, evalb, level=k)
            accs.append(float(token_accuracy(logits, evalb["labels"])))
    print("[serve] level accuracies: "
          + " ".join(f"L{i + 1}={a:.3f}" for i, a in enumerate(accs)))

    goal = Goal.MAXIMIZE_ACCURACY if args.goal == "max_acc" \
        else Goal.MINIMIZE_ENERGY
    serve_cfg = cfg.replace(nest_backend="kernel", attn_backend="kernel") \
        if device.type == "cuda" else cfg
    engine = ServeEngine(build_model(serve_cfg), max_len=32,
                         batch_size=args.batch, device=device)
    server = AlertServer(engine, params, accs, goal, prompt_len=8,
                         gen_tokens=4)
    base = float(server.table.latency[-1, -1])
    print(f"[serve] {serve_cfg.nest_backend} projections, "
          f"{serve_cfg.attn_backend} attention on {device}; profiled level "
          f"latencies: "
          + " ".join(f"{t:.4f}s" for t in server.table.latency[:, -1]))

    rng = np.random.default_rng(0)
    results = []
    for i in range(args.requests):
        deadline = base * args.deadline_scale * rng.uniform(0.85, 1.25)
        if goal is Goal.MAXIMIZE_ACCURACY:
            cons = Constraints.from_power_budget(deadline,
                                                 args.power_budget)
        else:
            cons = Constraints(deadline, accuracy_goal=args.accuracy_goal)
        prompt = np.asarray(data.batch_at(20_000 + i)
                            ["tokens"][:args.batch, :8])
        r = server.serve_one(prompt, cons)
        results.append(r)
        if i % 10 == 0:
            print(f"  req {i:3d} level={r.level} cap={r.power_cap:.0f}W "
                  f"lat={r.latency:.4f}s missed={r.missed}")
    out = {"device": str(device), "arch": cfg.name,
           "nest_backend": serve_cfg.nest_backend,
           "attn_backend": serve_cfg.attn_backend,
           "restored_step": restored_step, "accuracies": accs,
           "table_latency": server.table.latency[:, -1].tolist(),
           "requests": len(results),
           "levels": [r.level for r in results],
           "delivered_acc": float(np.mean([r.accuracy for r in results])),
           "miss_rate": float(np.mean([r.missed for r in results])),
           "mean_energy": float(np.mean([r.energy for r in results])),
           "slowdown_mu": float(server.controller.slowdown.mu)}
    print(f"[serve] {out['requests']} requests: delivered_acc="
          f"{out['delivered_acc']:.3f} miss_rate={out['miss_rate']:.2f} "
          f"mean_energy={out['mean_energy']:.1f}J (slowdown "
          f"mu={out['slowdown_mu']:.2f})")
    return out


if __name__ == "__main__":
    main()
