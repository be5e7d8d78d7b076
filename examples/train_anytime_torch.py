"""Train the paper's anytime LM with both of Section 4.3's training modes
under fault-tolerant supervision, on the PyTorch/CUDA port (the port of
``examples/train_anytime.py``, on ``repro_torch`` alone).

  * joint: weighted per-level losses, one backward pass (the nesting
    property), under the :class:`Supervisor`, which checkpoints every
    ``--ckpt-every`` steps; a crash is injected at ``--fail-at`` and the
    run restarts from the last checkpoint (the data pipeline is
    deterministic, so it resumes where it stopped);
  * greedy: stage-wise, the one-hot loss of level 1, then of level 2, ...
    (``greedy_stage``), ``--stage-steps`` steps a stage.

    PYTHONPATH=src python examples/train_anytime_torch.py \\
        [--joint-steps 120] [--fail-at 60] [--stage-steps 40] [--device cpu]

Training runs the ``blocks`` projections and ``ref`` attention (no kernel
has a backward).  Ends with an ``OK`` line once both modes have run.
"""

import argparse
import math
import tempfile

import torch

from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.ft import Supervisor
from repro_torch.train.losses import token_accuracy
from repro_torch.train.step import (init_train_state, make_anytime_loss_fn,
                                    make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--joint-steps", type=int, default=120)
    ap.add_argument("--fail-at", type=int, default=60)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--stage-steps", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced("alert-anytime-120m").replace(dtype="float32",
                                                    vocab=32)
    model = build_model(cfg)
    data = SyntheticLM(vocab=32, seq_len=64, global_batch=16, noise=0.05,
                       order=2)
    opt = AdamW(lr=8e-3)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}

    def eval_levels(params):
        b = batch_at(9_999)
        with torch.no_grad():
            return [float(token_accuracy(
                model.train_logits(params, b, level=k)[0], b["labels"]))
                for k in range(1, cfg.nest_levels + 1)]

    def fresh_state():
        return init_train_state(model, cfg, opt, torch.Generator(
            device=device).manual_seed(0), device=device)

    # --- joint training under the fault-tolerant supervisor ---------- #
    print(f"[joint] training on {device} with crash injection at step "
          f"{args.fail_at}...")
    step = make_train_step(model, cfg, opt,
                           loss_fn=make_anytime_loss_fn(model, cfg))
    joint = []
    with tempfile.TemporaryDirectory() as tmp:
        sup = Supervisor(step, batch_at, tmp + "/ckpt",
                         ckpt_every=args.ckpt_every)
        state, end = sup.run(fresh_state(), 0, args.joint_steps,
                             fail_at=args.fail_at,
                             on_metrics=lambda i, m: joint.append(
                                 float(m["loss"])))
    joint_accs = eval_levels(state.params)
    print(f"[joint] finished at step {end} (1 crash, 1 restart; "
          f"{len(joint)} steps run); level accs: "
          + " ".join(f"{a:.3f}" for a in joint_accs))
    if end != args.joint_steps or not all(math.isfinite(x) for x in joint) \
            or not joint[-1] < joint[0]:
        raise AssertionError(f"joint training ended at step {end} with "
                             f"losses {joint[0]} -> {joint[-1]}")

    # --- greedy stage-wise training ---------------------------------- #
    print("[greedy] stage-wise training (train L1, then L2, ...)")
    state = fresh_state()
    stage_losses = []
    for stage in range(1, cfg.nest_levels + 1):
        sstep = make_train_step(model, cfg, opt, loss_fn=make_anytime_loss_fn(
            model, cfg, greedy_stage=stage))
        for i in range(args.stage_steps):
            state, m = sstep(state, batch_at(1000 * stage + i))
        stage_losses.append(float(m["loss"]))
        print(f"  stage {stage}: loss {stage_losses[-1]:.3f}")
    greedy_accs = eval_levels(state.params)
    print("[greedy] level accs: " + " ".join(f"{a:.3f}" for a in greedy_accs))
    if not all(math.isfinite(x) for x in stage_losses):
        raise AssertionError(f"a greedy stage's loss is not finite: "
                             f"{stage_losses}")
    print(f"OK: joint training resumed after the crash to step {end} (loss "
          f"{joint[0]:.3f} -> {joint[-1]:.3f}); {cfg.nest_levels} greedy "
          f"stages trained.")
    return {"device": str(device), "joint_end": end, "joint_losses": joint,
            "joint_accuracies": joint_accs, "stage_losses": stage_losses,
            "greedy_accuracies": greedy_accs}


if __name__ == "__main__":
    main()
