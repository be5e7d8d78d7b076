"""Training launcher (port of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --steps 100 --ckpt-dir <dir> [--model-parallel 2] \\
        [--microbatches 2] [--compress] [--anytime] [--resume] \\
        [--fail-at N] [--device cpu]

Without ``--reduced`` the full config trains at its published widths and
depth, in its dtype.  ``--model-parallel`` resolves through
:func:`~repro_torch.launch.mesh.make_host_mesh` over the visible cards (or
the one ``--device`` names), as the reference's does; on a grid of more
than one shard the state is placed by the sharding rules
(:func:`~repro_torch.launch.shardings.param_shardings`) and trains with
:func:`~repro_torch.train.step.make_grid_train_step`.  ``--reduced``
trains the same-family shrunken config in float32.  The loop is
supervised (:class:`~repro_torch.runtime.ft.Supervisor`): atomic
checkpoints every ``--ckpt-every`` steps, deterministic restart-safe
data, optional crash injection, and a straggler monitor on the step
times.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import GridMesh, make_host_mesh
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.ft import Supervisor
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train.step import (init_train_state, make_anytime_loss_fn,
                                    make_grid_train_step, make_train_step)
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` leaves: the final state and step, the loss of
    every step run (a restarted step counts again), the step times (CUDA
    events on the card, the host clock on the CPU) and the monitor."""

    state: object
    start: int
    end: int
    losses: list
    step_ms: list
    monitor: StragglerMonitor
    model: object
    data: SyntheticLM


def batch_fn(data: SyntheticLM, device: torch.device):
    """``batch_at(step)``: the step's tokens and labels on ``device``."""
    def batch_at(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}
    return batch_at


class StepTimer:
    """A train step that times each of its calls: CUDA events around the
    call on the card, read by :meth:`finish` once the run is over (so no
    step waits for the device to be timed), the host clock on the CPU."""

    def __init__(self, step_fn, device: torch.device):
        self.step_fn, self.card = step_fn, device.type == "cuda"
        self._marks: list = []

    def __call__(self, state, batch):
        if not self.card:
            t0 = time.perf_counter()
            out = self.step_fn(state, batch)
            self._marks.append((time.perf_counter() - t0) * 1e3)
            return out
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = self.step_fn(state, batch)
        b.record()
        self._marks.append((a, b))
        return out

    def finish(self) -> list[float]:
        """Each call's time in ms, in call order."""
        if self.card:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self._marks]
        return list(self._marks)


def train(cfg: ModelConfig, *, steps: int, batch: int = 8, seq: int = 64,
          lr: float = 3e-3, anytime: bool = False, microbatches: int = 1,
          compress: bool = False, ckpt_dir: str, ckpt_every: int = 50,
          resume: bool = False, fail_at: int | None = None, device=None,
          mesh: GridMesh | None = None, log_every: int = 10) -> TrainRun:
    """Train ``cfg`` for ``steps`` steps (from step 0, or from the
    checkpoint's step with ``resume``, as the reference's launcher) on
    ``SyntheticLM(cfg.vocab, seq, batch)`` with ``AdamW(cosine_schedule(
    lr, steps // 10, steps))``, the joint anytime loss with uniform
    weights when ``anytime``, from weights drawn from a seed-0 generator
    on ``device`` (or, with ``resume``, the checkpoint under
    ``ckpt_dir``), supervised with a checkpoint every ``ckpt_every``
    steps and a crash injected at ``fail_at``; every ``log_every`` steps
    (0: never) a line on the standard output.  With ``mesh`` the weights
    are drawn on its home device, the state is placed on the grid by
    :func:`~repro_torch.launch.shardings.param_shardings` and each step is
    :func:`~repro_torch.train.step.make_grid_train_step`'s (``device`` is
    then the grid's home)."""
    dev = resolve_device(device) if mesh is None else mesh.home
    model = build_model(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    opt = AdamW(lr=cosine_schedule(lr, warmup=steps // 10, total=steps))
    loss_fn = make_anytime_loss_fn(model, cfg) if anytime else None
    state = init_train_state(model, cfg, opt,
                             torch.Generator(device=dev).manual_seed(0),
                             device=dev, compress=compress)
    if mesh is None:
        step = make_train_step(model, cfg, opt, microbatches=microbatches,
                               compress=compress, loss_fn=loss_fn)
    else:
        state = tree_map(lambda leaf, where: where.place(leaf), state,
                         sh.param_shardings(cfg, mesh, state))
        step = make_grid_train_step(model, cfg, opt, mesh,
                                    microbatches=microbatches,
                                    compress=compress, loss_fn=loss_fn)
    step_fn = StepTimer(step, dev)
    monitor = StragglerMonitor(n_hosts=1)
    losses: list = []
    t_last = [time.perf_counter()]

    def on_metrics(step, metrics):
        now = time.perf_counter()
        monitor.observe([now - t_last[0]])
        t_last[0] = now
        losses.append(float(metrics["loss"]))
        if log_every and step % log_every == 0:
            print(f"  step {step:5d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f}", flush=True)

    sup = Supervisor(step_fn, batch_fn(data, dev), ckpt_dir,
                     ckpt_every=ckpt_every)
    start = 0
    if resume:
        state, start = sup.restore(state)
        print(f"[train] resumed from step {start}", flush=True)
    state, end = sup.run(state, start, steps, fail_at=fail_at,
                         on_metrics=on_metrics)
    return TrainRun(state, start, end, losses, step_fn.finish(), monitor,
                    model, data)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b", choices=configs.ALL_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab (reduced runs)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8+error-feedback gradient compression")
    ap.add_argument("--anytime", action="store_true",
                    help="joint anytime training (needs nest_levels>1)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel degree of the (data, model) grid; "
                    "it shrinks until it divides the device count")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (FT demo)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    # The grid spans every visible card, or the one --device names.
    mesh = make_host_mesh(args.model_parallel, devices=None
                          if args.device is None else [args.device])
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(dtype="float32")
    if args.vocab:
        cfg = cfg.replace(vocab=args.vocab)
    print(f"[train] arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"mesh={dict(zip(mesh.axis_names, mesh.shape))} "
          f"device={mesh.home}")
    run = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, anytime=args.anytime,
                microbatches=args.microbatches, compress=args.compress,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume, fail_at=args.fail_at, device=mesh.home,
                mesh=mesh if mesh.size > 1 else None)
    if run.losses:
        print(f"[train] done at step {run.end}; loss {run.losses[0]:.3f} -> "
              f"{run.losses[-1]:.3f}; checkpoint at {args.ckpt_dir}")
    else:
        print(f"[train] no step ran; the checkpoint is at step {run.end}")
    return run


if __name__ == "__main__":
    main()
