"""Fault-tolerant training: the supervisor's checkpoint/restart loop and
failure injection (port of ``repro.runtime.ft``).

The loop's contract:

* the data pipeline is a pure function of the step
  (:mod:`repro_torch.data.synthetic`), so no state but the train state is
  needed to resume;
* checkpoints are atomic (:mod:`repro_torch.checkpoint.io`) and carry the
  step, so a restart resumes bit-exactly;
* a crash before the first checkpoint restarts from a copy of the state
  :meth:`Supervisor.run` entered with.

The session gateway raises :class:`InjectedFailure` too, at a chosen
round, to exercise its checkpointed resume.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.launch.mesh import GridShards
from repro_torch.tree import tree_map


class InjectedFailure(RuntimeError):
    """Raised to simulate a crash mid-run (a kill the run resumes from)."""


def _copy(leaf):
    if isinstance(leaf, GridShards):
        return leaf.clone()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.array(leaf, copy=True)


@dataclasses.dataclass
class Supervisor:
    """Drives ``train_step`` with a checkpoint every ``ckpt_every`` steps
    and restarts from the latest one on an :class:`InjectedFailure`, at
    most ``max_restarts`` times."""

    train_step: Callable          # (state, batch) -> (state, metrics)
    batch_at: Callable            # (step) -> batch
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3

    def run(self, state, start_step: int, n_steps: int,
            fail_at: int | None = None, on_metrics=None):
        """Run to ``start_step + n_steps``; raise an
        :class:`InjectedFailure` once at global step ``fail_at`` (before
        that step's checkpoint) to exercise the restart.  Returns
        ``(state, step)`` after a final checkpoint."""
        step = start_step
        # A copy of the entry state (clones, not references a later
        # update could overwrite): a crash before the first checkpoint
        # restarts from here, not from the in-flight state.
        self._initial = (tree_map(_copy, state), start_step)
        failed_once = False
        restarts = 0
        while step < start_step + n_steps:
            try:
                if fail_at is not None and step == fail_at \
                        and not failed_once:
                    failed_once = True
                    raise InjectedFailure(f"simulated crash at step {step}")
                batch = self.batch_at(step)
                state, metrics = self.train_step(state, batch)
                if on_metrics is not None:
                    on_metrics(step, metrics)
                step += 1
                if step % self.ckpt_every == 0:
                    ckpt_io.save(self.ckpt_dir, state, step=step)
            except InjectedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                state, step = self.restore(state)
        ckpt_io.save(self.ckpt_dir, state, step=step)
        return state, step

    def restore(self, like_state):
        """``(state, step)`` of the latest checkpoint (``<dir>`` or its
        ``.old`` torn-write fallback), restored into ``like_state``'s
        structure, dtypes and devices (a grid-sharded leaf placed as it
        is); with no checkpoint yet, a copy of
        the state and step :meth:`run` entered with."""
        if not os.path.exists(self.ckpt_dir) and \
                not os.path.exists(self.ckpt_dir + ".old"):
            initial = getattr(self, "_initial", None)
            if initial is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self.ckpt_dir!r} and no "
                    f"recorded initial state to restart from")
            return tree_map(_copy, initial[0]), initial[1]
        return ckpt_io.restore(self.ckpt_dir, like_state)
