"""The comparison that decides ``correct``.

Each side, the program or the control put in its place, hands in its
answers; one comparison reads them and :func:`judge` holds every number
against the mix's limit:

* served tokens (:func:`token_numbers`): on a sample of the window's
  served inputs drawn from the seed (one of each served level, the input
  with the most served tokens, the rest at random), the reference family
  runs in float32 over each prompt with its served tokens.  A token's gap
  is how far its logit lies below the reference's best at its position;
  ``logit_gap`` is the mean gap over the sample and ``widest_logit_gap``
  the largest.  The control's answers are the tokens that the float8
  version of the reference puts first at the same positions.
* picks and state (:func:`controller_numbers`): the reference controller
  (:mod:`perfbench.reference.alert`, float64) replays every tick from the
  full-clock level latencies that the side's table starts from and the
  latencies observed on the card, fed back at the side's own picks.  At
  every lane and tick ``pick_gap`` takes the widest relative gap of the
  predicted latency, accuracy and energy: the side's of its pick against
  the reference's of that same cell, and the reference's of that cell
  against the reference's of its own pick (so a different pick reads as
  the gap between the two cells); 1 where the served level, the miss or
  the delivered accuracy disagrees with what the reference derives.
  ``state_gap`` is the widest relative gap between the side's filter and
  goal state after its last tick and the reference's, and between the
  side's profile table and the one the reference derives.  The control
  (:func:`control_answers`) is the reference controller in float32,
  picking from its own state and fed back at its own picks.

The latencies observed at each lane and tick are measurements of the
card, which no reference can derive: both sides are judged on the
program's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import traffic
from perfbench.reference import alert
from perfbench.reference.common import exact_matmuls, gaps, group_inputs
from perfbench.reference.common import teacher_forced

TOKEN_BUDGET = 16384      # tokens of one stacked reference batch


def judge(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Every number that ``limits`` names beside its limit, and whether
    all are within them."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def sample(ticks: list, n: int, seed: int) -> list:
    """``(tick, lane)`` of ``n`` served inputs of the window."""
    pool = [(t.index, s.lane, s.level, s.tokens.shape[1])
            for t in ticks if t.in_window for s in t.inputs]
    if not pool:
        return []
    order = np.random.default_rng([seed, 1]).permutation(len(pool))
    longest = max(order, key=lambda k: pool[k][3])
    picked = [longest]
    seen = {pool[longest][2]}
    for k in order:
        if pool[k][2] not in seen:
            picked.append(k)
            seen.add(pool[k][2])
    picked += [k for k in order if k not in picked]
    return [pool[k][:2] for k in picked[:n]]


class _Gaps:
    """Running mean and largest served-token gap of one side."""

    def __init__(self):
        self.total, self.widest, self.tokens = 0.0, 0.0, 0

    def add(self, g: torch.Tensor) -> None:
        self.total += float(g.double().sum())
        self.widest = max(self.widest, float(g.max()))
        self.tokens += g.numel()

    def numbers(self) -> dict:
        return {"logit_gap": self.total / max(self.tokens, 1),
                "widest_logit_gap": self.widest,
                "served_tokens_checked": self.tokens}


def token_numbers(fam, params: dict, cfg: dict, mix: dict, ticks: list,
                  seed: int, control: bool) -> dict:
    """``{"program": numbers}``, and with ``control`` ``"control"`` too:
    the served-token gaps of each side over the same sample."""
    exact_matmuls()
    by = {(t.index, s.lane): s for t in ticks for s in t.inputs}
    picks = sample(ticks, mix["check_inputs"], seed)
    inputs = [(traffic.prompts(mix, seed, tick, cfg["vocab"])[lane],
               by[tick, lane].tokens, by[tick, lane].level)
              for tick, lane in picks]
    dev = params["embed"].device
    sides = {"program": _Gaps()}
    if control:
        sides["control"] = _Gaps()
    with torch.inference_mode():
        for (level, s0, n), idx in group_inputs(inputs).items():
            b = inputs[idx[0]][0].shape[0]
            per = max(1, TOKEN_BUDGET // (b * (s0 + n - 1)))
            for c in range(0, len(idx), per):
                chunk = [inputs[k] for k in idx[c:c + per]]
                toks = torch.as_tensor(np.stack(
                    [teacher_forced(p, t) for p, t, _ in chunk]),
                    dtype=torch.long, device=dev)
                ref, ctl = fam.logits(params, cfg, toks, level, s0, control)
                answers = {"program": torch.as_tensor(
                    np.stack([t for _, t, _ in chunk]), dtype=torch.long,
                    device=dev)}
                if control:
                    answers["control"] = ctl.argmax(dim=-1)
                for side, chosen in answers.items():
                    sides[side].add(gaps(ref, chosen))
    return {side: g.numbers() for side, g in sides.items()}


@dataclasses.dataclass
class Pick:
    """What a controller side answered at one tick: its decision (every
    lane's pick and its predicted latency, accuracy and energy) and, for
    every lane, the level served, the miss and the accuracy delivered."""

    model_index: np.ndarray
    power_index: np.ndarray
    predicted: tuple
    levels: list
    missed: list
    accuracy: list


def program_answers(ticks: list, streams: int) -> list:
    """The program's :class:`Pick` of every full tick, in order."""
    out = []
    for t in ticks:
        if t.decision is None or len(t.inputs) != streams:
            break
        d = t.decision
        out.append(Pick(np.asarray(d.model_index, np.int64),
                        np.asarray(d.power_index, np.int64),
                        (d.predicted_latency, d.predicted_accuracy,
                         d.predicted_energy),
                        [s.level for s in t.inputs],
                        [s.missed for s in t.inputs],
                        [s.accuracy for s in t.inputs]))
    return out


def _observed(ticks: list, n: int) -> list:
    """``(latency, tokens served)`` of every lane of the first ``n``
    ticks: the card's measurements."""
    return [(np.array([s.latency for s in t.inputs]),
             np.array([s.tokens.shape[1] for s in t.inputs]))
            for t in ticks[:n]]


def _tenants(mix: dict):
    people = traffic.tenants(mix)
    return (np.array([p[1] for p in people]),
            np.array([p[2] or 0.0 for p in people]),
            np.array([p[3] or 0.0 for p in people]),
            np.array([p[0] for p in people]))


def _outcome(cfg, mix, lat, ntok, deadline, i):
    missed = (lat > deadline) | (ntok < mix["gen_tokens"])
    delivered = np.where(missed, cfg["q_fail"],
                         np.asarray(cfg["level_accuracies"])[i])
    return missed, delivered


def _fleet(cfg, mix, base, buckets, dtype):
    return alert.FleetReference(base, cfg["level_accuracies"], cfg["q_fail"],
                                buckets, mix["min_clock_fraction"],
                                mix["streams"], mix["window"], dtype)


def control_answers(cfg: dict, mix: dict, ticks: list, table: dict,
                    levels: list) -> tuple[list, dict, dict]:
    """The control in the controller's place: the reference controller in
    float32, from the measured full-clock latencies of the program's
    table, picking from its own state and fed back at its own picks with
    the latencies observed at each lane.  Its picks, final state and
    table, as the program's are handed to :func:`controller_numbers`."""
    deadline, acc_goal, en_goal, codes = _tenants(mix)
    lat_tab = np.asarray(table["latency"])
    ctl = _fleet(cfg, mix, lat_tab[:, -1].astype(np.float32),
                 lat_tab.shape[1], np.float32)
    picks = []
    n = len(program_answers(ticks, mix["streams"]))
    for lat, ntok in _observed(ticks, n):
        i, j, *pred = ctl.select(deadline, acc_goal, en_goal, codes)
        missed, delivered = _outcome(cfg, mix, lat, ntok, deadline, i)
        picks.append(Pick(i, j, tuple(pred), [levels[k] for k in i],
                          list(missed), list(delivered)))
        ctl.observe(i, j, np.minimum(lat, deadline), missed, delivered,
                    ctl.run_power[i, j])
    table_c = {"latency": ctl.latency, "run_power": ctl.run_power,
               "caps": ctl.caps.astype(np.float32)}
    return picks, ctl.state(), table_c


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    den = np.maximum(np.abs(b), 1e-300)
    return float(np.max(np.abs(a - b) / den))


def controller_numbers(cfg: dict, mix: dict, ticks: list, picks: list,
                       table: dict, state: dict, levels: list) -> dict:
    """``pick_gap`` and ``state_gap`` of one side's ``picks``, final
    ``state`` and ``table``, against the float64 reference replayed at
    those picks over the observed latencies of ``ticks``."""
    deadline, acc_goal, en_goal, codes = _tenants(mix)
    lat_tab = np.asarray(table["latency"], np.float64)
    base, n_b = lat_tab[:, -1], lat_tab.shape[1]
    ref = _fleet(cfg, mix, base, n_b, np.float64)
    pick = 0.0
    for p, (lat, ntok) in zip(picks, _observed(ticks, len(picks))):
        r = ref.select(deadline, acc_goal, en_goal, codes)[2:]
        missed, delivered = _outcome(cfg, mix, lat, ntok, deadline,
                                     p.model_index)
        agree = all(lv == levels[i] and m == mm and a == aa for
                    lv, i, m, mm, a, aa in
                    zip(p.levels, p.model_index, p.missed, missed,
                        p.accuracy, delivered))
        at = ref.at(p.model_index, p.power_index)
        g = max(_rel(a, b) for a, b in zip(p.predicted + at, at + r))
        pick = max(pick, g if agree else 1.0)
        ref.observe(p.model_index, p.power_index, np.minimum(lat, deadline),
                    missed, delivered,
                    ref.run_power[p.model_index, p.power_index])
    want = ref.state()
    caps, lat_t, pw = alert.derive_table(base, n_b,
                                         mix["min_clock_fraction"])
    table_gap = max(_rel(table["latency"], lat_t),
                    _rel(table["run_power"], pw), _rel(table["caps"], caps))
    return {"pick_gap": pick,
            "state_gap": max([table_gap] + [_rel(state[k], want[k])
                                            for k in want])}
