"""The device trace of a steady stretch of whole ticks, reduced.

``torch.profiler`` records the CPU and the card over one warm-up tick and
then ``trace_ticks`` ticks, each inside a ``perfbench.tick`` range.  The
stretch runs from the start of the first recorded tick to the end of the
last.  From the events that ran on the card inside it: the busy seconds
(the union of their intervals), device time by kernel name, and the gaps
in which nothing ran, each put down to the innermost host event that
covers its middle (gaps under 20 us are summed apart: they lie between
the nodes of one graph replay).
"""

from __future__ import annotations

import bisect
import collections

import torch

TICK = "perfbench.tick"
SHORT_NS = 20_000   # shorter gaps lie between the nodes of one replay


def profiler(ticks: int):
    """A profiler that discards its first step and records ``ticks``."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(
        activities=act,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=ticks,
                                         repeat=1))


def _events(prof) -> list:
    """``(name, is device, start ns, end ns)`` of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and (e.name().startswith("perfbench.")
                    or getattr(e, "is_user_annotation", bool)()):
            continue         # a host range drawn on the device's timeline
        if e.name().startswith("ProfilerStep#"):
            continue
        out.append((e.name(), dev, e.start_ns(), e.end_ns()))
    return out


def reduce(prof, ticks: int, gap_names: int = 10) -> dict | None:
    """The stretch of the last ``ticks`` recorded ticks: its ``window_s``,
    ``busy_s``, ``kernels`` (seconds by name) and ``gaps`` (idle seconds by
    host activity, largest first); None where no event ran on the card."""
    events = _events(prof)
    found = sorted((s, e) for n, dev, s, e in events if not dev and n == TICK)
    ticks = found[-ticks:]
    if len(ticks) == 0:
        return None
    lo, hi = ticks[0][0], ticks[-1][1]
    dev = sorted((max(s, lo), min(e, hi), n) for n, d, s, e in events
                 if d and e > lo and s < hi)
    if not dev:
        return None
    kernels: dict = collections.defaultdict(float)
    busy, cur_s, cur_e = 0, None, None
    holes = []
    prev_end = lo
    for s, e, name in dev:
        kernels[name] += (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                holes.append((prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    busy += cur_e - cur_s
    if hi > prev_end:
        holes.append((prev_end, hi))
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and n != TICK and e > lo and s < hi)
    starts = [h[0] for h in host]
    gaps: dict = collections.defaultdict(float)
    for s, e in holes:
        if e - s < SHORT_NS:
            gaps[f"gaps under {SHORT_NS // 1000} us"] += (e - s) / 1e9
            continue
        mid = (s + e) // 2
        k = bisect.bisect_right(starts, mid)
        best = None
        for hs, he, hn in (host[i] for i in range(max(0, k - 400), k)):
            if he >= mid and (best is None or he - hs < best[0]):
                best = (he - hs, hn)
        gaps[best[1] if best else "no host event"] += (e - s) / 1e9
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernels": dict(kernels),
            "gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:gap_names]}


def seconds_of(kernels: dict, key: str) -> float:
    """Device seconds of the kernels whose name contains ``key``."""
    return sum(t for n, t in kernels.items() if key in n)
