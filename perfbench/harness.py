"""One run of one cell: set-up, the measured window, the optional traced
stretch, the check, and the result's metrics.

Everything a cell needs is found by name under ``<root>/perfbench``:
``BENCHMARK.json`` names the cell's configuration file and traffic mix
(``workloads/<traffic>.json``); the configuration names its reference
family (``reference/<family>.py``); each metric is read by
``metrics/<metric>.py`` (``read(run) -> float | None``); each kernel's
work formula is ``roofline/<kernel>.py``, which also names the program's
launch counter of that kernel (``COUNTER``).

The system under test is ``repro_torch``'s fleet server:
``FleetAlertServer.serve_tick`` over a ``ServeEngine`` that replays one
CUDA graph per (level, prompt length) for prefill and one per level for
decode.  Ticks run back to back for ``seconds``; each serves one input on
every live stream.  The harness wraps the engine's ``generate`` and the
scoring engine's ``select`` to record what they return, and nothing else.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from perfbench import check, traffic, weights
from perfbench import trace as tracing
from perfbench.roofline import bound_s, peaks

REPO = Path(__file__).resolve().parent.parent


def say(msg: str) -> None:
    """A line on standard error."""
    print(msg, file=sys.stderr, flush=True)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = REPO):
        self.root = Path(root)
        self.home = self.root / "perfbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        """The ``workloads`` entry ``name``."""
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration file of ``configs`` entry ``name``."""
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic_name: str) -> dict:
        """The traffic mix ``workloads/<traffic_name>.json``."""
        return json.loads((self.home / "workloads"
                           / f"{traffic_name}.json").read_text())

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` under the benchmark, loaded."""
        path = self.home / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name}".replace("-", "_").replace(".", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def rooflines(self) -> dict:
        """Every ``roofline/<kernel>.py``, loaded, by kernel name."""
        return {p.stem: self.module("roofline", p.stem)
                for p in sorted((self.home / "roofline").glob("*.py"))
                if p.stem != "__init__"}

    def metrics(self, cell: str, kind: str) -> list:
        """The ``kind`` (``end_to_end`` / ``per_layer``) metrics this cell
        reports."""
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Served:
    """One served input: the lane, level, tokens and the server's
    ``ServedInput`` fields the metrics and the check read."""

    lane: int
    level: int
    tokens: np.ndarray
    latency: float
    missed: bool
    accuracy: float


@dataclasses.dataclass
class Tick:
    """One ``serve_tick``: its host-clock span and what it served."""

    index: int
    start: float
    end: float
    in_window: bool
    inputs: list
    decision: object = None
    launches: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cfg: dict
    mix: dict
    family: object
    ticks: list
    window_s: float
    setup_s: float
    energy_j: float | None
    peak: dict | None
    trace: dict | None = None
    rooflines: dict = dataclasses.field(default_factory=dict)

    @property
    def window_ticks(self) -> list:
        """The ticks of the measured window."""
        return [t for t in self.ticks if t.in_window]

    @property
    def inputs(self) -> list:
        """Every input served in the measured window."""
        return [s for t in self.window_ticks for s in t.inputs]

    def forwards(self, s: Served) -> list:
        """``(new tokens, cached tokens)`` of each forward ``s`` ran."""
        s0 = self.mix["prompt_len"]
        return [(s0, 0)] + [(1, s0 + t) for t in range(s.tokens.shape[1] - 1)]


class Recorder:
    """Wraps the engine's ``generate`` and the scoring engine's ``select``
    to keep what they return, each call inside a profiler range."""

    def __init__(self, srv, torch):
        self.calls: list = []
        self.decision = None
        gen, sel = srv.engine.generate, srv.scoring.select
        rf = torch.profiler.record_function

        def generate(params, prompt, n_new, level=None, deadline_s=None,
                     clock=None):
            with rf("perfbench.generate"):
                r = gen(params, prompt, n_new, level=level,
                        deadline_s=deadline_s, clock=clock)
            self.calls.append(r["tokens"])
            return r

        def select(*args, **kwargs):
            with rf("perfbench.select"):
                self.decision = sel(*args, **kwargs)
            return self.decision

        srv.engine.generate = generate
        srv.scoring.select = select


def _launches(rooflines: dict) -> dict:
    """Each kernel's launch count so far: ``COUNTER`` of its roofline file
    is ``"<module>:<function>"``, whose ``launches`` the program counts."""
    out = {}
    for kernel, mod in rooflines.items():
        module, func = mod.COUNTER.split(":")
        if module in sys.modules:
            out[kernel] = getattr(sys.modules[module], func).launches
    return out


def _tick(srv, rec, mix, seed, index, in_window, vocab, rooflines,
          torch) -> Tick:
    prompts = traffic.prompts(mix, seed, index, vocab)
    rec.calls, rec.decision = [], None
    before = _launches(rooflines)
    t1 = time.perf_counter()
    with torch.profiler.record_function(tracing.TICK):
        outs = srv.serve_tick(list(prompts))
    t2 = time.perf_counter()
    after = _launches(rooflines)
    live = [s for s, o in enumerate(outs) if o is not None]
    if len(rec.calls) != len(live):
        raise RuntimeError(f"tick {index}: {len(live)} live lanes, "
                           f"{len(rec.calls)} generations")
    inputs = [Served(s, outs[s].level, toks, outs[s].latency,
                     outs[s].missed, outs[s].accuracy)
              for s, toks in zip(live, rec.calls)]
    return Tick(index, t1, t2, in_window, inputs, rec.decision,
                {k: after[k] - before[k] for k in after})


def _controller_state(srv, streams: int) -> tuple[dict, dict]:
    """The server's filter and goal state and its profile table, on the
    host, under the reference's names."""
    gb = srv._goal_bank.export_lanes(np.arange(streams))
    state = {"mu": srv.slowdown.mu, "sigma": srv.slowdown.sigma,
             "gain": srv.slowdown.gain,
             "process_noise": srv.slowdown.process_noise,
             "phi": srv.idle_power.phi, "variance": srv.idle_power.variance}
    state = {k: v.cpu().numpy() for k, v in state.items()}
    state.update(goal_buf=gb["buf"], goal_count=gb["count"],
                 goal_pos=gb["pos"])
    table = {"latency": srv.table.latency, "run_power": srv.table.run_power,
             "caps": srv.table.power_caps}
    return state, table


def roofline_share(run: Run, kernel: str) -> float | None:
    """Bound over device time of ``kernel`` in the traced stretch, in %;
    None where it did not run there or the launches counted differ from
    the calls the family's formulas expect."""
    tr = run.trace
    if not tr or run.peak is None:
        return None
    mod = run.rooflines[kernel]
    secs = tracing.seconds_of(tr["kernels"], mod.KERNEL)
    calls = []
    for t in tr["ticks"]:
        for s in t.inputs:
            lvl = s.level or run.cfg.get("nest_levels", 1)
            for new, ctx in run.forwards(s):
                calls += [c for k, c in run.family.kernel_calls(
                    run.cfg, lvl, run.mix["batch"], new, ctx) if k == kernel]
    counted = sum(t.launches.get(kernel, 0) for t in tr["ticks"])
    if not calls or secs <= 0:
        return None
    if counted != len(calls):
        say(f"{kernel}: {counted} launches counted, {len(calls)} expected: "
            f"no roofline")
        return None
    bound = sum(bound_s(*mod.work(c), run.peak) for c in calls)
    return 100.0 * bound / secs


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path = REPO, device: str = "cuda", t_start: float,
             control: bool = False, hook=None) -> dict:
    """One run of cell ``name`` on ``device``: the result line's dict,
    with the numbers compared beside their limits under ``checks``.  With
    ``control``, the control put in the program's place is judged by the
    same comparison and reported under ``control``.  ``hook(srv)``, where
    given, runs on the server before the harness wraps it (the tests
    break the timed path with it)."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.controller import Constraints, Goal
    from repro_torch.core.power import PowerModel
    from repro_torch.models.registry import build_model
    from repro_torch.serving.alert_server import FleetAlertServer
    from repro_torch.serving.engine import ServeEngine

    seed = int(seed) % 2 ** 63
    bench = Bench(root)
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    fam = bench.module("reference", cfg["reference"])
    rooflines = bench.rooflines()
    dev = torch.device(device)
    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [("imports", time.perf_counter())]
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in cfg.items() if k in fields})
    params = weights.make_params(fam.param_specs(cfg), seed, dev,
                                 getattr(torch, cfg["dtype"]))
    marks.append(("weights", time.perf_counter()))
    b, s0, n = mix["batch"], mix["prompt_len"], mix["gen_tokens"]
    engine = ServeEngine(build_model(mc), max_len=s0 + n, batch_size=b,
                         device=dev)
    srv = FleetAlertServer(engine, params,
                           level_accuracies=cfg["level_accuracies"],
                           goal=Goal.MINIMIZE_ENERGY,
                           n_streams=mix["streams"],
                           power_model=PowerModel(
                               min_fraction=mix["min_clock_fraction"]),
                           n_power_buckets=mix["power_buckets"],
                           q_fail=cfg["q_fail"], prompt_len=s0, gen_tokens=n,
                           accuracy_window=mix["window"], start_active=False)
    marks.append(("kernel builds, server profile and graphs",
                  time.perf_counter()))
    profiled = [float(x) * 1e3 for x in srv.table.latency[:, -1]]
    say(f"profiled full-clock latency of each level (ms): {profiled}")
    if "level_latency_ms" not in mix:
        say("the mix has no level_latency_ms: calibration run, no result")
        return None
    goals = {0: Goal.MINIMIZE_ENERGY, 1: Goal.MAXIMIZE_ACCURACY}
    for code, dl, ag, eg in traffic.tenants(mix):
        srv.admit(goals[code], Constraints(deadline=dl, accuracy_goal=ag,
                                           energy_goal=eg))
    if hook is not None:
        hook(srv)
    rec = Recorder(srv, torch)
    ticks, failed, attempted = [], 0, 0

    def serve(index, in_window):
        return _tick(srv, rec, mix, seed, index, in_window, cfg["vocab"],
                     rooflines, torch)

    for i in range(mix["warmup_ticks"]):
        ticks.append(serve(i, False))
    meter = None
    if card:
        from perfbench.energy import Nvml
        uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
        meter = Nvml(f"GPU-{uuid}" if uuid is not None else None)
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up ticks", t_start + setup_s))
    say("set-up (s): " + ", ".join(
        f"{k} {t - prev:.3f}" for (k, t), prev in
        zip(marks, [t_start] + [t for _, t in marks])))
    if meter is not None:
        meter.start()
    t0 = time.perf_counter()
    index = len(ticks)
    while time.perf_counter() - t0 < seconds:
        attempted += mix["streams"]
        try:
            ticks.append(serve(index, True))
        except Exception:        # the run goes on to report the failure
            say(traceback.format_exc())
            failed += mix["streams"]
            break
        index += 1
    window_s = (ticks[-1].end if ticks[-1].in_window else
                time.perf_counter()) - t0
    energy_j = meter.stop() if meter is not None else None
    traced = None
    if trace and not failed:
        with tracing.profiler(mix["trace_ticks"]) as prof:
            for _ in range(1 + mix["trace_ticks"]):
                ticks.append(serve(index, False))
                index += 1
                prof.step()
        traced = tracing.reduce(prof, mix["trace_ticks"])
        if traced is not None:
            traced["ticks"] = ticks[-mix["trace_ticks"]:]
    device_info = {"platform": "gpu" if card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if card
                   else dev.type, "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                       dev)) if card else 0}
    if meter is not None:
        device_info["power_limit_w"] = meter.power_limit_w()
        device_info["energy_source"] = meter.source
        meter.close()
    if traced is not None:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
    # The program's state to the host; then free it before the check.
    state, table = _controller_state(srv, mix["streams"])
    levels = [lvl or 0 for lvl in engine.levels]
    del srv, engine, rec
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    limits = dict(failed=0, **mix["limits"])
    tokens = check.token_numbers(fam, params, cfg, mix, ticks, seed,
                                 control)
    picks = check.program_answers(ticks, mix["streams"])
    numbers = dict(tokens["program"], failed=failed, **check.
                   controller_numbers(cfg, mix, ticks, picks, table, state,
                                      levels))
    checks, correct = check.judge(numbers, limits)
    say(f"check: {numbers['served_tokens_checked']} served tokens and "
        f"{len(picks)} ticks in {time.perf_counter() - t_check:.3f} s; "
        f"mean and widest logit gap {numbers['logit_gap']!r}, "
        f"{numbers['widest_logit_gap']!r}")

    run = Run(cfg, mix, fam, ticks, window_s, setup_s, energy_j,
              peaks(device_info["kind"]) if card else None, traced,
              rooflines)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(name, kind):
        value = bench.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct,
              "attempted": attempted,
              "failed": failed,
              "metrics": metrics,
              "device": device_info}
    if traced is not None:
        result["breakdown"] = {
            "device_ops": sorted(([k[:120], v] for k, v in
                                  traced["kernels"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[k[:120], v] for k, v in traced["gaps"]]}
    if control:
        c_picks, c_state, c_table = check.control_answers(
            cfg, mix, ticks, table, levels)
        c_numbers = dict(tokens["control"], failed=0, **check.
                         controller_numbers(cfg, mix, ticks, c_picks,
                                            c_table, c_state, levels))
        c_checks, c_correct = check.judge(c_numbers, limits)
        result["control"] = {"correct": c_correct, "checks": c_checks,
                             "numbers": c_numbers}
        result["numbers"] = numbers
    result["checks"] = checks
    return result
