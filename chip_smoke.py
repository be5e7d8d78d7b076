#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any mismatch exits nonzero):

1. device: the card's name and power limit (``nvidia-smi``); no CUDA
   device -> exit 1 before anything else.
2. build: compile every kernel of the served path (``nvcc``, one process
   per source, started together) and print the build time.
3. kernel vs plain: ``alert_select`` on the card against its plain
   PyTorch version on the same inputs, at S in {1, 4097, 65536} lanes of a
   seeded K=12 x L=8 table (mixed goals, dead lanes holding garbage, both
   energy modes, predictions on and off).  Picks, feasibility and relax
   codes must be equal; predictions equal bitwise (or within rtol 1e-12,
   with the reason printed).  Times the kernel and the plain version at
   S=65536 with CUDA events and prints the bound.
4. serve: ``alert-anytime-120m`` at full width in bf16 with weights from a
   seed-0 ``torch.Generator`` on the card, behind a ``FleetAlertServer``
   (8 streams, batch 4, prompt 8, 4 new tokens) profiled on the card, for
   4 ticks of Eq. 4 and Eq. 5 tenants with one retire/admit.  Checks
   every live lane's result, the tokens, and that the kernel's launch
   counter grew by one per tick; then holds the kernel to its plain
   version on the server's own lane state.  Before that, the port's model
   on the card is held to the same model on the CPU at a reduced size.
5. the last lines: one JSON object per kernel, the ``nvidia-smi`` line,
   and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: FP64 (non-tensor-core) 34 TFLOP/s, HBM3
# 3.35 TB/s, both at the full 700 W power limit.  The kernel issues plain
# FP64 instructions, not the FP64 tensor-core DMMA path.
H100_FP64_FLOPS = 34e12
H100_HBM_BYTES_S = 3.35e12

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/alert_select.cu"
KERNEL_REPLACES = "src/repro/kernels/alert_select.py:164"
PRED_RTOL = 1e-12
LEVEL_ACCURACIES = [0.62, 0.71, 0.78, 0.83]
N_TICKS = 4


class SmokeFailure(RuntimeError):
    """A phase found a mismatch."""


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int, rounds: int = 5, warmup: int = 3) -> float:
    """Per-call time on the card: CUDA events around ``launches``
    back-to-back calls, divided by the count; the median of ``rounds``
    such runs.  Where a call's host work outlasts its device work the card
    waits between calls and this measures the host side.  The inputs stay
    in L2 (S=65536 lanes of 96 B are 6.3 MB)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def host_ms(fn, reps: int = 20) -> float:
    """Median host wall time of ``fn`` (which must end in a host copy)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# --------------------------------------------------------------------- #
# phase 3: kernel vs plain                                               #
# --------------------------------------------------------------------- #
def fleet_inputs(table, s: int, seed: int, device):
    """Seeded mixed-goal lane state as the engine hands it to the kernel:
    ``[S]`` f64 vectors (sigma floored), int32 goal codes and lane mask,
    10% dead lanes holding NaN/inf/huge garbage."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    med_lat = float(np.median(table.latency))
    med_en = float(np.median(table.run_power)) * med_lat
    vals = [rng.uniform(0.5, 3.0, s), rng.uniform(0.01, 0.5, s),
            rng.uniform(0.05, 0.8, s), rng.uniform(0.1, 3.0, s) * med_lat,
            rng.uniform(0.2, 1.1, s), rng.uniform(0.0, 2.5, s) * med_en]
    goal_kind = rng.integers(0, 2, s)
    active = rng.random(s) >= 0.1
    garbage = rng.choice([np.nan, np.inf, -np.inf, 1e300], size=s)
    for v in vals:
        v[~active] = garbage[~active]
    f64 = [torch.as_tensor(v, dtype=torch.float64, device=device)
           for v in vals]
    f64[1] = torch.clamp_min(f64[1], 1e-6)
    ints = [torch.as_tensor(x.astype(np.int32), device=device)
            for x in (goal_kind, active)]
    return f64 + ints


def compare(got, want, what: str) -> float:
    """Picks/feasibility/relax exact, predictions bitwise or within
    rtol 1e-12; returns the largest absolute prediction difference."""
    import torch

    names = ("model_index", "power_index", "predicted_latency",
             "predicted_accuracy", "predicted_energy", "feasible",
             "relaxed_code")
    for n in (0, 1, 5, 6):
        if not torch.equal(got[n], want[n]):
            bad = int((got[n] != want[n]).sum())
            raise SmokeFailure(f"{what}: {names[n]} differs on {bad} lanes")
    err = 0.0
    for n in (2, 3, 4):
        g, w = got[n], want[n]
        if torch.equal(g, w):
            continue
        both_nan = torch.isnan(g) & torch.isnan(w)
        d = torch.where(both_nan, 0.0, (g - w).abs())
        rel = torch.where(both_nan, 0.0, d / w.abs().clamp_min(1e-300))
        if float(rel.max()) > PRED_RTOL:
            raise SmokeFailure(f"{what}: {names[n]} off by rel "
                               f"{float(rel.max()):.3e}")
        err = max(err, float(d.max()))
        say(f"  {what}: {names[n]} not bitwise, within rtol 1e-12 "
            f"(max abs {float(d.max()):.3e}): the two paths rounded "
            f"differently in the last place")
    return err


def kernel_vs_plain(device, sizes=(1, 4097, 65536), time_s=65536):
    """Phase 3; returns (max_abs_err, timing dict at ``time_s``)."""
    import torch

    from repro_torch.core.batched import BatchedAlertEngine
    from repro_torch.core.profiles import synthetic_table
    from repro_torch.kernels import alert_select as ks

    table = synthetic_table(0)
    k, l = table.latency.shape
    overhead = 0.05 * float(table.latency.min())
    eng = BatchedAlertEngine(table, None, overhead=overhead, device=device)
    consts = dict(latency=eng._latency, run_power=eng._run_power,
                  weights=eng._weights, q_fail=eng._q_fail,
                  overhead=overhead)
    err = 0.0
    timing = {}
    for s in sizes:
        args = fleet_inputs(table, s, seed=s, device=device)
        for paper in (True, False):
            for pred in (True, False):
                kw = dict(consts, paper_faithful_energy=paper,
                          predictions=pred)
                got = ks.alert_select(*args, **kw)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                want = ks.alert_select_plain(*args, **kw)
                what = f"S={s} paper_faithful={paper} predictions={pred}"
                err = max(err, compare(got, want, what))
                say(f"  ok {what}")
        if s == time_s:
            kw = dict(consts, paper_faithful_energy=True, predictions=True)
            timing = time_select(ks, args, kw, s, k, l, device)
    return err, timing


def time_select(ks, args, kw, s, k, l, device) -> dict:
    """Kernel and plain-version medians (CUDA events) and the bound."""
    if device.type != "cuda":
        return {}
    ms = cuda_ms(lambda: ks.alert_select(*args, **kw), launches=100)
    plain_ms = cuda_ms(lambda: ks.alert_select_plain(*args, **kw),
                       launches=10, rounds=3)
    cost = ks.alert_select_cost(s, k, l, predictions=kw["predictions"])
    t_ops = cost["flops"] / H100_FP64_FLOPS * 1e3
    t_bytes = cost["bytes_accessed"] / H100_HBM_BYTES_S * 1e3
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=cost["flops"], bytes=cost["bytes_accessed"],
               erf=cost["transcendentals"], shape=f"S={s},K={k},L={l}")
    say(f"  time S={s} K={k} L={l}: kernel {ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, bound {out['bound_ms']:.6f} ms by "
        f"{out['bound_by']} ({cost['flops']:.4g} FP64 ops at 34 TFLOP/s = "
        f"{t_ops:.6f} ms; {cost['bytes_accessed']:.4g} B at 3.35 TB/s = "
        f"{t_bytes:.6f} ms; the {cost['transcendentals']:.4g} erf calls "
        f"are counted as 0 FP64 ops, so the bound is low)")
    return out


# --------------------------------------------------------------------- #
# phase 4: serve                                                         #
# --------------------------------------------------------------------- #
def model_cpu_vs_card(device) -> float:
    """The reduced float32 model with the same weights on the CPU and on
    the card: per-level prefill logits, and one KV-cached decode step
    against the full forward, within 1e-4 (float32, TF32 off; the card
    sums in another order)."""
    import numpy as np
    import torch

    from repro_torch.configs.alert_anytime import reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.models.registry import build_model

    cfg = reduced().replace(dtype="float32")
    cpu = torch.device("cpu")
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), device=cpu)
    on_card = {k: v.to(device) for k, v in params.items() if k != "layers"}
    on_card["layers"] = [{p: {n: w.to(device) for n, w in part.items()}
                          for p, part in layer.items()}
                         for layer in params["layers"]]
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    worst = 0.0
    with torch.inference_mode():
        for level in range(1, cfg.nest_levels + 1):
            a = tfm.lm_apply(params, cfg, torch.as_tensor(toks[:, :8]),
                             level=level).logits
            b = tfm.lm_apply(on_card, cfg,
                             torch.as_tensor(toks[:, :8], device=device),
                             level=level).logits.cpu()
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                raise SmokeFailure(f"level {level}: card logits differ from "
                                   f"CPU by {float((a - b).abs().max())}")
            eng = ServeEngine(build_model(cfg), max_len=12, batch_size=2,
                              device=device)
            t = torch.as_tensor(toks, device=device)
            full = tfm.lm_apply(on_card, cfg, t, level=level).logits[:, 8]
            pre = tfm.lm_apply(on_card, cfg, t[:, :8], level=level)
            caches = eng._merge(eng.init_caches(level), pre.caches)
            step = tfm.lm_apply(on_card, cfg, t[:, 8:9], mode="decode",
                                caches=caches, cache_len=8,
                                level=level).logits[:, 0]
            if not torch.allclose(step, full, rtol=1e-4, atol=1e-4):
                raise SmokeFailure(f"level {level}: decode step differs from "
                                   f"the full forward")
    say(f"  reduced model, card vs CPU and decode vs forward: ok "
        f"(max abs logit diff {worst:.3e})")
    return worst


def tenants(table):
    """Eight tenants, Eq. 4 and Eq. 5 mixed, with deadlines and goals
    placed against the profiled latencies so picks vary."""
    from repro_torch.core.controller import Constraints, Goal

    lat = table.latency[:, -1]
    base = [lat[min(i, len(lat) - 1)] for i in range(4)]
    top_w = float(table.run_power[0, -1])
    mk_e = lambda dl, acc: (Goal.MINIMIZE_ENERGY,
                            Constraints(deadline=dl, accuracy_goal=acc))
    mk_a = lambda dl, frac: (Goal.MAXIMIZE_ACCURACY,
                             Constraints(deadline=dl,
                                         energy_goal=frac * top_w * dl))
    return [mk_e(3.0 * base[3], 0.8), mk_e(1.5 * base[1], 0.7),
            mk_a(3.0 * base[3], 0.9), mk_a(2.0 * base[2], 0.5),
            mk_e(1.2 * base[0], 0.6), mk_a(1.5 * base[1], 0.8),
            mk_e(2.0 * base[2], 0.75), mk_a(0.8 * base[0], 0.9)]


def serve(device, cfg, n_streams=8, batch_size=4, prompt_len=8,
          gen_tokens=4, expect_kernel=True) -> dict:
    """Phase 4: the fleet server over ``cfg`` on ``device``."""
    import numpy as np
    import torch

    from repro_torch.core.controller import Goal
    from repro_torch.kernels import alert_select as ks
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.alert_server import FleetAlertServer
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_lm(cfg, gen, device=device)
    n_params = sum(p.numel() for p in [params["embed"], params["unembed"],
                                       params["final_norm"]]
                   + [w for layer in params["layers"]
                      for part in layer.values() for w in part.values()])
    say(f"  model {cfg.name}: {n_params} parameters, {cfg.dtype}, "
        f"{cfg.n_layers} layers, d={cfg.d_model}, init "
        f"{time.perf_counter() - t0:.3f} s")
    engine = ServeEngine(build_model(cfg), max_len=prompt_len + gen_tokens,
                         batch_size=batch_size, device=device)

    ks.alert_select.launches = 0           # main path starts here
    t0 = time.perf_counter()
    srv = FleetAlertServer(engine, params,
                           level_accuracies=LEVEL_ACCURACIES[
                               :cfg.nest_levels],
                           goal=Goal.MINIMIZE_ENERGY, n_streams=n_streams,
                           prompt_len=prompt_len, gen_tokens=gen_tokens,
                           start_active=False)
    say(f"  profiled on {device.type} in {time.perf_counter() - t0:.3f} s; "
        f"per-level latency at full power (s): "
        + ", ".join(f"L{i + 1}={x:.6f}"
                    for i, x in enumerate(srv.table.latency[:, -1])))
    people = tenants(srv.table)
    for goal, cons in people:
        srv.admit(goal, cons)

    tokens_seen = []
    plain_generate = engine.generate

    def recording_generate(*args, **kwargs):
        r = plain_generate(*args, **kwargs)
        tokens_seen.append(r["tokens"])
        return r

    engine.generate = recording_generate
    rng = np.random.default_rng(0)
    counts = []
    for tick in range(N_TICKS):
        if tick == 2:
            srv.retire(5)
            lane = srv.admit(*people[2])
            say(f"  tick {tick}: retired lane 5, admitted lane {lane}")
        prompts = [rng.integers(0, cfg.vocab, (batch_size, prompt_len))
                   .astype(np.int32) for _ in range(srv.n_streams)]
        n_tok = len(tokens_seen)
        t1 = time.perf_counter()
        outs = srv.serve_tick(prompts)
        dt = time.perf_counter() - t1
        counts.append(ks.alert_select.launches)
        live = np.nonzero(srv.active)[0]
        for s in live:
            o = outs[s]
            if o is None:
                raise SmokeFailure(f"tick {tick}: live lane {s} not served")
            nums = (o.power_cap, o.latency, o.accuracy, o.energy)
            if not all(math.isfinite(x) for x in nums) or o.latency <= 0:
                raise SmokeFailure(f"tick {tick}: lane {s} bad result {o}")
        for toks in tokens_seen[n_tok:]:
            if toks.shape[0] != batch_size or not 1 <= toks.shape[1] <= \
                    gen_tokens or toks.min() < 0 or toks.max() >= cfg.vocab:
                raise SmokeFailure(f"tick {tick}: tokens out of range")
        if len(tokens_seen) - n_tok != len(live):
            raise SmokeFailure(f"tick {tick}: {len(live)} live lanes, "
                               f"{len(tokens_seen) - n_tok} generations")
        say(f"  tick {tick}: {dt:.4f} s, levels "
            + " ".join(str(outs[s].level) if outs[s] else "-"
                       for s in range(srv.n_streams))
            + ", missed " + " ".join(str(int(outs[s].missed)) if outs[s]
                                     else "-" for s in range(srv.n_streams))
            + f", alert_select launches {ks.alert_select.launches}")
    launches = ks.alert_select.launches   # main path ends here
    if expect_kernel and counts != list(range(1, N_TICKS + 1)):
        raise SmokeFailure(f"alert_select launch counts per tick {counts}, "
                           f"expected one launch per tick")
    say(f"  served {N_TICKS} ticks; alert_select launches {launches}")
    return {"server": srv, "launches": launches}


def main_path_inputs(srv):
    """The kernel's inputs for the server's next tick, built with the
    scoring engine's own conversions (as ``serve_tick`` builds them)."""
    import numpy as np

    from repro_torch.core.batched import GOAL_MAX_ACCURACY

    eng = srv.scoring
    s = srv.n_streams
    deadlines, e_goals = np.ones(s), np.zeros(s)
    for lane in np.nonzero(srv.active)[0]:
        c = srv.lane_constraints[lane]
        deadlines[lane] = c.deadline
        if srv.goal_kinds[lane] == GOAL_MAX_ACCURACY:
            e_goals[lane] = c.energy_goal
    args = [eng._vec(srv.slowdown.mu, s),
            eng._vec(srv.slowdown.sigma, s, floor=1e-6),
            eng._vec(srv.idle_power.phi, s), eng._vec(deadlines, s),
            eng._vec(srv._goal_bank.current_goal(), s),
            eng._vec(e_goals, s), eng._lane_ints(srv.goal_kinds),
            eng._lane_ints(srv.active)]
    kw = dict(latency=eng._latency, run_power=eng._run_power,
              weights=eng._weights, q_fail=eng._q_fail,
              overhead=eng.overhead, paper_faithful_energy=True,
              predictions=True)
    return args, kw


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        say("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        say(f"FAIL: the port's sources are not under {SRC}")
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.alert_anytime import CONFIG
    from repro_torch.kernels import alert_select as ks
    from repro_torch.kernels.build import build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    say("== phase 1: device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, count {torch.cuda.device_count()}")
    say(f"  nvidia-smi: {smi}")

    say("== phase 2: build")
    built = build(["alert_select"])
    for name, b in built.items():
        say(f"  {name}: {'reused' if b.reused else 'built'} in "
            f"{b.seconds:.3f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                say(f"    ptxas: {line.strip()}")

    say("== phase 3: alert_select kernel vs plain version on the card")
    err, timing = kernel_vs_plain(device)

    say("== phase 4: serve")
    err_model = model_cpu_vs_card(device)
    run = serve(device, CONFIG)
    args, kw = main_path_inputs(run["server"])
    got = ks.alert_select(*args, **kw)
    torch.cuda.synchronize(device)
    err = max(err, compare(got, ks.alert_select_plain(*args, **kw),
                           "main-path shape S=%d K=%d L=%d"
                           % ((args[0].shape[0],) + tuple(kw["latency"]
                                                          .shape))))
    mp_ms = cuda_ms(lambda: ks.alert_select(*args, **kw), launches=200)
    mp_plain = cuda_ms(lambda: ks.alert_select_plain(*args, **kw),
                       launches=50)
    srv = run["server"]
    select_ms = host_ms(lambda: srv.scoring.select(
        *args[:4], accuracy_goal=args[4], energy_goal=args[5],
        goal_kind=args[6], active=args[7]))
    s_mp, (k_mp, l_mp) = args[0].shape[0], kw["latency"].shape
    cost = ks.alert_select_cost(s_mp, k_mp, l_mp, predictions=True)
    mp_bound = max(cost["flops"] / H100_FP64_FLOPS,
                   cost["bytes_accessed"] / H100_HBM_BYTES_S) * 1e3
    say(f"  main-path shape S={s_mp} K={k_mp} L={l_mp}: kernel "
        f"{mp_ms:.6f} ms, plain {mp_plain:.6f} ms, bound {mp_bound:.9f} ms; "
        f"one BatchedAlertEngine.select call (host wall, results on the "
        f"host) {select_ms:.6f} ms")
    say(f"  reduced-model max abs logit diff {err_model:.3e}")
    say(f"== done in {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "alert_select", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": run["launches"],
        "max_abs_err": err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None,
        "shape": timing["shape"], "main_path_shape":
            f"S={s_mp},K={k_mp},L={l_mp}",
        "main_path_ms": mp_ms, "main_path_plain_ms": mp_plain,
        "main_path_bound_ms": mp_bound, "main_path_select_ms": select_ms}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        say(f"FAIL: {exc}")
        sys.exit(1)
