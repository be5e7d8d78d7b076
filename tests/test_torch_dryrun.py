"""The data plane's dry run (``repro_torch.launch.dryrun``): the count on
``meta`` held to the reference's compiled counts, and on its own.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host devices)
when it is imported, which would change the device count of every later
test in this process; so it is reached only in subprocesses, each with
its own ``XLA_FLAGS`` of 4 host devices, at reduced configs and a tiny
shape (64 tokens, batch 4) on a (2, 2) ``("data", "model")`` grid, each
under a 120 s timeout.  There the reference compiles the step with the
overrides of its ``calibrate`` (no layer scan, attention chunks
unrolled, one time chunk: ``mamba_chunk = rwkv_chunk = 64``) and reads
``memory_analysis``, ``cost_analysis`` and its HLO's collectives, and
the ``dot_general`` FLOPs of the same step's jaxpr (a ``scan`` or
``while`` body counted once, as XLA counts it).  The port counts the
same configs (its forward is unrolled already) on a (2, 2) ``meta``
grid.  Nothing here compiles the 16x16 or 2x16x16 grids of the
reference; on those the port is held by its own checks.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported
from repro_torch.launch import dryrun as dr
from repro_torch.launch import roofline
from repro_torch.launch.mesh import GridMesh
from repro_torch.models import moe as moe_mod

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("gemma3-1b", "olmoe-1b-7b", "jamba-v0.1-52b", "rwkv6-3b")
KINDS = ("prefill", "decode", "train")
SEQ, BATCH = 64, 4

REFERENCE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
import jax._src.core as jcore
from repro import configs
from repro.configs.shapes import SHAPES, ShapeSpec, input_specs
from repro.launch import dryrun as dr
from repro.models.registry import build_model
from repro.optim.adamw import AdamW
from repro.train.step import make_train_step

def sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x

def dot_flops(jaxpr):
    # every dot_general, a scan/while/remat body counted once (as XLA
    # counts a while body), the larger branch of a cond
    total = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            k = int(np.prod([lhs[i] for i in lc])) if lc else 1
            total += 2 * int(np.prod(e.outvars[0].aval.shape)) * k
        else:
            subs = [dot_flops(j) for j in sub_jaxprs(e)]
            if subs:
                total += max(subs) if e.primitive.name == "cond" \\
                    else sum(subs)
    return total

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mesh = jax.make_mesh((2, 2), ("data", "model"))
cfg = configs.get_reduced(arch).replace(
    unroll_layers=True, attn_unroll_chunks=True, mamba_chunk=seq,
    rwkv_chunk=seq)
model = build_model(cfg)
out = {}
for kind in ("prefill", "decode", "train"):
    shape = ShapeSpec("tiny_" + kind, seq, batch, kind)
    compiled = dr._lower_cell(cfg, shape, mesh).compile()
    m = dr._measure(compiled)
    batch_specs = input_specs(cfg, shape)
    if kind == "train":
        opt = AdamW(lr=3e-4)
        jp = jax.make_jaxpr(make_train_step(model, cfg, opt))(
            dr.abstract_state(model, cfg, opt), batch_specs)
    else:
        params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        if kind == "prefill":
            jp = jax.make_jaxpr(model.prefill)(params, batch_specs)
        else:
            caches = jax.eval_shape(lambda: model.init_caches(batch, seq))
            jp = jax.make_jaxpr(model.decode_step)(params, batch_specs,
                                                   caches)
    out[kind] = {
        "flops": m["flops"], "bytes": m["bytes"], "coll": m["coll_detail"],
        "argument_size":
            compiled.memory_analysis().argument_size_in_bytes,
        "dot_flops": dot_flops(jp.jaxpr)}
if len(sys.argv) > 4:
    out["recurrence"] = {
        f"{a}/{s}": dr._recurrence_flops(configs.get_config(a), sh)
        for a in configs.ALL_IDS for s, sh in SHAPES.items()}
print(json.dumps(out))
"""


class Reference:
    """The reference's counts of each of ``ARCHS`` (one subprocess an
    arch, all started when the module's first test runs, so they compile
    while the port's own checks run), and its ``_recurrence_flops`` of
    every arch and shape."""

    TIMEOUT = 120

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=SRC)
        self.started = time.monotonic()
        self.procs = {arch: subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REFERENCE), arch,
             str(SEQ), str(BATCH)]
            + (["recurrence"] if arch == ARCHS[0] else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for arch in ARCHS}
        self.out = None

    def result(self) -> dict:
        if self.out is None:
            out = {}
            for arch, proc in self.procs.items():
                left = self.TIMEOUT - (time.monotonic() - self.started)
                stdout, stderr = proc.communicate(timeout=max(left, 1))
                assert proc.returncode == 0, stderr[-3000:]
                out[arch] = json.loads(stdout.strip().splitlines()[-1])
            self.out = out
        return self.out

    def stop(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference_runs():
    ref = Reference()
    yield ref
    ref.stop()


@pytest.fixture(scope="module")
def reference(reference_runs):
    return reference_runs.result()


def grid_2x2() -> GridMesh:
    return GridMesh(np.array(["meta"] * 4, dtype=object).reshape(2, 2),
                    ("data", "model"))


def port_config(arch):
    return configs.get_reduced(arch).replace(mamba_chunk=SEQ, rwkv_chunk=SEQ)


@pytest.fixture(scope="module")
def port():
    """The port's count of each of ``ARCHS`` and ``KINDS`` at the same
    configs and shape on a (2, 2) ``meta`` grid."""
    mesh = grid_2x2()
    return {(arch, kind): dr.count_step(
        port_config(arch), ShapeSpec("tiny_" + kind, SEQ, BATCH, kind),
        mesh) for arch in ARCHS for kind in KINDS}


def whole(cfg, periods: int):
    """``cfg`` at ``periods`` whole periods of its layer plan (of a plan
    long enough to show its period)."""
    p = cfg.replace(n_layers=4 * cfg.n_layers).layer_period()
    if cfg.encoder_layers:
        return cfg.replace(n_layers=periods, encoder_layers=periods)
    return cfg.replace(n_layers=periods * p)


COMPOSED = [(a, k) for a in ("olmoe-1b-7b", "rwkv6-3b", "whisper-tiny",
                              "qwen2-vl-2b") for k in KINDS] + \
    [("gemma3-1b", "prefill"), ("gemma3-1b", "decode"),
     ("jamba-v0.1-52b", "prefill")]


@pytest.mark.parametrize("arch,kind", COMPOSED)
def test_composition_is_a_direct_count(arch, kind):
    """The record's count, composed from one and two periods (and one,
    two and four chunks of a time loop), equals a direct count of the
    whole unrolled config, 3 periods of reduced width with 8 chunks, in
    every FLOP, byte, collective and argument and output byte; and
    ``calibrate`` is the direct count at one chunk plus
    ``_recurrence_flops``.  The cases cover each layer kind (attention
    global and windowed, MoE, Mamba, RWKV, the encoder-decoder, M-RoPE)
    and a time loop in a prefill (Mamba) and a train step (RWKV)."""
    mesh = grid_2x2()
    shape = ShapeSpec("tiny_" + kind, SEQ, BATCH, kind)
    cfg = whole(configs.get_reduced(arch), 3).replace(mamba_chunk=8,
                                                      rwkv_chunk=8)
    got, want = dr.count_cell(cfg, shape, mesh), dr.count_step(cfg, shape,
                                                               mesh)
    for key in ("flops", "bytes", "coll", "traffic", "coll_detail",
                "product_flops"):
        assert got[key] == want[key], key
    for key in ("argument_size", "output_size"):
        assert got["memory"][key] == want["memory"][key], key
    cal = dr.calibrate(cfg, shape, mesh)
    one = dr.count_step(cfg.replace(mamba_chunk=SEQ, rwkv_chunk=SEQ), shape,
                        mesh)
    assert cal["flops"] == one["flops"] + dr._recurrence_flops(cfg, shape)
    for key in ("bytes", "coll", "traffic"):
        assert cal[key] == one[key], key


@pytest.fixture(scope="module")
def rwkv_long():
    t0 = time.perf_counter()
    recs = {multi: dr.run_cell("rwkv6-3b", SHAPES["long_500k"], multi)
            for multi in (False, True)}
    return recs, time.perf_counter() - t0


def test_rwkv_long_500k_full_size_on_both_grids(rwkv_long):
    recs, seconds = rwkv_long
    assert seconds < 30
    cfg = configs.get_config("rwkv6-3b")
    for multi, rec in recs.items():
        assert rec["status"] == "ok"
        assert rec["mesh"] == ("2x16x16" if multi else "16x16")
        assert rec["n_devices"] == (512 if multi else 256)
        assert rec["param_count"] == cfg.param_count()
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert ("calibrated" in rec) == (not multi)
    # batch 1 does not split over the data axes, so the pod axis adds
    # nothing a device does
    single, multi = recs[False], recs[True]
    for key in ("flops_per_device", "bytes_per_device", "memory"):
        assert single[key] == multi[key], key
    cal = single["calibrated"]
    assert cal["flops_per_device"] == pytest.approx(
        single["flops_per_device"] + dr._recurrence_flops(
            cfg, SHAPES["long_500k"]), rel=1e-12)


def test_record_keys_feed_the_roofline(rwkv_long, tmp_path):
    """The record has the reference's keys (``generated_code_size`` and
    ``hlo_bytes`` None: there is no compiled program), and
    ``roofline.analyze`` and ``table`` run on it."""
    rec = rwkv_long[0][False]
    assert {"arch", "shape", "kind", "mesh", "variant", "status", "reason",
            "lower_s", "compile_s", "n_devices", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "memory",
            "param_count", "active_param_count", "hlo_bytes",
            "calibrated"} == set(rec)
    assert rec["hlo_bytes"] is None
    assert rec["memory"]["generated_code_size"] is None
    assert set(rec["collective_bytes_per_device"]) == set(dr.COLLECTIVES) \
        | {"total", "traffic_total", "traffic", "counts"}
    assert set(rec["calibrated"]) == {
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collective_traffic_per_device",
        "one_period", "two_period"}
    a = roofline.analyze(rec)
    assert a["bound_s"] > 0 and a["dominant"] in ("compute", "memory",
                                                   "collective")
    (tmp_path / "r.json").write_text(json.dumps(rec))
    rows = roofline.table(str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in rows] == \
        [("rwkv6-3b", "long_500k")]


def test_every_cell_status_is_cell_supported(monkeypatch):
    """Every ``ARCH_IDS`` x ``SHAPES`` cell on the 16x16 grid ends ``ok``
    or ``skip`` as ``cell_supported`` decides, the skip with its reason:
    each supported cell counted once at full width and shape, its depth
    cut to one period of its layers and its time loops to one chunk (the
    verdict depends on neither; ``test_composition_is_a_direct_count``
    holds the composition over both)."""
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch: whole(full(arch), 1))
    monkeypatch.setattr(dr, "count_cell", lambda cfg, shape, mesh, *a:
                        dr.count_step(cfg.replace(
                            mamba_chunk=shape.seq_len,
                            rwkv_chunk=shape.seq_len), shape, mesh))
    for arch in configs.ARCH_IDS:
        for shape in SHAPES.values():
            ok, reason = cell_supported(full(arch), shape)
            rec = dr.run_cell(arch, shape, False, calibrate_flops=False)
            assert rec["status"] == ("ok" if ok else "skip"), (arch, shape)
            assert rec["reason"] == reason


def test_variant_the_config_refuses_is_a_skip():
    rec = dr.run_cell("olmoe-1b-7b", SHAPES["decode_32k"], False,
                      variant="anytime_blocks")
    assert rec["status"] == "skip" and "nest" in rec["reason"]
    with pytest.raises(KeyError):
        dr.run_cell("olmoe-1b-7b", SHAPES["decode_32k"], False,
                    variant="no-such-variant")


def test_main_writes_caches_and_exits_zero(tmp_path, capsys):
    argv = ["--arch", "rwkv6-3b", "--shape", "long_500k", "--mesh", "both",
            "--out", str(tmp_path)]
    assert dr.main(argv) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["rwkv6-3b__long_500k__multi__baseline.json",
                     "rwkv6-3b__long_500k__single__baseline.json"]
    capsys.readouterr()
    assert dr.main(argv) == 0
    assert capsys.readouterr().out.count("[cached]") == 2


def test_scans_counted_once_restores_the_mixers():
    from repro_torch.models import mamba, rwkv
    before = (mamba._ssm_scan, rwkv._wkv_chunk_scan, rwkv.rwkv_scan)
    with dr.scans_counted_once():
        assert mamba._ssm_scan is not before[0]
    assert (mamba._ssm_scan, rwkv._wkv_chunk_scan, rwkv.rwkv_scan) == before


def test_the_count_does_not_depend_on_the_device():
    """The counter over the real step on the CPU (seeded weights and
    batch) counts what it counts on ``meta``: the phase-39 rule of
    ``chip_smoke.py``, here at reduced size."""
    cfg = configs.get_reduced("alert-anytime-120m")
    mesh = GridMesh(np.array([["meta"]], dtype=object), ("data", "model"))
    cpu = GridMesh(np.array([["cpu"]], dtype=object), ("data", "model"))
    for kind, seq in (("train", 32), ("prefill", 8), ("decode", 12)):
        shape = ShapeSpec(kind, seq, 4, kind)
        a = dr.count_step(cfg, shape, mesh)
        b = dr.count_step(cfg, shape, cpu, device="cpu")
        for key in ("flops", "bytes", "product_flops", "by_op"):
            assert a[key] == b[key], (kind, key)
        assert a["memory"]["argument_size"] == b["memory"]["argument_size"]


# --------------------------------------------------------------------- #
# against the reference, last: its subprocesses compile meanwhile        #
# --------------------------------------------------------------------- #
def index_extra_bytes(kind: str) -> int:
    """Per-device bytes the port's int64 token ids (and labels) add over
    the reference's int32 ones: ``[B, S]`` split over ``data`` (2)."""
    tokens = BATCH // 2 * (1 if kind == "decode" else SEQ)
    return (2 if kind == "train" else 1) * tokens * 4


def unread_cache_len(arch: str, kind: str) -> int:
    """``jit`` leaves out an argument the step never reads: a decode
    step's int32 ``cache_len`` where no layer attends (RWKV), which the
    port's step reads only to make positions no layer uses."""
    plan = port_config(arch).layer_plan()
    return 4 if kind == "decode" and not any(
        m.startswith("attn") for m, _ in plan) else 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_size_is_the_references(arch, kind, reference, port):
    """Params (or the AdamW state), batch and caches by the rules,
    shard by shard: the reference's ``argument_size_in_bytes`` exactly,
    once the port's int64 token ids are counted as the reference's
    int32 and an argument the reference's step never reads is left
    out."""
    got = port[arch, kind]["memory"]["argument_size"]
    want = reference[arch][kind]["argument_size"]
    assert got - index_extra_bytes(kind) - unread_cache_len(arch, kind) \
        == want


def recompute_extra(arch: str) -> int:
    """Products the port's train step runs and the reference's does not:
    ``torch.utils.checkpoint`` reruns the whole checkpointed region in the
    backward pass, where ``jax.checkpoint`` reruns only what the backward
    reads.  A MoE layer reruns its combine product ``[g, s, e, c] x d``
    (with ``remat=False`` olmoe and jamba match exactly); an RWKV layer's
    chunk checkpoint reruns the output product ``r . (S + u k v^T)``, a
    chunk's body counted once."""
    cfg = port_config(arch)
    extra = 0
    tokens = BATCH * SEQ
    for mixer, ffn in cfg.layer_plan():
        if ffn == "moe":
            sg = min(moe_mod.MOE_GROUP_SIZE, tokens)
            c = moe_mod.capacity(sg, cfg.top_k, cfg.n_experts,
                                 cfg.capacity_factor)
            extra += 2 * tokens * cfg.n_experts * c * cfg.d_model
        if mixer == "rwkv":
            extra += 2 * BATCH * cfg.rwkv_n_heads * cfg.rwkv_head_dim ** 2
    return extra


# port / reference train product FLOPs, pinned (recompute_extra's cause)
TRAIN_PRODUCT_RATIO = {"gemma3-1b": 1.0,
                       "olmoe-1b-7b": 484442112 / 442499072,
                       "jamba-v0.1-52b": 1554104320 / 1470218240,
                       "rwkv6-3b": 197296128 / 197263360}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_product_flops_are_the_references(arch, kind, reference, port):
    """Every ``mm``/``bmm`` the port counts against every ``dot_general``
    of the reference's jaxpr of the same step: equal for prefill and
    decode; for train equal but for the work the two steps' recompute
    differs by (:func:`recompute_extra`), the ratio pinned."""
    got = port[arch, kind]["product_flops"]
    want = reference[arch][kind]["dot_flops"]
    if kind != "train":
        assert got == want
        return
    assert got - want == recompute_extra(arch)
    assert got / want == pytest.approx(TRAIN_PRODUCT_RATIO[arch], rel=1e-12)


# Measured at these configs (port / reference, over ARCHS x KINDS): FLOPs
# 0.58-1.16 (XLA counts its fusions' elementwise work and leaves out
# transcendentals; the port counts one FLOP an element of every op), bytes
# 0.32-1.17 (the port's count is unfused; XLA reads a decode step's caches
# and parameters as its fusions need them), the collectives' total
# 0.30-1.04, and each kind off by at most 0.46 of the cell's total (XLA
# moves kv heads that do not split over ``model`` with all-to-all and
# collective-permute, which these rules never pick, and gathers where the
# port reduces).  The bounds below hold those with a margin.
FLOPS_RATIO = (0.5, 2.0)
BYTES_RATIO = (0.25, 2.0)
COLL_TOTAL_RATIO = (0.25, 2.0)
COLL_KIND_SHARE = 0.6


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_within_the_stated_tolerance(arch, kind, reference, port):
    got, want = port[arch, kind], reference[arch][kind]
    lo, hi = FLOPS_RATIO
    assert lo <= got["flops"] / want["flops"] <= hi
    lo, hi = BYTES_RATIO
    assert lo <= got["bytes"] / want["bytes"] <= hi
    lo, hi = COLL_TOTAL_RATIO
    assert lo <= got["coll"] / want["coll"]["total"] <= hi
    for c in dr.COLLECTIVES:
        assert abs(got["coll_detail"][c] - want["coll"][c]) <= \
            COLL_KIND_SHARE * want["coll"]["total"], c


def test_recurrence_flops_are_the_references(reference):
    got = {f"{a}/{s}": dr._recurrence_flops(configs.get_config(a), sh)
           for a in configs.ALL_IDS for s, sh in SHAPES.items()}
    assert got == reference[ARCHS[0]]["recurrence"]


def test_the_reference_dry_run_is_not_imported_here():
    assert "repro.launch.dryrun" not in sys.modules
    assert "jax" not in sys.modules or \
        "xla_force_host_platform_device_count=512" not in \
        os.environ.get("XLA_FLAGS", "")
