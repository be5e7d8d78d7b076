"""Roofline analysis over dry-run records (port of
``repro.launch.roofline``), on the H100's constants.

Per (arch x shape) cell, from the per-device cost of the partitioned step:

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

Also reported: MODEL_FLOPS = 6*N*D (train) / 2*N_active*D (inference),
the useful-compute ratio MODEL_FLOPS / (FLOPs * chips), the dominant
term, and a one-line diagnosis of what would move it.  ``analyze`` reads
records with the keys the reference's ``launch/dryrun.py`` writes.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s
NVLink 4 each way, 80 GB of HBM.
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_BYTES = 80e9


def projected_memory_bytes(cfg, shape, chips: int = 256) -> float:
    """Analytic per-device HBM traffic assuming the card's kernels fuse
    (flash attention's tiles in shared memory, fused elementwise) — the
    memory term the CUDA kernels target.  A count of every op's operands
    is an unfused upper bound; this is the fused lower bound.
    """
    P = cfg.param_count()
    tokens = shape.global_batch * shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers + cfg.encoder_layers
    n_attn = sum(1 for m, _ in cfg.layer_plan()
                 if m in ("attn", "attn_local"))
    kv_bytes_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 2  # k+v bf16
    if shape.kind == "train":
        # params fwd+remat+bwd reads (3x2B) + grad f32 w+r (8B) + adam m,v
        # r+w (16B) + param write (2B) = 34B/param; boundary activations
        # saved+read+recomputed ~ 6B/token/layer; logits r+w bf16+f32.
        return (34.0 * P + 6.0 * tokens * d * L
                + 12.0 * tokens * cfg.vocab) / chips
    if shape.kind == "prefill":
        logits_tokens = shape.global_batch if cfg.prefill_last_only \
            else tokens
        return (2.0 * P + 4.0 * tokens * d * L
                + n_attn * tokens * kv_bytes_tok
                + 4.0 * logits_tokens * cfg.vocab) / chips
    # decode: params once + full KV read + state read/write
    state = 0.0
    for m, _ in cfg.layer_plan():
        if m == "mamba":
            state += 8.0 * cfg.mamba_d_inner * cfg.mamba_d_state
        elif m == "rwkv":
            state += 8.0 * cfg.d_model * cfg.rwkv_head_dim
    b = shape.global_batch
    kv_read = n_attn * b * shape.seq_len * kv_bytes_tok
    if cfg.sliding_window and cfg.global_every:
        n_local = sum(1 for m, _ in cfg.layer_plan() if m == "attn_local")
        n_global = n_attn - n_local
        kv_read = (n_global * shape.seq_len +
                   n_local * min(cfg.sliding_window, shape.seq_len)) * \
            b * kv_bytes_tok
    return (2.0 * P + kv_read + b * state
            + 4.0 * b * cfg.vocab) / chips


def model_flops(rec: dict) -> float:
    """Useful FLOPs for the whole step (all chips).  A record of a shape
    other than the four ``SHAPES`` carries its step's ``tokens``."""
    n_active = rec["active_param_count"]
    shape = rec["shape"]
    kind = rec["kind"]
    tokens = rec["tokens"] if "tokens" in rec else \
        {"train_4k": 256 * 4096, "prefill_32k": 32 * 32768,
         "decode_32k": 128, "long_500k": 1}[shape]
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def analyze(rec: dict) -> dict:
    chips = rec["n_devices"]
    cal = rec.get("calibrated")
    if cal:
        # Period-composed measurements (a dry run's count over one and two
        # periods of layers composed into the whole depth).
        flops_dev = cal["flops_per_device"]
        bytes_dev = cal["bytes_per_device"]
        coll_dev = cal["collective_bytes_per_device"]
        traffic_dev = cal["collective_traffic_per_device"]
        coll = rec["collective_bytes_per_device"]
    else:
        flops_dev = rec["flops_per_device"] or 0.0
        bytes_dev = rec["bytes_per_device"] or 0.0
        coll = rec["collective_bytes_per_device"]
        coll_dev = coll["total"]
        traffic_dev = coll.get("traffic_total", coll_dev)

    compute_t = flops_dev / PEAK_FLOPS
    memory_t = bytes_dev / HBM_BW
    collective_t = coll_dev / LINK_BW
    traffic_t = traffic_dev / LINK_BW

    terms = {"compute": compute_t, "memory": memory_t,
             "collective": collective_t}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(rec)
    useful_ratio = mf / (flops_dev * chips) if flops_dev else 0.0
    # Roofline fraction: useful work rate vs peak under the binding term.
    step_time = max(compute_t, memory_t, collective_t)
    mfu = mf / (chips * PEAK_FLOPS * step_time) if step_time else 0.0

    mem = rec.get("memory", {})
    hbm_per_dev = (mem.get("argument_size") or 0) + \
        (mem.get("temp_size") or 0) + (mem.get("output_size") or 0)

    # Projected (fused) memory term + resulting roofline fraction: the
    # measured bytes are an unfused upper bound; this is what the CUDA
    # kernels (flash attention / nested matmul / rwkv scan) target.
    proj_memory_t = None
    proj_mfu = None
    if rec["arch"] in configs.ALL_IDS and rec["shape"] in SHAPES:
        cfg = configs.get_config(rec["arch"])
        proj_memory_t = projected_memory_bytes(
            cfg, SHAPES[rec["shape"]], chips) / HBM_BW
        proj_step = max(compute_t, proj_memory_t, collective_t)
        proj_mfu = mf / (chips * PEAK_FLOPS * proj_step) if proj_step \
            else 0.0

    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "variant": rec.get("variant", "baseline"),
        "compute_s": compute_t, "memory_s": memory_t,
        "collective_s": collective_t, "collective_traffic_s": traffic_t,
        "dominant": dominant, "bound_s": bound,
        "model_flops": mf, "useful_flops_ratio": useful_ratio,
        "roofline_fraction": mfu,
        "proj_memory_s": proj_memory_t,
        "proj_roofline_fraction": proj_mfu,
        "hbm_bytes_per_device": hbm_per_dev,
        "fits_80gb": hbm_per_dev < HBM_BYTES,
        "compile_s": rec.get("compile_s"),
    }


def diagnosis(a: dict) -> str:
    if a["dominant"] == "compute":
        if a["useful_flops_ratio"] < 0.5:
            return ("compute-bound with low useful-FLOP ratio: compiled "
                    "FLOPs include remat/dispatch/padding waste - cut "
                    "recompute or padded ops")
        return ("compute-bound near useful peak: gains need larger per-chip "
                "work or lower-precision matmuls")
    if a["dominant"] == "memory":
        return ("HBM-bound: raise arithmetic intensity (fuse, batch more "
                "tokens per weight read, shrink KV/dtype)")
    return ("collective-bound: reshard to cut gathered bytes, overlap "
            "collectives with compute, or compress gradients")


def load_all(directory: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("status") == "ok":
            recs.append(r)
    return recs


def table(directory: str, mesh: str = "16x16",
          variant: str = "baseline") -> list[dict]:
    out = []
    for r in load_all(directory):
        if r["mesh"] != mesh or r.get("variant", "baseline") != variant:
            continue
        a = analyze(r)
        a["note"] = diagnosis(a)
        out.append(a)
    return out


def fmt_table(rows: list[dict], markdown: bool = False) -> str:
    if markdown:
        lines = ["| arch | shape | compute s | mem s (meas) | mem s (proj) "
                 "| coll s | dominant | useful | roofl% (meas) | roofl% "
                 "(proj) | fits 80GB |",
                 "|---|---|---|---|---|---|---|---|---|---|---|"]
        for a in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
            pm = a.get("proj_memory_s")
            pr = a.get("proj_roofline_fraction")
            lines.append(
                f"| {a['arch']} | {a['shape']} | {a['compute_s']:.3g} | "
                f"{a['memory_s']:.3g} | "
                + (f"{pm:.3g}" if pm is not None else "n/a") + " | "
                + f"{a['collective_s']:.3g} | {a['dominant']} | "
                f"{a['useful_flops_ratio']:.2f} | "
                f"{100 * a['roofline_fraction']:.1f}% | "
                + (f"{100 * pr:.1f}%" if pr is not None else "n/a") + " | "
                + ("yes" if a['fits_80gb'] else "NO") + " |")
        return "\n".join(lines)
    hdr = (f"{'arch':22s} {'shape':12s} {'comp(s)':>9s} {'mem(s)':>9s} "
           f"{'memP(s)':>9s} {'coll(s)':>9s} {'dom':>6s} {'useful':>7s} "
           f"{'roofl%':>7s} {'roofP%':>7s} {'fits':>5s}")
    lines = [hdr, "-" * len(hdr)]
    for a in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        pm = a.get("proj_memory_s")
        pr = a.get("proj_roofline_fraction")
        lines.append(
            f"{a['arch']:22s} {a['shape']:12s} {a['compute_s']:9.3g} "
            f"{a['memory_s']:9.3g} "
            + (f"{pm:9.3g} " if pm is not None else f"{'n/a':>9s} ")
            + f"{a['collective_s']:9.3g} "
            f"{a['dominant'][:6]:>6s} {a['useful_flops_ratio']:7.2f} "
            f"{100 * a['roofline_fraction']:6.1f}% "
            + (f"{100 * pr:6.1f}% " if pr is not None else f"{'n/a':>7s} ")
            + f"{'y' if a['fits_80gb'] else 'N':>5s}")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    d = sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun"
    rows = table(d)
    print(fmt_table(rows))
    print()
    for a in sorted(rows, key=lambda x: x["roofline_fraction"])[:5]:
        print(f"WORST {a['arch']} {a['shape']}: {a['note']}")
