"""Run-report renderer for flight recordings (port of
``repro.obs.report``).

Renders a saved (or live) :class:`~repro_torch.obs.FlightRecorder` as plain
text: the metric catalog with values, host-phase span totals, and the
telemetry-ring summary, plus pointers to the trace files a viewer can
open.  Used as a CLI over a :meth:`FlightRecorder.save` directory::

    PYTHONPATH=src python -m repro_torch.obs.report runs/obs_demo

and as a library (:func:`render_recorder`).
"""

from __future__ import annotations

import json
import os
import sys


def _fmt(v: float) -> str:
    """Compact numeric formatting for table cells."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def render_metrics(snapshot: list[dict]) -> str:
    """Text table of a :meth:`MetricsRegistry.snapshot` list."""
    lines = ["== metrics ==",
             f"{'name':40s} {'type':9s} {'labels':24s} value"]
    for m in snapshot:
        labels = ",".join(f"{k}={v}" for k, v in
                          sorted(m["labels"].items())) or "-"
        if m["type"] in ("counter", "gauge"):
            val = _fmt(m["value"])
        elif m["type"] == "histogram":
            val = (f"n={m['count']} mean={_fmt(m['mean'])} "
                   f"p50={_fmt(m['p50'])} p99={_fmt(m['p99'])} "
                   f"max={_fmt(m['max'])}")
        else:  # timer
            val = (f"n={m['count']} total={m['total_s']:.4f}s "
                   f"last={m['last_s']:.4f}s mean={m['mean_s']:.4f}s")
        lines.append(f"{m['name']:40s} {m['type']:9s} {labels:24s} {val}")
    return "\n".join(lines)


def render_spans(phase_totals: dict[str, dict], *,
                 trace_paths: dict[str, str] | None = None) -> str:
    """Text table of span phase totals (``SpanTracer.phase_totals``)."""
    lines = ["== host phases ==",
             f"{'phase':28s} {'count':>7s} {'total_s':>10s} {'max_s':>10s}"]
    for name, row in sorted(phase_totals.items(),
                            key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"{name:28s} {row['count']:7d} "
                     f"{row['total_s']:10.4f} {row['max_s']:10.4f}")
    if trace_paths:
        lines.append("")
        lines.append(f"spans jsonl : {trace_paths.get('spans', '-')}")
        lines.append(f"chrome trace: {trace_paths.get('trace', '-')} "
                     "(open in chrome://tracing or ui.perfetto.dev)")
    return "\n".join(lines)


def render_ring(summary: dict) -> str:
    """Text block for a :meth:`TelemetryRing.summary` dict."""
    return "\n".join([
        "== telemetry ring (per-round, device-resident) ==",
        f"rounds          : {summary['rounds_seen']} seen, "
        f"{summary['rounds_retained']} retained "
        f"(capacity {summary['capacity']})",
        f"lane-rounds     : {_fmt(summary['lane_rounds_active'])} active, "
        f"feasible frac {summary['feasible_frac']:.4f}, "
        f"relaxed frac {summary['relaxed_frac']:.4f}",
        f"energy / misses : {summary['energy_j']:.4f} J, "
        f"{summary['missed']} deadline misses",
    ])


def render_recorder(obs, *, trace_paths: dict[str, str] | None = None) -> str:
    """Full text report for a live :class:`FlightRecorder`."""
    return "\n\n".join([
        render_metrics(obs.metrics.snapshot()),
        render_spans(obs.spans.phase_totals(), trace_paths=trace_paths),
        render_ring(obs.ring.summary()),
    ])


def _spans_totals_from_jsonl(path: str) -> dict[str, dict]:
    """Rebuild phase totals from a saved ``spans.jsonl``."""
    totals: dict[str, dict] = {}
    with open(path) as f:
        f.readline()  # _meta header
        for line in f:
            rec = json.loads(line)
            if rec["ph"] != "X":
                continue
            row = totals.setdefault(
                rec["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            dur_s = rec["dur_us"] * 1e-6
            row["count"] += 1
            row["total_s"] += dur_s
            row["max_s"] = max(row["max_s"], dur_s)
    return totals


def render_run_dir(run_dir: str) -> str:
    """Full text report for a :meth:`FlightRecorder.save` directory."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.ring import TelemetryRing

    metrics_p = os.path.join(run_dir, "metrics.json")
    spans_p = os.path.join(run_dir, "spans.jsonl")
    ring_p = os.path.join(run_dir, "ring.json")
    parts = [f"flight recording: {run_dir}"]
    if os.path.exists(metrics_p):
        parts.append(render_metrics(MetricsRegistry.load_snapshot(metrics_p)))
    if os.path.exists(spans_p):
        parts.append(render_spans(
            _spans_totals_from_jsonl(spans_p),
            trace_paths={"spans": spans_p,
                         "trace": os.path.join(run_dir, "trace.json")}))
    if os.path.exists(ring_p):
        parts.append(render_ring(TelemetryRing.load(ring_p)["summary"]))
    return "\n\n".join(parts)


def main(argv: list[str] | None = None) -> int:
    """CLI entry point: ``python -m repro_torch.obs.report <run_dir>``."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.obs.report <run_dir>\n"
              "  <run_dir>: directory written by FlightRecorder.save()",
              file=sys.stderr)
        return 2
    if not os.path.isdir(argv[0]):
        print(f"not a directory: {argv[0]}", file=sys.stderr)
        return 2
    print(render_run_dir(argv[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
