"""Share of the traced ticks' wall time in the controller: the program's
``select`` and ``feedback`` spans over its ``serve_tick`` spans (the
paper's controller overhead), over the last ``trace_ticks`` ticks in the
program's process recorder, which records while the profiler does.  None
where the program keeps no such spans."""

import sys


def read(run):
    """Percent."""
    rec = getattr(sys.modules.get("repro_torch.obs"), "PROCESS_RECORDER",
                  None)
    tot = rec.spans.tree_totals("serve_tick", run.mix["trace_ticks"]) \
        if rec is not None else None
    if tot is None or tot["serve_tick"]["total_s"] <= 0:
        return None
    ctl = sum(tot[k]["total_s"] for k in ("select", "feedback") if k in tot)
    return 100.0 * ctl / tot["serve_tick"]["total_s"]
