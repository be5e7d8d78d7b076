"""Share of the traced inputs' ``generate`` time that the host spends in
the engine's ``step`` spans (on the card, enqueuing a graph replay), over
the last ``trace_ticks`` ticks in the program's process recorder, which
records while the profiler does.  None where the program keeps no such
spans.

Read in the traced stretch, a ``step`` span also times what CUPTI adds to
each graph launch, about 60 times the launch's untraced cost on an H100,
so this reading stands for the profiler's launch cost, not the program's
untraced one; a reading in the untraced window, with a recorder attached,
is what a change to graph launches should be judged by."""

import sys


def read(run):
    """Percent."""
    rec = getattr(sys.modules.get("repro_torch.obs"), "PROCESS_RECORDER",
                  None)
    tot = rec.spans.tree_totals("serve_tick", run.mix["trace_ticks"]) \
        if rec is not None else None
    if tot is None or "step" not in tot or tot["generate"]["total_s"] <= 0:
        return None
    return 100.0 * tot["step"]["total_s"] / tot["generate"]["total_s"]
