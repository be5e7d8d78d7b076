"""The model FLOPs of every window input at its served level (the
reference family's formula: live projection blocks, attention over live
pairs, the unembedding of the rows that pick a token),
over the window's seconds times the card's bf16 peak."""


def read(run):
    """Percent."""
    if run.peak is None or run.window_s <= 0:
        return None
    flops = 0.0
    for s in run.inputs:
        lvl = s.level or run.cfg.get("nest_levels", 1)
        for new, ctx in run.forwards(s):
            flops += run.family.forward_flops(run.cfg, lvl,
                                              run.mix["batch"], new, ctx)
    return 100.0 * flops / (run.window_s * run.peak["flops"])
