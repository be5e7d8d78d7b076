"""``flash_attention``'s share of its roofline in the traced stretch: the sum of
its calls' bounds over its device time."""

from perfbench.harness import roofline_share


def read(run):
    """Percent."""
    return roofline_share(run, "flash_attention")
