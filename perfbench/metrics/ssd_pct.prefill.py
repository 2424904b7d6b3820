"""The share of device time launched inside the program's ``ssm.ssd``
spans: the SSD mixer's forward (projections, convolutions, intra-chunk
chain, states, K4, inter-chunk term, gated norm, out-projection)."""
from perfbench.lib import spans


def read(run):
    return spans.share(run, ["ssm.ssd"])
