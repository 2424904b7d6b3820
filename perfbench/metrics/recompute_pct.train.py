"""The share of device time launched inside the program's
``model.layer.recompute`` spans: remat's recompute of each block in the
backward."""
from perfbench.lib import spans


def read(run):
    return spans.share(run, ["model.layer.recompute"])
