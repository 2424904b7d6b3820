"""The share of device time launched inside the program's ``ssm.ssd``
and ``ssm.ssd.backward`` spans: the SSD mixer's forward, its forward
again in remat's recompute, and its backward."""
from perfbench.lib import spans


def read(run):
    return spans.share(run, ["ssm.ssd", "ssm.ssd.backward"])
