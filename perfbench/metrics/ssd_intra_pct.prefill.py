"""The share of device time launched inside the program's ``ssm.intra``
spans: the SSD mixer's (B, C, Q, Q, H) intra-chunk chain, from the
decays through the intra-chunk einsum."""
from perfbench.lib import spans


def read(run):
    return spans.share(run, ["ssm.intra"])
