"""The share of device time in elementwise kernels (the SSD mixer's
intra-chunk tensors and their gradients), by kernel name."""
from perfbench.lib import readers


def read(run):
    return readers.kind_pct(run, "elementwise")
