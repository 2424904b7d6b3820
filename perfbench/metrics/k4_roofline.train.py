"""K4's byte bound over its device time in the window's steps: each
layer's forward scan twice a step (forward and recompute), its reverse
walk with da once, at 3.35 TB/s."""
from perfbench.lib import readers


def read(run):
    return readers.k4_train_roofline(run)
