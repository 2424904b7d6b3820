"""Model FLOPs of the work completed in the window (perfbench/counts),
over the window, over the bf16 peak of 989 TFLOP/s."""
from perfbench.lib import readers


def read(run):
    return readers.mfu(run)
