"""Model FLOPs of the training steps completed in the window (forward
and backward, perfbench/counts), over the window, over the bf16 peak of
989 TFLOP/s."""
from perfbench.lib import readers


def read(run):
    return readers.train_mfu(run)
