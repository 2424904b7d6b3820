"""Tokens of every training step completed in the window, over the
window's seconds (host clock)."""
from perfbench.lib import readers


def read(run):
    return readers.trained_tokens(run) / run.window_s
