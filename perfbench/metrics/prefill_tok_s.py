"""Prompt tokens of every request completed in the window, over the
window's seconds (host clock)."""
from perfbench.lib import readers


def read(run):
    return readers.prompt_tokens(run) / run.window_s
