"""The share of the traced window in which no device event ran."""
from perfbench.lib import readers


def read(run):
    return readers.idle_pct(run)
