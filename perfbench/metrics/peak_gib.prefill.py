"""Device memory allocated at most in the window (the allocator's peak
after a reset just before it), in GiB."""
from perfbench.lib import readers


def read(run):
    return readers.peak_gib(run)
