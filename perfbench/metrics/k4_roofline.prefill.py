"""K4's byte bound (decays and states read once, scanned states written
once, at 3.35 TB/s) over its device time, each K4 kernel of the trace one
scan of the prefill's (batch, chunks, heads, headdim, state)."""
from perfbench.lib import readers


def read(run):
    return readers.k4_roofline(run, readers.ssd_scan_shape)
