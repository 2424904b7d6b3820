"""K4's state scan (``c4_statescan``): the SSD's inter-chunk recurrence
``run[c] = a[c] * run[c-1] + states[c]`` over (B, C, H, P, N) float32
states with one decay a (B, C, H) head."""
from __future__ import annotations


def state_scan_bytes(b: int, c: int, h: int, p: int, n: int,
                     elem: int = 4) -> int:
    """Bytes the scan must move: the decays and the states read once,
    the scanned states written once."""
    return (b * c * h + 2 * b * c * h * p * n) * elem


def reverse_walk_bytes(b: int, c: int, h: int, p: int, n: int,
                       elem: int = 4) -> int:
    """Bytes of the reverse walk that also reduces da: the decays, the
    incoming gradient and the forward's output read once, the gradient of
    the states written once (the da partials are a few bytes a block)."""
    return (b * c * h + 3 * b * c * h * p * n) * elem
