"""GPipe pipeline parallelism over a group of ranks
(``src/repro/distributed/pipeline.py``).

Schedule: S stages (one per rank of ``group``, in group-rank order), M
microbatches, T = M + S − 1 ticks. At tick t, stage s runs microbatch
(t − s) when it is in range; activations hop right one stage per tick.
The reference, as SPMD, runs the stage body on zeros on a stage's
inactive (bubble) ticks and masks the result; here a rank skips the
body on those ticks and moves nothing, so a stage's inactive ticks cost
no compute. The last stage's outputs are the same either way. The bubble
is still (S − 1)/T of the ticks (:func:`bubble_fraction`).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collectives as C


def gpipe_forward(stage_fn: Callable, local_params, microbatches: torch.Tensor,
                  group, n_stages: int) -> torch.Tensor:
    """Run microbatches through the pipeline; returns stacked outputs.

    ``stage_fn(local_params, x_mb) -> y_mb``, applied by every stage to
    its own params, keeps the microbatch's shape and dtype (the handoff
    buffer is a microbatch's). ``microbatches``: (M, ...), identical on
    every stage (stage 0 consumes them). The output is valid on the LAST
    stage (zeros elsewhere)."""
    if C.size(group) != n_stages:
        raise ValueError(f"{n_stages} stages over a group of "
                         f"{C.size(group)} ranks")
    s = C.rank(group)
    m = microbatches.shape[0]
    outs = torch.zeros_like(microbatches)
    buf = None
    for t in range(m + n_stages - 1):
        mb = t - s
        y = None
        if 0 <= mb < m:
            x = microbatches[mb] if s == 0 else buf
            y = stage_fn(local_params, x)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise ValueError(f"stage output {tuple(y.shape)} {y.dtype} "
                                 f"!= microbatch {tuple(x.shape)} {x.dtype}")
            if s == n_stages - 1:
                outs[mb] = y
        # stage s sends what it ran this tick; stage s + 1 receives it
        send = s + 1 if y is not None and s < n_stages - 1 else None
        recv = s - 1 if s > 0 and 0 <= t - (s - 1) < m else None
        got = C.shift([y] if send is not None else [], group, send, recv,
                      like=[microbatches[0]])
        buf = got[0] if got else None
    return outs


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead — the napkin number used in §Perf."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
