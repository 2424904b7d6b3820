"""What the metric readers (``perfbench/metrics/<name>.py``) share: each
reader is one of these applied to the run's record. A reader returns
None where the run gives it nothing to read."""
from __future__ import annotations

import importlib

from . import peaks


def counts(run):
    return importlib.import_module(f"perfbench.counts.{run.model['family']}")


def counter(run, name: str, **labels):
    """The increase over the window of the program's counter ``name``
    with exactly ``labels``; None where the program registers no such
    counter."""
    return run.counters.get((name, tuple(sorted(
        (k, str(v)) for k, v in labels.items()))))


def prompt_tokens(run) -> int:
    return sum(b.rows * b.prompt_len for b in run.batches)


def idle_pct(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def kind_pct(run, kind: str):
    if run.trace is None:
        return None
    by = run.trace.seconds_by_kind()
    total = sum(by.values())
    return 100.0 * by.get(kind, 0.0) / total if total else None


def mfu(run):
    """The model FLOPs of the work completed in the window, over the
    window, over the bf16 peak."""
    c = counts(run)
    flops = sum(c.request_flops(run.model, b.rows, b.prompt_len, b.gen)
                for b in run.batches)
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS


def k4_roofline(run, shape_of):
    """K4's byte bound over its device time: every K4 kernel in the trace
    is one scan of ``shape_of(run)`` = (B, C, H, P, N)."""
    if run.trace is None:
        return None
    t, n = run.trace.kernel_seconds("k4_")
    if not n or not t:
        return None
    k4 = importlib.import_module("perfbench.counts.k4")
    bound = n * k4.state_scan_bytes(*shape_of(run)) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / t


def ssd_scan_shape(run):
    m, mix = run.model, run.mix
    h = m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]
    return (mix["batch"], mix["prompt_len"] // m["ssm_chunk"], h,
            m["ssm_headdim"], m["ssm_state"])


def peak_gib(run):
    return run.peak_window_bytes / 2 ** 30


def trained_tokens(run) -> int:
    return sum(b.rows * b.seq_len for b in run.batches)


def train_mfu(run):
    """The model FLOPs of the steps completed in the window (forward and
    backward), over the window, over the bf16 peak."""
    c = counts(run)
    flops = sum(c.train_flops(run.model, b.rows, b.seq_len)
                for b in run.batches)
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS


def ssd_train_shape(run):
    m, mix = run.model, run.mix
    h = m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]
    return (mix["batch"], mix["seq_len"] // m["ssm_chunk"], h,
            m["ssm_headdim"], m["ssm_state"])


def k4_train_roofline(run):
    """K4's byte bound over its device time in the window's training
    steps: a layer's forward scan twice a step (the forward and remat's
    recompute) and its reverse walk with da once."""
    if run.trace is None:
        return None
    t, n = run.trace.kernel_seconds("k4_")
    if not n or not t:
        return None
    k4 = importlib.import_module("perfbench.counts.k4")
    shape = ssd_train_shape(run)
    per_step = run.model["n_layers"] * (2 * k4.state_scan_bytes(*shape)
                                        + k4.reverse_walk_bytes(*shape))
    return 100.0 * len(run.batches) * per_step / peaks.HBM_BYTES_PER_S / t
