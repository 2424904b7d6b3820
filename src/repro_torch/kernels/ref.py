"""Torch-eager oracles for the ported SIMD instructions.

These are the "base RV32IM core runs it in software" implementations
from the paper's evaluation (§4.1 baselines): semantically identical to
the GPU kernels, written with stock torch ops only. The oracles of the
instructions not ported yet (sorting networks, scans, top-k, attention)
arrive with their kernels.
"""
from __future__ import annotations

import torch


# -- c0_lv / c0_sv (streaming, §4.1) + STREAM kernels ------------------------

def stream_copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone()          # a materialised copy, never a view

def stream_scale(x: torch.Tensor, s) -> torch.Tensor:
    return x * s

def stream_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b

def stream_triad(a: torch.Tensor, b: torch.Tensor, s) -> torch.Tensor:
    return a + s * b
